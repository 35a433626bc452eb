// The single-token decode attention kernel shared by decode_attention.cu
// (contiguous cache) and paged_decode_attention.cu (block-table pool).
//
// Per row b and query head h: softmax(q . K^T * scale) V over the
// positions t < len of KV head h // g, online softmax in f32, the
// reference's finite NEG_INF mask, and out = acc / max(l, 1e-30).  A row
// with len <= 0 softmaxes NEG_INF uniformly over all nb * bs positions, as
// the masked reference does.
//
// K and V are read as pages (P, bs, HKV, hd) through strides.  With TABLE,
// position t of row b lives at page bt[b, t / bs] (clamped into [0, P - 1],
// so pool sentinels steer no load out of the pool), offset t % bs.
// Without it, row b is page b and t its offset: the contiguous cache,
// launched with P = B, bs = T and nb = 1.  QUANT pages are int8 with an f32
// scale per (token, head), dequantized in registers after the load.
//
// One CTA per (row, KV head) serves all g query heads, so each K/V position
// is read once per KV head.  Its 4 warps take interleaved positions, keep
// per-warp (m, l, acc) for the g heads in registers (lanes split head_dim)
// and merge them once in shared memory.  Positions at or past len are never
// loaded.
#pragma once

#include "common.cuh"

constexpr int DA_WARPS = 4;
constexpr int DA_MAX_G = 8;    // query heads per KV head
constexpr int DA_MAX_J = 4;    // head_dim / 32, so head_dim <= 128
constexpr int DA_MAX_HD = DA_MAX_J * 32;

__device__ __forceinline__ float rt_to_f32(int8_t x) {
  return static_cast<float>(x);
}

struct DecodeStrides {
  long long q_b, q_h;          // q (B, HQ, hd), unit stride on hd
  long long k_p, k_t, k_h;     // k pages (P, bs, HKV, hd), unit stride on hd
  long long v_p, v_t, v_h;
  long long ks_p, ks_t, ks_h;  // k scales (P, bs, HKV), QUANT only
  long long vs_p, vs_t, vs_h;
  long long o_b, o_h;          // out (B, HQ, hd)
  long long bt_b;              // block table (B, NB), unit stride on NB
};

// lens: (B,) int32 device array, or null to use `len_all` for every row;
// a row's length is capped at nb * bs.
template <typename T, typename KV, bool QUANT, bool TABLE>
__global__ void __launch_bounds__(DA_WARPS * 32)
decode_attention_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                        const KV* __restrict__ vp,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs, T* __restrict__ out,
                        const int* __restrict__ bt,
                        const int* __restrict__ lens, int len_all, int hq,
                        int hkv, int hd, int n_pages, int bs, int nb,
                        float scale, DecodeStrides st) {
  __shared__ float sm_m[DA_WARPS][DA_MAX_G];
  __shared__ float sm_l[DA_WARPS][DA_MAX_G];
  __shared__ float sm_acc[DA_WARPS][DA_MAX_G][DA_MAX_HD];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int g = hq / hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t_len = nb * bs;
  const int len = min(lens != nullptr ? lens[b] : len_all, t_len);
  const bool all_masked = len <= 0;
  const int n = all_masked ? t_len : len;
  const int* row = bt + b * st.bt_b;

  float qr[DA_MAX_G][DA_MAX_J];
#pragma unroll
  for (int h = 0; h < DA_MAX_G; ++h)
#pragma unroll
    for (int j = 0; j < DA_MAX_J; ++j) {
      const int dd = lane + 32 * j;
      qr[h][j] = (h < g && dd < hd)
                     ? rt_to_f32(q[b * st.q_b + (kh * g + h) * st.q_h + dd])
                     : 0.f;
    }

  float m[DA_MAX_G], l[DA_MAX_G], acc[DA_MAX_G][DA_MAX_J];
#pragma unroll
  for (int h = 0; h < DA_MAX_G; ++h) {
    m[h] = RT_NEG_INF;
    l[h] = 0.f;
#pragma unroll
    for (int j = 0; j < DA_MAX_J; ++j) acc[h][j] = 0.f;
  }

  for (int t = warp; t < n; t += DA_WARPS) {
    int page = b, off = t;
    if constexpr (TABLE) {
      const int blk = t / bs;
      off = t - blk * bs;
      page = min(max(row[blk], 0), n_pages - 1);
    }
    const KV* krow = kp + page * st.k_p + off * st.k_t + kh * st.k_h;
    const KV* vrow = vp + page * st.v_p + off * st.v_t + kh * st.v_h;
    float k_scale = 1.f, v_scale = 1.f;
    if constexpr (QUANT) {
      k_scale = ks[page * st.ks_p + off * st.ks_t + kh * st.ks_h];
      v_scale = vs[page * st.vs_p + off * st.vs_t + kh * st.vs_h];
    }
    float kt[DA_MAX_J], vt[DA_MAX_J];
#pragma unroll
    for (int j = 0; j < DA_MAX_J; ++j) {
      const int dd = lane + 32 * j;
      kt[j] = dd < hd ? rt_to_f32(krow[dd]) * k_scale : 0.f;
      vt[j] = dd < hd ? rt_to_f32(vrow[dd]) * v_scale : 0.f;
    }
#pragma unroll
    for (int h = 0; h < DA_MAX_G; ++h) {
      if (h >= g) break;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < DA_MAX_J; ++j) s = fmaf(qr[h][j], kt[j], s);
      s = rt_warp_sum(s);
      s = all_masked ? RT_NEG_INF : s * scale;
      const float m_new = fmaxf(m[h], s);
      const float alpha = expf(m[h] - m_new);
      const float p = expf(s - m_new);
      l[h] = l[h] * alpha + p;
#pragma unroll
      for (int j = 0; j < DA_MAX_J; ++j)
        acc[h][j] = fmaf(p, vt[j], acc[h][j] * alpha);
      m[h] = m_new;
    }
  }

#pragma unroll
  for (int h = 0; h < DA_MAX_G; ++h) {
    if (h >= g) break;
    if (lane == 0) {
      sm_m[warp][h] = m[h];
      sm_l[warp][h] = l[h];
    }
#pragma unroll
    for (int j = 0; j < DA_MAX_J; ++j) {
      const int dd = lane + 32 * j;
      if (dd < hd) sm_acc[warp][h][dd] = acc[h][j];
    }
  }
  __syncthreads();

  // merge the warps' partial softmax states; a warp that saw no position
  // holds (NEG_INF, 0, 0) and contributes nothing
  for (int idx = threadIdx.x; idx < g * hd; idx += blockDim.x) {
    const int h = idx / hd, dd = idx % hd;
    float mx = RT_NEG_INF;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) mx = fmaxf(mx, sm_m[w][h]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) {
      const float c = expf(sm_m[w][h] - mx);
      lsum = fmaf(sm_l[w][h], c, lsum);
      a = fmaf(sm_acc[w][h][dd], c, a);
    }
    out[b * st.o_b + (kh * g + h) * st.o_h + dd] =
        rt_from_f32<T>(a / fmaxf(lsum, 1e-30f));
  }
}

static inline bool da_shapes_ok(int b, int hq, int hkv, int hd, int n_pages,
                                int bs, int nb) {
  return b > 0 && hkv > 0 && hq % hkv == 0 && hq / hkv <= DA_MAX_G &&
         hd > 0 && hd <= DA_MAX_HD && n_pages > 0 && bs > 0 && nb > 0;
}
