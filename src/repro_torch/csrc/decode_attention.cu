// Single-token decode attention over a contiguous KV cache.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/kernel.py::decode_attention_kernel
//   (_dec_kernel).
// Computes, per row b and query head h: softmax(q . K^T * scale) V over the
// positions t < kv_len of KV head h // g, with online softmax in f32, the
// reference's finite NEG_INF mask, and out = acc / max(l, 1e-30).
//
// Bound on Hopper: bytes.  Each cached K/V element is used for 2*g flops
// (g = HQ/HKV query heads per KV head), so the kernel streams the valid
// prefix of the cache and little else.  Design: one CTA per (row, KV head)
// serves all g query heads, so each K/V position is read once per KV head
// rather than once per query head as the TPU grid (B, HQ, nKV) does.  The
// TPU's sequential KV grid axis becomes a loop inside the CTA: its 4 warps
// take interleaved positions, keep per-warp (m, l, acc) for the g heads in
// registers (lanes split head_dim), and meet once in shared memory at the
// end.  Positions at or past a row's kv_len are never loaded.  K and V are
// read through strides, so the engine passes its (B, T, HKV, hd) cache as a
// transposed view without a copy, and per-row lengths come from a device
// array (the Pallas wrapper took one scalar for all rows).
#include "common.cuh"

constexpr int DA_WARPS = 4;
constexpr int DA_MAX_G = 8;    // query heads per KV head
constexpr int DA_MAX_J = 4;    // head_dim / 32, so head_dim <= 128
constexpr int DA_MAX_HD = DA_MAX_J * 32;

struct DecodeStrides {
  long long q_b, q_h;          // q (B, HQ, hd), unit stride on hd
  long long k_b, k_h, k_t;     // k (B, HKV, T, hd), unit stride on hd
  long long v_b, v_h, v_t;
  long long o_b, o_h;          // out (B, HQ, hd)
};

template <typename T>
__global__ void __launch_bounds__(DA_WARPS * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ out,
                        const int* __restrict__ kv_lens, int kv_len,
                        int hq, int hkv, int t_len, int hd, float scale,
                        DecodeStrides st) {
  __shared__ float sm_m[DA_WARPS][DA_MAX_G];
  __shared__ float sm_l[DA_WARPS][DA_MAX_G];
  __shared__ float sm_acc[DA_WARPS][DA_MAX_G][DA_MAX_HD];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int g = hq / hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = kv_lens != nullptr ? kv_lens[b] : kv_len;
  // a row with no valid position softmaxes NEG_INF everywhere: uniform
  // weights over all T positions, exactly as the masked reference does
  const bool all_masked = len <= 0;
  const int n = all_masked ? t_len : min(len, t_len);

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

  const T* kbase = k + b * st.k_b + kh * st.k_h;
  const T* vbase = v + b * st.v_b + kh * st.v_h;
  for (int t = warp; t < n; t += DA_WARPS) {
    float kt[DA_MAX_J], vt[DA_MAX_J];
#pragma unroll
    for (int j = 0; j < DA_MAX_J; ++j) {
      const int dd = lane + 32 * j;
      kt[j] = dd < hd ? rt_to_f32(kbase[t * st.k_t + dd]) : 0.f;
      vt[j] = dd < hd ? rt_to_f32(vbase[t * st.v_t + dd]) : 0.f;
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

// kv_lens: (B,) int32 device array, or null to use the scalar kv_len for
// every row.  hd <= 128 and hq / hkv <= 8; the wrapper checks both.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* out,
    const void* kv_lens, int kv_len, int b, int hq, int hkv, int t_len,
    int hd, float scale, long long q_b, long long q_h, long long k_b,
    long long k_h, long long k_t, long long v_b, long long v_h,
    long long v_t, long long o_b, long long o_h, int dtype, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || hq / hkv > DA_MAX_G ||
      hd <= 0 || hd > DA_MAX_HD || t_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const DecodeStrides st{q_b, q_h, k_b, k_h, k_t, v_b, v_h, v_t, o_b, o_h};
  const dim3 grid(hkv, b);
  auto s = static_cast<cudaStream_t>(stream);
  RT_DISPATCH(dtype, T,
              decode_attention_kernel<T><<<grid, DA_WARPS * 32, 0, s>>>(
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<T*>(out),
                  static_cast<const int*>(kv_lens), kv_len, hq, hkv, t_len,
                  hd, scale, st));
  return static_cast<int>(cudaGetLastError());
}
