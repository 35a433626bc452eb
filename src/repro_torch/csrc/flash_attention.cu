// Tiled online-softmax attention (prefill).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
//   (_fa_kernel).
// Computes, per (b, query head h, query row i) with position
// q_offset + i: softmax over key positions of (q . k) * scale, optionally
// soft-capped (cap * tanh(s / cap)), masked to NEG_INF where causal
// (key > query), outside the window (query - key >= window) or at or past
// kv_len, times V; KV head h // g (GQA by index, K/V never expanded).
//
// Bound on Hopper: at the main path's prefill shapes (S = T = 16 tokens,
// head_dim 64) bytes, and far below one launch either way: a CTA holds
// one 16 x 32 score tile.  For long prompts the bound becomes the tensor
// cores' flops, which this first version does not reach (no wgmma, no TMA;
// that is later work).  Design: one CTA per (b, q head, 16-row query tile);
// the TPU's sequential KV grid axis becomes a loop over 32-key tiles held
// in shared memory as f32 (K rows padded by one word so lanes read distinct
// banks).  Each of the 4 warps owns 4 query rows; a lane owns one key of
// the tile for the scores and a 32-wide stripe of head_dim for the output.
// Key tiles wholly masked for every row of the CTA are skipped; if some
// row of the CTA has no valid key at all, every tile is visited so that
// the row softmaxes NEG_INF uniformly, as the reference does.  head_dim is
// a runtime value up to 128: no padding of q/k/v is needed.  All tensors
// are read and written through strides.
#include "common.cuh"

constexpr int FA_WARPS = 4;
constexpr int FA_ROWS = 4;                      // query rows per warp
constexpr int FA_BQ = FA_WARPS * FA_ROWS;       // query rows per CTA
constexpr int FA_BK = 32;                       // keys per tile, one per lane
constexpr int FA_MAX_HD = 128;
constexpr int FA_MAX_J = FA_MAX_HD / 32;

struct FlashStrides {
  long long q_b, q_h, q_s;     // q (B, HQ, S, hd), unit stride on hd
  long long k_b, k_h, k_t;     // k (B, HKV, T, hd)
  long long v_b, v_h, v_t;
  long long o_b, o_h, o_s;     // out (B, HQ, S, hd)
};

struct FlashParams {
  int hq, hkv, s_len, t_len, hd;
  float scale, softcap;
  int causal, window, kv_len, q_offset;
};

template <typename T>
__global__ void __launch_bounds__(FA_WARPS * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       FlashParams p, FlashStrides st) {
  __shared__ float ks[FA_BK][FA_MAX_HD + 1];
  __shared__ float vs[FA_BK][FA_MAX_HD];
  __shared__ float qs[FA_BQ][FA_MAX_HD];

  const int q0 = blockIdx.x * FA_BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.hq / p.hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd = p.hd;
  const int kvl = min(p.kv_len, p.t_len);

  const T* qb = q + b * st.q_b + h * st.q_h;
  for (int idx = threadIdx.x; idx < FA_BQ * hd; idx += blockDim.x) {
    const int r = idx / hd, dd = idx % hd;
    qs[r][dd] = q0 + r < p.s_len ? rt_to_f32(qb[(q0 + r) * st.q_s + dd]) : 0.f;
  }

  // key range that holds a valid key for some row of this CTA
  int lo = p.t_len, hi = 0;
  bool some_row_empty = false;
  for (int r = 0; r < FA_BQ && q0 + r < p.s_len; ++r) {
    const int qpos = p.q_offset + q0 + r;
    const int hi_r = p.causal ? min(qpos + 1, kvl) : kvl;
    const int lo_r = p.window ? max(0, qpos - p.window + 1) : 0;
    if (lo_r >= hi_r) some_row_empty = true;
    lo = min(lo, lo_r);
    hi = max(hi, hi_r);
  }
  if (some_row_empty) {
    lo = 0;
    hi = p.t_len;
  }

  float m[FA_ROWS], l[FA_ROWS], acc[FA_ROWS][FA_MAX_J];
#pragma unroll
  for (int rr = 0; rr < FA_ROWS; ++rr) {
    m[rr] = RT_NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < FA_MAX_J; ++j) acc[rr][j] = 0.f;
  }

  const T* kb = k + b * st.k_b + kh * st.k_h;
  const T* vb = v + b * st.v_b + kh * st.v_h;
  for (int t0 = (lo / FA_BK) * FA_BK; t0 < hi; t0 += FA_BK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int idx = threadIdx.x; idx < FA_BK * hd; idx += blockDim.x) {
      const int j = idx / hd, dd = idx % hd;
      const bool in = t0 + j < p.t_len;
      ks[j][dd] = in ? rt_to_f32(kb[(t0 + j) * st.k_t + dd]) : 0.f;
      vs[j][dd] = in ? rt_to_f32(vb[(t0 + j) * st.v_t + dd]) : 0.f;
    }
    __syncthreads();

    const int kpos = t0 + lane;
    const bool exists = kpos < p.t_len;   // keys past T are not keys at all
#pragma unroll
    for (int rr = 0; rr < FA_ROWS; ++rr) {
      const int r = warp * FA_ROWS + rr;
      if (q0 + r >= p.s_len) break;      // warp-uniform
      const int qpos = p.q_offset + q0 + r;
      float s = 0.f;
      for (int dd = 0; dd < hd; ++dd) s = fmaf(qs[r][dd], ks[lane][dd], s);
      s *= p.scale;
      if (p.softcap != 0.f) s = p.softcap * tanhf(s / p.softcap);
      bool masked = kpos >= kvl;
      if (p.causal) masked |= qpos < kpos;
      if (p.window) masked |= qpos - kpos >= p.window;
      if (masked) s = RT_NEG_INF;

      const float m_new = fmaxf(m[rr], rt_warp_max(exists ? s : -INFINITY));
      const float alpha = expf(m[rr] - m_new);
      const float pr = exists ? expf(s - m_new) : 0.f;
      l[rr] = l[rr] * alpha + rt_warp_sum(pr);
#pragma unroll
      for (int j = 0; j < FA_MAX_J; ++j) acc[rr][j] *= alpha;
      for (int jj = 0; jj < FA_BK; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, pr, jj);
#pragma unroll
        for (int j = 0; j < FA_MAX_J; ++j) {
          const int dd = lane + 32 * j;
          if (dd < hd) acc[rr][j] = fmaf(pj, vs[jj][dd], acc[rr][j]);
        }
      }
      m[rr] = m_new;
    }
  }

  T* ob = out + b * st.o_b + h * st.o_h;
#pragma unroll
  for (int rr = 0; rr < FA_ROWS; ++rr) {
    const int r = warp * FA_ROWS + rr;
    if (q0 + r >= p.s_len) break;
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int j = 0; j < FA_MAX_J; ++j) {
      const int dd = lane + 32 * j;
      if (dd < hd) ob[(q0 + r) * st.o_s + dd] = rt_from_f32<T>(acc[rr][j] * inv);
    }
  }
}

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int b, int hq,
    int hkv, int s_len, int t_len, int hd, float scale, int causal,
    int window, float softcap, int kv_len, int q_offset, long long q_b,
    long long q_h, long long q_s, long long k_b, long long k_h,
    long long k_t, long long v_b, long long v_h, long long v_t,
    long long o_b, long long o_h, long long o_s, int dtype, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || s_len <= 0 || t_len <= 0 ||
      hd <= 0 || hd > FA_MAX_HD)
    return static_cast<int>(cudaErrorInvalidValue);
  const FlashParams p{hq, hkv, s_len, t_len, hd, scale, softcap,
                      causal, window, kv_len, q_offset};
  const FlashStrides st{q_b, q_h, q_s, k_b, k_h, k_t,
                        v_b, v_h, v_t, o_b, o_h, o_s};
  const dim3 grid((s_len + FA_BQ - 1) / FA_BQ, hq, b);
  auto s = static_cast<cudaStream_t>(stream);
  RT_DISPATCH(dtype, T,
              flash_attention_kernel<T><<<grid, FA_WARPS * 32, 0, s>>>(
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<T*>(out), p, st));
  return static_cast<int>(cudaGetLastError());
}
