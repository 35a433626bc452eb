// WKV6: the RWKV-6 time-mix recurrence with data-dependent decay.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6/kernel.py::wkv6_kernel (_wkv6_kernel).
// Per batch row b and head h, with the state S (hd x hd, f32):
//   o_t = r_t S_{t-1} + (r_t . (u_h * k_t)) v_t
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t
// and the final state sT.  The TPU kernel walks T in chunks of 16 on its
// sequential grid axis, carrying S in VMEM, and forms each chunk's pairwise
// decays in log space on the matrix unit.  Here the sequential axis becomes
// a loop over T inside the CTA, one token at a time: the same (o, sT) as
// the chunked form, and overflow-safe for any decay since exp(logw) <= 1
// multiplies S directly.
//
// Bound on Hopper: bytes.  The f32 state is read once and written once
// (2 * B * H * hd^2 * 4 bytes, 5.2 MB at decode for B 4, H 40, hd 64) and
// each token adds 5 * H * hd * 4 bytes of r, k, v, logw and o; a token does
// ~4 hd^2 flops per head against that, far below the card's balance point.
// Design: one CTA per (b, h); thread j owns column j of S in registers (the
// columns are independent, so no reduction crosses threads).  Each step,
// thread i stages r_t[i], k_t[i] and exp(logw_t[i]) in shared memory, and
// every thread walks i over them: o_t[j] += r[i] S[i][j], the bonus
// sum r[i] u[i] k[i] (the same in every thread), S[i][j] = w[i] S[i][j] +
// k[i] v[j].  r, k, v and logw are read through strides in the layer's
// (B, T, H, hd) layout; o is written contiguous (B, T, H, hd).
//
// In place: s0 and sT may be the same buffer (the engine's cache).  Thread
// j reads all of column j before the loop and writes it after, and no
// other thread touches that column, so neither is marked __restrict__.
#include "common.cuh"

template <int HD>
__global__ void __launch_bounds__(HD < 32 ? 32 : HD)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* s0,
            float* __restrict__ o, float* sT, int t_len, int h,
            long long sb, long long st, long long sh) {
  __shared__ float sr[HD], sk[HD], sw[HD], su[HD];
  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh % h;
  const int j = threadIdx.x;
  const bool live = j < HD;
  const size_t s_base = static_cast<size_t>(bh) * HD * HD;

  float s[HD];
  if (live) {
    su[j] = u[hi * HD + j];
#pragma unroll
    for (int i = 0; i < HD; ++i) s[i] = s0[s_base + i * HD + j];
  }
  const long long in_base = bi * sb + hi * sh + j;
  const long long o_step = static_cast<long long>(h) * HD;
  float* o_row = o + (static_cast<long long>(bi) * t_len * h + hi) * HD + j;

  for (int t = 0; t < t_len; ++t) {
    const long long off = in_base + t * st;
    float vj = 0.f;
    if (live) {
      sr[j] = r[off];
      sk[j] = k[off];
      sw[j] = expf(logw[off]);
      vj = v[off];
    }
    __syncthreads();
    if (live) {
      float acc = 0.f, bonus = 0.f;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float ri = sr[i], ki = sk[i];
        acc = fmaf(ri, s[i], acc);
        bonus = fmaf(ri * su[i], ki, bonus);
        s[i] = fmaf(sw[i], s[i], ki * vj);
      }
      o_row[t * o_step] = fmaf(bonus, vj, acc);
    }
    __syncthreads();  // the next step overwrites sr, sk, sw
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < HD; ++i) sT[s_base + i * HD + j] = s[i];
  }
}

// r, k, v, logw: (b, t, h, hd) f32 through strides (sb, st, sh; unit on
// hd); u: (h, hd); s0, sT: (b, h, hd, hd) contiguous, possibly one buffer;
// o: (b, t, h, hd) contiguous.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* logw, const void* u, const void* s0,
                           void* o, void* sT, int b, int t, int h, int hd,
                           long long sb, long long st, long long sh,
                           void* stream) {
  if (b <= 0 || t <= 0 || h <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const float*>(r);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* wp = static_cast<const float*>(logw);
  const auto* up = static_cast<const float*>(u);
  const auto* s0p = static_cast<const float*>(s0);
  auto* op = static_cast<float*>(o);
  auto* sTp = static_cast<float*>(sT);
#define WKV6_CASE(HD)                                                      \
  case HD:                                                                 \
    wkv6_kernel<HD><<<b * h, HD < 32 ? 32 : HD, 0, s>>>(                   \
        rp, kp, vp, wp, up, s0p, op, sTp, t, h, sb, st, sh);               \
    break;
  switch (hd) {
    WKV6_CASE(8)
    WKV6_CASE(16)
    WKV6_CASE(32)
    WKV6_CASE(64)
    WKV6_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WKV6_CASE
  return static_cast<int>(cudaGetLastError());
}
