// Single-token decode attention through a block table over a pool of KV
// pages, with the pool in bf16/f32 or in int8 with per-(token, head) scales.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/decode_attention/kernel.py::paged_decode_attention_kernel
//   (_paged_dec_kernel) and
//   src/repro/kernels/decode_attention/kernel.py::
//   paged_decode_attention_quant_kernel (_paged_dec_quant_kernel).
// Computes, per row b and query head h: softmax(q . K^T * scale) V over the
// positions t < kv_lens[b] of KV head h // g, where position t lives at
// page bt[b, t / bs], offset t % bs.  Online softmax in f32, the
// reference's finite NEG_INF mask, out = acc / max(l, 1e-30).  Table
// entries are clamped to [0, P - 1] (pool sentinels steer no load out of
// the pool) and kv_lens is capped at NB * bs, as the Pallas wrapper does.
// A row with kv_lens <= 0 softmaxes NEG_INF uniformly over all NB * bs
// positions, as the masked reference does.
//
// Bound on Hopper: bytes.  Each cached K/V element is used for 2 * g flops
// (g = HQ / HKV), so the kernel streams the valid pages of each row and
// little else.  Design: the kernel of decode_attention.cuh, shared with the
// contiguous kernel, with the block-table lookup switched on.  One CTA
// per (KV head, row, split of the positions) serves all g query heads, so
// each page is read once per KV head, not once per query head as the TPU
// grid (B, HQ, NB) does.  The TPU's sequential NB grid axis becomes a loop
// of batches of positions inside the CTA, split across CTAs when NB * bs is
// long (the last CTA of a (row, KV head) merges the splits in the same
// launch); each CTA reads its own block-table entries (the TPU
// scalar-prefetched them).  Positions at or past kv_lens[b] are never
// loaded.  The pool is read in place in its (P, bs, HKV, hd) layout through
// strides (the Pallas wrapper re-lays it head-major on every call).  The
// int8 variant loads 8 bytes of payload a lane and the f32 scale of each
// (token, head) and dequantizes in registers: its HBM traffic is the int8
// bytes plus 4 B per (token, head) for K and for V, and no widened copy is
// ever written.
#include "decode_attention.cuh"

// Pages in the dtype of q and out (f32 or bf16).  bt: (B, NB) int32 with
// row stride bt_b; kv_lens: (B,) int32.  The wrapper checks every shape;
// window >= 0 and softcap >= 0 (0: off) for both entries.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* kp, const void* vp, void* out, const void* bt,
    const void* kv_lens, int b, int hq, int hkv, int hd, int n_pages, int bs,
    int nb, float scale, int window, float softcap, long long q_b,
    long long q_h, long long k_p, long long k_t, long long k_h, long long v_p,
    long long v_t, long long v_h, long long o_b, long long o_h,
    long long bt_b, int n_split, int split_len, void* ws, void* counters,
    int dtype, void* stream) {
  const DecodeSplit sp{n_split, split_len, static_cast<float*>(ws),
                       static_cast<unsigned*>(counters)};
  if (!da_shapes_ok(b, hq, hkv, hd, n_pages, bs, nb, sp, window,
                    softcap))
    return static_cast<int>(cudaErrorInvalidValue);
  const DecodeStrides st{q_b, q_h, k_p, k_t, k_h, v_p, v_t, v_h, 0,
                         0,   0,   0,   0,   0,   o_b, o_h, bt_b};
  const dim3 grid(hkv, b, n_split);
  auto s = static_cast<cudaStream_t>(stream);
  RT_DISPATCH(dtype, T,
              decode_attention_kernel<T, T, false, true>
              <<<grid, DA_THREADS, 0, s>>>(
                  static_cast<const T*>(q), static_cast<const T*>(kp),
                  static_cast<const T*>(vp), nullptr, nullptr,
                  static_cast<T*>(out), static_cast<const int*>(bt),
                  static_cast<const int*>(kv_lens), 0, hq, hkv, hd, n_pages,
                  bs, nb, scale, window, softcap, st, sp,
                  da_vec_ok<T, T>(hd, q, kp, vp, st)));
  return static_cast<int>(cudaGetLastError());
}

// int8 pages with f32 scale pages (P, bs, HKV); q and out f32 or bf16.
extern "C" int paged_decode_attention_quant_launch(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, void* out, const void* bt, const void* kv_lens, int b,
    int hq, int hkv, int hd, int n_pages, int bs, int nb, float scale,
    int window, float softcap, long long q_b, long long q_h, long long k_p,
    long long k_t, long long k_h, long long v_p, long long v_t, long long v_h,
    long long ks_p, long long ks_t, long long ks_h, long long vs_p,
    long long vs_t, long long vs_h, long long o_b, long long o_h,
    long long bt_b, int n_split, int split_len, void* ws, void* counters,
    int dtype, void* stream) {
  const DecodeSplit sp{n_split, split_len, static_cast<float*>(ws),
                       static_cast<unsigned*>(counters)};
  if (!da_shapes_ok(b, hq, hkv, hd, n_pages, bs, nb, sp, window,
                    softcap))
    return static_cast<int>(cudaErrorInvalidValue);
  const DecodeStrides st{q_b,  q_h,  k_p,  k_t,  k_h, v_p, v_t, v_h, ks_p,
                         ks_t, ks_h, vs_p, vs_t, vs_h, o_b, o_h, bt_b};
  const dim3 grid(hkv, b, n_split);
  auto s = static_cast<cudaStream_t>(stream);
  RT_DISPATCH(dtype, T,
              decode_attention_kernel<T, int8_t, true, true>
              <<<grid, DA_THREADS, 0, s>>>(
                  static_cast<const T*>(q), static_cast<const int8_t*>(kp),
                  static_cast<const int8_t*>(vp),
                  static_cast<const float*>(ks),
                  static_cast<const float*>(vs), static_cast<T*>(out),
                  static_cast<const int*>(bt),
                  static_cast<const int*>(kv_lens), 0, hq, hkv, hd, n_pages,
                  bs, nb, scale, window, softcap, st, sp,
                  da_vec_ok<T, int8_t>(hd, q, kp, vp, st)));
  return static_cast<int>(cudaGetLastError());
}
