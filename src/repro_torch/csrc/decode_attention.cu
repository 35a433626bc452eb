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
// prefix of the cache and little else.  Design: the kernel of
// decode_attention.cuh, shared with the paged kernels, with row b as page b
// of a pool of B pages of T positions (no table).  One CTA per (KV head,
// row, split of the positions) serves all g query heads, so each K/V
// position is read once per KV head rather than once per query head as the
// TPU grid (B, HQ, nKV) does; the TPU's sequential KV grid axis becomes a
// loop of batches of positions inside the CTA, split across CTAs when T is
// long (the last CTA of a (row, KV head) merges the splits in the same
// launch).  Positions at or past a row's kv_len are never loaded.  K and V
// are read through strides, so the engine passes its (B, T, HKV, hd) cache
// as a transposed view without a copy, and per-row lengths come from a
// device array (the Pallas wrapper took one scalar for all rows).
#include "decode_attention.cuh"

// kv_lens: (B,) int32 device array, or null to use the scalar kv_len for
// every row.  hd <= 128 and hq / hkv <= 8; the wrapper checks both.
// window >= 0 and softcap >= 0 (0: off).  The split (n_split, split_len,
// workspace, counters) is the wrapper's plan.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* out,
    const void* kv_lens, int kv_len, int b, int hq, int hkv, int t_len,
    int hd, float scale, int window, float softcap, long long q_b,
    long long q_h, long long k_b, long long k_h, long long k_t, long long v_b,
    long long v_h, long long v_t, long long o_b, long long o_h, int n_split,
    int split_len, void* ws, void* counters, int dtype, void* stream) {
  const DecodeSplit sp{n_split, split_len, static_cast<float*>(ws),
                       static_cast<unsigned*>(counters)};
  if (!da_shapes_ok(b, hq, hkv, hd, b, t_len, 1, sp, window, softcap))
    return static_cast<int>(cudaErrorInvalidValue);
  // k (B, HKV, T, hd) read as B pages of T positions: page stride k_b
  const DecodeStrides st{q_b, q_h, k_b, k_t, k_h, v_b, v_t, v_h, 0,
                         0,   0,   0,   0,   0,   o_b, o_h, 0};
  const dim3 grid(hkv, b, n_split);
  auto s = static_cast<cudaStream_t>(stream);
  RT_DISPATCH(dtype, T,
              decode_attention_kernel<T, T, false, false>
              <<<grid, DA_THREADS, 0, s>>>(
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), nullptr, nullptr,
                  static_cast<T*>(out), nullptr,
                  static_cast<const int*>(kv_lens), kv_len, hq, hkv, hd, b,
                  t_len, 1, scale, window, softcap, st, sp,
                  da_vec_ok<T, T>(hd, q, k, v, st)));
  return static_cast<int>(cudaGetLastError());
}

// Multi-query form (speculative verify, the draft's catch-up step): q and
// out (B, S, HQ, hd); query j of row b at position kv_lens[b] - S + j (see
// decode_attention.cuh, MQ).  The split is the wrapper's plan for B rows;
// the workspace and counters hold B * S (row, query) pairs; grid.z runs
// over the S queries' splits.
extern "C" int decode_attention_mq_launch(
    const void* q, const void* k, const void* v, void* out,
    const void* kv_lens, int b, int s_q, int hq, int hkv, int t_len, int hd,
    float scale, int window, float softcap, long long q_b, long long q_s,
    long long q_h, long long k_b, long long k_h, long long k_t, long long v_b,
    long long v_h, long long v_t, long long o_b, long long o_s, long long o_h,
    int n_split, int split_len, void* ws, void* counters, int dtype,
    void* stream) {
  const DecodeSplit sp{n_split, split_len, static_cast<float*>(ws),
                       static_cast<unsigned*>(counters)};
  if (kv_lens == nullptr || s_q < 1 ||
      !da_shapes_ok(b, hq, hkv, hd, b, t_len, 1, sp, window, softcap) ||
      static_cast<long long>(n_split) * s_q > DA_MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeStrides st{q_b, q_h, k_b, k_t, k_h, v_b, v_t, v_h, 0,
                   0,   0,   0,   0,   0,   o_b, o_h, 0};
  st.n_q = s_q;
  st.q_s = q_s;
  st.o_s = o_s;
  const dim3 grid(hkv, b, n_split * s_q);
  auto s = static_cast<cudaStream_t>(stream);
  RT_DISPATCH(dtype, T,
              decode_attention_kernel<T, T, false, false, true>
              <<<grid, DA_THREADS, 0, s>>>(
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), nullptr, nullptr,
                  static_cast<T*>(out), nullptr,
                  static_cast<const int*>(kv_lens), 0, hq, hkv, hd, b,
                  t_len, 1, scale, window, softcap, st, sp,
                  da_vec_ok<T, T>(hd, q, k, v, st) &&
                      q_s * static_cast<long long>(sizeof(T)) % 16 == 0));
  return static_cast<int>(cudaGetLastError());
}
