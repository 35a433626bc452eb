// The single-token decode attention kernel shared by decode_attention.cu
// (contiguous cache) and paged_decode_attention.cu (block-table pool).
//
// Per row b and query head h: softmax(q . K^T * scale) V over the
// positions t < len of KV head h // g, online softmax in f32, the
// reference's finite NEG_INF mask, and out = acc / max(l, 1e-30).  The
// reference model's decode options, in its order
// (repro/layers/attention.py::mha): softcap > 0 caps each scaled score to
// softcap * tanh(s / softcap); window > 0 then keeps only the positions
// t > len - 1 - window (a sliding-window layer, the query at len - 1; len
// is the row's length as given, also where it exceeds nb * bs).  A row
// that keeps no position (len <= 0, or a window wholly past nb * bs)
// softmaxes NEG_INF uniformly over all nb * bs positions, as the masked
// reference does.
//
// K and V are read as pages (P, bs, HKV, hd) through strides.  With TABLE,
// position t of row b lives at page bt[b, t / bs] (clamped into [0, P - 1],
// so pool sentinels steer no load out of the pool), offset t % bs.
// Without it, row b is page b and t its offset: the contiguous cache,
// launched with P = B, bs = T and nb = 1.  QUANT pages are int8 with an f32
// scale per (token, head), dequantized in registers after the load.
//
// Bound on Hopper: bytes, the valid prefix of K and V once per KV head.  At
// the main path's shapes that is a few tens of KB, so the call is one
// launch plus the memory latency it waits on; the design cuts the number
// of dependent round trips and keeps many positions' loads in flight:
//  * Many positions per load.  A lane holds 8 elements of a (token, head)
//    row (16 bytes in bf16, 32 in f32, 8 in int8), so lp = hd / 8 lanes
//    (a power of two) hold a row and one warp instruction loads 32 / lp
//    positions: 4 at hd 64.  Each lane group takes DA_U positions a batch,
//    and every K, V and scale load of the batch is issued before any math;
//    the first batch's before the row's length has arrived (its addresses
//    are clamped to the static length), so the call waits for one round
//    trip to HBM, not two.
//    The dot products reduce inside the lp-lane group (3 shuffles at hd 64).
//  * One softmax update per batch, not per position: the scores of the
//    batch for all g heads, one warp max and one rescale per head, then
//    P . V with each lane group accumulating its own positions over its
//    dims; the groups meet once, after the last batch.
//  * Split over positions in the same launch: grid (KV head, row, split).
//    The wrapper picks the splits from the static length (T or NB * bs,
//    never the device lengths, which would need a host sync):
//    kernels/decode_attention/ops.py::split_plan, one split at the main
//    path's T = 128, enough CTAs to fill the card at T = 1024.  A split
//    whose range starts at or past its row's length stores the neutral
//    partial (NEG_INF, 0, 0), and so does a split whose range ends at or
//    before the window's first position; a split that the window's start
//    cuts begins at the batch holding that position.  Each split writes
//    its (m, l, acc) to a workspace; the last CTA of each (row, KV head)
//    to arrive (a counter after __threadfence, reset by that CTA) merges
//    the splits in split order and writes out, so every call gives the
//    same bits and an all-masked row stays uniform.  With one split there
//    is no workspace.
//  * Table entries and strides are read once per position from registers;
//    no pointer is loaded from the constant bank inside the loop.
// Where hd % 8 != 0 or a pointer or stride is not aligned to a lane's
// vector, the same kernel loads element by element.
//
// MQ (multi-query: the speculative verify and the draft's catch-up step)
// gives each row n_q queries, q and out (B, n_q, HQ, hd).  Query j of row b
// sits at position lens[b] - n_q + j: its length is lens[b] - (n_q - 1 - j),
// capped at nb * bs as a row's is, and its window starts from that length.
// grid.z runs over the (query, split) pairs, z = j * n_split + split, and
// each CTA runs the body above at its query's length with the split plan
// of a B-row call, so a query's sums are taken in the order of a
// single-token step at the same length.  The workspace and the counters
// are kept per (row, query).  The row stays blockIdx.y, and the query and
// split are read again from ctaid.z where they are used, so the MQ
// instance holds no more registers than the single-token one.
#pragma once

#include "common.cuh"

constexpr int DA_WARPS = 4;
constexpr int DA_THREADS = DA_WARPS * 32;
constexpr int DA_MAX_G = 8;    // query heads per KV head
constexpr int DA_MAX_HD = 128;
constexpr int DA_EPL = 8;      // elements of a row one lane holds
constexpr int DA_U = 2;        // positions a lane group takes per batch
constexpr int DA_MAX_SPLITS = 65535;

__device__ __forceinline__ float rt_to_f32(int8_t x) {
  return static_cast<float>(x);
}

// DA_EPL elements of KV, one lane's share of a row, as raw registers
template <typename KV>
struct DaLane;

template <>
struct DaLane<__nv_bfloat16> {
  static constexpr int BYTES = 16;
  struct Raw { uint4 a; };
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return {__ldg(reinterpret_cast<const uint4*>(p))};
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    RtVec16<__nv_bfloat16>::unpack(r.a, f);
  }
};

template <>
struct DaLane<float> {
  static constexpr int BYTES = 16;
  struct Raw { uint4 a, b; };
  static __device__ __forceinline__ Raw load(const float* p) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
    return {__ldg(v), __ldg(v + 1)};
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    RtVec16<float>::unpack(r.a, f);
    RtVec16<float>::unpack(r.b, f + 4);
  }
};

template <>
struct DaLane<int8_t> {
  static constexpr int BYTES = 8;
  struct Raw { uint2 a; };
  static __device__ __forceinline__ Raw load(const int8_t* p) {
    return {__ldg(reinterpret_cast<const uint2*>(p))};
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float* f) {
    const uint32_t w[2] = {r.a.x, r.a.y};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      f[i] = static_cast<float>(
          static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xffu));
  }
};

// A lane's DA_EPL elements of a row at `p`, dims d0..d0+7, as f32,
// element by element and zero past hd (the path for rows that are not
// aligned to a lane's vector).
template <typename E>
__device__ __forceinline__ void da_load_scalar(const E* p, int d0, int hd,
                                               float* f) {
#pragma unroll
  for (int e = 0; e < DA_EPL; ++e)
    f[e] = d0 + e < hd ? rt_to_f32(p[d0 + e]) : 0.f;
}

// blockIdx.z read anew (volatile: not kept in a register from an earlier
// read, so what derives from it is computed where it is used)
__device__ __forceinline__ int da_ctaid_z() {
  int z;
  asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(z));
  return z;
}

struct DecodeStrides {
  long long q_b, q_h;          // q (B, HQ, hd), unit stride on hd
  long long k_p, k_t, k_h;     // k pages (P, bs, HKV, hd), unit stride on hd
  long long v_p, v_t, v_h;
  long long ks_p, ks_t, ks_h;  // k scales (P, bs, HKV), QUANT only
  long long vs_p, vs_t, vs_h;
  long long o_b, o_h;          // out (B, HQ, hd)
  long long bt_b;              // block table (B, NB), unit stride on NB
  int n_q = 1;                 // MQ only: queries a row, and their
  long long q_s = 0, o_s = 0;  // strides in q (B, n_q, HQ, hd) and out
};

// The split of the positions (kernels/decode_attention/ops.py::split_plan)
// and, with more than one split, the workspace of (B, HKV, n_split, g,
// hd + 2) floats and the (B, HKV) arrival counters, zero between calls.
struct DecodeSplit {
  int n_split, split_len;
  float* ws;
  unsigned* counters;
};

// lens: (B,) int32 device array, or null to use `len_all` for every row;
// a row's length is capped at nb * bs.  MQ needs lens.
template <typename T, typename KV, bool QUANT, bool TABLE, bool MQ = false>
__global__ void __launch_bounds__(DA_THREADS)
decode_attention_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                        const KV* __restrict__ vp,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs, T* __restrict__ out,
                        const int* __restrict__ bt,
                        const int* __restrict__ lens, int len_all, int hq,
                        int hkv, int hd, int n_pages, int bs, int nb,
                        float scale, int window, float softcap,
                        DecodeStrides st, DecodeSplit sp, int vec) {
  __shared__ float sm_m[DA_WARPS][DA_MAX_G];
  __shared__ float sm_l[DA_WARPS][DA_MAX_G];
  __shared__ float sm_acc[DA_WARPS][DA_MAX_G][DA_MAX_HD];
  __shared__ bool sm_last;

  const int kh = blockIdx.x, b = blockIdx.y;
  int split = blockIdx.z;
  const T* qb = q + b * st.q_b;
  if constexpr (MQ) {
    const int qi = split / sp.n_split;
    split -= qi * sp.n_split;
    qb += qi * st.q_s;
  }
  const int g = hq / hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int lp = 1;                        // lanes per position: hd / 8, pow2
  while (lp * DA_EPL < hd) lp <<= 1;
  const int ppw = 32 / lp;           // positions per warp instruction
  const int grp = lane / lp, d0 = (lane % lp) * DA_EPL;
  // a lane past hd (hd not a power of two) loads the row's last 8 dims
  // and weighs them 0 through q
  const int dl = vec ? min(d0, hd - DA_EPL) : d0;

  float qr[DA_MAX_G][DA_EPL];
#pragma unroll
  for (int h = 0; h < DA_MAX_G; ++h) {
    const T* qh = qb + (kh * g + min(h, g - 1)) * st.q_h;
    if (vec)
      DaLane<T>::unpack(DaLane<T>::load(qh + dl), qr[h]);
    else
      da_load_scalar(qh, d0, hd, qr[h]);
  }
#pragma unroll
  for (int h = 0; h < DA_MAX_G; ++h)
#pragma unroll
    for (int e = 0; e < DA_EPL; ++e)
      if (h >= g || d0 >= hd) qr[h][e] = 0.f;

  const int t_len = nb * bs;
  int len_in = 0;                    // the row's length, used below
  if constexpr (!MQ) len_in = lens != nullptr ? lens[b] : len_all;
  const int t0 = split * sp.split_len;
  const int* row = bt + b * st.bt_b;
  const long long k_p = st.k_p, k_t = st.k_t, v_p = st.v_p, v_t = st.v_t;
  const long long k_off = kh * st.k_h, v_off = kh * st.v_h;

  // A batch's loads, raw.  Addresses depend only on the static length: a
  // position is clamped into [0, t_len), so the first batch is issued
  // before the row's length has arrived; a position past the range loads a
  // row of the cache or pool that then weighs 0 (its score -inf, its V 0).
  typename DaLane<KV>::Raw kr[DA_U], vr[DA_U];
  const KV* krow[DA_U];
  const KV* vrow[DA_U];
  float k_scale[DA_U], v_scale[DA_U];
  auto load_batch = [&](int base) {
    int t[DA_U], page[DA_U], off[DA_U];
#pragma unroll
    for (int u = 0; u < DA_U; ++u) {
      t[u] = min(base + u * ppw + grp, t_len - 1);
      page[u] = b;
      off[u] = t[u];
      if constexpr (TABLE) page[u] = row[t[u] / bs];   // all in flight
    }
#pragma unroll
    for (int u = 0; u < DA_U; ++u) {
      if constexpr (TABLE) {
        off[u] = t[u] - t[u] / bs * bs;
        page[u] = min(max(page[u], 0), n_pages - 1);
      }
      krow[u] = kp + page[u] * k_p + off[u] * k_t + k_off;
      vrow[u] = vp + page[u] * v_p + off[u] * v_t + v_off;
      if constexpr (QUANT) {
        k_scale[u] = ks[page[u] * st.ks_p + off[u] * st.ks_t + kh * st.ks_h];
        v_scale[u] = vs[page[u] * st.vs_p + off[u] * st.vs_t + kh * st.vs_h];
      }
    }
    if (vec) {
#pragma unroll
      for (int u = 0; u < DA_U; ++u) {
        kr[u] = DaLane<KV>::load(krow[u] + dl);
        vr[u] = DaLane<KV>::load(vrow[u] + dl);
      }
    }
  };
  const int first = t0 + warp * DA_U * ppw;
  load_batch(first);
  // MQ: the query's own length, loaded (and its index read anew from
  // ctaid.z) after the first batch's loads are issued, so neither is held
  // across them: the f32 instance then keeps the single-token one's
  // registers
  if constexpr (MQ)
    len_in = lens[b] - (st.n_q - 1 - da_ctaid_z() / sp.n_split);

  const int len = min(len_in, t_len);
  // the window's first position, from the row's own length (not the
  // clamped one), as the reference masks it
  const int lo_w = window > 0 ? max(0, len_in - window) : 0;
  const bool all_masked = len <= 0 || lo_w >= len;
  const int n = all_masked ? t_len : len;
  const int t1 = min(t0 + sp.split_len, n);
  // the batches wholly below the window are skipped (the prefetched first
  // batch is then reloaded at the first one kept), and a split with nothing
  // at or above it keeps the neutral partial
  const int lo = all_masked ? 0 : lo_w;
  const int stride = DA_WARPS * DA_U * ppw;
  int start = first;
  if (lo > t0 && lo < t1) {
    start += (lo - t0) / stride * stride;
    if (start != first) load_batch(start);
  }
  const int t_hi = lo < t1 ? t1 : t0;

  float m[DA_MAX_G], l[DA_MAX_G], acc[DA_MAX_G][DA_EPL];
#pragma unroll
  for (int h = 0; h < DA_MAX_G; ++h) {
    m[h] = RT_NEG_INF;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < DA_EPL; ++e) acc[h][e] = 0.f;
  }

  for (int base = start; base < t_hi; base += stride) {
    if (base != start) load_batch(base);
    bool valid[DA_U];
    float kf[DA_U][DA_EPL], vf[DA_U][DA_EPL];
#pragma unroll
    for (int u = 0; u < DA_U; ++u) {
      const int tp = base + u * ppw + grp;
      valid[u] = tp < t1 && tp >= lo;
      if (vec) {
        DaLane<KV>::unpack(kr[u], kf[u]);
        DaLane<KV>::unpack(vr[u], vf[u]);
      } else {
        da_load_scalar(krow[u], d0, hd, kf[u]);
        da_load_scalar(vrow[u], d0, hd, vf[u]);
      }
    }
    if constexpr (QUANT) {
#pragma unroll
      for (int u = 0; u < DA_U; ++u)
#pragma unroll
        for (int e = 0; e < DA_EPL; ++e) {
          kf[u][e] *= k_scale[u];
          vf[u][e] *= v_scale[u];
        }
    }
#pragma unroll
    for (int u = 0; u < DA_U; ++u)          // a stale row weighs exactly 0
#pragma unroll
      for (int e = 0; e < DA_EPL; ++e) vf[u][e] = valid[u] ? vf[u][e] : 0.f;

#pragma unroll
    for (int h = 0; h < DA_MAX_G; ++h) {
      if (h >= g) break;
      float s[DA_U];
      float mb = -INFINITY;
#pragma unroll
      for (int u = 0; u < DA_U; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < DA_EPL; ++e)
          dot = fmaf(qr[h][e], kf[u][e], dot);
        for (int o = 1; o < lp; o <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        float sc = dot * scale;
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
        s[u] = !valid[u] ? -INFINITY : (all_masked ? RT_NEG_INF : sc);
        mb = fmaxf(mb, s[u]);
      }
      for (int o = lp; o < 32; o <<= 1)
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, o));
      const float m_new = fmaxf(m[h], mb);
      const float alpha = expf(m[h] - m_new);
      l[h] *= alpha;
#pragma unroll
      for (int e = 0; e < DA_EPL; ++e) acc[h][e] *= alpha;
#pragma unroll
      for (int u = 0; u < DA_U; ++u) {
        const float p = expf(s[u] - m_new);      // 0 past the range
        l[h] += p;
#pragma unroll
        for (int e = 0; e < DA_EPL; ++e)
          acc[h][e] = fmaf(p, vf[u][e], acc[h][e]);
      }
      m[h] = m_new;
    }
  }

  // the lane groups of a warp share m: sum their l and acc
#pragma unroll
  for (int h = 0; h < DA_MAX_G; ++h) {
    if (h >= g) break;
    for (int o = lp; o < 32; o <<= 1) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], o);
#pragma unroll
      for (int e = 0; e < DA_EPL; ++e)
        acc[h][e] += __shfl_xor_sync(0xffffffffu, acc[h][e], o);
    }
    if (lane == 0) {
      sm_m[warp][h] = m[h];
      sm_l[warp][h] = l[h];
    }
    if (grp == 0)
#pragma unroll
      for (int e = 0; e < DA_EPL; ++e)
        if (d0 + e < hd) sm_acc[warp][h][d0 + e] = acc[h][e];
  }
  __syncthreads();

  // the (row, query) pair r indexes the output, the workspace and the
  // counters (r = b without MQ)
  int r = b;
  T* ob = out + b * st.o_b;
  if constexpr (MQ) {
    const int z = da_ctaid_z();
    const int qe = z / sp.n_split;
    split = z - qe * sp.n_split;
    r = b * st.n_q + qe;
    ob += qe * st.o_s;
  }
  // merge the warps' partial softmax states; a warp that saw no position
  // holds (NEG_INF, 0, 0) and contributes nothing
  const size_t part_stride = static_cast<size_t>(g) * (hd + 2);
  float* part = sp.n_split == 1
                    ? nullptr
                    : sp.ws + (static_cast<size_t>(r * hkv + kh) *
                                   sp.n_split + split) * part_stride;
  for (int idx = threadIdx.x; idx < g * hd; idx += DA_THREADS) {
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
    if (sp.n_split == 1) {
      ob[(kh * g + h) * st.o_h + dd] =
          rt_from_f32<T>(a / fmaxf(lsum, 1e-30f));
    } else {
      part[h * (hd + 2) + 2 + dd] = a;
      if (dd == 0) {
        part[h * (hd + 2)] = mx;
        part[h * (hd + 2) + 1] = lsum;
      }
    }
  }
  if (sp.n_split == 1) return;

  // the last split of (row, KV head) to arrive merges all of them
  __threadfence();
  __syncthreads();
  unsigned* counter = sp.counters + r * hkv + kh;
  if (threadIdx.x == 0)
    sm_last = atomicAdd(counter, 1u) == static_cast<unsigned>(sp.n_split - 1);
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  if (threadIdx.x == 0) *counter = 0u;         // ready for the next call
  const float* parts = sp.ws + static_cast<size_t>(r * hkv + kh) *
                                   sp.n_split * part_stride;
  for (int idx = threadIdx.x; idx < g * hd; idx += DA_THREADS) {
    const int h = idx / hd, dd = idx % hd;
    float mx = RT_NEG_INF;
    for (int s = 0; s < sp.n_split; ++s)
      mx = fmaxf(mx, __ldcg(parts + s * part_stride + h * (hd + 2)));
    float lsum = 0.f, a = 0.f;
    for (int s = 0; s < sp.n_split; ++s) {
      const float* ps = parts + s * part_stride + h * (hd + 2);
      const float c = expf(__ldcg(ps) - mx);
      lsum = fmaf(__ldcg(ps + 1), c, lsum);
      a = fmaf(__ldcg(ps + 2 + dd), c, a);
    }
    ob[(kh * g + h) * st.o_h + dd] =
        rt_from_f32<T>(a / fmaxf(lsum, 1e-30f));
  }
}

static inline bool da_shapes_ok(int b, int hq, int hkv, int hd, int n_pages,
                                int bs, int nb, const DecodeSplit& sp,
                                int window, float softcap) {
  const int t_len = nb * bs;
  return window >= 0 && softcap >= 0.f && b > 0 && b <= 65535 && hkv > 0 &&
         hq % hkv == 0 &&
         hq / hkv <= DA_MAX_G && hd > 0 && hd <= DA_MAX_HD && n_pages > 0 &&
         bs > 0 && nb > 0 && sp.n_split >= 1 &&
         sp.n_split <= DA_MAX_SPLITS && sp.split_len >= 1 &&
         static_cast<long long>(sp.n_split) * sp.split_len >= t_len &&
         static_cast<long long>(sp.n_split - 1) * sp.split_len < t_len &&
         (sp.n_split == 1 || (sp.ws != nullptr && sp.counters != nullptr));
}

// Whether every lane's 8 elements of q and of each K/V row can be loaded
// as vectors: hd % 8 == 0 and each pointer and stride aligned to them.
template <typename T, typename KV>
static inline int da_vec_ok(int hd, const void* q, const void* kp,
                            const void* vp, const DecodeStrides& st) {
  constexpr int a = DaLane<KV>::BYTES;
  auto kv = [](long long s) { return s * sizeof(KV) % a == 0; };
  auto qs = [](long long s) { return s * sizeof(T) % 16 == 0; };
  return hd % DA_EPL == 0 && rt_aligned(q) && rt_aligned(kp, a) &&
         rt_aligned(vp, a) && qs(st.q_b) && qs(st.q_h) && kv(st.k_p) &&
         kv(st.k_t) && kv(st.k_h) && kv(st.v_p) && kv(st.v_t) && kv(st.v_h);
}
