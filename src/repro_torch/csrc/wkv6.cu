// WKV6: the RWKV-6 time-mix recurrence with data-dependent decay.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6/kernel.py::wkv6_kernel (_wkv6_kernel).
// Per batch row b and head h, with the state S (hd x hd, f32):
//   o_t = r_t S_{t-1} + (r_t . (u_h * k_t)) v_t
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t
// and the final state sT.
//
// Bound on Hopper: bytes.  Read once, the call moves r, k, v, logw and o
// (5 * B * T * H * hd * 4 bytes), u, and the f32 state read and written
// (2 * B * H * hd^2 * 4): 5.2 MB at decode (B 4, H 40, hd 64), 53.7 MB at
// B 1, T 1024, against ~5 hd^2 flops per token and head.  Every column CTA
// (below) reads all of r, k and logw, so at hd 64 the kernel issues 14 / 5
// of the bound's per-token bytes; the hd / 16 CTAs of one head run side by
// side, so the re-reads come from L2.
//
// Columns across CTAs (T > 1).  o_t[j] and S[:, j] depend on column j of S
// and of v, and on r, k and logw, which every column needs, so the columns
// are independent.  Grid (B * H, hd / CW), CW = min(16, hd): 160 CTAs at B
// 1, H 40, hd 64, where one CTA a head left 92 of 132 SMs idle.  Each CTA
// reads and writes only its own columns of the state, so s0 and sT may be
// one buffer (the engine's cache): neither is marked __restrict__.
//
// T = 1 (decode): wkv6_step_kernel, one CTA a head.  Thread j keeps
// column j of the state in registers, so o[j] needs no reduction across
// threads, and its loads of the column coalesce across the warp.  On an
// H100 this beat splitting the columns over CTAs with 16-byte loads and a
// shuffle reduction of o (8.6-8.7 us against 9.5-9.6 us at B 4, H 40, cold
// L2): at one token the reduction's latency outweighs the wider grid.
//
// T > 1: wkv6_chunk_kernel, the TPU kernel's chunked form.  T is walked in
// chunks of C = 16 by a loop inside the CTA (the TPU's sequential grid
// axis).  With cum the inclusive prefix sum of logw over a chunk's rows,
// cum_exc = cum - logw and tot = cum[C-1]:
//   A[t,s] = sum_i r[t,i] k[s,i] exp(cum_exc[t,i] - cum[s,i])  (s < t)
//   A[t,t] = sum_i r[t,i] u[i] k[t,i]
//   o      = A V + (r * exp(cum_exc)) S
//   S     <- exp(tot) * S + (k * exp(tot - cum))^T V
// Every exp argument is <= 0, so any decay is overflow-safe.  The prefix
// sum is compensated (hi + lo, Knuth's two-sum) and each difference is
// taken as (hi - hi) + (lo - lo): with decays of exp(-50) and exp(-1e-4) in
// turn, cum reaches -400 within a chunk and a plain f32 cumsum drops the
// -1e-4 steps (the plain chunked version is 4.4e-4 off the float64
// recurrence there; this kernel keeps to 2e-5).
//
// A chunk in the CTA (8 warps):
//  - staging: four bulk tensor copies (the TMA engine, from tensor maps
//    the host encodes each call) bring its rows of r, k, logw and the
//    CTA's columns of v into one of two stages while the previous chunk
//    computes; an mbarrier counts their bytes.  Rows past T arrive as
//    zeros (the maps' out-of-bounds fill), so a ragged last chunk needs no
//    padding.  Rows that are not 16-byte aligned are copied by every
//    thread with plain loads instead.
//  - the column phase: warp w holds 32 columns of r, k and the prefix sum
//    in registers, forms its terms of a fixed group of A's entries and of
//    a few of its diagonal rows, and sums each over the columns with a warp
//    reduce-scatter; for those rows it also writes r * exp(cum_exc) and
//    (k * exp(tot - cum))^T to shared memory.
//  - the state phase: thread (g, j) keeps hd / 16 rows of column j of S in
//    registers for the whole call, adds its rows' part of o_t[j] for all 16
//    t (and column g of A V), updates its rows of S, and the warps' parts
//    are summed through shared memory.  Two CTA barriers a chunk.
// Each column CTA forms A itself (120 * hd exps a chunk): sharing A would
// take a second launch (one empty launch costs ~4.7 us on an H100, more
// than a 12-token chunk) or a cluster exchange with a barrier every chunk.
// f32 FMAs throughout: plain TF32 would keep three digits, and the layer's
// f32 logits need more.  What bounds the kernel in practice is each
// chunk's dependent chain (loads, prefix sum, exps, reduce-scatter,
// barriers) on 8 warps an SM, not bytes.
#include "common.cuh"

#include <cuda.h>
#include <cudaTypedefs.h>

#include <utility>

namespace {

constexpr int WKV_C = 16;          // chunk rows
constexpr int WKV_CHUNK_NT = 256;  // threads a CTA, T > 1

template <int HD>
struct WkvShape {
  static constexpr int CW = HD < 16 ? HD : 16;   // state columns a CTA
  static constexpr int P = HD + 4;               // padded row of rq
  static constexpr int PK = WKV_C + 4;           // padded row of kT
  // the column phase: warp w takes columns (w % NIB) * 32 + lane and the
  // strictly-lower entries of A in pair group w / NIB
  static constexpr int NIB = HD >= 32 ? HD / 32 : 1;
  static constexpr int NPG = WKV_CHUNK_NT / 32 / NIB;
  static constexpr int PPG = WKV_C * (WKV_C - 1) / 2 / NPG;
  static constexpr int V = PPG <= 16 ? 16 : PPG <= 32 ? 32 : 64;
  static constexpr int DPG = WKV_C / NPG;        // diagonal rows a group
  static constexpr int AE = WKV_C * WKV_C;       // A, row-major, per i block
  static constexpr int STAGE = 3 * WKV_C * HD + WKV_C * CW;  // r k logw v
  static constexpr int FLOATS = 2 * STAGE + WKV_C * P + HD * PK + NIB * AE +
                                WKV_CHUNK_NT / 32 * WKV_C * CW + HD;
  static constexpr int BYTES = FLOATS * 4;
};

// Strictly-lower entry e = t (t - 1) / 2 + s of a WKV_C x WKV_C matrix.
__host__ __device__ constexpr int tri_t(int e) {
  int t = 1;
  while (e >= t) e -= t++;
  return t;
}
__host__ __device__ constexpr int tri_s(int e) {
  int t = 1;
  while (e >= t) e -= t++;
  return e;
}

// Row-major index in A of entry e, for an e known only at run time
// (1 + 8 e is an exact square at the first entry of each row).
__device__ __forceinline__ int wkv_entry(int e) {
  const int t = static_cast<int>((1.f + sqrtf(1.f + 8.f * e)) * 0.5f);
  return t * WKV_C + e - t * (t - 1) / 2;
}

// exp(x) for x <= 0; ex2.approx flushes a result below 2^-126 to zero
__device__ __forceinline__ float wkv_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The mbarrier a stage's bulk tensor copies complete on: one arrival that
// expects their bytes.
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared.b64 [%0], 1;" ::"r"(smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Tensor maps of r, k, logw and v for the bulk tensor copies: dims (hd and
// then T, H, B in the order of their strides), a box of 16 rows of T.
struct WkvMaps {
  CUtensorMap r, k, w, v;
  int pos_t, pos_h, pos_b;      // the dims that T, H and B take (1 to 3)
};

__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace

// T = 1: thread j owns column j of the head's state in registers, so o[j]
// needs no reduction across threads; its hd loads of the column are issued
// before the first use and coalesce across the threads (a row a warp
// load).
template <int HD>
__global__ void __launch_bounds__(HD < 32 ? 32 : HD)
wkv6_step_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ logw,
                 const float* __restrict__ u, const float* s0,
                 float* __restrict__ o, float* sT, int h, long long sb,
                 long long sh) {
  __shared__ float sr[HD], sk[HD], sw[HD], su[HD];
  const int bh = blockIdx.x, bi = bh / h, hi = bh % h;
  const int j = threadIdx.x;
  const bool live = j < HD;
  const size_t s_base = static_cast<size_t>(bh) * HD * HD;
  const long long off = bi * sb + hi * sh + j;
  float s[HD], vj = 0.f;
  if (live) {
#pragma unroll
    for (int i = 0; i < HD; ++i) s[i] = s0[s_base + i * HD + j];
    su[j] = u[hi * HD + j];
    sr[j] = r[off];
    sk[j] = k[off];
    sw[j] = __expf(logw[off]);
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
      sT[s_base + i * HD + j] = fmaf(sw[i], s[i], ki * vj);
    }
    o[static_cast<long long>(bh) * HD + j] = fmaf(bonus, vj, acc);
  }
}

// One term of A[t, s] for this lane's column: r[t] k[s] exp(cum_exc[t] -
// cum[s]) with cum_exc[t] = cum[t - 1], each difference hi - hi + lo - lo.
template <int T, int S>
__device__ __forceinline__ float wkv_pair(const float (&xr)[WKV_C],
                                          const float (&xk)[WKV_C],
                                          const float (&ch)[WKV_C],
                                          const float (&cl)[WKV_C]) {
  return xr[T] * xk[S] * wkv_exp((ch[T - 1] - ch[S]) + (cl[T - 1] - cl[S]));
}

template <int E0, int... Q>
__device__ __forceinline__ void wkv_pairs(float* val,
                                          const float (&xr)[WKV_C],
                                          const float (&xk)[WKV_C],
                                          const float (&ch)[WKV_C],
                                          const float (&cl)[WKV_C],
                                          std::integer_sequence<int, Q...>) {
  ((val[Q] = wkv_pair<tri_t(E0 + Q), tri_s(E0 + Q)>(xr, xk, ch, cl)), ...);
}

// The column phase of pair group PG: this lane's terms of the group's
// strictly-lower entries of A and of the diagonal rows t = PG (mod NPG),
// summed over the warp's 32 columns into `apart` (row-major); and for those
// rows rq[t][i] = r[t][i] exp(cum_exc[t][i]) and kT[i][t] = k[t][i]
// exp(tot[i] - cum[t][i]).
template <int HD, int PG>
__device__ __forceinline__ void wkv_columns(
    const float (&xr)[WKV_C], const float (&xk)[WKV_C],
    const float (&ch)[WKV_C], const float (&cl)[WKV_C], float ui, int i,
    bool live, int lane, float* apart, float* rq, float* kT, float* et) {
  using S_ = WkvShape<HD>;
  constexpr int C = WKV_C, P = S_::P, PK = S_::PK, V = S_::V;
  constexpr int PPG = S_::PPG, NPG = S_::NPG;
  float val[V];
#pragma unroll
  for (int q = PPG; q < V; ++q) val[q] = 0.f;
  wkv_pairs<PG * PPG>(val, xr, xk, ch, cl,
                      std::make_integer_sequence<int, PPG>{});
  if constexpr (V == 16) {
    rt_reduce_scatter_step<8>(val, lane, 16);
    rt_reduce_scatter_step<4>(val, lane, 8);
    rt_reduce_scatter_step<2>(val, lane, 4);
    rt_reduce_scatter_step<1>(val, lane, 2);
    val[0] += __shfl_xor_sync(0xffffffffu, val[0], 1);
    if (!(lane & 1) && (lane >> 1) < PPG)
      apart[wkv_entry(PG * PPG + (lane >> 1))] = val[0];
  } else {
    rt_warp_reduce_scatter<V>(val, lane);
#pragma unroll
    for (int q = 0; q < V / 32; ++q) {
      const int e = lane * (V / 32) + q;
      if (e < PPG) apart[wkv_entry(PG * PPG + e)] = val[q];
    }
  }
  // the diagonal rows t = PG + d NPG: r[t] u k[t], summed over the warp's
  // columns by one reduce-scatter of the DPG values (lane l ends with
  // value l >> (5 - log2 DPG), summed over the lanes below that bit)
  constexpr int DPG = S_::DPG, LOW = 32 / DPG;
  float bonus[DPG];
#pragma unroll
  for (int d = 0; d < DPG; ++d)
    bonus[d] = xr[PG + d * NPG] * ui * xk[PG + d * NPG];
  if constexpr (DPG == 8) {
    rt_reduce_scatter_step<4>(bonus, lane, 16);
    rt_reduce_scatter_step<2>(bonus, lane, 8);
    rt_reduce_scatter_step<1>(bonus, lane, 4);
  } else if constexpr (DPG == 4) {
    rt_reduce_scatter_step<2>(bonus, lane, 16);
    rt_reduce_scatter_step<1>(bonus, lane, 8);
  } else {
    static_assert(DPG == 2, "two, four or eight diagonal rows a group");
    rt_reduce_scatter_step<1>(bonus, lane, 16);
  }
#pragma unroll
  for (int o = LOW / 2; o > 0; o >>= 1)
    bonus[0] += __shfl_xor_sync(0xffffffffu, bonus[0], o);
  if (lane % LOW == 0) {
    const int t = PG + lane / LOW * NPG;
    apart[t * (C + 1)] = bonus[0];
  }
  if (live) {
#pragma unroll
    for (int d = 0; d < DPG; ++d) {
      const int t = PG + d * NPG, te = t > 0 ? t - 1 : 0;
      rq[t * P + i] = t == 0 ? xr[0] : xr[t] * wkv_exp(ch[te] + cl[te]);
      kT[i * PK + t] =
          xk[t] * wkv_exp((ch[C - 1] - ch[t]) + (cl[C - 1] - cl[t]));
    }
  }
  if (PG == 0 && live) et[i] = wkv_exp(ch[C - 1] + cl[C - 1]);
}

template <int HD, int PG = 0>
__device__ __forceinline__ void wkv_columns_of(
    int pg, const float (&xr)[WKV_C], const float (&xk)[WKV_C],
    const float (&ch)[WKV_C], const float (&cl)[WKV_C], float ui, int i,
    bool live, int lane, float* apart, float* rq, float* kT, float* et) {
  if constexpr (PG < WkvShape<HD>::NPG) {
    if (pg == PG)
      wkv_columns<HD, PG>(xr, xk, ch, cl, ui, i, live, lane, apart, rq, kT,
                          et);
    else
      wkv_columns_of<HD, PG + 1>(pg, xr, xk, ch, cl, ui, i, live, lane, apart,
                                 rq, kT, et);
  }
}

template <int HD>
__global__ void __launch_bounds__(WKV_CHUNK_NT, HD <= 64 ? 2 : 1)
wkv6_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const float* __restrict__ logw,
                  const float* __restrict__ u, const float* s0,
                  float* __restrict__ o, float* sT, int t_len, int h,
                  long long sb, long long st, long long sh, int vec,
                  const __grid_constant__ WkvMaps maps) {
  using S_ = WkvShape<HD>;
  constexpr int C = WKV_C, NT = WKV_CHUNK_NT, CW = S_::CW, P = S_::P;
  constexpr int PK = S_::PK, NW = NT / 32, NIB = S_::NIB, AE = S_::AE;
  constexpr int G = NT / CW;                    // column groups of threads
  constexpr int RG = HD / G > 0 ? HD / G : 1;   // state rows a group holds
  constexpr int GA = HD / RG;                   // groups that hold rows
  extern __shared__ __align__(128) float wkv_smem[];
  float* stage = wkv_smem;                      // 2 x [r | k | logw | v]
  float* rq = stage + 2 * S_::STAGE;            // r * exp(cum_exc)
  float* kT = rq + C * P;                       // (k * exp(tot - cum))^T
  float* apart = kT + HD * PK;                  // A, per i block
  float* part = apart + NIB * AE;               // o partials of each warp
  float* et = part + NW * C * CW;               // exp(tot)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = tid % CW, g = tid / CW;
  const int ib = warp % NIB, pg = warp / NIB;
  const int bh = blockIdx.x, bi = bh / h, hi = bh % h, j0 = blockIdx.y * CW;
  const int n_chunks = (t_len + C - 1) / C;
  const size_t s_off = static_cast<size_t>(bh) * HD * HD + j0;
  const int i = ib * 32 + lane;                 // this lane's column
  const bool live = i < HD;
  const long long in = bi * sb + hi * sh;
  const float ui = live ? u[hi * HD + i] : 0.f;
  __shared__ uint64_t bar[2];                   // one for each stage
  // Stage the rows of chunk c (r, k, logw, and the CTA's columns of v);
  // rows at or past T read as zero.  With 16-byte aligned rows one thread
  // issues four bulk tensor copies; otherwise every thread copies, and the
  // barrier after it orders them.
  auto issue = [&](int c) {
    float* sg = stage + (c & 1) * S_::STAGE;
    const long long row0 = in + static_cast<long long>(c) * C * st;
    const int valid = min(t_len - c * C, C);
    if (vec) {
      if (tid == 0) {
        const int tc = c * C;
        const int c1 = maps.pos_t == 1 ? tc : maps.pos_h == 1 ? hi : bi;
        const int c2 = maps.pos_t == 2 ? tc : maps.pos_h == 2 ? hi : bi;
        const int c3 = maps.pos_t == 3 ? tc : maps.pos_h == 3 ? hi : bi;
        uint64_t* b = &bar[c & 1];
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        bar_expect(b, C * (3 * HD + CW) * 4);    // rows past T come as 0
        tensor_copy(sg, &maps.r, 0, c1, c2, c3, b);
        tensor_copy(sg + C * HD, &maps.k, 0, c1, c2, c3, b);
        tensor_copy(sg + 2 * C * HD, &maps.w, 0, c1, c2, c3, b);
        tensor_copy(sg + 3 * C * HD, &maps.v, j0, c1, c2, c3, b);
      }
    } else {
      for (int x = tid; x < valid * (3 * HD + CW); x += NT) {
        const int t = x / (3 * HD + CW), e = x % (3 * HD + CW);
        const long long g_off = row0 + t * st;
        if (e < 3 * HD)
          sg[(e / HD * C + t) * HD + e % HD] =
              (e < HD ? r : e < 2 * HD ? k : logw)[g_off + e % HD];
        else
          sg[3 * C * HD + t * CW + e - 3 * HD] = v[g_off + j0 + e - 3 * HD];
      }
    }
  };

  if (tid == 0) {
    bar_init(&bar[0]);
    bar_init(&bar[1]);
  }
  // this thread's rows of the state slice, in registers for the whole call
  float sreg[RG];
#pragma unroll
  for (int rr = 0; rr < RG; ++rr)
    sreg[rr] = g < GA ? s0[s_off + (g * RG + rr) * HD + j] : 0.f;
  // A's upper triangle stays zero; the column phase writes the rest
  for (int x = tid; x < NIB * AE; x += NT)
    if (x % C > (x % AE) / C) apart[x] = 0.f;
  __syncthreads();                              // the barriers, initialised
  issue(0);

  for (int c = 0; c < n_chunks; ++c) {
    const int valid = min(t_len - c * C, C);
    // every thread has left chunk c - 1 (the barrier before its output),
    // so its stage takes chunk c + 1
    if (c + 1 < n_chunks) issue(c + 1);
    if (vec) {
      bar_wait(&bar[c & 1], (c >> 1) & 1);
    } else {
      __syncthreads();
    }
    const float* sg = stage + (c & 1) * S_::STAGE;
    float vc[C];
#pragma unroll
    for (int s = 0; s < C; ++s)
      vc[s] = s < valid ? sg[3 * C * HD + s * CW + j] : 0.f;

    {  // the column phase: the compensated prefix sum of logw in registers
      float xr[C], xk[C], ch[C], cl[C];
#pragma unroll
      for (int t = 0; t < C; ++t) {
        const bool in_t = live && t < valid;
        xr[t] = in_t ? sg[t * HD + i] : 0.f;
        xk[t] = in_t ? sg[(C + t) * HD + i] : 0.f;
        ch[t] = in_t ? sg[(2 * C + t) * HD + i] : 0.f;
      }
      float hs = 0.f, lo = 0.f;
#pragma unroll
      for (int t = 0; t < C; ++t) {
        const float x = ch[t], sum = hs + x, bp = sum - hs;
        lo += (hs - (sum - bp)) + (x - bp);
        hs = sum;
        ch[t] = hs;
        cl[t] = lo;
      }
      wkv_columns_of<HD>(pg, xr, xk, ch, cl, ui, i, live, lane,
                         apart + ib * AE, rq, kT, et);
    }
    __syncthreads();

    // o partials: group g takes column s = g of A V and its state rows
    float po[C];
#pragma unroll
    for (int t = 0; t < C; ++t) po[t] = 0.f;
    if (g < C) {
      float vg = 0.f;
#pragma unroll
      for (int s = 0; s < C; ++s) vg = s == g ? vc[s] : vg;
#pragma unroll
      for (int t = 0; t < C; ++t) {
        float a = 0.f;
#pragma unroll
        for (int b = 0; b < NIB; ++b) a += apart[b * AE + t * C + g];
        po[t] = a * vg;
      }
    }
    if (g < GA) {
#pragma unroll
      for (int rr = 0; rr < RG; rr += (RG % 4 == 0 ? 4 : 1)) {
        const int i = g * RG + rr;
        if constexpr (RG % 4 == 0) {
#pragma unroll
          for (int t = 0; t < C; ++t) {
            const float4 q4 = lds4(rq + t * P + i);
            po[t] = fmaf(q4.x, sreg[rr], po[t]);
            po[t] = fmaf(q4.y, sreg[rr + 1], po[t]);
            po[t] = fmaf(q4.z, sreg[rr + 2], po[t]);
            po[t] = fmaf(q4.w, sreg[rr + 3], po[t]);
          }
        } else {
#pragma unroll
          for (int t = 0; t < C; ++t)
            po[t] = fmaf(rq[t * P + i], sreg[rr], po[t]);
        }
      }
      // then the state rows: S <- exp(tot) S + kT V
#pragma unroll
      for (int rr = 0; rr < RG; ++rr) {
        const int i = g * RG + rr;
        float a = et[i] * sreg[rr];
#pragma unroll
        for (int s = 0; s < C; s += 4) {
          const float4 k4 = lds4(kT + i * PK + s);
          a = fmaf(k4.x, vc[s], a);
          a = fmaf(k4.y, vc[s + 1], a);
          a = fmaf(k4.z, vc[s + 2], a);
          a = fmaf(k4.w, vc[s + 3], a);
        }
        sreg[rr] = a;
      }
    }
#pragma unroll
    for (int t = 0; t < C; ++t) {
#pragma unroll
      for (int off = 16; off >= CW; off >>= 1)
        po[t] += __shfl_xor_sync(0xffffffffu, po[t], off);
    }
    if (lane < CW) {
#pragma unroll
      for (int t = 0; t < C; ++t) part[(warp * C + t) * CW + j] = po[t];
    }
    __syncthreads();
    // the next chunk's column phase writes only what this step has read
    for (int x = tid; x < valid * CW; x += NT) {
      const int t = x / CW, jj = x % CW;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) sum += part[(w * C + t) * CW + jj];
      o[(static_cast<long long>(bi) * t_len + c * C + t) * h * HD +
        static_cast<long long>(hi) * HD + j0 + jj] = sum;
    }
  }
#pragma unroll
  for (int rr = 0; rr < RG; ++rr)
    if (g < GA) sT[s_off + (g * RG + rr) * HD + j] = sreg[rr];
}

template <int HD>
static cudaError_t wkv6_run(const float* r, const float* k, const float* v,
                            const float* logw, const float* u,
                            const float* s0, float* o, float* sT, int b,
                            int t, int h, long long sb, long long st,
                            long long sh, int vec, const WkvMaps& maps,
                            cudaStream_t s) {
  if (t == 1) {
    wkv6_step_kernel<HD><<<b * h, HD < 32 ? 32 : HD, 0, s>>>(
        r, k, v, logw, u, s0, o, sT, h, sb, sh);
    return cudaGetLastError();
  }
  const dim3 grid(b * h, HD / WkvShape<HD>::CW);
  constexpr int bytes = WkvShape<HD>::BYTES;
  static bool configured = false;     // once per process, not per call
  if (bytes > 48 * 1024 && !configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_chunk_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  wkv6_chunk_kernel<HD><<<grid, WKV_CHUNK_NT, bytes, s>>>(
      r, k, v, logw, u, s0, o, sT, t, h, sb, st, sh, vec, maps);
  return cudaGetLastError();
}

// Encode the four tensor maps; false where libcuda has no encoder or
// refuses the layout (the kernel then copies with plain loads).
static bool wkv_maps(WkvMaps* m, const void* r, const void* k, const void* v,
                     const void* logw, int hd, int cw, int b, int t, int h,
                     long long sb, long long st, long long sh) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                         12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  if (encode == nullptr) return false;
  // dims 1..3: T, H, B ordered by stride
  const long long stride[3] = {st, sh, sb};
  const int size[3] = {t, h, b};
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && stride[order[j]] < stride[order[j - 1]]; --j) {
      const int x = order[j];
      order[j] = order[j - 1];
      order[j - 1] = x;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {0, 1, 1, 1}, unit[4] = {1, 1, 1, 1};
  int* pos[3] = {&m->pos_t, &m->pos_h, &m->pos_b};
  for (int d = 0; d < 3; ++d) {
    dims[d + 1] = static_cast<cuuint64_t>(size[order[d]]);
    strides[d] = static_cast<cuuint64_t>(stride[order[d]]) * 4;
    if (order[d] == 0) box[d + 1] = WKV_C;
    *pos[order[d]] = d + 1;
  }
  const void* base[4] = {r, k, logw, v};
  CUtensorMap* map[4] = {&m->r, &m->k, &m->w, &m->v};
  for (int a = 0; a < 4; ++a) {
    box[0] = static_cast<cuuint32_t>(a < 3 ? hd : cw);
    if (encode(map[a], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
               const_cast<void*>(base[a]), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return false;
  }
  return true;
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
  const int cw = hd < 16 ? hd : 16;
  WkvMaps maps = {};
  const bool vec = rt_aligned(r) && rt_aligned(k) && rt_aligned(v) &&
                   rt_aligned(logw) && rt_aligned(s0) && rt_aligned(sT) &&
                   sb % 4 == 0 && st % 4 == 0 && sh % 4 == 0 && t > 1 &&
                   wkv_maps(&maps, r, k, v, logw, hd, cw, b, t, h, sb, st,
                            sh);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* rp = static_cast<const float*>(r);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* wp = static_cast<const float*>(logw);
  const auto* up = static_cast<const float*>(u);
  const auto* s0p = static_cast<const float*>(s0);
  auto* op = static_cast<float*>(o);
  auto* sTp = static_cast<float*>(sT);
  cudaError_t e;
#define WKV6_CASE(HD)                                                     \
  case HD:                                                                \
    e = wkv6_run<HD>(rp, kp, vp, wp, up, s0p, op, sTp, b, t, h, sb, st,   \
                     sh, vec, maps, s);                                   \
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
  return static_cast<int>(e);
}
