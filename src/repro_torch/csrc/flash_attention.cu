// Tiled online-softmax attention (prefill).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
//   (_fa_kernel).
// Computes, per (b, query head h, query row i) with position
// q_offset + i: softmax over key positions of (q . k) * scale, optionally
// soft-capped (cap * tanh(s / cap)), masked to NEG_INF where causal
// (key > query), outside the window (query - key >= window) or at or past
// kv_len, times V; KV head h // g (GQA by index, K/V never expanded).  Keys
// at or past T get zero weight; a row with no valid key softmaxes NEG_INF
// uniformly over all T keys, as the reference does.
//
// Bound on Hopper: at the main path's prefill (S = T = 16 tokens, 15/5
// heads, head_dim 64) bytes, and far below one launch: what is left above
// the empty-kernel floor is latency, a chain of dependent memory round
// trips and arithmetic.  For long prompts the bound becomes the tensor
// cores' flops.
//
// bf16 (what serving runs): flash_attention_bf16_kernel.
//  * GQA packing: one CTA per (b, KV head, tile of 64 query rows), where a
//    query row is a (position, head) pair of that KV head's g query heads,
//    flattened position-major.  Each K/V tile is loaded once per group, not
//    g times; at the main path's shape one CTA per KV head holds all 48 rows
//    (3 of its 4 warps busy).  Each row masks with its own position.
//  * Tensor cores: S = Q K^T and O += P V with mma.sync m16n8k16 (bf16 in,
//    f32 accumulate), fragments from shared memory by ldmatrix (.trans for
//    V).  Each warp owns 16 rows; the online softmax runs in f32 on the
//    accumulator fragments with quad shuffles; P is rounded to bf16 for the
//    P V product, as FlashAttention does.  head_dim is padded with zeros in
//    shared memory to the kernel's HD (16, 32, 64 or 128).
//  * A small loop body: a warp walks a K/V tile 32 keys at a time in a
//    rolled loop (scores, mask, softmax and P V for those keys), with no
//    per-element guards outside boundary groups, so that the body stays in
//    the instruction cache.  Unrolled over a whole 64-key tile with guards,
//    the kernel waited on instruction fetch: its time grew by ~6 us per
//    tile whatever the tile held.
//  * Asynchronous copies: the Q tile and the first K/V tile are issued as
//    16-byte cp.async.cg (zero-filled past hd and past T) before the first
//    wait, so their HBM latencies overlap; K/V tiles of 64 keys go through a
//    two-stage ring, tile j+1 issued before tile j is computed.  Shared rows
//    are padded by 16 bytes, so ldmatrix reads 8 rows in 8 distinct bank
//    groups.  A row start that is not 16-byte aligned, or hd % 8 != 0, takes
//    scalar loads in the same kernel.  The output goes through shared memory
//    and leaves as 16-byte stores where aligned.
//  * Masking: key tiles outside every row's causal and window range are
//    skipped, and so are the 32-key groups past the last needed key; only
//    boundary groups are masked per element.  If some row of the CTA has no
//    valid key, every tile is visited.
//  * Not here: wgmma wants 64-row tiles per warpgroup (a prefill CTA holds
//    16-48 rows at the main path's shapes), and a TMA tensor map would be
//    encoded on the host per call (the cache pointers move).
// f32: flash_attention_f32_kernel, full f32 on the CUDA cores (TF32 would
// break the 2e-5 kernel bound): one CTA per (b, q head, 16-row tile), 32-key
// f32 tiles in shared memory, a lane per key for the scores and a 32-wide
// head_dim stripe for the output.  Both read and write through strides.
#include "common.cuh"

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

constexpr int FA_MAX_HD = 128;

// Keys [lo_r, hi_r) are the valid keys of query row i (position
// q_offset + i).  Both ends are nondecreasing in i and hi_r - lo_r is
// concave, so the rows without a valid key lie at the ends of any range of
// rows, and a range is described by its first and last row.
__device__ __forceinline__ void fa_row_keys(const FlashParams& p, int i,
                                            int& lo_r, int& hi_r) {
  const int qpos = p.q_offset + i;
  const int kvl = min(p.kv_len, p.t_len);
  hi_r = p.causal ? min(qpos + 1, kvl) : kvl;
  lo_r = p.window ? max(0, qpos - p.window + 1) : 0;
}

// Keys [lo, hi) hold every valid key of query rows first..last, or [0, T)
// if one of them has none, so that it softmaxes NEG_INF uniformly; keys in
// [full_lo, full_hi) are valid for every one of those rows.
__device__ __forceinline__ void fa_key_range(const FlashParams& p, int first,
                                             int last, int& lo, int& hi,
                                             int& full_lo, int& full_hi) {
  int lo_first, hi_first;
  fa_row_keys(p, first, lo_first, hi_first);
  fa_row_keys(p, last, full_lo, hi);
  lo = lo_first;
  full_hi = hi_first;
  if (lo_first >= hi_first || full_lo >= hi) {
    lo = 0;
    hi = p.t_len;
  }
}

// ------------------------------------------------------------------ f32
constexpr int FA_WARPS = 4;
constexpr int FA_ROWS = 4;                      // query rows per warp
constexpr int FA_BQ = FA_WARPS * FA_ROWS;       // query rows per CTA
constexpr int FA_BK = 32;                       // keys per tile, one per lane
constexpr int FA_MAX_J = FA_MAX_HD / 32;

__global__ void __launch_bounds__(FA_WARPS * 32)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, FlashParams p,
                           FlashStrides st) {
  __shared__ float ks[FA_BK][FA_MAX_HD + 1];
  __shared__ float vs[FA_BK][FA_MAX_HD];
  __shared__ float qs[FA_BQ][FA_MAX_HD];

  const int q0 = blockIdx.x * FA_BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (p.hq / p.hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd = p.hd;
  const int kvl = min(p.kv_len, p.t_len);

  const float* qb = q + b * st.q_b + h * st.q_h;
  for (int idx = threadIdx.x; idx < FA_BQ * hd; idx += blockDim.x) {
    const int r = idx / hd, dd = idx % hd;
    qs[r][dd] = q0 + r < p.s_len ? qb[(q0 + r) * st.q_s + dd] : 0.f;
  }

  int lo, hi, full_lo, full_hi;
  fa_key_range(p, q0, min(q0 + FA_BQ, p.s_len) - 1, lo, hi, full_lo,
               full_hi);

  float m[FA_ROWS], l[FA_ROWS], acc[FA_ROWS][FA_MAX_J];
#pragma unroll
  for (int rr = 0; rr < FA_ROWS; ++rr) {
    m[rr] = RT_NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < FA_MAX_J; ++j) acc[rr][j] = 0.f;
  }

  const float* kb = k + b * st.k_b + kh * st.k_h;
  const float* vb = v + b * st.v_b + kh * st.v_h;
  for (int t0 = (lo / FA_BK) * FA_BK; t0 < hi; t0 += FA_BK) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int idx = threadIdx.x; idx < FA_BK * hd; idx += blockDim.x) {
      const int j = idx / hd, dd = idx % hd;
      const bool in = t0 + j < p.t_len;
      ks[j][dd] = in ? kb[(t0 + j) * st.k_t + dd] : 0.f;
      vs[j][dd] = in ? vb[(t0 + j) * st.v_t + dd] : 0.f;
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

  float* ob = out + b * st.o_b + h * st.o_h;
#pragma unroll
  for (int rr = 0; rr < FA_ROWS; ++rr) {
    const int r = warp * FA_ROWS + rr;
    if (q0 + r >= p.s_len) break;
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int j = 0; j < FA_MAX_J; ++j) {
      const int dd = lane + 32 * j;
      if (dd < hd) ob[(q0 + r) * st.o_s + dd] = acc[rr][j] * inv;
    }
  }
}

// ------------------------------------------------------------------ bf16
constexpr int FB_WARPS = 4;
constexpr int FB_BQ = 16 * FB_WARPS;   // query rows ((position, head) pairs)
constexpr int FB_BK = 64;              // keys per tile
constexpr int FB_GK = 32;              // keys per step of the inner loop
constexpr int FB_PAD = 8;              // elements of padding per shared row

template <int HD>
struct FbShape {
  static constexpr int LD = HD + FB_PAD;   // shared row stride, elements
  static constexpr int CH = HD / 8;        // 16-byte chunks per row
  static constexpr int BYTES = (FB_BQ + 4 * FB_BK) * LD * 2;  // Q + 2 x K, V
};

// Copies ROWS rows of hd bf16 values into a [ROWS][LD] shared tile, zero
// past hd and in rows whose source is null.  Each thread copies one 16-byte
// chunk column of every (128 / CH)-th row.  vec: 16-byte cp.async (every
// row start 16-byte aligned and hd % 8 == 0), else scalar loads.  `valid`
// is any 16-byte aligned global address, the source of a zero fill.
template <int HD, int ROWS, typename RowPtr>
__device__ __forceinline__ void fb_load(uint16_t* tile, RowPtr row_ptr,
                                        int hd, bool vec,
                                        const uint16_t* valid) {
  constexpr int CH = FbShape<HD>::CH, LD = FbShape<HD>::LD;
  constexpr int STEP = FB_WARPS * 32 / CH;
  const int col = (threadIdx.x % CH) * 8;
#pragma unroll
  for (int row = threadIdx.x / CH; row < ROWS; row += STEP) {
    const uint16_t* src = row_ptr(row);
    uint16_t* dst = tile + row * LD + col;
    if (vec) {
      const bool in = src != nullptr && col < hd;
      cp_async16(smem_addr(dst), in ? src + col : valid, in);
    } else {
      uint16_t e[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        e[i] = src != nullptr && col + i < hd ? src[col + i] : 0;
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(e[0] | (uint32_t(e[1]) << 16), e[2] | (uint32_t(e[3]) << 16),
                     e[4] | (uint32_t(e[5]) << 16), e[6] | (uint32_t(e[7]) << 16));
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(FB_WARPS * 32)
flash_attention_bf16_kernel(const uint16_t* __restrict__ q,
                            const uint16_t* __restrict__ k,
                            const uint16_t* __restrict__ v,
                            uint16_t* __restrict__ out, FlashParams p,
                            FlashStrides st, int vec_in, int vec_out) {
  constexpr int LD = FbShape<HD>::LD, CH = FbShape<HD>::CH;
  constexpr int KSTEPS = HD / 16;      // 16-wide steps over head_dim
  constexpr int ONB = HD / 8;          // 8-column blocks of the output
  constexpr int NBLK = FB_GK / 8;      // 8-key blocks of a score group
  extern __shared__ __align__(16) unsigned char fb_smem[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(fb_smem);
  uint16_t* ks = qs + FB_BQ * LD;      // stage s at ks + s * FB_BK * LD
  uint16_t* vs = ks + 2 * FB_BK * LD;

  const int g = p.hq / p.hkv;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int n_pairs = p.s_len * g;
  const int m0 = blockIdx.x * FB_BQ;
  const int m_end = min(m0 + FB_BQ, n_pairs);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hd = p.hd;
  const int kvl = min(p.kv_len, p.t_len);

  int lo, hi, full_lo, full_hi;
  fa_key_range(p, m0 / g, (m_end - 1) / g, lo, hi, full_lo, full_hi);
  const int t_first = (lo / FB_BK) * FB_BK;
  const int n_tiles = (hi - t_first + FB_BK - 1) / FB_BK;

  const uint16_t* qb = q + b * st.q_b;
  const uint16_t* kb = k + b * st.k_b + kh * st.k_h;
  const uint16_t* vb = v + b * st.v_b + kh * st.v_h;
  // pair m: query row m / g of head kh * g + m % g
  fb_load<HD, FB_BQ>(
      qs,
      [&](int row) -> const uint16_t* {
        const int m = m0 + row;
        return m < m_end ? qb + (kh * g + m % g) * st.q_h + (m / g) * st.q_s
                         : nullptr;
      },
      hd, vec_in, q);
  auto load_kv = [&](int tile, int stage) {
    const int t0 = t_first + tile * FB_BK;
    fb_load<HD, FB_BK>(
        ks + stage * FB_BK * LD,
        [&](int row) -> const uint16_t* {
          return t0 + row < p.t_len ? kb + (t0 + row) * st.k_t : nullptr;
        },
        hd, vec_in, k);
    fb_load<HD, FB_BK>(
        vs + stage * FB_BK * LD,
        [&](int row) -> const uint16_t* {
          return t0 + row < p.t_len ? vb + (t0 + row) * st.v_t : nullptr;
        },
        hd, vec_in, v);
  };
  load_kv(0, 0);
  cp_async_commit();

  // this lane's rows of the warp's 16: pair rows r0 and r0 + 8
  const int r0 = warp * 16 + (lane >> 2);
  const int qpos[2] = {p.q_offset + (m0 + r0) / g,
                       p.q_offset + (m0 + r0 + 8) / g};
  const bool warp_live = m0 + warp * 16 < m_end;
  // this lane's ldmatrix row offsets (bytes) into a K and a V tile
  const uint32_t k_off =
      ((lane & 7) + (lane >> 4) * 8) * LD * 2 + ((lane >> 3) & 1) * 16;
  const uint32_t v_off =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * LD * 2 + (lane >> 4) * 16;

  uint32_t qf[KSTEPS][4];
  float o[ONB][4];
#pragma unroll
  for (int j = 0; j < ONB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {RT_NEG_INF, RT_NEG_INF}, l_run[2] = {0.f, 0.f};

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) {
      load_kv(tile + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_live) {
      if (tile == 0) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          ldsm_x4(smem_addr(qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8),
                  qf[kk]);
      }
      const int t0 = t_first + tile * FB_BK;
      const uint32_t kt = smem_addr(ks + stage * FB_BK * LD) + k_off;
      const uint32_t vt = smem_addr(vs + stage * FB_BK * LD) + v_off;
      // FB_GK-key groups up to the last key any row needs, one at a time:
      // the loop body stays small enough for the instruction cache
      const int n_grp =
          min(FB_BK / FB_GK, (min(hi, p.t_len) - t0 + FB_GK - 1) / FB_GK);
#pragma unroll 1
      for (int grp = 0; grp < n_grp; ++grp) {
        const int k0 = t0 + grp * FB_GK;
        float s[NBLK][4] = {};
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
          for (int jj = 0; jj < NBLK / 2; ++jj) {
            uint32_t bk[4];
            ldsm_x4(kt + (grp * FB_GK + jj * 16) * LD * 2 + kk * 32, bk);
            mma_bf16(s[2 * jj], qf[kk], bk[0], bk[1]);
            mma_bf16(s[2 * jj + 1], qf[kk], bk[2], bk[3]);
          }
        }
        // element (n, c): key k0 + 8 n + 2 (lane & 3) + (c & 1), of row
        // r0 + 8 (c >> 1)
#pragma unroll
        for (int n = 0; n < NBLK; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[n][c] *= p.scale;
        if (p.softcap != 0.f) {
#pragma unroll
          for (int n = 0; n < NBLK; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              s[n][c] = p.softcap * tanhf(__fdividef(s[n][c], p.softcap));
        }
        if (!(k0 >= full_lo && k0 + FB_GK <= full_hi &&
              k0 + FB_GK <= p.t_len)) {
          // a boundary group: mask each element with its row's position
#pragma unroll
          for (int n = 0; n < NBLK; ++n) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int kpos = k0 + n * 8 + 2 * (lane & 3) + (c & 1);
              const int qp = qpos[c >> 1];
              bool masked = kpos >= kvl;
              if (p.causal) masked |= kpos > qp;
              if (p.window) masked |= qp - kpos >= p.window;
              if (masked) s[n][c] = RT_NEG_INF;
              if (kpos >= p.t_len) s[n][c] = -INFINITY;   // not a key at all
            }
          }
        }
        // online softmax of the group
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int n = 0; n < NBLK; ++n)
            mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_run[r], mx);
          alpha[r] = __expf(m_run[r] - m_new);
          m_run[r] = m_new;
          l_run[r] *= alpha[r];
        }
#pragma unroll
        for (int n = 0; n < NBLK; ++n) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[n][c] = __expf(s[n][c] - m_run[c >> 1]);
            l_run[c >> 1] += s[n][c];   // this lane's part; summed over the quad
          }
        }
#pragma unroll
        for (int j = 0; j < ONB; ++j) {
          o[j][0] *= alpha[0];
          o[j][1] *= alpha[0];
          o[j][2] *= alpha[1];
          o[j][3] *= alpha[1];
        }
        // O += P V, P rounded to bf16 as the A operand
#pragma unroll
        for (int jj = 0; jj < NBLK / 2; ++jj) {
          const uint32_t a[4] = {pack_bf16(s[2 * jj][0], s[2 * jj][1]),
                                 pack_bf16(s[2 * jj][2], s[2 * jj][3]),
                                 pack_bf16(s[2 * jj + 1][0], s[2 * jj + 1][1]),
                                 pack_bf16(s[2 * jj + 1][2], s[2 * jj + 1][3])};
#pragma unroll
          for (int j = 0; j < KSTEPS; ++j) {
            uint32_t bv[4];
            ldsm_x4_trans(vt + (grp * FB_GK + jj * 16) * LD * 2 + j * 32, bv);
            mma_bf16(o[2 * j], a, bv[0], bv[1]);
            mma_bf16(o[2 * j + 1], a, bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();   // the stage is consumed before it is refilled
  }

  // normalise into the Q tile's shared rows, then store 16 bytes a thread
  if (warp_live) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l_run[r] = 1.f / fmaxf(l, 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < ONB; ++j) {
      uint16_t* row0 = qs + r0 * LD + j * 8 + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(row0) =
          pack_bf16(o[j][0] * l_run[0], o[j][1] * l_run[0]);
      *reinterpret_cast<uint32_t*>(row0 + 8 * LD) =
          pack_bf16(o[j][2] * l_run[1], o[j][3] * l_run[1]);
    }
  }
  __syncthreads();
  uint16_t* obase = out + b * st.o_b;
  const int col = (threadIdx.x % CH) * 8;
  for (int row = threadIdx.x / CH; row < FB_BQ; row += FB_WARPS * 32 / CH) {
    const int m = m0 + row;
    if (m >= m_end || col >= hd) continue;
    uint16_t* dst = obase + (kh * g + m % g) * st.o_h + (m / g) * st.o_s + col;
    const uint16_t* src = qs + row * LD + col;
    if (vec_out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int i = 0; i < 8 && col + i < hd; ++i) dst[i] = src[i];
    }
  }
}

template <int HD>
static cudaError_t flash_bf16_launch(const void* q, const void* k,
                                     const void* v, void* out, int b,
                                     const FlashParams& p,
                                     const FlashStrides& st, int vec_in,
                                     int vec_out, cudaStream_t s) {
  constexpr int bytes = FbShape<HD>::BYTES;
  static bool configured = false;     // once per process, not per call
  if (bytes > 48 * 1024 && !configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_bf16_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((p.s_len * (p.hq / p.hkv) + FB_BQ - 1) / FB_BQ, p.hkv, b);
  flash_attention_bf16_kernel<HD><<<grid, FB_WARPS * 32, bytes, s>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), p, st,
      vec_in, vec_out);
  return cudaGetLastError();
}

static bool aligned16(const void* ptr, long long s0, long long s1,
                      long long s2, int hd) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s0 % 8 == 0 &&
         s1 % 8 == 0 && s2 % 8 == 0 && hd % 8 == 0;
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
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == RT_F32) {
    const dim3 grid((s_len + FA_BQ - 1) / FA_BQ, hq, b);
    flash_attention_f32_kernel<<<grid, FA_WARPS * 32, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), p, st);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != RT_BF16) return static_cast<int>(cudaErrorInvalidValue);
  const int vec_in = aligned16(q, q_b, q_h, q_s, hd) &&
                     aligned16(k, k_b, k_h, k_t, hd) &&
                     aligned16(v, v_b, v_h, v_t, hd);
  const int vec_out = aligned16(out, o_b, o_h, o_s, hd);
  cudaError_t e;
  if (hd <= 16)
    e = flash_bf16_launch<16>(q, k, v, out, b, p, st, vec_in, vec_out, s);
  else if (hd <= 32)
    e = flash_bf16_launch<32>(q, k, v, out, b, p, st, vec_in, vec_out, s);
  else if (hd <= 64)
    e = flash_bf16_launch<64>(q, k, v, out, b, p, st, vec_in, vec_out, s);
  else
    e = flash_bf16_launch<128>(q, k, v, out, b, p, st, vec_in, vec_out, s);
  return static_cast<int>(e);
}
