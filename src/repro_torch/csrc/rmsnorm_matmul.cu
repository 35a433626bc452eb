// Fused RMSNorm + projection matmul.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fused/rmsnorm_matmul/kernel.py::rmsnorm_matmul_kernel
//   (_rms_mm_kernel).
// Computes normed = (x * rsqrt(mean(x^2) + eps) * w) rounded to x's dtype,
// then proj = normed @ W with f32 accumulation, stored in W's dtype.
// Returns both, as the reference does (the normed rows feed wk and wv).
//
// Bound on Hopper: bytes.  At decode N <= max_batch rows, so the product is
// a GEMV: 2*N*D*F flops against D*F weight elements, about N flops per byte
// in bf16, two orders of magnitude under the tensor-core balance point.  W
// has to stream through once (1.84 MB at SmolLM's 960 x 960, 0.56 us at
// 3.35 TB/s); x and the outputs are a few KB.  So the design keeps the whole
// of W in flight across the card in one wave, waits for one HBM round trip,
// and keeps the work per row small:
//  * Narrow column tiles, whole K per CTA: grid (F / 8, N / 16), 256
//    threads.  At SmolLM's F = 960 that is 120 CTAs on 132 SMs.  A CTA
//    owns 8 output columns and every row of K, so no
//    partial sum leaves the CTA and the call stays one launch with no
//    workspace.  (Splitting K across CTAs instead needs a combine through
//    global memory and a second dependent round trip.)  Each 16-byte load is
//    half of a 32-byte sector; the neighbouring CTA reads the other half at
//    the same moment, so HBM moves each sector once and L2 serves the rest.
//  * 16-byte loads of W, a 1024-row chunk at a time (wider D loops over
//    chunks), all issued before anything waits on them; the loads of x the
//    product needs go out with them, and the row statistics (every CTA
//    computes them again from x, which is small and L2-resident) meet one
//    barrier while those loads are in flight.
//  * bf16 (the serving path; D and F multiples of 8, aligned): the tensor
//    cores.  At most 16 rows x 8 columns is one mma.sync m16n8k16 tile per
//    16 rows of K (rows past N are zero), so the per-row work is a few
//    instructions; with FMAs and shuffles the time grew with every row of
//    N, by more than the whole decode call's memory time.  See
//    rmsnorm_matmul_mma_kernel.
//  * f32, and bf16 with ragged or unaligned operands: FMAs.  Thread t holds
//    rows t + 256 i (i < 4) of the chunk, 8 columns a row (one uint4 in
//    bf16, two in f32; element loads where F % 8 != 0 or W is unaligned,
//    the VEC = false instance), and x at those k for the CTA's rows.  Rows
//    go in two groups of 8 over the held W tile, so W is read once for
//    every N up to 16: a group's products sit in 64 registers and meet the
//    other threads' by a warp reduce-scatter (62 shuffles) and one exchange
//    of the 8 warps in shared memory.
// More than 16 rows take further row blocks (grid.y), each reading W
// again, from L2.  CTAs of column tile 0 (the FMA kernel) or of tiles 0-7
// (the mma kernel, one K slice each) write `normed`.
#include "common.cuh"

constexpr int RM_THREADS = 256;
constexpr int RM_WARPS = RM_THREADS / 32;
constexpr int RM_COLS = 8;                  // output columns per CTA
constexpr int RM_ROWS = 16;                 // rows per CTA (grid.y: more)
constexpr int RM_RPT = 4;                   // W rows a thread holds a chunk
constexpr int RM_KC = RM_THREADS * RM_RPT;  // W rows per chunk
constexpr int RM_MAX_GRID_Y = 65535;

// x: (n, d), w: (d,), wp: (d, f), proj: (n, f), normed: (n, d), contiguous
// and of one dtype T.  VEC: f % 8 == 0 and wp 16-byte aligned; vec_x: d a
// multiple of the 16-byte vector and x aligned.
template <typename T, bool VEC>
__global__ void __launch_bounds__(RM_THREADS)
rmsnorm_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ wp, T* __restrict__ proj,
                      T* __restrict__ normed, int n, int d, int f, float eps,
                      int vec_x) {
  using V = RtVec16<T>;
  constexpr int R = 8;                        // rows per group
  constexpr int NG = RM_ROWS / R;             // row groups per CTA
  constexpr int SR = RM_ROWS / RM_WARPS;      // rows a warp sums
  constexpr int NV = RM_COLS / V::N;          // 16-byte vectors a W row tile
  constexpr int NR = R * RM_COLS;             // products a thread holds
  __shared__ float inv_s[RM_ROWS];
  __shared__ float red[RM_WARPS][NR];
  __shared__ float oacc[RM_ROWS * RM_COLS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * RM_COLS;
  const int row0 = blockIdx.y * RM_ROWS;
  const int rows = min(RM_ROWS, n - row0);
  const bool write_normed = blockIdx.x == 0;
  const int n_chunks = (d + RM_KC - 1) / RM_KC;

  // a chunk's operands at the thread's k, raw, so no use of them waits
  // before the statistics
  uint4 wv[RM_RPT][NV];                       // VEC: 16-byte W vectors
  T ws[RM_RPT][VEC ? 1 : RM_COLS];            // !VEC: W elements
  T nw[RM_RPT];                               // the norm weight
  T xr[RM_ROWS][RM_RPT];                         // the CTA's rows of x
  auto load_chunk = [&](int c) {
#pragma unroll
    for (int i = 0; i < RM_RPT; ++i) {
      const int k = c * RM_KC + tid + i * RM_THREADS;
      const T* row = wp + static_cast<size_t>(k) * f + col0;
      nw[i] = k < d ? w[k] : rt_from_f32<T>(0.f);
#pragma unroll
      for (int r = 0; r < RM_ROWS; ++r)
        xr[r][i] = (r < rows && k < d)
                       ? x[static_cast<size_t>(row0 + r) * d + k]
                       : rt_from_f32<T>(0.f);
      if constexpr (VEC) {
#pragma unroll
        for (int v = 0; v < NV; ++v)
          wv[i][v] = k < d ? __ldg(reinterpret_cast<const uint4*>(row) + v)
                           : make_uint4(0, 0, 0, 0);
      } else {
#pragma unroll
        for (int j = 0; j < RM_COLS; ++j)
          ws[i][j] = (k < d && col0 + j < f) ? row[j] : rt_from_f32<T>(0.f);
      }
    }
  };
  auto w_row = [&](int i, float* out) {       // W row i of the tile as f32
    if constexpr (VEC) {
#pragma unroll
      for (int v = 0; v < NV; ++v) V::unpack(wv[i][v], out + v * V::N);
    } else {
#pragma unroll
      for (int j = 0; j < RM_COLS; ++j) out[j] = rt_to_f32(ws[i][j]);
    }
  };

  // 1. the first chunk in flight, then the statistics: warp w sums rows
  //    w and w + 8, all of their loads in flight together
  load_chunk(0);
  if (tid < RM_ROWS * RM_COLS) oacc[tid] = 0.f;
  float ss[SR];
#pragma unroll
  for (int j = 0; j < SR; ++j) ss[j] = 0.f;
  if (vec_x) {
    const int nvec = d / V::N;
#pragma unroll 4
    for (int c = lane; c < nvec; c += 32)
#pragma unroll
      for (int j = 0; j < SR; ++j) {
        const int r = warp + j * RM_WARPS;
        if (r < rows) {
          float v[V::N];
          V::unpack(__ldg(reinterpret_cast<const uint4*>(
                              x + static_cast<size_t>(row0 + r) * d) + c), v);
#pragma unroll
          for (int e = 0; e < V::N; ++e) ss[j] = fmaf(v[e], v[e], ss[j]);
        }
      }
  } else {
#pragma unroll 4
    for (int i = lane; i < d; i += 32)
#pragma unroll
      for (int j = 0; j < SR; ++j) {
        const int r = warp + j * RM_WARPS;
        if (r < rows) {
          const float v =
              rt_to_f32(x[static_cast<size_t>(row0 + r) * d + i]);
          ss[j] = fmaf(v, v, ss[j]);
        }
      }
  }
#pragma unroll
  for (int j = 0; j < SR; ++j) {
    const int r = warp + j * RM_WARPS;
    const float t = rt_warp_sum(ss[j]);
    if (lane == 0 && r < rows)
      inv_s[r] = rsqrtf(t / static_cast<float>(d) + eps);
  }
  __syncthreads();

  // 2. per chunk of K and group of R rows: normed rows at the thread's k,
  //    their products with the held W tile, summed over the CTA
  for (int c = 0; c < n_chunks; ++c) {
    if (c > 0) load_chunk(c);
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
      const int g0 = gi * R;
      if (g0 >= rows) break;
      float nx[R][RM_RPT];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < RM_RPT; ++i) {
          const int k = c * RM_KC + tid + i * RM_THREADS;
          nx[r][i] = 0.f;
          if (g0 + r < rows && k < d) {
            const T v = rt_from_f32<T>(rt_to_f32(xr[g0 + r][i]) *
                                       inv_s[g0 + r] * rt_to_f32(nw[i]));
            nx[r][i] = rt_to_f32(v);
            if (write_normed)
              normed[static_cast<size_t>(row0 + g0 + r) * d + k] = v;
          }
        }
      float acc[NR];
#pragma unroll
      for (int e = 0; e < NR; ++e) acc[e] = 0.f;
#pragma unroll
      for (int i = 0; i < RM_RPT; ++i) {
        float wf[RM_COLS];
        w_row(i, wf);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < RM_COLS; ++j)
            acc[r * RM_COLS + j] = fmaf(nx[r][i], wf[j], acc[r * RM_COLS + j]);
      }
      rt_warp_reduce_scatter(acc, lane);
#pragma unroll
      for (int q = 0; q < NR / 32; ++q)
        red[warp][lane * (NR / 32) + q] = acc[q];
      __syncthreads();
      if (tid < NR && g0 + tid / RM_COLS < rows) {
        float s = 0.f;
#pragma unroll
        for (int wi = 0; wi < RM_WARPS; ++wi) s += red[wi][tid];
        oacc[g0 * RM_COLS + tid] += s;
      }
      __syncthreads();
    }
  }

  // 3. the CTA's rows x 8 outputs
  if (tid < rows * RM_COLS && col0 + tid % RM_COLS < f)
    proj[static_cast<size_t>(row0 + tid / RM_COLS) * f + col0 +
         tid % RM_COLS] = rt_from_f32<T>(oacc[tid]);
}

// The bf16 kernel on the tensor cores: the same grid, 16 rows a CTA.  A
// CTA's product, at most 16 rows x 8 columns, is one mma.sync m16n8k16
// tile per 16 rows of K: warp w owns K rows [128 w, 128 w + 128) of each
// 1024-row chunk, so it keeps one 16 x 8 f32 accumulator, and the 8 warps
// meet once, at the end.  W's chunk comes in by 16-byte cp.async into
// shared memory (zero past d) and reaches the B fragments by
// ldmatrix.trans; the A fragments are the normed rows, computed in
// registers from x pairs each lane loads at its own fragment positions.
// Every load of W and x is issued before the statistics, which come from
// the same pairs when D fits one chunk (x is then read once), else from a
// pass of 16-byte loads.  Needs f and d multiples of 8 and x, wp 16-byte (w
// 4-byte) aligned.
constexpr int RM_STEPS = RM_KC / 16 / RM_WARPS;  // k-steps a warp a chunk

__global__ void __launch_bounds__(RM_THREADS)
rmsnorm_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w,
                          const __nv_bfloat16* __restrict__ wp,
                          __nv_bfloat16* __restrict__ proj,
                          __nv_bfloat16* __restrict__ normed, int n, int d,
                          int f, float eps) {
  using V = RtVec16<__nv_bfloat16>;
  constexpr int SR = RM_ROWS / RM_WARPS;      // rows a warp sums
  __shared__ __align__(16) uint16_t sw[RM_KC * RM_COLS];
  __shared__ float inv_s[RM_ROWS];
  __shared__ float red[RM_WARPS][RM_ROWS * RM_COLS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = lane / 4, q = lane % 4;      // fragment row and k pair
  const int col0 = blockIdx.x * RM_COLS;
  const int row0 = blockIdx.y * RM_ROWS;
  const int rows = min(RM_ROWS, n - row0);
  // warp w's K slice of `normed` is written by column tile w mod grid.x,
  // so the stores are spread over up to 8 CTAs
  const bool write_normed = warp % gridDim.x == blockIdx.x;
  const int n_chunks = (d + RM_KC - 1) / RM_KC;

  // x and w pairs at this lane's A-fragment positions: [step][k half * 2 +
  // row half] and [step][k half]
  uint32_t xa[RM_STEPS][4], wa[RM_STEPS][2];
  auto issue = [&](int c) {
#pragma unroll
    for (int i = 0; i < RM_RPT; ++i) {
      const int kl = tid + i * RM_THREADS, k = c * RM_KC + kl;
      cp_async16(smem_addr(sw + kl * RM_COLS),
                 wp + static_cast<size_t>(min(k, d - 1)) * f + col0, k < d);
    }
    cp_async_commit();
#pragma unroll
    for (int s = 0; s < RM_STEPS; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = c * RM_KC + (warp * RM_STEPS + s) * 16 + 2 * q + 8 * h;
        wa[s][h] = k < d ? __ldg(reinterpret_cast<const uint32_t*>(w + k))
                         : 0u;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = r0 + 8 * rr;
          xa[s][2 * h + rr] =
              (r < rows && k < d)
                  ? __ldg(reinterpret_cast<const uint32_t*>(
                        x + static_cast<size_t>(row0 + r) * d + k))
                  : 0u;
        }
      }
  };

  issue(0);
  if (n_chunks == 1) {
    // the CTA's lanes hold all of x between them: the statistics from the
    // fragment pairs, so x is read once
    float s0 = 0.f, s1 = 0.f;                 // rows r0 and r0 + 8
#pragma unroll
    for (int s = 0; s < RM_STEPS; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t a = xa[s][2 * h], b = xa[s][2 * h + 1];
        const float a0 = __uint_as_float(a << 16);
        const float a1 = __uint_as_float(a & 0xffff0000u);
        const float b0 = __uint_as_float(b << 16);
        const float b1 = __uint_as_float(b & 0xffff0000u);
        s0 = fmaf(a0, a0, fmaf(a1, a1, s0));
        s1 = fmaf(b0, b0, fmaf(b1, b1, s1));
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (q == 0) {
      red[warp][r0] = s0;
      red[warp][r0 + 8] = s1;
    }
    __syncthreads();
    if (tid < RM_ROWS) {
      float t = 0.f;
#pragma unroll
      for (int wi = 0; wi < RM_WARPS; ++wi) t += red[wi][tid];
      inv_s[tid] =
          tid < rows ? rsqrtf(t / static_cast<float>(d) + eps) : 0.f;
    }
  } else {
    // wider rows: one warp sums two rows with 16-byte loads
    float ss[SR];
#pragma unroll
    for (int j = 0; j < SR; ++j) ss[j] = 0.f;
    const int nvec = d / V::N;
#pragma unroll 4
    for (int c = lane; c < nvec; c += 32)
#pragma unroll
      for (int j = 0; j < SR; ++j) {
        const int r = warp + j * RM_WARPS;
        if (r < rows) {
          float v[V::N];
          V::unpack(__ldg(reinterpret_cast<const uint4*>(
                              x + static_cast<size_t>(row0 + r) * d) + c),
                    v);
#pragma unroll
          for (int e = 0; e < V::N; ++e) ss[j] = fmaf(v[e], v[e], ss[j]);
        }
      }
#pragma unroll
    for (int j = 0; j < SR; ++j) {
      const int r = warp + j * RM_WARPS;
      const float t = rt_warp_sum(ss[j]);
      if (lane == 0)
        inv_s[r] = r < rows ? rsqrtf(t / static_cast<float>(d) + eps) : 0.f;
    }
  }

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < n_chunks; ++c) {
    if (c > 0) {
      __syncthreads();                        // the last chunk's sw is read
      issue(c);
    }
    cp_async_wait<0>();
    __syncthreads();
    uint32_t b[4];                            // B of two steps, by ldmatrix
#pragma unroll
    for (int s = 0; s < RM_STEPS; ++s) {
      const int kl = (warp * RM_STEPS + s) * 16;
      if (c * RM_KC + kl >= d) break;
      if (s % 2 == 0) ldsm_x4_trans(smem_addr(sw + (kl + lane) * RM_COLS), b);
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float w_lo = __uint_as_float(wa[s][h] << 16);
        const float w_hi = __uint_as_float(wa[s][h] & 0xffff0000u);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const uint32_t xv = xa[s][2 * h + rr];
          const float inv = inv_s[r0 + 8 * rr];
          const uint32_t nv =
              pack_bf16(__uint_as_float(xv << 16) * inv * w_lo,
                        __uint_as_float(xv & 0xffff0000u) * inv * w_hi);
          a[2 * h + rr] = nv;
          const int k = c * RM_KC + kl + 2 * q + 8 * h;
          if (write_normed && r0 + 8 * rr < rows && k < d)
            *reinterpret_cast<uint32_t*>(
                normed + static_cast<size_t>(row0 + r0 + 8 * rr) * d + k) =
                nv;
        }
      }
      mma_bf16(acc, a, b[(s % 2) * 2], b[(s % 2) * 2 + 1]);
    }
  }

  // the 8 warps' 16 x 8 tiles meet once (red's statistics were read
  // before the barrier after the last chunk's cp.async)
  red[warp][r0 * RM_COLS + 2 * q] = acc[0];
  red[warp][r0 * RM_COLS + 2 * q + 1] = acc[1];
  red[warp][(r0 + 8) * RM_COLS + 2 * q] = acc[2];
  red[warp][(r0 + 8) * RM_COLS + 2 * q + 1] = acc[3];
  __syncthreads();
  if (tid < RM_ROWS * RM_COLS) {
    const int r = tid / RM_COLS, col = col0 + tid % RM_COLS;
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < RM_WARPS; ++wi) sum += red[wi][tid];
    if (r < rows && col < f)
      proj[static_cast<size_t>(row0 + r) * f + col] =
          __float2bfloat16_rn(sum);
  }
}

// The launch plan of kernels/fused/rmsnorm_matmul/ops.py::tile_plan, which
// the caller passes and this entry checks: grid (ceil(f / 8), ceil(n / 16)).
extern "C" int rmsnorm_matmul_launch(const void* x, const void* w,
                                     const void* wp, void* proj,
                                     void* normed, int n, int d, int f,
                                     int grid_x, int grid_y, float eps,
                                     int dtype, void* stream) {
  if (n <= 0 || d <= 0 || f <= 0 ||
      grid_x != (f + RM_COLS - 1) / RM_COLS ||
      grid_y != (n + RM_ROWS - 1) / RM_ROWS || grid_y > RM_MAX_GRID_Y)
    return static_cast<int>(cudaErrorInvalidValue);
  const int es = dtype == RT_F32 ? 4 : 2;
  const bool vec_w = f % RM_COLS == 0 && rt_aligned(wp);
  const int vec_x = d % (16 / es) == 0 && rt_aligned(x);
  const dim3 grid(grid_x, grid_y);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == RT_BF16 && vec_w && vec_x && d % 8 == 0 && rt_aligned(w, 4)) {
    using T = __nv_bfloat16;
    rmsnorm_matmul_mma_kernel<<<grid, RM_THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(wp), static_cast<T*>(proj),
        static_cast<T*>(normed), n, d, f, eps);
    return static_cast<int>(cudaGetLastError());
  }
  RT_DISPATCH(dtype, T, {
    const auto kernel = vec_w ? rmsnorm_matmul_kernel<T, true>
                              : rmsnorm_matmul_kernel<T, false>;
    kernel<<<grid, RM_THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(wp), static_cast<T*>(proj),
        static_cast<T*>(normed), n, d, f, eps, vec_x);
  });
  return static_cast<int>(cudaGetLastError());
}
