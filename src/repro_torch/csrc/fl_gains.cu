// Facility-location greedy gains for NVIDIA Hopper (sm_90a): the three
// kernels of the `fl_gains` family.
//
// Replaces the TPU kernels of src/repro/kernels/fl_gains/fl_gains.py:
//   fl_gains_pallas                 (_fl_gains_kernel)
//       g_j = sum_i relu(K_ij - c_i) over a materialised K (n, n_cand);
//   fl_gains_gram_free_pallas       (_fl_gains_gram_free_kernel)
//       the same with K_ij = 0.5 + 0.5 * <z_i, zc_j> built on the fly;
//   fl_gains_gram_free_delta_pallas (_fl_gains_gram_free_delta_kernel)
//       sum_i relu(K_ij - c_new_i) - relu(K_ij - c_old_i) over touched rows.
//
// Summation order.  On the TPU the ground axis i is the innermost,
// sequential grid axis, revisiting the output.  Blocks here run in parallel
// in no order, so i is cut into fixed chunks of CHUNK rows (by absolute row
// index): one block sums one chunk for a block of candidates in a fixed
// order and writes a per-chunk partial; a second kernel adds the partials
// chunk by chunk in index order (with one chunk the first kernel writes the
// result itself).  No atomics.  Every candidate's sum is therefore a fixed
// function of its own column and of the row order alone: repeated launches
// are bit-identical, a candidate's gain does not depend on which other
// candidates share the launch (gains_at == gathered gains; the delta on a
// candidate slice == the full call), and rows past the end or carrying an
// infinite cover add exact zeros in the same slots (the lazy engine's
// two-level gathers are bit-identical).
//
// +inf covers are exact zeros: relu(x - inf) = fmaxf(-inf, 0) = 0, and the
// delta of a row with c_old = c_new = +inf is 0 - 0.  Ragged n, n_cand and
// d are masked in the kernels; nothing is padded by the caller.
//
// Arithmetic: IEEE fp32 only.  The fused products are k-ordered FMAs on the
// CUDA cores starting from 0 (no TF32, no split-k), the same order as the
// similarity kernel (csrc/similarity.cu), and 0.5 + 0.5 * acc rounds once
// (0.5 * acc is exact).  Every gain feeds a greedy argmax.
//
// Bounds on this card (H100 SXM, 67 TFLOP/s fp32, 3.35 TB/s):
//   gram-free gains at (8192, 8192, 768): 2 * n * n_cand * d = 1.03e11 FLOP
//     against ~50 MB moved -> bound by operations (~1.54 ms);
//   delta at b touched rows: 2 * b * n_cand * d FLOP against the zc read
//     (25 MB at 8192 x 768) -> bound by bytes below b ~ 40, by operations
//     above (~0.19 ms at b = 1024);
//   gains over a materialised (8192, 8192) K: 268 MB read -> bound by bytes
//     (~80 us).
//
// Two designs.  The tiled kernel (B2, and B3 above b = 64): a 64 x 64
// (rows x candidates) tile per step with both operands staged through
// shared memory in 16-deep slabs.  The small-b instance of B3 (b <= 64, the
// lazy engine's common gathers): the work is b dot products per candidate
// and the bytes are zc's, so it streams zc at memory speed:
//   * 32 candidates per block: 256 blocks at 8192 candidates, all resident
//     at once (at most 104,448 bytes of dynamic shared memory each, at
//     b = 64);
//   * k-slabs of 64 floats of the 32 candidate rows and of the touched rows
//     go through a 4-stage ring in shared memory, filled by 16-byte
//     cp.async copies (no register staging): three slabs of each block,
//     ~48 KB of zc per SM, are in flight while one is computed;
//   * one instance per power of two BP >= b (the gather levels; rows past
//     b are zero-filled and left out of the sum).  A thread owns R rows
//     times C candidates, so the work grows with b: one pair per thread up
//     to b = 4 (32 to 128 threads), then 2 or 4 rows and 1, 2 or 4
//     candidates per thread at 128 threads, so that a value loaded from
//     shared memory serves several FMAs.  The choice per level was measured: with fewer threads (one
//     warp holding all rows) each launch waited on its loads' latency.
//     A load phase reads one touched row (a broadcast) and 8 consecutive
//     candidate rows (distinct banks at the pitch of 68 floats), 4 k at a
//     time;
//   * the b x 32 terms go to shared memory and are summed there in the
//     tiled kernel's order (below).
// Both instances give each candidate the same fp32 value, bit for bit: per
// pair one fmaf chain over k in order from 0.f, s = 0.5f + 0.5f * acc, the
// row term t_i = fmaxf(s - c_new_i, 0.f) - fmaxf(s - c_old_i, 0.f); in a
// 256-row chunk, partial P_r (r < 16) adds t_r, t_{r+16}, t_{r+32}, ... to
// 0.f in row order, and the chunk's value is ((P_0 + P_1) + ...) + P_15.
// So b rows padded with +inf rows up to the next level (or the budget) give
// the b rows' value whichever instance runs.  The small-b instance needs
// d % 4 == 0 and 16-byte-aligned z and zc (cp.async's granule); a call
// without them runs the tiled instance.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;            // ground rows per tile
constexpr int BN = 64;            // candidates per block
constexpr int BK = 16;            // k-slab depth
constexpr int TM = 4;             // rows per thread
constexpr int TN = 4;             // candidates per thread
constexpr int RS = BM / TM;       // 16: row stride between a thread's rows
constexpr int CS = BN / TN;       // 16: column stride between a thread's columns
constexpr int THREADS = RS * CS;  // 256
constexpr int CHUNK = 256;        // ground rows per chunk (fixed: sets the order)
constexpr int COLS = 256;         // candidates per block of the materialised kernel

static_assert(CHUNK % BM == 0, "a chunk is a whole number of row tiles");
static_assert(BM * BK == THREADS * 4 && BN * BK == THREADS * 4,
              "the loader moves exactly 4 values of each operand per thread");

// Gram-free gains (DELTA = false: ca = c) or lazy delta (DELTA = true:
// ca = c_old, cb = c_new) of one chunk of ground rows for BN candidates.
// grid = (ceil(n_cand / BN), n_chunks, batch).  Writes out[b, chunk, j]
// (partial_stride = n_cand, batch_stride = n_chunks * n_cand).
template <bool DELTA>
__global__ void __launch_bounds__(THREADS)
gram_free_kernel(const float* __restrict__ z, const float* __restrict__ zc,
                 long long zc_bstride, const float* __restrict__ ca,
                 const float* __restrict__ cb, long long c_bstride,
                 float* __restrict__ out, long long out_bstride, int n, int n_cand,
                 int d) {
  __shared__ float As[BK][BM + 1];  // ground rows, k-major
  __shared__ float Bs[BK][BN + 1];  // candidate rows, k-major
  __shared__ float cov_a[BM];
  __shared__ float cov_b[BM];
  __shared__ float red[RS][BN];

  const int tid = threadIdx.x;
  const int tx = tid % CS;
  const int ty = tid / CS;
  const int col0 = blockIdx.x * BN;
  const int chunk = blockIdx.y;
  const int row_begin = chunk * CHUNK;
  const int row_end = min(n, row_begin + CHUNK);
  zc += blockIdx.z * zc_bstride;
  ca += blockIdx.z * c_bstride;
  if (DELTA) cb += blockIdx.z * c_bstride;

  const int lr = tid / 4;        // loader: tile row
  const int lk = (tid % 4) * 4;  // loader: 4 consecutive k
  const int kr = col0 + lr;

  // part[j]: this thread's sum, in row order, over rows ty + RS * i of
  // every tile of the chunk, for candidate col0 + tx + CS * j
  float part[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) part[j] = 0.f;

  for (int row0 = row_begin; row0 < row_end; row0 += BM) {
    __syncthreads();  // the previous tile's epilogue is done with cov_*
    if (tid < BM) {
      const int r = row0 + tid;
      cov_a[tid] = r < row_end ? ca[r] : CUDART_INF_F;
      if (DELTA) cov_b[tid] = r < row_end ? cb[r] : CUDART_INF_F;
    }
    const int qr = row0 + lr;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + lk + e;
        As[lk + e][lr] = (qr < row_end && k < d) ? z[(long long)qr * d + k] : 0.f;
        Bs[lk + e][lr] = (kr < n_cand && k < d) ? zc[(long long)kr * d + k] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + i * RS];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * CS];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    if (d <= 0) __syncthreads();  // cov_* written above are visible below

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int lrow = ty + i * RS;
      if (row0 + lrow >= row_end) continue;
      const float c1 = cov_a[lrow];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float s = 0.5f + 0.5f * acc[i][j];
        if (DELTA) {
          part[j] += fmaxf(s - cov_b[lrow], 0.f) - fmaxf(s - c1, 0.f);
        } else {
          part[j] += fmaxf(s - c1, 0.f);
        }
      }
    }
  }

  // the RS row partials of each candidate, added in ty order
#pragma unroll
  for (int j = 0; j < TN; ++j) red[ty][tx + j * CS] = part[j];
  __syncthreads();
  if (tid < BN) {
    const int col = col0 + tid;
    if (col < n_cand) {
      float s = red[0][tid];
#pragma unroll
      for (int t = 1; t < RS; ++t) s += red[t][tid];
      out[blockIdx.z * out_bstride + (long long)chunk * n_cand + col] = s;
    }
  }
}

// Gains over a materialised K: one thread per candidate column, rows of
// the chunk in order.  grid = (ceil(n_cand / COLS), n_chunks, batch).
__global__ void __launch_bounds__(COLS)
dense_kernel(const float* __restrict__ K, long long k_bstride, long long ldk,
             const float* __restrict__ c, long long c_bstride,
             float* __restrict__ out, long long out_bstride, int n, int n_cand) {
  __shared__ float cov[CHUNK];
  const int chunk = blockIdx.y;
  const int row_begin = chunk * CHUNK;
  const int rows = min(n, row_begin + CHUNK) - row_begin;
  c += blockIdx.z * c_bstride;
  for (int r = threadIdx.x; r < rows; r += COLS) cov[r] = c[row_begin + r];
  __syncthreads();
  const int col = blockIdx.x * COLS + threadIdx.x;
  if (col >= n_cand) return;
  const float* kp = K + blockIdx.z * k_bstride + (long long)row_begin * ldk + col;
  float s = 0.f;
#pragma unroll 8
  for (int r = 0; r < rows; ++r) s += fmaxf(kp[(long long)r * ldk] - cov[r], 0.f);
  out[blockIdx.z * out_bstride + (long long)chunk * n_cand + col] = s;
}

// out[b, j] = sum over chunks, in chunk order, of partial[b, chunk, j].
__global__ void reduce_chunks_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int n_chunks,
                                     int n_cand) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n_cand) return;
  const float* p = partial + (long long)blockIdx.y * n_chunks * n_cand + col;
  float s = p[0];
  for (int ch = 1; ch < n_chunks; ++ch) s += p[(long long)ch * n_cand];
  out[(long long)blockIdx.y * n_cand + col] = s;
}

int n_chunks_of(int n) { return (n + CHUNK - 1) / CHUNK; }

// With one chunk the first kernel writes `out`; else it writes `scratch`
// (batch, n_chunks, n_cand) and the second pass reduces it into `out`.
int finish(float* scratch, float* out, int n_chunks, int n_cand, int batch,
           cudaStream_t stream) {
  int err = static_cast<int>(cudaGetLastError());
  if (err || n_chunks == 1) return err;
  const dim3 grid((n_cand + 255) / 256, batch);
  reduce_chunks_kernel<<<grid, 256, 0, stream>>>(scratch, out, n_chunks, n_cand);
  return static_cast<int>(cudaGetLastError());
}

template <bool DELTA>
int launch_gram_free(const void* z, const void* zc, long long zc_bstride,
                     const void* ca, const void* cb, long long c_bstride, void* out,
                     void* scratch, int n, int n_cand, int d, int batch,
                     void* stream) {
  const int n_chunks = n_chunks_of(n);
  auto s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(n_chunks == 1 ? out : scratch);
  const dim3 grid((n_cand + BN - 1) / BN, n_chunks, batch);
  gram_free_kernel<DELTA><<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(z), static_cast<const float*>(zc), zc_bstride,
      static_cast<const float*>(ca), static_cast<const float*>(cb), c_bstride, dst,
      (long long)n_chunks * n_cand, n, n_cand, d);
  return finish(static_cast<float*>(scratch), static_cast<float*>(out), n_chunks,
                n_cand, batch, s);
}

// ---------------------------------------------------------------------------
// B3 at b <= SMALL_B: the small-b instance
// ---------------------------------------------------------------------------

constexpr int SMALL_B = 64;                 // largest b it takes: a gather level
constexpr int SB_CANDS = 32;                // candidates per block
constexpr int SB_BK = 64;                   // k-slab depth
constexpr int SB_PITCH = SB_BK + 4;         // slab row pitch (floats)
constexpr int SB_STAGES = 4;
constexpr int SB_GRANULES = SB_BK / 4;      // 16-byte copies per slab row

// The instance for b <= BP touched rows (BP a power of two): R rows times
// C candidates per thread, G groups of rows by LANES lanes of candidates.
template <int BP>
struct SmallB {
  static constexpr int R = BP < 8 ? 1 : (BP < 32 ? 2 : 4);   // rows per thread: g + G i
  static constexpr int G = BP / R;                           // row groups
  static constexpr int C = BP <= 8 ? 1 : (BP < 64 ? 2 : 4);  // candidates: lane + LANES j
  static constexpr int LANES = SB_CANDS / C;
  static constexpr int ACTIVE = G * LANES;              // threads that compute
  static constexpr int THREADS = ACTIVE < 64 ? 64 : ACTIVE;  // threads that copy
  static constexpr int STAGE = (SB_CANDS + BP) * SB_PITCH;   // floats: zc slab, then z slab
  static constexpr int SMEM = SB_STAGES * STAGE * 4;
  static_assert(ACTIVE % 32 == 0, "whole warps compute");
  static_assert(SB_STAGES * STAGE >= (BP + RS) * SB_CANDS, "the ring holds the terms");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without the registers; zero-filled when !valid
// (src-size 0: `src` is not read).
__device__ __forceinline__ void copy16(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// Slab k0 of candidates [col0, col0 + 32) and of the touched rows, rows
// [b, BP) zero-filled.
template <int BP>
__device__ __forceinline__ void small_b_slab(float* st, const float* __restrict__ z,
                                             const float* __restrict__ zc, int col0, int b,
                                             int n_cand, int k0, int d) {
  for (int e = threadIdx.x; e < (SB_CANDS + BP) * SB_GRANULES; e += SmallB<BP>::THREADS) {
    const int r = e / SB_GRANULES;
    const int g = (e % SB_GRANULES) * 4;
    const bool cand = r < SB_CANDS;
    const int row = cand ? col0 + r : r - SB_CANDS;
    const bool ok = (cand ? row < n_cand : row < b) && k0 + g < d;
    const float* src = cand ? zc : z;
    copy16(smem_addr(st + r * SB_PITCH + g), ok ? src + (long long)row * d + k0 + g : src, ok);
  }
}

// grid = ceil(n_cand / 32); writes out[j] for the block's candidates.
template <int BP>
__global__ void __launch_bounds__(SmallB<BP>::THREADS)
delta_small_b_kernel(const float* __restrict__ z, const float* __restrict__ zc,
                     const float* __restrict__ c_old, const float* __restrict__ c_new,
                     float* __restrict__ out, int b, int n_cand, int d) {
  using P = SmallB<BP>;
  extern __shared__ __align__(16) float ring[];
  __shared__ float cov_old[BP];
  __shared__ float cov_new[BP];

  const int tid = threadIdx.x;
  const int lane = tid % P::LANES;
  const int grp = tid / P::LANES;
  const int col0 = blockIdx.x * SB_CANDS;
  const int nk = (d + SB_BK - 1) / SB_BK;

#pragma unroll
  for (int s = 0; s < SB_STAGES - 1; ++s) {
    if (s < nk) small_b_slab<BP>(ring + s * P::STAGE, z, zc, col0, b, n_cand, s * SB_BK, d);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int r = tid; r < b; r += P::THREADS) {
    cov_old[r] = c_old[r];
    cov_new[r] = c_new[r];
  }

  float acc[P::R][P::C];
#pragma unroll
  for (int i = 0; i < P::R; ++i)
#pragma unroll
    for (int j = 0; j < P::C; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(SB_STAGES - 2) : "memory");
    __syncthreads();
    const int next = kt + SB_STAGES - 1;
    if (next < nk)
      small_b_slab<BP>(ring + (next % SB_STAGES) * P::STAGE, z, zc, col0, b, n_cand,
                       next * SB_BK, d);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (tid >= P::ACTIVE) continue;  // whole warps

    const float* cs = ring + (kt % SB_STAGES) * P::STAGE;
    const float* zs = cs + SB_CANDS * SB_PITCH;
#pragma unroll
    for (int g = 0; g < SB_BK; g += 4) {
      float4 c[P::C];
#pragma unroll
      for (int j = 0; j < P::C; ++j)
        c[j] = *reinterpret_cast<const float4*>(cs + (lane + P::LANES * j) * SB_PITCH + g);
#pragma unroll
      for (int i = 0; i < P::R; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(zs + (grp + P::G * i) * SB_PITCH + g);
#pragma unroll
        for (int j = 0; j < P::C; ++j) {
          acc[i][j] = fmaf(a.x, c[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, c[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, c[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, c[j].w, acc[i][j]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // the ring is free for the terms; cov_* are visible

  // terms[row][cand] of the b rows, then the fixed order of the tiled
  // kernel: part[r][cand] adds rows r, r + 16, ... to 0.f in order, and
  // the value adds part[0], part[1], ..., part[15] in order
  float* terms = ring;                          // BP x 32
  float* part = ring + BP * SB_CANDS;           // 16 x 32
  if (tid < P::ACTIVE) {
#pragma unroll
    for (int i = 0; i < P::R; ++i) {
      const int row = grp + P::G * i;
      if (row >= b) continue;
      const float c1 = cov_old[row];
#pragma unroll
      for (int j = 0; j < P::C; ++j) {
        const float s = 0.5f + 0.5f * acc[i][j];
        terms[row * SB_CANDS + lane + P::LANES * j] =
            fmaxf(s - cov_new[row], 0.f) - fmaxf(s - c1, 0.f);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < RS * SB_CANDS; e += P::THREADS) {
    const int r = e / SB_CANDS;
    const int j = e % SB_CANDS;
    float p = 0.f;
    for (int row = r; row < b; row += RS) p += terms[row * SB_CANDS + j];
    part[e] = p;
  }
  __syncthreads();
  if (tid < SB_CANDS && col0 + tid < n_cand) {
    float s = part[tid];
#pragma unroll
    for (int t = 1; t < RS; ++t) s += part[t * SB_CANDS + tid];
    out[col0 + tid] = s;
  }
}

bool small_b(const void* z, const void* zc, int b, int d) {
  return b <= SMALL_B && d % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(zc) % 16 == 0;
}

template <int BP>
int launch_small_b(const void* z, const void* zc, const void* c_old, const void* c_new,
                   void* out, int b, int n_cand, int d, cudaStream_t stream) {
  auto kernel = delta_small_b_kernel<BP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SmallB<BP>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(n_cand + SB_CANDS - 1) / SB_CANDS, SmallB<BP>::THREADS, SmallB<BP>::SMEM, stream>>>(
      static_cast<const float*>(z), static_cast<const float*>(zc),
      static_cast<const float*>(c_old), static_cast<const float*>(c_new),
      static_cast<float*>(out), b, n_cand, d);
  return static_cast<int>(cudaGetLastError());
}

// The instance of the smallest power of two BP >= b.
int launch_delta_small_b(const void* z, const void* zc, const void* c_old, const void* c_new,
                         void* out, int b, int n_cand, int d, cudaStream_t s) {
  if (b <= 1) return launch_small_b<1>(z, zc, c_old, c_new, out, b, n_cand, d, s);
  if (b <= 2) return launch_small_b<2>(z, zc, c_old, c_new, out, b, n_cand, d, s);
  if (b <= 4) return launch_small_b<4>(z, zc, c_old, c_new, out, b, n_cand, d, s);
  if (b <= 8) return launch_small_b<8>(z, zc, c_old, c_new, out, b, n_cand, d, s);
  if (b <= 16) return launch_small_b<16>(z, zc, c_old, c_new, out, b, n_cand, d, s);
  if (b <= 32) return launch_small_b<32>(z, zc, c_old, c_new, out, b, n_cand, d, s);
  return launch_small_b<64>(z, zc, c_old, c_new, out, b, n_cand, d, s);
}

}  // namespace

// Plain C entry points (bound with ctypes).  All tensors are fp32,
// row-major and contiguous except K (row stride ldk, unit column stride);
// a batch stride of 0 shares an operand across the batch.  `scratch` holds
// batch * ceil(n / 256) * n_cand floats (unused when n <= 256).  Each
// returns cudaGetLastError() right after its launches: 0 means accepted.
// Requires n >= 1, n_cand >= 1, batch >= 1 (the wrapper handles empties).

// B2: out[b, j] = sum_i relu(0.5 + 0.5 <z_i, zc[b, j]> - c[b, i]).
extern "C" int fl_gains_gram_free_f32(const void* z, const void* zc,
                                      long long zc_bstride, const void* c,
                                      long long c_bstride, void* out, void* scratch,
                                      int n, int n_cand, int d, int batch,
                                      void* stream) {
  return launch_gram_free<false>(z, zc, zc_bstride, c, nullptr, c_bstride, out,
                                 scratch, n, n_cand, d, batch, stream);
}

// B3: out[j] = sum_i relu(K_ij - c_new_i) - relu(K_ij - c_old_i) over the
// b touched rows z (b, d), K_ij = 0.5 + 0.5 <z_i, zc_j>.  The small-b
// instance for b <= 64, d % 4 == 0 and 16-byte-aligned z and zc, else the
// tiled one; the two agree bit for bit.  *small_b_out is set to 1 if the
// small-b instance was launched, else 0.
extern "C" int fl_gains_gram_free_delta_f32(const void* z, const void* zc,
                                            const void* c_old, const void* c_new,
                                            void* out, void* scratch, int b,
                                            int n_cand, int d, int* small_b_out,
                                            void* stream) {
  *small_b_out = small_b(z, zc, b, d) ? 1 : 0;
  if (*small_b_out)
    return launch_delta_small_b(z, zc, c_old, c_new, out, b, n_cand, d,
                                static_cast<cudaStream_t>(stream));
  return launch_gram_free<true>(z, zc, 0, c_old, c_new, 0, out, scratch, b, n_cand,
                                d, 1, stream);
}

// Dynamic shared memory of the small-b launch at b <= 64 (its largest).
extern "C" int fl_gains_gram_free_delta_small_b_smem_bytes() { return SmallB<SMALL_B>::SMEM; }

// B4: out[b, j] = sum_i relu(K[b, i, j] - c[b, i]).
extern "C" int fl_gains_f32(const void* K, long long k_bstride, long long ldk,
                            const void* c, long long c_bstride, void* out,
                            void* scratch, int n, int n_cand, int batch,
                            void* stream) {
  const int n_chunks = n_chunks_of(n);
  auto s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(n_chunks == 1 ? out : scratch);
  const dim3 grid((n_cand + COLS - 1) / COLS, n_chunks, batch);
  dense_kernel<<<grid, COLS, 0, s>>>(static_cast<const float*>(K), k_bstride, ldk,
                                     static_cast<const float*>(c), c_bstride, dst,
                                     (long long)n_chunks * n_cand, n, n_cand);
  return finish(static_cast<float*>(scratch), static_cast<float*>(out), n_chunks,
                n_cand, batch, s);
}
