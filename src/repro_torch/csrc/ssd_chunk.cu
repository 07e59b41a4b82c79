// One Mamba-2 SSD chunk for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ssd_chunk_pallas (body _ssd_kernel) of
// src/repro/kernels/ssd_chunk/ssd_chunk.py.  Per (batch, head), over the
// chunk's rows t, s < len:
//   cum   = cumsum_t log(max(a_t, 1e-20))
//   y_t   = sum_{s <= t} (c_t . b_s) exp(cum_t - cum_s) x_s  +  (c_t . h_in) exp(cum_t)
//   h_out = exp(cum_end) h_in + sum_s b_s (x_s exp(cum_end - cum_s))^T
// with b and c shared across heads.  A ragged last chunk (len < L of the
// sequence's chunking) is masked here: rows past len are neither read nor
// written, and cum_end is cum at row len - 1 -- what the reference's padding
// (a = 1, b = c = x = 0) gives -- so nothing is padded by the caller.  Inputs
// are addressed through strides (unit stride on the last dim), so chunk
// slices of the sequence go in, and y is written into the whole sequence's
// output, without copies.
//
// Two instances; ssd_chunk_f32 alone picks one and reports which it launched:
//   * mma, for every call whose loads cp.async can address -- x, b, c and
//     h_in 16-byte aligned, each of their strides a multiple of 4 floats --
//     with len <= 256, P <= 64 and N <= 128 (every call of the serving path);
//   * simt, the fp32 CUDA-core kernel the mma instance replaced
//     (ssd_chunk_kernel below, unchanged), for every other call.
//
// The mma instance.
// Numbers: f32 accuracy from the TF32 tensor cores by a three-part split.
// All four products -- c b^T, the weighted (L, L) x (L, P) of each head,
// c h_in and b^T (x o rem) -- run on mma.sync.m16n8k8 tf32 with f32
// accumulators.  Each operand u splits as u_hi = cvt.rna.tf32(u) and
// u_lo = cvt.rna.tf32(u - u_hi) (the rounding done by two integer ops, bit
// for bit), and each 8-deep k-step sums a_lo b_hi, then a_hi b_lo, then
// a_hi b_hi on the tensor cores from zero and adds that to the running sum
// with an f32 add.  The dropped a_lo b_lo and the rounding of the lo parts
// leave about 2^-21 of each product, about one more f32 rounding: at
// Jamba's widths the split is ~5e-5 off the f32 plain chunk, one TF32 part
// ~8e-2, against the reference's 1e-4.  The running sum stays out of the
// tensor cores because they round toward zero, after cutting every term to
// a multiple of 2^(E - 25), E the largest term's exponent (measured through
// ssd_mma_probe below; kernels/ssd_chunk/tf32.py models it bit for bit):
// carried through them, the sum would lose up to an ulp of itself a k-step,
// always downward, ~4x the error.  tests/test_torch_ssd_chunk.py emulates
// all three on the CPU.  The elementwise work stays f32 on the CUDA cores:
// cum is summed in row order by one thread per head (the logs are taken in
// parallel), so its values are the simt instance's; the decay is
// expf(cum_t - cum_s) of the difference (cum falls below -88 within a chunk
// once a < 0.7, so exp(cum_t) exp(-cum_s) would overflow); the weight
// s_ts * decay is formed in f32 and then split.  No atomics and a fixed
// order: repeated launches are bit-equal.
// Why mma.sync and not wgmma: wgmma reads tf32 operands from shared memory
// K-major only (its transpose flags are for 16-bit types) and x is (s, p)
// with p contiguous; mma.sync loads its fragments from shared memory in any
// layout.
// Blocks of 256 threads (8 warps), one launch per chunk, heaviest first:
//   * y blocks, one per (64-row t tile, batch, group of 8 heads).  A block
//     builds its band of c b^T (its 64 rows x the s < t0 + 64 columns) once,
//     in shared memory, for all 8 heads.  Then two heads at a time (4 warps
//     a head, 16 rows x 64 columns a warp): c h_in over k = n, the rows
//     scaled by exp(cum_t), then the weighted band times x over the s tiles
//     at or below the t tile (the diagonal one masked s <= t, each warp
//     stopping at its last row).  A warp forms its weights from the band and
//     cum straight into its A fragment, each weight once.
//   * h blocks, one per (batch, head): the (N, P) state, 16 state rows a
//     warp, k = s over the chunk's rows.
// Every tile (64 rows of b, x or h_in) goes through a 3-stage ring of
// 16-byte cp.async copies, zero-filled past len, P and N so that padding
// adds exact zeros: the next tile loads while this one computes.  The
// pitches keep the fragment reads free of bank conflicts: a fragment reads
// A[g][q] and B[q][g] (g = lane / 4, q = lane % 4), so an operand stored
// k-contiguous has a pitch = 4 (mod 32) floats (c and b in the y role, the
// band: 132 and 260) and one stored n-contiguous 8 (mod 32) (x and h_in:
// 72; b as the A of b^T x: 136).
// Budget: a y block holds the c tile (33,792 B), the band (66,560 B), the
// ring (3 x 36,864 B) and cum (8,320 B): 219,264 B of dynamic shared memory,
// one block of 8 warps per SM (an h block uses 161,808 B of it).
// __launch_bounds__(256, 1) allows 255 registers a thread; the build's
// -Xptxas -v report holds the count (chip_smoke.py prints it and fails on a
// spill).
//
// Bounds on this card (H100 SXM: 67 TFLOP/s fp32 on the CUDA cores, 495
// TFLOP/s TF32 on the tensor cores through wgmma, 3.35 TB/s): one chunk at
// Jamba's shape (L 256, 256 heads of P 64, N 128) needs ~3.24 GFLOP against
// ~51 MB moved, 48 us at the fp32 peak and 15 us of bytes; the split runs
// 3 x 3.24 GFLOP of TF32, 20 us at the wgmma peak.  Per 8-deep k-step a
// y warp issues ~170 other instructions beside its 24 mma (4 expf for its
// weights, the splits of 20 operands, 22 shared loads, 32 adds): with 2
// warps per scheduler the instance is bound by latency and issue, not by
// the tensor cores.  Later work: wgmma with x transposed in shared memory,
// fewer splits per product (a warp over more rows), and the chunk loop in
// one launch.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_ring.cuh"

// The simt instance (ssd_chunk_kernel), fp32 FMAs on the CUDA cores.  The
// TPU kernel holds a whole (L, L, heads) decay stack in VMEM (~2.6 MB at
// L = 256, 8 heads); a Hopper block has at most 227 KB, and the f32 (L, L)
// scores alone are 256 KB.  So the work is tiled, in one launch with two
// block roles:
//   * y blocks, one per (batch, block of 4 heads, 64-row t tile): the
//     inter-chunk term from c and h_in first, then a loop over the s tiles
//     at or below the t tile, each building the 64 x 64 tile of c b^T from
//     the N state columns once for the 4 heads, weighting it by
//     exp(cum_t - cum_s) with the s <= t mask, and accumulating it times x;
//   * h blocks, one per (batch, head), own the whole (N, P) state and sum
//     b_s (x_s exp(cum_end - cum_s)) over s in a fixed order.
// Every output element is summed by one thread in a fixed order; cum is
// computed by one thread per head, sequentially, in each block that needs
// it.  c b^T is rebuilt for each block of 4 heads, 64 times a chunk at
// Jamba's shape: ~0.67 GFLOP on top of the 3.24 the chunk needs, and the
// diagonal tiles are computed whole.
namespace {

constexpr int TILE = 64;          // rows (t or s) per tile
constexpr int P_MAX = 64;         // head dim held by the tiles
constexpr int N_MAX = 128;        // state dim held by the tiles
constexpr int HB = 4;             // heads per y block
constexpr int THREADS = 256;
constexpr int NLD = N_MAX + 1;    // padded row stride of the c and b tiles
constexpr int WLD = TILE + 1;     // padded row stride of the weight tile

static_assert(N_MAX * P_MAX <= TILE * NLD, "h_in fits the b tile's buffer");
static_assert(THREADS == 256 && TILE == 64 && P_MAX == 64 && N_MAX == 128,
              "the thread layouts below assume these sizes");

struct Strides {
  long long x[3], a[3], b[2], c[2], h[3], y[3], ho[3];
};

// One call's operands and sizes (n_hg, n_y: the mma instance's grid).
struct Args {
  const float *x, *a, *b, *c, *h_in;
  float *y, *h_out;
  Strides st;
  int B, L, H, P, N, n_hg, n_y;
};

__host__ __device__ constexpr size_t smem_floats(int L) {
  return 2 * TILE * NLD + TILE * WLD + TILE * P_MAX + (size_t)HB * L;
}

// cum[t] = sum_{u <= t} log(max(a_u, 1e-20)) for t < n, in order.
__device__ __forceinline__ void cumsum_log(float* cum, const float* __restrict__ a,
                                           long long a_st, int n) {
  float acc = 0.f;
  for (int t = 0; t < n; ++t) {
    acc += logf(fmaxf(a[t * a_st], 1e-20f));
    cum[t] = acc;
  }
}

// Rows [r0, r0 + TILE) of a (len, N) matrix (row stride ld) into a TILE x NLD
// tile, rows past len zero.
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          long long ld, int r0, int len, int N) {
  for (int e = threadIdx.x; e < TILE * N; e += THREADS) {
    const int r = e / N, n = e - r * N;
    dst[r * NLD + n] = r0 + r < len ? src[(long long)(r0 + r) * ld + n] : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ bm, const float* __restrict__ cm,
                 const float* __restrict__ h_in, float* __restrict__ y,
                 float* __restrict__ h_out, Strides st, int H, int P, int N, int L, int n_y) {
  extern __shared__ float smem[];
  float* Cs = smem;                 // TILE x NLD: c rows of the t tile
  float* Bs = Cs + TILE * NLD;      // TILE x NLD: b rows of an s tile (or h_in, N x P_MAX)
  float* Ws = Bs + TILE * NLD;      // TILE x WLD: weights of one head
  float* Xs = Ws + TILE * WLD;      // TILE x P_MAX: x rows of one head
  float* cum = Xs + TILE * P_MAX;   // HB x L

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n_hb = (H + HB - 1) / HB;
  const int n_t = (L + TILE - 1) / TILE;

  if ((int)blockIdx.x < n_y) {
    // ---- y block: (batch, heads hb0 .. hb0 + HB, rows t0 .. t0 + TILE)
    int idx = blockIdx.x;
    const int tt = n_t - 1 - idx % n_t;  // heaviest tiles first
    idx /= n_t;
    const int hb0 = (idx % n_hb) * HB;
    const int bi = idx / n_hb;
    const int t0 = tt * TILE;
    const int t_end = min(L, t0 + TILE);
    const int nh = min(HB, H - hb0);
    const float* xb = x + bi * st.x[0];
    const float* ab = a + bi * st.a[0];
    const float* bb = bm + bi * st.b[0];
    const float* cb = cm + bi * st.c[0];

    if (tid < nh) cumsum_log(cum + tid * L, ab + (hb0 + tid) * st.a[2], st.a[1], t_end);
    load_rows(Cs, cb, st.c[1], t0, L, N);
    __syncthreads();

    float acc[HB][4][4] = {};
    // inter-chunk term: (c_t . h_in) exp(cum_t)
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      if (hh >= nh) break;
      const float* hb = h_in + bi * st.h[0] + (hb0 + hh) * st.h[1];
      for (int e = tid; e < N * P; e += THREADS) {
        const int n = e / P, p = e - n * P;
        Bs[n * P_MAX + p] = hb[n * st.h[2] + p];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          float s = 0.f;
          if (p < P)
            for (int n = 0; n < N; ++n) s = fmaf(Cs[t * NLD + n], Bs[n * P_MAX + p], s);
          acc[hh][i][j] = t0 + t < t_end ? s * expf(cum[hh * L + t0 + t]) : 0.f;
        }
      }
      __syncthreads();
    }

    // intra-chunk term over the s tiles at or below the t tile
    for (int s0 = 0; s0 <= t0; s0 += TILE) {
      load_rows(Bs, bb, st.b[1], s0, L, N);
      __syncthreads();
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * NLD + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * NLD + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
      }
      const int n_s = min(TILE, L - s0);
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) {
        if (hh >= nh) break;
        const float* ch = cum + hh * L;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            Ws[(ty + 16 * i) * WLD + tx + 16 * j] =
                (s <= t && t < t_end) ? sc[i][j] * expf(ch[t] - ch[s]) : 0.f;
          }
        }
        const float* xh = xb + (hb0 + hh) * st.x[2];
        for (int e = tid; e < TILE * P; e += THREADS) {
          const int r = e / P, p = e - r * P;
          Xs[r * P_MAX + p] = s0 + r < L ? xh[(long long)(s0 + r) * st.x[1] + p] : 0.f;
        }
        __syncthreads();
        for (int s = 0; s < n_s; ++s) {
          float xv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = Xs[s * P_MAX + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float w = Ws[(ty + 16 * i) * WLD + s];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[hh][i][j] = fmaf(w, xv[j], acc[hh][i][j]);
          }
        }
        __syncthreads();  // Ws and Xs are rewritten for the next head
      }
    }

#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      if (hh >= nh) break;
      float* yh = y + bi * st.y[0] + (hb0 + hh) * st.y[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t >= t_end) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) yh[(long long)t * st.y[1] + p] = acc[hh][i][j];
        }
      }
    }
    return;
  }

  // ---- h block: (batch, head), the whole (N, P) state
  const int idx = blockIdx.x - n_y;
  const int h = idx % H;
  const int bi = idx / H;
  const float* xh = x + bi * st.x[0] + h * st.x[2];
  const float* bb = bm + bi * st.b[0];
  if (tid == 0) cumsum_log(cum, a + bi * st.a[0] + h * st.a[2], st.a[1], L);
  __syncthreads();
  const float tot = cum[L - 1];

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int s0 = 0; s0 < L; s0 += TILE) {
    __syncthreads();  // the previous tile is no longer read
    load_rows(Bs, bb, st.b[1], s0, L, N);
    for (int e = tid; e < TILE * P; e += THREADS) {
      const int r = e / P, p = e - r * P;
      Xs[r * P_MAX + p] =
          s0 + r < L ? xh[(long long)(s0 + r) * st.x[1] + p] * expf(tot - cum[s0 + r]) : 0.f;
    }
    __syncthreads();
    const int n_s = min(TILE, L - s0);
    for (int s = 0; s < n_s; ++s) {
      float xv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = Xs[s * P_MAX + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float bv = Bs[s * NLD + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bv, xv[j], acc[i][j]);
      }
    }
  }
  const float decay = expf(tot);
  const float* hi = h_in + bi * st.h[0] + h * st.h[1];
  float* ho = h_out + bi * st.ho[0] + h * st.ho[1];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tx + 16 * j;
      if (p < P) ho[n * st.ho[2] + p] = decay * hi[n * st.h[2] + p] + acc[i][j];
    }
  }
}

}  // namespace

namespace mma3 {

constexpr int T = 64;             // rows of a tile: t, s or n
constexpr int L_MAX = 256;        // chunk rows the instance holds
constexpr int P_MAX = 64;         // head dim held by the tiles
constexpr int N_MAX = 128;        // state dim held by the tiles
constexpr int G = 8;              // heads per y block
constexpr int THREADS = 256;      // 8 warps
constexpr int STAGES = 3;         // tiles in the ring
constexpr int CP = N_MAX + 4;     // 132: c and b rows, k = n contiguous
constexpr int SP = L_MAX + 4;     // 260: the band of c b^T, k = s contiguous
constexpr int XP = P_MAX + 8;     // 72: x and h_in rows, p contiguous
constexpr int BP = N_MAX + 8;     // 136: b rows as the A of b^T x, n contiguous
constexpr int CUMP = L_MAX + 4;   // cum of one head (heads on distinct banks)
constexpr int Y_STAGE = 2 * T * XP;          // two heads' x or h_in tiles, or a b tile
constexpr int H_STAGE = T * BP + T * XP;     // a b tile and an x tile
constexpr int Y_FLOATS = T * CP + T * SP + STAGES * Y_STAGE + G * CUMP;
constexpr int H_FLOATS = STAGES * H_STAGE + CUMP + L_MAX;
constexpr int SMEM_BYTES = 4 * (Y_FLOATS > H_FLOATS ? Y_FLOATS : H_FLOATS);

static_assert(T * CP <= Y_STAGE, "a b tile fits a y stage");
static_assert(SMEM_BYTES <= 232448, "a block fits an SM's shared memory");
static_assert(THREADS == 256 && T == 64 && P_MAX == 64 && N_MAX == 128 && L_MAX == 256 && G == 8,
              "the warp layouts below assume these sizes");

// 16 bytes global -> shared: `nbytes` (0, 4, 8, 12 or 16) read, the rest
// zero-filled (0: `src` is not read).
__device__ __forceinline__ void copy16(float* dst, const float* src, int nbytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(ring128::smem_addr(dst)),
               "l"(src), "r"(nbytes)
               : "memory");
}

// Rows [r0, r0 + T) (read below rlim) and columns [0, W) (read below ncols)
// of a matrix with row stride ld into a tile of pitch `pitch`, zero elsewhere.
template <int W>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const float* __restrict__ src,
                                          long long ld, int r0, int rlim, int ncols) {
  constexpr int GR = W / 4;  // granules of 4 floats per row
#pragma unroll
  for (int i = 0; i < T * GR / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / GR, col = e % GR * 4;
    const int n = r0 + r < rlim ? 4 * max(0, min(4, ncols - col)) : 0;
    copy16(dst + r * pitch + col, n ? src + (long long)(r0 + r) * ld + col : src, n);
  }
}

// cvt.rna.tf32.f32 by two integer ops, bit for bit: half of the 13 dropped
// bits added to the magnitude, then the 13 bits cleared (ties away from
// zero).  The cvt instruction issues on a slower pipe than these two.
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// u = hi + lo in TF32 parts: hi = rna(u), lo = rna(u - hi).
__device__ __forceinline__ void split(float u, uint32_t& hi, uint32_t& lo) {
  hi = tf32(u);
  lo = tf32(u - __uint_as_float(hi));
}

// The A fragment (rows g, g + 8 at column q, then at column q + 4) in parts.
struct AFrag {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ AFrag(float a0, float a1, float a2, float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b for one k-step, the B fragment (b0 = B[q][g], b1 = B[q + 4][g])
// split here: a_lo b_hi, then a_hi b_lo, then a_hi b_hi, summed from zero on
// the tensor cores and added to d with f32 adds: the tensor cores round
// their sums toward zero (see the note at the top), so d carried through
// them would lose up to an ulp of itself a k-step, always downward.
__device__ __forceinline__ void mma3(float (&d)[4], const AFrag& a, float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  mma(s, a.lo, h0, h1);
  mma(s, a.hi, l0, l1);
  mma(s, a.hi, h0, h1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += s[i];
}

// cum[hh * CUMP + t] of heads h0 + hh < h0 + nh over rows t < t_end: the logs
// in parallel, then each head's sums in row order by one thread (the simt
// instance's order); rows [t_end, t_pad) repeat cum[t_end - 1].  Ends before
// the sums are published: the caller's next barrier does that.
__device__ __forceinline__ void cum_rows(float* cum, const Args& p, int bi, int h0, int nh,
                                         int t_end, int t_pad) {
  const float* ab = p.a + bi * p.st.a[0] + h0 * p.st.a[2];
  for (int e = threadIdx.x; e < t_end * nh; e += THREADS) {
    const int t = e / nh, hh = e - t * nh;
    cum[hh * CUMP + t] = logf(fmaxf(ab[t * p.st.a[1] + hh * p.st.a[2]], 1e-20f));
  }
  __syncthreads();
  if ((int)threadIdx.x < nh) {
    float* cr = cum + threadIdx.x * CUMP;
    float acc = 0.f;
    int t = 0;
    // four rows a load and a store (CUMP and the cum base are multiples of
    // 4 floats), so the chain is the additions alone
#pragma unroll 4
    for (; t + 4 <= t_end; t += 4) {
      float4 v = *reinterpret_cast<const float4*>(cr + t);
      v.x = acc += v.x;
      v.y = acc += v.y;
      v.z = acc += v.z;
      v.w = acc += v.w;
      *reinterpret_cast<float4*>(cr + t) = v;
    }
    for (; t < t_end; ++t) cr[t] = acc += cr[t];
    for (; t < t_pad; ++t) cr[t] = acc;
  }
}

// The band's 64 x 64 tile S[t][s] = c_t . b_s for one s tile (bt: b rows,
// pitch CP) into Sd (pitch SP).  Warp (wr, wc): rows 16 wr .., columns
// 32 wc .. (4 n-tiles); k = n.
__device__ __forceinline__ void band_step(const float* Cs, const float* bt, float* Sd, int N,
                                          int wr, int wc, int g, int q) {
  float acc[4][4] = {};
  const float* ca = Cs + (16 * wr + g) * CP + q;
  const float* ba = bt + (32 * wc + g) * CP + q;
  const int n_ks = (N + 7) / 8;
  for (int ks = 0; ks < n_ks; ++ks) {
    const int k0 = 8 * ks;
    const AFrag a(ca[k0], ca[8 * CP + k0], ca[k0 + 4], ca[8 * CP + k0 + 4]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma3(acc[nt], a, ba[8 * nt * CP + k0], ba[8 * nt * CP + k0 + 4]);
  }
  float* d = Sd + (16 * wr + g) * SP + 32 * wc + 2 * q;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    d[8 * nt] = acc[nt][0];
    d[8 * nt + 1] = acc[nt][1];
    d[8 * SP + 8 * nt] = acc[nt][2];
    d[8 * SP + 8 * nt + 1] = acc[nt][3];
  }
}

// acc += c[:, k] h_in[k, :] over n_ks k-steps of one h_in tile (ht: rows n,
// pitch XP); ca: this thread's c row ta at the tile's first column, + q.
__device__ __forceinline__ void inter_step(float (&acc)[8][4], const float* ca, const float* ht,
                                           int n_ks, int g, int q) {
  for (int ks = 0; ks < n_ks; ++ks) {
    const int k0 = 8 * ks;
    const AFrag a(ca[k0], ca[8 * CP + k0], ca[k0 + 4], ca[8 * CP + k0 + 4]);
    const float* bp = ht + (k0 + q) * XP + g;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma3(acc[nt], a, bp[8 * nt], bp[4 * XP + 8 * nt]);
  }
}

// acc += w x over n_ks k-steps of one s tile (xt: rows s, pitch XP), with
// w[t][s] = S[t][s] expf(cum_t - cum_s), zero where s > t on the diagonal
// tile, formed in f32 in the A fragment.  sa: the band at row ta and the
// tile's first column, + q; cs: cum at the tile's first row; ta: this
// thread's first row within the t tile (the diagonal tile's s start at t0).
__device__ __forceinline__ void intra_step(float (&acc)[8][4], const float* sa, const float* cs,
                                           float cta, float ctb, const float* xt, int n_ks,
                                           bool diag, int ta, int g, int q) {
  for (int ks = 0; ks < n_ks; ++ks) {
    const int k0 = 8 * ks, s = k0 + q;
    const float c0 = cs[s], c1 = cs[s + 4];
    float w0 = sa[k0] * expf(cta - c0), w1 = sa[8 * SP + k0] * expf(ctb - c0);
    float w2 = sa[k0 + 4] * expf(cta - c1), w3 = sa[8 * SP + k0 + 4] * expf(ctb - c1);
    if (diag) {
      w0 = s <= ta ? w0 : 0.f;
      w1 = s <= ta + 8 ? w1 : 0.f;
      w2 = s + 4 <= ta ? w2 : 0.f;
      w3 = s + 4 <= ta + 8 ? w3 : 0.f;
    }
    const AFrag a(w0, w1, w2, w3);
    const float* bp = xt + s * XP + g;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma3(acc[nt], a, bp[8 * nt], bp[4 * XP + 8 * nt]);
  }
}

// y block: rows t0 .. t0 + 63 of heads h0 .. h0 + 7 of batch bi.
__device__ __forceinline__ void y_role(const Args& p, float* smem, int idx) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const int n_t = (p.L + T - 1) / T, per_t = p.B * p.n_hg;
  const int tt = n_t - 1 - idx / per_t;  // heaviest tiles first
  const int bi = idx % per_t / p.n_hg, h0 = idx % p.n_hg * G;
  const int t0 = tt * T, t_end = min(p.L, t0 + T), nh = min(G, p.H - h0);
  const int nb = tt + 1;        // band steps: the s tiles 0 .. tt
  const int per_pair = 2 + nb;  // a pair of heads: h_in's two halves, then x's s tiles
  const int n_steps = nb + (nh + 1) / 2 * per_pair;
  const Strides& st = p.st;
  float* Cs = smem;                        // T x CP: c rows of the t tile
  float* Ss = Cs + T * CP;                 // T x SP: the band of c b^T
  float* ring = Ss + T * SP;               // STAGES x Y_STAGE
  float* cum = ring + STAGES * Y_STAGE;    // G x CUMP

  auto issue = [&](int step) {
    if (step >= n_steps) return;
    float* dst = ring + step % STAGES * Y_STAGE;
    if (step < nb) {
      load_tile<N_MAX>(dst, CP, p.b + bi * st.b[0], st.b[1], step * T, p.L, p.N);
      return;
    }
    const int pair = (step - nb) / per_pair, j = (step - nb) % per_pair;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int h = h0 + 2 * pair + e;
      if (2 * pair + e >= nh) break;
      if (j < 2)
        load_tile<P_MAX>(dst + e * T * XP, XP, p.h_in + bi * st.h[0] + h * st.h[1], st.h[2],
                         j * T, p.N, p.P);
      else
        load_tile<P_MAX>(dst + e * T * XP, XP, p.x + bi * st.x[0] + h * st.x[2], st.x[1],
                         (j - 2) * T, p.L, p.P);
    }
  };

  load_tile<N_MAX>(Cs, CP, p.c + bi * st.c[0], st.c[1], t0, p.L, p.N);
  issue(0);
  ring128::copy_commit();
  issue(1);
  ring128::copy_commit();
  cum_rows(cum, p, bi, h0, nh, t_end, t0 + T);

  const int e = warp >> 2, r = warp & 3;  // pair steps: head 2 pair + e, rows 16 r ..
  const int ta = 16 * r + g;              // this thread's rows ta and ta + 8 of the tile
  float acc[8][4];
  for (int step = 0; step < n_steps; ++step) {
    ring128::copy_wait<STAGES - 2>();
    __syncthreads();  // the step's tiles landed; the stage issue() refills is free
    issue(step + STAGES - 1);
    ring128::copy_commit();
    const float* tile = ring + step % STAGES * Y_STAGE;
    if (step < nb) {
      band_step(Cs, tile, Ss + step * T, p.N, warp & 3, warp >> 2, g, q);
      continue;
    }
    const int pair = (step - nb) / per_pair, j = (step - nb) % per_pair;
    const int hh = 2 * pair + e;
    if (j == 0) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    }
    if (hh >= nh) continue;
    const float* xt = tile + e * T * XP;
    const float* cr = cum + hh * CUMP;
    if (j < 2) {
      inter_step(acc, Cs + ta * CP + j * T + q, xt, min(8, (p.N - j * T + 7) / 8), g, q);
      if (j == 1) {
        const float ea = expf(cr[t0 + ta]), eb = expf(cr[t0 + ta + 8]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          acc[nt][0] *= ea;
          acc[nt][1] *= ea;
          acc[nt][2] *= eb;
          acc[nt][3] *= eb;
        }
      }
      continue;
    }
    const int s0 = (j - 2) * T;
    const bool diag = j - 2 == tt;
    intra_step(acc, Ss + ta * SP + s0 + q, cr + s0, cr[t0 + ta], cr[t0 + ta + 8], xt,
               diag ? 2 * r + 2 : 8, diag, ta, g, q);
    if (j < per_pair - 1) continue;
    float* yh = p.y + bi * st.y[0] + (h0 + hh) * st.y[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + ta + 8 * half;
      if (t >= t_end) continue;
      float* row = yh + t * st.y[1];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = 8 * nt + 2 * q;
        if (col < p.P) row[col] = acc[nt][2 * half];
        if (col + 1 < p.P) row[col + 1] = acc[nt][2 * half + 1];
      }
    }
  }
}

// h block: the (N, P) state of head h of batch bi.
__device__ __forceinline__ void h_role(const Args& p, float* smem, int idx) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const int h = idx % p.H, bi = idx / p.H;
  const int n_s = (p.L + T - 1) / T;
  const Strides& st = p.st;
  float* ring = smem;                      // STAGES x H_STAGE
  float* cum = ring + STAGES * H_STAGE;    // CUMP
  float* rem = cum + CUMP;                 // L_MAX: exp(cum_end - cum_s), 0 past len
  const float* bb = p.b + bi * st.b[0];
  const float* xh = p.x + bi * st.x[0] + h * st.x[2];

  auto issue = [&](int step) {
    if (step >= n_s) return;
    float* dst = ring + step % STAGES * H_STAGE;
    load_tile<N_MAX>(dst, BP, bb, st.b[1], step * T, p.L, p.N);
    load_tile<P_MAX>(dst + T * BP, XP, xh, st.x[1], step * T, p.L, p.P);
  };

  issue(0);
  ring128::copy_commit();
  issue(1);
  ring128::copy_commit();
  cum_rows(cum, p, bi, h, 1, p.L, p.L);
  __syncthreads();
  const float tot = cum[p.L - 1];
  for (int s = threadIdx.x; s < n_s * T; s += THREADS) rem[s] = s < p.L ? expf(tot - cum[s]) : 0.f;

  const int n0 = 16 * warp;  // this warp's state rows n0 + g and n0 + g + 8
  float acc[8][4] = {};
  for (int step = 0; step < n_s; ++step) {
    ring128::copy_wait<STAGES - 2>();
    __syncthreads();  // the step's tiles (and rem) landed; the stage issue() refills is free
    issue(step + STAGES - 1);
    ring128::copy_commit();
    if (n0 >= p.N) continue;
    const float* bt = ring + step % STAGES * H_STAGE;
    const float* xt = bt + T * BP;
    const float* rs = rem + step * T;
    for (int ks = 0; ks < 8; ++ks) {
      const int s = 8 * ks + q;
      // A[n][s] = b[s][n]: rows n0 + g, n0 + g + 8 at columns s, s + 4
      const float* ap = bt + s * BP + n0 + g;
      const AFrag a(ap[0], ap[8], ap[4 * BP], ap[4 * BP + 8]);
      const float r0 = rs[s], r1 = rs[s + 4];
      const float* bp = xt + s * XP + g;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mma3(acc[nt], a, bp[8 * nt] * r0, bp[4 * XP + 8 * nt] * r1);
    }
  }
  if (n0 >= p.N) return;
  const float decay = expf(tot);
  const float* hi = p.h_in + bi * st.h[0] + h * st.h[1];
  float* ho = p.h_out + bi * st.ho[0] + h * st.ho[1];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = n0 + g + 8 * half;
    if (n >= p.N) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = 8 * nt + 2 * q;
      if (col < p.P)
        ho[n * st.ho[2] + col] = decay * hi[n * st.h[2] + col] + acc[nt][2 * half];
      if (col + 1 < p.P)
        ho[n * st.ho[2] + col + 1] = decay * hi[n * st.h[2] + col + 1] + acc[nt][2 * half + 1];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) ssd_chunk_mma_kernel(const Args p) {
  extern __shared__ __align__(16) float ring_smem[];
  if ((int)blockIdx.x < p.n_y)
    y_role(p, ring_smem, blockIdx.x);
  else
    h_role(p, ring_smem, blockIdx.x - p.n_y);
}

// One mma.sync.m16n8k8 tf32 a warp, d = a b + c on tile blockIdx.x: a (16 x
// 8, row-major), b (8 x 8, [k][n]), c and d (16 x 8); the operands' bits go
// to the tensor cores as they are.
__global__ void mma_probe_kernel(const float* a, const float* b, const float* c, float* d) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const float* at = a + 128 * blockIdx.x;
  const float* bt = b + 64 * blockIdx.x;
  const uint32_t af[4] = {__float_as_uint(at[8 * g + q]), __float_as_uint(at[8 * g + 64 + q]),
                          __float_as_uint(at[8 * g + q + 4]),
                          __float_as_uint(at[8 * g + 64 + q + 4])};
  const int o = 128 * blockIdx.x + 8 * g + 2 * q;
  float acc[4] = {c[o], c[o + 1], c[o + 64], c[o + 65]};
  mma(acc, af, __float_as_uint(bt[8 * q + g]), __float_as_uint(bt[8 * q + 32 + g]));
  d[o] = acc[0];
  d[o + 1] = acc[1];
  d[o + 64] = acc[2];
  d[o + 65] = acc[3];
}

}  // namespace mma3

namespace {

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// The mma instance takes every call whose loads cp.async can address and
// whose sizes its tiles hold.
bool mma_instance(const float* x, const float* b, const float* c, const float* h_in,
                  const Strides& st, int L, int P, int N) {
  if (L > mma3::L_MAX || P > mma3::P_MAX || N > mma3::N_MAX) return false;
  if (!aligned16(x) || !aligned16(b) || !aligned16(c) || !aligned16(h_in)) return false;
  const long long copied[] = {st.x[0], st.x[1], st.x[2], st.b[0], st.b[1], st.c[0],
                              st.c[1], st.h[0], st.h[1], st.h[2]};
  for (long long s : copied)
    if (s % 4) return false;
  return true;
}

int launch_mma(const Args& args, cudaStream_t stream) {
  Args p = args;
  p.n_hg = (p.H + mma3::G - 1) / mma3::G;
  const long long n_y = (long long)p.B * ((p.L + mma3::T - 1) / mma3::T) * p.n_hg;
  const long long grid = n_y + (long long)p.B * p.H;
  if (grid > INT_MAX) return cudaErrorInvalidConfiguration;
  p.n_y = static_cast<int>(n_y);
  const cudaError_t err = cudaFuncSetAttribute(
      mma3::ssd_chunk_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, mma3::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  mma3::ssd_chunk_mma_kernel<<<static_cast<int>(grid), mma3::THREADS, mma3::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

int launch_simt(const Args& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(p.L);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long n_y = (long long)p.B * ((p.H + HB - 1) / HB) * ((p.L + TILE - 1) / TILE);
  const long long grid = n_y + (long long)p.B * p.H;
  if (grid > INT_MAX) return cudaErrorInvalidConfiguration;
  ssd_chunk_kernel<<<static_cast<int>(grid), THREADS, smem, stream>>>(
      p.x, p.a, p.b, p.c, p.h_in, p.y, p.h_out, p.st, p.H, p.P, p.N, p.L, static_cast<int>(n_y));
  return cudaGetLastError();
}

}  // namespace

// x (B, L, H, P), a (B, L, H), b and c (B, L, N), h_in and h_out (B, H, N, P),
// y (B, L, H, P), all f32 with a unit stride on the last dim; `strides` holds
// the other strides in elements: x, a, y (batch, row, head); b, c (batch,
// row); h_in, h_out (batch, head, state row).  h_out must not alias h_in.
// Requires B, L, H >= 1 (the wrapper handles empties), P <= 64, N <= 128.
// *mma_out is set to 1 if the mma instance was launched, else 0 (simt).
// Returns cudaGetLastError() right after the launch: 0 means accepted.
extern "C" int ssd_chunk_f32(const float* x, const float* a, const float* b, const float* c,
                             const float* h_in, float* y, float* h_out,
                             const long long* strides, int B, int L, int H, int P, int N,
                             int* mma_out, void* stream) {
  Args p{x, a, b, c, h_in, y, h_out, {}, B, L, H, P, N, 0, 0};
  const long long* s = strides;
  for (int i = 0; i < 3; ++i) p.st.x[i] = *s++;
  for (int i = 0; i < 3; ++i) p.st.a[i] = *s++;
  for (int i = 0; i < 2; ++i) p.st.b[i] = *s++;
  for (int i = 0; i < 2; ++i) p.st.c[i] = *s++;
  for (int i = 0; i < 3; ++i) p.st.h[i] = *s++;
  for (int i = 0; i < 3; ++i) p.st.y[i] = *s++;
  for (int i = 0; i < 3; ++i) p.st.ho[i] = *s++;
  const auto stream_ = static_cast<cudaStream_t>(stream);
  *mma_out = mma_instance(x, b, c, h_in, p.st, L, P, N) ? 1 : 0;
  return *mma_out ? launch_mma(p, stream_) : launch_simt(p, stream_);
}

// The tensor cores' f32 accumulation, for holding it against a model of it
// (tests/test_torch_cuda.py, chip_smoke.py phase 10): d = a b + c through the
// mma instance's one product instruction, per tile of `tiles`, each a (16,
// 8) row-major, b (8, 8) indexed [k][n], c and d (16, 8); a and b hold TF32
// values (their low 13 bits zero).  Returns cudaGetLastError().
extern "C" int ssd_mma_probe(const float* a, const float* b, const float* c, float* d, int tiles,
                             void* stream) {
  if (tiles < 1) return cudaErrorInvalidValue;
  mma3::mma_probe_kernel<<<tiles, 32, 0, static_cast<cudaStream_t>(stream)>>>(a, b, c, d);
  return cudaGetLastError();
}

// Dynamic shared memory of each instance's launch (simt: at chunk length L).
extern "C" int ssd_chunk_mma_smem_bytes() { return mma3::SMEM_BYTES; }
extern "C" int ssd_chunk_simt_smem_bytes(int L) { return (int)(sizeof(float) * smem_floats(L)); }
