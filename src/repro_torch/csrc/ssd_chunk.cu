// One Mamba-2 SSD chunk for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ssd_chunk_pallas (body _ssd_kernel) of
// src/repro/kernels/ssd_chunk/ssd_chunk.py.  Per (batch, head), over the
// chunk's rows t, s < len, f32 throughout:
//   cum   = cumsum_t log(max(a_t, 1e-20))
//   y_t   = sum_{s <= t} (c_t . b_s) exp(cum_t - cum_s) x_s  +  (c_t . h_in) exp(cum_t)
//   h_out = exp(cum_end) h_in + sum_s b_s (x_s exp(cum_end - cum_s))^T
// with b and c shared across heads.
//
// Design.  The TPU kernel holds a whole (L, L, heads) decay stack in VMEM
// (~2.6 MB at L = 256, 8 heads); a Hopper block has at most 227 KB, and the
// f32 (L, L) scores alone are 256 KB.  So the work is tiled, in one launch
// with two block roles:
//   * y blocks, one per (batch, block of 4 heads, 64-row t tile): the
//     inter-chunk term from c and h_in first, then a loop over the s tiles
//     at or below the t tile, each building the 64 x 64 tile of c b^T from
//     the N state columns once for the 4 heads, weighting it by
//     exp(cum_t - cum_s) with the s <= t mask, and accumulating it times x;
//   * h blocks, one per (batch, head), own the whole (N, P) state and sum
//     b_s (x_s exp(cum_end - cum_s)) over s in a fixed order.
// No atomics: every output element is summed by one thread in a fixed
// order, so repeated launches are bit-identical.  cum is computed by one
// thread per head, sequentially, redundantly in each block that needs it
// (identical code, identical values).  A ragged last chunk (len < L) is
// masked here: rows past len are neither read nor written, and cum_end is
// cum at row len - 1 — what the reference's padding (a = 1, b = c = x = 0)
// gives — so nothing is padded by the caller.  Inputs are addressed through
// strides (unit stride on the last dim), so chunk slices of the sequence go
// in, and y is written into the whole sequence's output, without copies.
//
// Bounds on this card (H100 SXM, 67 TFLOP/s f32, 3.35 TB/s): one chunk at
// Jamba's shape (L 256, 256 heads of P 64, N 128) needs ~3.2 GFLOP (c b^T,
// the masked (L, L) x (L, P) products per head, the c h_in and b^T x
// products) against ~51 MB moved -> bound by operations (~48 us).  c b^T is
// rebuilt once per block of 4 heads (64 times per chunk), which adds about a
// tenth to the operations.  Tensor cores and a chunk loop inside one launch
// are later work.
#include <cuda_runtime.h>

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

// x (B, L, H, P), a (B, L, H), b and c (B, L, N), h_in and h_out (B, H, N, P),
// y (B, L, H, P), all f32 with a unit stride on the last dim; `strides` holds
// the other strides in elements: x, a, y (batch, row, head); b, c (batch,
// row); h_in, h_out (batch, head, state row).  h_out must not alias h_in.
extern "C" int ssd_chunk_f32(const float* x, const float* a, const float* b, const float* c,
                             const float* h_in, float* y, float* h_out,
                             const long long* strides, int B, int L, int H, int P, int N,
                             void* stream) {
  Strides st;
  const long long* s = strides;
  for (int i = 0; i < 3; ++i) st.x[i] = *s++;
  for (int i = 0; i < 3; ++i) st.a[i] = *s++;
  for (int i = 0; i < 2; ++i) st.b[i] = *s++;
  for (int i = 0; i < 2; ++i) st.c[i] = *s++;
  for (int i = 0; i < 3; ++i) st.h[i] = *s++;
  for (int i = 0; i < 3; ++i) st.y[i] = *s++;
  for (int i = 0; i < 3; ++i) st.ho[i] = *s++;
  const size_t smem = sizeof(float) * smem_floats(L);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_y = B * ((H + HB - 1) / HB) * ((L + TILE - 1) / TILE);
  const int grid = n_y + B * H;
  ssd_chunk_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, a, b, c, h_in, y, h_out, st, H, P, N, L, n_y);
  return cudaGetLastError();
}
