// Causal GQA flash attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_pallas (body _flash_kernel) of
// src/repro/kernels/flash_attention/flash_attention.py:
//   s = (q k^T) * scale, masked to -1e30 where key >= Sk or, if causal,
//   key > row + causal_offset; online softmax with running max m,
//   denominator l and output acc in f32; out = acc / max(l, 1e-30) in q's
//   dtype.  Query head h reads kv head h / group: K and V are never repeated.
//
// Design.  One block per (64-row query tile, batch * query head).  The TPU
// kernel's sequential kv grid axis becomes a loop inside the block, so
// nothing carries over between blocks.  Each step stages a 64-key tile of
// K in shared memory, forms the 64 x 64 scores (4 x 4 per thread), updates
// the row statistics (a row's 16 threads share it through half-warp
// shuffles), writes p to shared memory, then stages the V tile in the same
// buffer and accumulates p v (4 rows x 8 head-dim columns per thread).
// Key tiles wholly above the causal diagonal for every row of the query
// tile are skipped: key 0 is valid for every row when causal_offset >= 0,
// so a skipped tile would add p = exp(-1e30 - m) = 0 and scale by
// exp(m - m) = 1 — the result is the same.  Ragged query rows, keys and
// head dims (D <= 128) are masked here; q, k, v and o are addressed through
// strides (unit stride on D), so the model's (B, S, H, D) activations need
// no transpose copy.
//
// Arithmetic: all f32 on the CUDA cores.  Products are d-ordered FMAs from
// 0, scaled after the product as the TPU kernel does; p stays f32 for p v
// (a bf16 p would round where the reference does not).  expf, not __expf.
//
// Bounds on this card (H100 SXM, 989 TFLOP/s bf16 on the tensor cores,
// 67 TFLOP/s f32 on the CUDA cores, 3.35 TB/s): causal prefill at S = 2048,
// 32 query heads of 128 does 4 * Hq * D * S (S + 1) / 2 = 34.4 GFLOP
// against 37.7 MB of q, k, v and o -> bound by operations (34.8 us at the
// bf16 rate).  This version runs on the CUDA cores at f32 and is far from
// that bound; tensor cores (wgmma on bf16 q k^T, which is exact in f32
// accumulation) and TMA-fed pipelines are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BKV = 64;           // keys per step
constexpr int D_MAX = 128;        // head dim held by the tiles
constexpr int THREADS = 256;
constexpr int TR = BQ / 16;       // 4 rows per thread: ty + 16 i
constexpr int TC = BKV / 16;      // 4 score columns per thread: tx + 16 j
constexpr int TD = D_MAX / 16;    // 8 output columns per thread: tx + 16 j
constexpr int QLD = D_MAX + 1;    // padded row stride of the Q and K/V tiles
constexpr int PLD = BKV + 1;      // padded row stride of the p tile
constexpr float NEG = -1e30f;     // the reference's masked logit
static_assert(BQ == BKV, "load_tile stages BKV rows, the Q tile too");
constexpr size_t SMEM = sizeof(float) * (BQ * QLD + BKV * QLD + BQ * PLD);

struct Strides {
  long long q[3], k[3], v[3], o[3];  // batch, head, row (elements)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Rows [r0, r0 + rows) of a (.., D) matrix at `src` (row stride `ld`) into a
// BKV x QLD f32 tile; rows past `n` and columns past D are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, long long ld,
                                          int r0, int n, int D) {
  for (int e = threadIdx.x; e < BKV * D; e += THREADS) {
    const int r = e / D, c = e - r * D;
    dst[r * QLD + c] = r0 + r < n ? to_f(src[(long long)(r0 + r) * ld + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, Strides st, int Hq, int group, int Sq, int Sk, int D,
             int causal, int offset, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // BQ x QLD
  float* KVs = Qs + BQ * QLD;       // BKV x QLD: K, then V of the same keys
  float* Ps = KVs + BKV * QLD;      // BQ x PLD

  const int tid = threadIdx.x;
  const int tx = tid % 16;          // the 16 threads of a row group are one half-warp
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y % Hq;
  const int hk = h / group;
  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + hk * st.k[1];
  const T* vb = v + b * st.v[0] + hk * st.v[1];
  T* ob = o + b * st.o[0] + h * st.o[1];

  load_tile(Qs, qb, st.q[2], q0, Sq, D);  // BQ == BKV rows
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int kend = causal ? min(Sk, last_row + offset + 1) : Sk;

  float m[TR], l[TR], acc[TR][TD];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += BKV) {
    __syncthreads();  // the previous step is done with V and p
    load_tile(KVs, kb, st.k[2], k0, Sk, D);
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[TR], c[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = Qs[(ty + 16 * i) * QLD + d];
#pragma unroll
      for (int j = 0; j < TC; ++j) c[j] = KVs[(tx + 16 * j) * QLD + d];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < Sk && (!causal || col <= row + offset);
        s[i][j] = ok ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * PLD + tx + 16 * j] = p;
        rs += p;
      }
      // butterfly: every lane of the half-warp ends with the same sum
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // K no longer read; p complete
    load_tile(KVs, vb, st.v[2], k0, Sk, D);
    __syncthreads();

    const int n_keys = min(BKV, Sk - k0);  // V rows past Sk are zero and p there is 0
    for (int c = 0; c < n_keys; ++c) {
      float vv[TD];
#pragma unroll
      for (int j = 0; j < TD; ++j) vv[j] = KVs[c * QLD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float p = Ps[(ty + 16 * i) * PLD + c];
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      const int col = tx + 16 * j;
      if (col < D) put(ob + (long long)row * st.o[2] + col, acc[i][j] / den);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, const long long* strides,
           int B, int Hq, int Hkv, int Sq, int Sk, int D, int causal, int offset, float scale,
           cudaStream_t stream) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  flash_kernel<T><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), st, Hq, Hq / Hkv, Sq, Sk, D, causal, offset, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   const long long* strides, int B, int Hq, int Hkv, int Sq,
                                   int Sk, int D, int causal, int offset, float scale,
                                   void* stream) {
  return launch<float>(q, k, v, o, strides, B, Hq, Hkv, Sq, Sk, D, causal, offset, scale,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    const long long* strides, int B, int Hq, int Hkv, int Sq,
                                    int Sk, int D, int causal, int offset, float scale,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, strides, B, Hq, Hkv, Sq, Sk, D, causal, offset,
                               scale, static_cast<cudaStream_t>(stream));
}
