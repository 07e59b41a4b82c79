// Rescaled-cosine Gram tiles for NVIDIA Hopper (sm_90a): S = 0.5 + 0.5 * Zq * Zk^T.
//
// Replaces the TPU kernel `similarity_pallas` / `_sim_kernel` in
// src/repro/kernels/similarity/similarity.py.  Same function: fp32
// accumulation, fp32 or bf16 inputs, and both `normalized` branches — with
// normalized == 0 the row L2 normalisation rsqrt(max(sum z^2, 1e-16)) is
// fused (applied to the dot product in the epilogue instead of to the rows
// before it; equal up to fp32 rounding).
//
// Design: one 64x64 output tile per block of 256 threads, a 16-deep k-slab
// staged through shared memory (transposed, k-major), 4x4 outputs per thread
// at rows ty + 16*i and columns tx + 16*j so that the epilogue's stores are
// coalesced.  The kernel masks ragged edges itself (rows, columns and depth),
// so the caller needs no padding copy, and it writes through a row stride
// `ldo`, so a tile can land directly in a larger (padded) output matrix.
//
// No TF32: every product is an IEEE fp32 FMA on the CUDA cores.  The Gram
// feeds greedy argmaxes where near-ties decide the trajectory, so TF32's
// ~3 decimal digits would change which elements are picked.
//
// Bound on this card (H100 SXM): at the main path's tile, 2*2048*5000*768 ~
// 15.7 GFLOP against ~63 MB moved (inputs once, fp32 output once), i.e.
// ~250 FLOP/byte — compute-bound at the published 67 TFLOP/s fp32 peak
// (~0.23 ms).  This first version is simple and right; making it fast
// (3xTF32 on wgmma, TMA-fed pipelines) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;                     // output rows per block
constexpr int BN = 64;                     // output columns per block
constexpr int BK = 16;                     // k-slab depth
constexpr int TM = 4;                      // output rows per thread
constexpr int TN = 4;                      // output columns per thread
constexpr int RS = BM / TM;                // 16: row stride between a thread's outputs
constexpr int CS = BN / TN;                // 16: column stride between a thread's outputs
constexpr int THREADS = RS * CS;           // 256

static_assert(BM * BK == THREADS * 4 && BN * BK == THREADS * 4,
              "the loader moves exactly 4 values of each operand per thread");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
similarity_kernel(const T* __restrict__ zq, const T* __restrict__ zk,
                  float* __restrict__ out, int mq, int mk, int d,
                  long long ldo, int normalized) {
  // +1 column of padding breaks the power-of-two stride of the transposed
  // stores (bank conflicts drop from 4-way to 2-way)
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  __shared__ float inv_q[BM];
  __shared__ float inv_k[BN];

  const int tid = threadIdx.x;
  const int tx = tid % CS;
  const int ty = tid / CS;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  // loader: thread t brings 4 consecutive k values of tile row t / 4
  const int lr = tid / 4;
  const int lk = (tid % 4) * 4;
  const int qr = row0 + lr;
  const int kr = col0 + lr;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  // normalized == 0: threads [0, BM) sum the squares of query row tid,
  // threads [BM, BM + BN) those of key row tid - BM, from the staged slabs
  float ss = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + lk + e;
      As[lk + e][lr] = (qr < mq && k < d) ? to_f32(zq[(long long)qr * d + k]) : 0.f;
      Bs[lk + e][lr] = (kr < mk && k < d) ? to_f32(zk[(long long)kr * d + k]) : 0.f;
    }
    __syncthreads();
    if (!normalized && tid < BM + BN) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float v = tid < BM ? As[kk][tid] : Bs[kk][tid - BM];
        ss = fmaf(v, v, ss);
      }
    }
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

  if (!normalized) {  // uniform across the block, so the barrier is safe
    if (tid < BM) {
      inv_q[tid] = 1.f / sqrtf(fmaxf(ss, 1e-16f));
    } else if (tid < BM + BN) {
      inv_k[tid - BM] = 1.f / sqrtf(fmaxf(ss, 1e-16f));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * RS;
    if (r >= mq) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * CS;
      if (c >= mk) continue;
      float v = acc[i][j];
      if (!normalized) v = v * inv_q[ty + i * RS] * inv_k[tx + j * CS];
      out[(long long)r * ldo + c] = 0.5f + 0.5f * v;
    }
  }
}

template <typename T>
int launch(const void* zq, const void* zk, void* out, int mq, int mk, int d,
           long long ldo, int normalized, void* stream) {
  const dim3 grid((mk + BN - 1) / BN, (mq + BM - 1) / BM);
  similarity_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(zq), static_cast<const T*>(zk),
      static_cast<float*>(out), mq, mk, d, ldo, normalized);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  Inputs are row-major (m, d);
// `out` is row-major with row stride `ldo` >= mk.  Each returns
// cudaGetLastError() right after the launch: 0 means it was accepted.
extern "C" int similarity_f32(const void* zq, const void* zk, void* out, int mq,
                              int mk, int d, long long ldo, int normalized,
                              void* stream) {
  return launch<float>(zq, zk, out, mq, mk, d, ldo, normalized, stream);
}

extern "C" int similarity_bf16(const void* zq, const void* zk, void* out, int mq,
                               int mk, int d, long long ldo, int normalized,
                               void* stream) {
  return launch<__nv_bfloat16>(zq, zk, out, mq, mk, d, ldo, normalized, stream);
}
