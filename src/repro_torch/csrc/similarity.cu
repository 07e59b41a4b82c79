// Rescaled-cosine Gram tiles for NVIDIA Hopper (sm_90a): S = 0.5 + 0.5 * Zq * Zk^T.
//
// Replaces the TPU kernel `similarity_pallas` / `_sim_kernel` in
// src/repro/kernels/similarity/similarity.py.  Same function: fp32
// accumulation, fp32 or bf16 inputs, and both `normalized` branches — with
// normalized == 0 the row L2 normalisation rsqrt(max(sum z^2, 1e-16)) is
// fused (applied to the dot product in the epilogue instead of to the rows
// before it; equal up to fp32 rounding).
//
// Arithmetic: IEEE fp32 only, on the CUDA cores (no TF32).  The Gram feeds
// greedy argmaxes where near-ties decide the trajectory, and the fused
// fl_gains kernels (csrc/fl_gains.cu) build the same similarities in their
// tiles, so every output is one fmaf chain over k in order from 0.f, then
// 0.5f + 0.5f * v; with normalized == 0 the squares are one fmaf(v, v, ss)
// chain in k order, the inverse norm is 1.f / sqrtf(fmaxf(ss, 1e-16f)) and
// v becomes v * inv_q * inv_k before the epilogue.  The bf16 instance
// converts each value exactly to fp32 and runs the same chain.
//
// Bound on this card (H100 SXM): at the main path's tile, 2*2048*5000*768 ~
// 15.7 GFLOP against ~63 MB moved (inputs once, fp32 output once), i.e.
// ~250 FLOP/byte — bound by operations at the 67 TFLOP/s fp32 CUDA-core
// peak (~0.23 ms).  So the design keeps the FMA pipes fed, on the memory
// path and microtile of csrc/tile_ring.cuh (shared with the gram-free gains
// kernel, whose tiles are bit-equal to these rows):
//   * one 128 x 128 output tile per block of 256 threads; each thread owns
//     an 8 x 8 register microtile at rows ty + 16 i and columns tx + 16 j,
//     so a half-warp's epilogue stores are 16 consecutive floats;
//   * k-slabs of 32 elements of both operands go through a 4-stage ring in
//     shared memory, filled by cp.async that bypasses the registers: the
//     next three slabs are in flight while one is computed, behind one
//     barrier per slab; per 4 k, 16 shared-memory loads feed 256 FFMAs;
//   * 147,456 bytes of dynamic shared memory (fp32; 73,728 for bf16), one
//     block per SM: 640 blocks at (2048, 5000), 4.85 waves on 132 SMs.
// The copies zero-fill rows past mq / mk and k past d, so ragged edges add
// fmaf(0, 0, acc) = acc terms only (the result is unchanged); they need
// 4-element granules, i.e. d % 4 == 0 and bases aligned to 4 elements —
// the Python dispatch copies an input that lacks them
// (kernels/similarity/ops.py).  The output goes through the row stride
// `ldo`, so a tile can land directly in a larger (padded) matrix.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_ring.cuh"

namespace {

using namespace ring128;

static_assert(THREADS == BM + BN, "normalized == 0: one thread per row of either slab");

template <typename T, bool NORMALIZED>
__global__ void __launch_bounds__(THREADS, 1)
similarity_kernel(const T* __restrict__ zq, const T* __restrict__ zk,
                  float* __restrict__ out, int mq, int mk, int d, long long ldo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);  // the ring; per stage: Zq slab, then Zk slab
  __shared__ float inv_q[BM];
  __shared__ float inv_k[BN];

  const int tid = threadIdx.x;
  const int tx = tid % CS;
  const int ty = tid / CS;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int nk = (d + BK - 1) / BK;

  // the first STAGES - 1 slabs; a group is committed even when empty, so
  // that group kt always holds slab kt
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(smem + s * STAGE, zq, row0, mq, zk, col0, mk, s * BK, d);
    copy_commit();
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  // normalized == 0: thread t < BM sums the squares of Zq slab row t,
  // thread t >= BM those of Zk slab row t - BM
  float ss = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    copy_wait<STAGES - 2>();  // this thread's copies of slab kt have landed
    __syncthreads();          // everyone's have, and everyone is done with slab kt - 1
    const int next = kt + STAGES - 1;
    if (next < nk)            // refill the stage slab kt - 1 used
      load_stage(smem + (next % STAGES) * STAGE, zq, row0, mq, zk, col0, mk, next * BK, d);
    copy_commit();

    const T* As = smem + (kt % STAGES) * STAGE;
    const T* Bs = As + BM * PITCH;
    if (!NORMALIZED) {
      const T* own = tid < BM ? As + tid * PITCH : Bs + (tid - BM) * PITCH;
#pragma unroll
      for (int g = 0; g < BK; g += 4) {
        const float4 v = load4(own + g);
        ss = fmaf(v.x, v.x, ss);
        ss = fmaf(v.y, v.y, ss);
        ss = fmaf(v.z, v.z, ss);
        ss = fmaf(v.w, v.w, ss);
      }
    }
    stage_fma(acc, As, tx, ty);
  }

  if (!NORMALIZED) {
    const float inv = 1.f / sqrtf(fmaxf(ss, 1e-16f));
    if (tid < BM) {
      inv_q[tid] = inv;
    } else {
      inv_k[tid - BM] = inv;
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
      if (!NORMALIZED) v = v * inv_q[ty + i * RS] * inv_k[tx + j * CS];
      out[(long long)r * ldo + c] = 0.5f + 0.5f * v;
    }
  }
}

template <typename T, bool NORMALIZED>
cudaError_t launch_instance(const T* zq, const T* zk, float* out, int mq, int mk, int d,
                            long long ldo, cudaStream_t stream) {
  auto kernel = similarity_kernel<T, NORMALIZED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes<T>());
  if (err != cudaSuccess) return err;
  const dim3 grid((mk + BN - 1) / BN, (mq + BM - 1) / BM);
  kernel<<<grid, THREADS, smem_bytes<T>(), stream>>>(zq, zk, out, mq, mk, d, ldo);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* zq, const void* zk, void* out, int mq, int mk, int d, long long ldo,
           int normalized, void* stream) {
  const uintptr_t granule = 4 * sizeof(T);
  if (d % 4 || reinterpret_cast<uintptr_t>(zq) % granule ||
      reinterpret_cast<uintptr_t>(zk) % granule)
    return static_cast<int>(cudaErrorInvalidValue);  // the copies cannot address it
  auto q = static_cast<const T*>(zq);
  auto k = static_cast<const T*>(zk);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(normalized ? launch_instance<T, true>(q, k, o, mq, mk, d, ldo, s)
                                     : launch_instance<T, false>(q, k, o, mq, mk, d, ldo, s));
}

}  // namespace

// Plain C entry points (bound with ctypes).  Inputs are row-major (m, d)
// with d % 4 == 0 and bases aligned to 4 elements (else
// cudaErrorInvalidValue, nothing launched); `out` is row-major with row
// stride `ldo` >= mk.  Each returns cudaGetLastError() right after the
// launch: 0 means it was accepted.
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

// Dynamic shared memory of one launch, fp32 (bf16 == 0) or bf16 instance.
extern "C" int similarity_smem_bytes(int bf16) {
  return bf16 ? smem_bytes<__nv_bfloat16>() : smem_bytes<float>();
}
