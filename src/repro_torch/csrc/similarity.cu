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
// peak (~0.23 ms).  So the design keeps the FMA pipes fed:
//   * one 128 x 128 output tile per block of 256 threads; each thread owns
//     an 8 x 8 register microtile at rows ty + 16 i and columns tx + 16 j,
//     so a half-warp's epilogue stores are 16 consecutive floats;
//   * k-slabs of 32 elements of both operands go through a 4-stage ring in
//     shared memory, filled by cp.async (16-byte copies of 4 fp32, 8-byte
//     copies of 4 bf16) that bypass the registers: the next three slabs are
//     in flight while one is computed, behind one barrier per slab;
//   * a slab keeps the rows' global layout (k contiguous) at a pitch of 36
//     elements, and a thread reads 4 consecutive k of a row at once
//     (LDS.128 for fp32, LDS.64 for bf16): per 4 k, 16 loads feed 256
//     FFMAs.  The threads of one load phase read one row of the Zq slab
//     (a broadcast) and 8 (bf16: 16) consecutive rows of the Zk slab, which
//     the pitch of 9 load widths spreads over distinct banks;
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

namespace {

constexpr int BM = 128;                    // output rows per block
constexpr int BN = 128;                    // output columns per block
constexpr int BK = 32;                     // k-slab depth
constexpr int TM = 8;                      // output rows per thread
constexpr int TN = 8;                      // output columns per thread
constexpr int RS = BM / TM;                // 16: row stride between a thread's outputs
constexpr int CS = BN / TN;                // 16: column stride between a thread's outputs
constexpr int THREADS = RS * CS;           // 256
constexpr int PITCH = BK + 4;              // slab row pitch (elements)
constexpr int STAGES = 4;                  // slabs in the ring
constexpr int GRANULES = BK / 4;           // 4-element copies per slab row

static_assert(THREADS == BM + BN, "normalized == 0: one thread per row of either slab");
static_assert(BM * GRANULES == 4 * THREADS && BN * GRANULES == 4 * THREADS,
              "each thread issues 4 copies per operand per slab");

template <typename T>
constexpr int smem_bytes() {
  return STAGES * (BM + BN) * PITCH * static_cast<int>(sizeof(T));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 elements global -> shared without the registers; zero-filled when !valid
// (src-size 0: `src` is not read).
__device__ __forceinline__ void copy4(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void copy4(uint32_t dst, const __nv_bfloat16* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 consecutive elements of a slab row, as fp32 (bf16 -> fp32 is exact:
// the bf16 bits are the upper half of the float).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Rows [r0, r0 + 128) and k in [k0, k0 + BK) of a row-major (m, d) matrix
// into the slab at `dst`.
template <typename T>
__device__ __forceinline__ void load_slab(T* dst, const T* __restrict__ src, int r0, int m,
                                          int k0, int d) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int e = threadIdx.x + q * THREADS;
    const int r = e / GRANULES;
    const int g = (e % GRANULES) * 4;
    const bool ok = r0 + r < m && k0 + g < d;
    copy4(smem_addr(dst + r * PITCH + g), ok ? src + (long long)(r0 + r) * d + k0 + g : src,
          ok);
  }
}

template <typename T, bool NORMALIZED>
__global__ void __launch_bounds__(THREADS, 1)
similarity_kernel(const T* __restrict__ zq, const T* __restrict__ zk,
                  float* __restrict__ out, int mq, int mk, int d, long long ldo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);  // per stage: Zq slab, then Zk slab
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
    if (s < nk) {
      T* a = ring + s * (BM + BN) * PITCH;
      load_slab(a, zq, row0, mq, s * BK, d);
      load_slab(a + BM * PITCH, zk, col0, mk, s * BK, d);
    }
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
    if (next < nk) {          // refill the stage slab kt - 1 used
      T* a = ring + (next % STAGES) * (BM + BN) * PITCH;
      load_slab(a, zq, row0, mq, next * BK, d);
      load_slab(a + BM * PITCH, zk, col0, mk, next * BK, d);
    }
    copy_commit();

    const T* As = ring + (kt % STAGES) * (BM + BN) * PITCH;
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
#pragma unroll
    for (int g = 0; g < BK; g += 4) {
      float4 b[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = load4(Bs + (tx + j * CS) * PITCH + g);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 a = load4(As + (ty + i * RS) * PITCH + g);
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
      }
    }
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
