// The memory path and register microtile of the rescaled-cosine Gram kernel
// (csrc/similarity.cu, B1), shared with the ring instance of the gram-free
// gains kernel (csrc/fl_gains.cu, B2), so that the two build every
// similarity with the same fmaf chain:
//   * a block of 256 threads computes a 128 x 128 tile (rows of A x rows of
//     B); each thread owns an 8 x 8 register microtile at A rows ty + 16 i
//     and B rows tx + 16 j;
//   * k-slabs of 32 elements of both operands go through a 4-stage ring in
//     dynamic shared memory, filled by cp.async (16-byte copies of 4 fp32,
//     8-byte copies of 4 bf16) that bypass the registers;
//   * a slab keeps the rows' global layout (k contiguous) at a pitch of 36
//     elements, and a thread reads 4 consecutive k of a row at once (LDS.128
//     for fp32, LDS.64 for bf16): per 4 k, 16 loads feed 256 FFMAs.  The
//     threads of one load phase read one row of the A slab (a broadcast) and
//     8 (bf16: 16) consecutive rows of the B slab, which the pitch of 9 load
//     widths spreads over distinct banks;
//   * per pair, one fmaf chain over k in order from 0.f (no TF32, no split
//     over k).  The copies zero-fill rows past the end and k past d, which
//     add fmaf(0, 0, acc) = acc terms only.
// The copies need 4-element granules: d % 4 == 0 and bases aligned to 4
// elements.  Included by .cu files only.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ring128 {

constexpr int BM = 128;                    // A rows per block
constexpr int BN = 128;                    // B rows per block
constexpr int BK = 32;                     // k-slab depth
constexpr int TM = 8;                      // A rows per thread
constexpr int TN = 8;                      // B rows per thread
constexpr int RS = BM / TM;                // 16: stride between a thread's A rows
constexpr int CS = BN / TN;                // 16: stride between a thread's B rows
constexpr int THREADS = RS * CS;           // 256
constexpr int PITCH = BK + 4;              // slab row pitch (elements)
constexpr int STAGES = 4;                  // slabs in the ring
constexpr int GRANULES = BK / 4;           // 4-element copies per slab row
constexpr int STAGE = (BM + BN) * PITCH;   // elements per stage: A slab, then B slab

static_assert(BM * GRANULES == 4 * THREADS && BN * GRANULES == 4 * THREADS,
              "each thread issues 4 copies per operand per slab");

template <typename T>
constexpr int smem_bytes() {
  return STAGES * STAGE * static_cast<int>(sizeof(T));
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

// Slab k0 of A rows [ra, ra + 128) (of ma) and of B rows [rb, rb + 128) (of
// mb) into one stage of the ring.
template <typename T>
__device__ __forceinline__ void load_stage(T* stage, const T* __restrict__ a, int ra, int ma,
                                           const T* __restrict__ b, int rb, int mb, int k0,
                                           int d) {
  load_slab(stage, a, ra, ma, k0, d);
  load_slab(stage + BM * PITCH, b, rb, mb, k0, d);
}

// The FMAs of one stage: acc[i][j] = fmaf(A[ty + 16 i][k], B[tx + 16 j][k],
// acc[i][j]) for the slab's k in order.
template <typename T>
__device__ __forceinline__ void stage_fma(float (&acc)[TM][TN], const T* stage, int tx, int ty) {
  const T* as = stage;
  const T* bs = stage + BM * PITCH;
#pragma unroll
  for (int g = 0; g < BK; g += 4) {
    float4 b[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = load4(bs + (tx + j * CS) * PITCH + g);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 a = load4(as + (ty + i * RS) * PITCH + g);
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

}  // namespace ring128
