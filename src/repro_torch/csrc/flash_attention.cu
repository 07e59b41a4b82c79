// Causal GQA flash attention for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_pallas (body _flash_kernel) of
// src/repro/kernels/flash_attention/flash_attention.py:
//   s = (q k^T) * scale, masked to -1e30 where key >= Sk or, if causal,
//   key > row + causal_offset; online softmax with running max m,
//   denominator l and output acc in f32; out = acc / max(l, 1e-30) in q's
//   dtype.  Query head h reads kv head h / group: K and V are never repeated.
//
// Bound on this card (H100 SXM: 989 TFLOP/s bf16 on the tensor cores, 67
// TFLOP/s f32 on the CUDA cores, 3.35 TB/s): causal prefill at S = 2048, 32
// query heads of 128 does 4 * Hq * D * S (S + 1) / 2 = 34.4 GFLOP against
// 37.7 MB of q, k, v and o -> bound by operations, 34.8 us at the bf16 rate.
// So the bf16 instance is built around the tensor cores.
//
// bf16: flash_attention_bf16, a warp-specialised wgmma kernel.
//   * One block per (128 query rows, batch * query head), 384 threads:
//     warpgroups 0 and 1 each own 64 of the rows (wgmma's M) and compute;
//     warpgroup 2 is the producer, one thread of which issues TMA loads.
//     setmaxnreg moves registers from the producer (24) to the consumers
//     (240): a consumer thread holds 64 f32 of s, 64 of the output and
//     2 x 32 registers of packed bf16 pairs of p (its two parts, below).
//     Query tiles run longest first (blockIdx.y counts down the sequence,
//     heads vary fastest) so the causal work balances over the SMs.
//   * Q (128 x D) and a ring of two K/V stages (128 keys x D each) live in
//     shared memory, filled by TMA (cp.async.bulk.tensor, 4-D maps over the
//     strided (D, S, H, B) views, built on the host for each call) and
//     completed on mbarriers: the next key tile loads while this one is
//     computed.  Each row of a tile is split into 64-column panels of 128
//     bytes with the 128-byte swizzle that the wgmma descriptors read.
//     TMA zero-fills boxes past S or D, so ragged lengths and any D < 128
//     are exact (the zero columns add nothing); keys at or past Sk are
//     still masked.
//   * s = q k^T: wgmma m64n128k16, both operands from shared memory (K-major),
//     f32 accumulation.  Each product of two bf16 values is exact in f32, so
//     this is the reference's q.astype(f32) @ k.astype(f32) up to the order
//     of the f32 sum.
//   * o += p v: p goes to the tensor cores as bf16 register operands -- the
//     s accumulator's fragment is the A-register fragment of the next wgmma,
//     pair by pair -- and v is read from shared memory MN-major (the
//     transpose flag).  p is split into two bf16 parts, p_hi = bf16(p) and
//     p_lo = bf16(p - p_hi) (the subtraction is exact in f32), and
//     o += p_hi v + p_lo v in two wgmmas.  One bf16 p (relative error
//     <= 2^-8, bf16's unit roundoff) would move acc / l by up to
//     2^-8 * max|v| -- a flip of the output's last bf16 bit where the output
//     is large (the first rows, which average few keys), 1.6e-2 against the
//     reference on the card; the two parts leave at most 2^-16 * max|v|.
//     That is the only numerical change from the reference, which keeps p
//     in f32; l is summed from the f32 p.
//   * Key tiles wholly above the causal diagonal are not loaded: key 0 is
//     valid for every row when causal_offset >= 0, so such a tile would add
//     p = exp(-1e30 - m) = 0 and scale by exp(m - m) = 1 -- the result is the
//     same.  The same holds for the tile a warpgroup skips when only the
//     other warpgroup's rows reach it.  Only tiles that cross the diagonal or
//     Sk are masked.
//   * No atomics and no split over keys: a launch is deterministic.
//   * Two instances (a template flag): serving, as above; train
//     (flash_attention_bf16_train, the chunked route of models/attention.py
//     under autograd), which rounds p to bf16 once before p v -- the chunked
//     loop's operand, so one wgmma -- and writes, for the backward, each
//     row's log-sum-exp m + log(l) in f32 and the output's bf16 remainder
//     beside the output.  l is summed from the f32 p in both.
//
// bf16 backward: flash_attention_bf16_bwd, three launches on the stream, with
//   no float atomics (every sum in a fixed order: two runs are bit-equal).
//   * delta: D_i = sum_d dO * O over a row from the forward's f32 output (o
//     and its bf16 remainder o_lo, as the chunked loop's autograd has it: where
//     a row's attention is peaked, dP - D is a difference of near-equal terms
//     and bf16 o alone would move it), one warp a row, a fixed shuffle tree.
//   * dK/dV: one block per (batch * kv head, 128-key tile), key tiles with the
//     most work first.  K and V stay in shared memory; the producer streams
//     the group's query heads and, for each, the 64-row query steps from the
//     diagonal down (Q, dO, and the rows' lse and delta by bulk copy) through
//     a ring of three stages.  Each consumer warpgroup owns 64 of the keys:
//     s^T = K Q^T and dP^T = V dO^T (m64n64, both operands from shared
//     memory), p = exp(s - lse) in f32, dV += bf16(p)^T dO (p is the
//     forward's bf16 operand), dS = p (dP - D) in f32, dK += dS^T Q (m64n128,
//     the transposed operand from registers).  dK and dV sum over the group's
//     query heads in the block: K and V are never repeated, and no partial
//     sum leaves the block.
//   * dS goes to the tensor cores in two bf16 parts, as the serving forward
//     feeds p (split_bf16): the chunked loop's autograd keeps dS in f32 for
//     both of its products, and dS = p (dP - D) is a small difference where
//     the attention is near uniform, so its bf16 rounding does not cancel
//     over a weight's gradient (one bf16 dS moved a projection's gradient of
//     a 24-layer model by 6.4% of its norm against f32 attention, on the
//     card).  It costs one more product in each of dK and dQ.
//   * dQ: one block per (128 query rows, batch * query head), as the forward:
//     Q and dO once, the K/V ring; s = Q K^T and dP = dO V^T, p and dS as
//     above, dQ += dS K.  A second pass over the scores instead of a sum of
//     partial dQ across key tiles, which would need atomics or a reduction.
//   Tiles wholly above the causal diagonal are skipped in both, as in the
//   forward.  The two passes make 5 + 4 products of 2 * D FLOP per scored
//   pair (the forward 2): bound by operations on the tensor cores, as the
//   forward is.
//
// f32: flash_attention_f32, the CUDA-core kernel.  An f32 input has no exact
//   tensor-core route (TF32 keeps 10 mantissa bits), so it keeps the design of
//   the first port: one block per (64-row query tile, batch * query head),
//   64-key tiles staged in shared memory as f32, both products as d-ordered
//   FMAs, p kept in f32, expf.  This is a dtype route: a bf16 call never
//   reaches it.
//
// Both address q, k, v and o through strides (unit stride on D), so the
// model's (B, S, H, D) activations need no transpose copy.  The bf16 kernel
// needs what TMA needs -- a 16-byte-aligned base, D % 8 == 0 and row, head
// and batch strides that are multiples of 16 bytes; the Python dispatch
// copies an input that lacks them (kernels/flash_attention/ops.py).
#include <cuda.h>          // CUtensorMap and its enums (types only: no -lcuda)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled, fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;  // the reference's masked logit

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int BQ = 64;            // query rows per block
constexpr int BKV = 64;           // keys per step
constexpr int D_MAX = 128;        // head dim held by the tiles
constexpr int THREADS = 256;
constexpr int TR = BQ / 16;       // 4 rows per thread: ty + 16 i
constexpr int TC = BKV / 16;      // 4 score columns per thread: tx + 16 j
constexpr int TD = D_MAX / 16;    // 8 output columns per thread: tx + 16 j
constexpr int QLD = D_MAX + 1;    // padded row stride of the Q and K/V tiles
constexpr int PLD = BKV + 1;      // padded row stride of the p tile
static_assert(BQ == BKV, "load_tile stages BKV rows, the Q tile too");
constexpr size_t SMEM = sizeof(float) * (BQ * QLD + BKV * QLD + BQ * PLD);

struct Strides {
  long long q[3], k[3], v[3], o[3];  // batch, head, row (elements)
};

// Rows [r0, r0 + rows) of a (.., D) matrix at `src` (row stride `ld`) into a
// BKV x QLD tile; rows past `n` and columns past D are zero.
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, long long ld,
                                          int r0, int n, int D) {
  for (int e = threadIdx.x; e < BKV * D; e += THREADS) {
    const int r = e / D, c = e - r * D;
    dst[r * QLD + c] = r0 + r < n ? src[(long long)(r0 + r) * ld + c] : 0.f;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, Strides st, int Hq,
                 int group, int Sq, int Sk, int D, int causal, int offset, float scale) {
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
  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* kb = k + b * st.k[0] + hk * st.k[1];
  const float* vb = v + b * st.v[0] + hk * st.v[1];
  float* ob = o + b * st.o[0] + h * st.o[1];

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
      if (col < D) ob[(long long)row * st.o[2] + col] = acc[i][j] / den;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the wgmma kernel
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BQ = 128;          // query rows per block: two consumer warpgroups of 64
constexpr int BK = 128;          // keys per tile
constexpr int PANEL = 64;        // head-dim columns per 128-byte swizzled panel
constexpr int ROW_BYTES = 128;   // one panel row
constexpr int STAGES = 2;        // the K/V ring
constexpr int THREADS = 384;     // warpgroups 0, 1 consume, warpgroup 2 produces
constexpr int CONSUMER_WARPS = 8;

// Shared memory: Q panels, then per stage the K panels and the V panels, then
// the mbarriers.  Every panel is 1024-byte aligned (the swizzle repeats every
// 8 rows).  The head dim is held as 128 columns: TMA zero-fills those past D.
constexpr int PANELS = 128 / PANEL;
constexpr int Q_PANEL = BQ * ROW_BYTES;
constexpr int KV_PANEL = BK * ROW_BYTES;
constexpr int Q_BYTES = PANELS * Q_PANEL;
constexpr int K_BYTES = PANELS * KV_PANEL;
constexpr int STAGE_BYTES = 2 * K_BYTES;  // K, then V
constexpr int BARS = Q_BYTES + STAGES * STAGE_BYTES;
constexpr int SMEM_BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled tile: start address, leading and
// stride byte offsets (in 16-byte units), layout type 1 (128-byte swizzle).
// K-major: rows 128 bytes apart, 8-row groups SBO = 1024 bytes apart, LBO
// unused; a 16-column step of K advances the start by 32 bytes.  MN-major
// (v): 8-key groups SBO = 1024 bytes apart, 64-column panels LBO apart.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// `bytes` contiguous bytes (16-byte aligned, a multiple of 16) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}
// Keep the compiler from moving reads or writes of wgmma accumulators across
// the asynchronous instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) as two packed bf16 pairs, hi = bf16(a, b) and lo = bf16 of the
// remainders (exact in f32), so hi + lo = (a, b) to a relative 2^-16.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // .x (the low half) = a
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// d (64 x 128, f32) = a b^T (+ d if accumulate): a (64 x 16) and b (128 x 16)
// in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) = a b^T (+ d if accumulate): a (64 x 16) and b (64 x 16)
// in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32) += a b: a (64 x 16, bf16) in registers, b (16 x 128) in
// shared memory, MN-major (the transpose flag).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The wgmma accumulator fragment of a 64 x N tile: register i of thread
// (warp w, lane) holds row 16 w + lane / 4 + 8 * ((i % 4) / 2), column
// 8 * (i / 4) + 2 * (lane % 4) + i % 2.  Pairs (i, i + 1) of the s fragment,
// packed to bf16, are in order the A-register fragment of the p v wgmma.
// TRAIN: p rounded to bf16 once; each row's lse written (lse_len per batch
// * head), and the output's remainder o_lo = bf16(o_f32 - o) beside o (o's
// strides), so the backward's D reads the f32 output to 2^-16 (neither
// where its pointer is null).
template <bool TRAIN>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                   long long o_b, long long o_h, long long o_s, int Hq, int group, int Sq, int Sk,
                   int D, int causal, int offset, float scale, float* __restrict__ lse,
                   int lse_len, __nv_bfloat16* __restrict__ o_lo) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sKV = base + Q_BYTES;
  const uint32_t bar_q = base + BARS;
  const uint32_t bar_full = bar_q + 8;                // STAGES barriers: a stage has landed
  const uint32_t bar_empty = bar_full + 8 * STAGES;   // STAGES barriers: a stage is free

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest query tiles first
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int kend = causal ? min(Sk, last_row + offset + 1) : Sk;
  const int n_tiles = (kend + BK - 1) / BK;
  const int role = threadIdx.x / 128;                // warpgroup

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (role == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q, Q_BYTES);
#pragma unroll
      for (int p = 0; p < PANELS; ++p)
        tma_load(sQ + p * Q_PANEL, &tq, bar_q, p * PANEL, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(bar_empty + 8 * s, (j / STAGES - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t sK = sKV + s * STAGE_BYTES;
        mbar_expect_tx(full, STAGE_BYTES);
#pragma unroll
        for (int p = 0; p < PANELS; ++p) {
          tma_load(sK + p * KV_PANEL, &tk, full, p * PANEL, j * BK, hk, b);
          tma_load(sK + K_BYTES + p * KV_PANEL, &tv, full, p * PANEL, j * BK, hk, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup `role` owns rows [row0, row0 + 64) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r_lo = (t / 32) * 16 + lane / 4;  // this thread's rows: r_lo and r_lo + 8
    const int c_lo = 2 * (lane % 4);            // its first column in every 8-column block
    const int row0 = q0 + 64 * role;
    const bool active = row0 < Sq;
    const int wend = !active ? 0 : causal ? min(Sk, min(row0 + 64, Sq) + offset) : Sk;
    const uint32_t sQw = sQ + 64 * role * ROW_BYTES;

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // rows r_lo, r_lo + 8 (l: this thread's part)

    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const int k0 = j * BK;
      mbar_wait(bar_full + 8 * s, (j / STAGES) & 1);
      if (k0 < wend) {
        const uint32_t sK = sKV + s * STAGE_BYTES;
        const uint32_t sV = sK + K_BYTES;
        float sc[64];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {  // 16 head-dim columns a step, 4 steps a panel
          const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes into the panel row
          wgmma_ss_n128(sc, make_desc(sQw + (kk / 4) * Q_PANEL + off, 16, 1024),
                        make_desc(sK + (kk / 4) * KV_PANEL + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // scale, mask, row max (a row's four threads are one quad of lanes)
        const bool mask = k0 + BK > Sk || (causal && k0 + BK - 1 > row0 + offset);
        float mx[2] = {NEG, NEG};
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int hi = (i % 4) / 2;
          float x = sc[i] * scale;
          if (mask) {
            const int col = k0 + 8 * (i / 4) + c_lo + i % 2;
            const int row = row0 + r_lo + 8 * hi;
            if (col >= Sk || (causal && col > row + offset)) x = NEG;
          }
          sc[i] = x;
          mx[hi] = fmaxf(mx[hi], x);
        }
        float alpha[2];
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
          mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
          const float m_new = fmaxf(m[hi], mx[hi]);
          alpha[hi] = expf(m[hi] - m_new);
          m[hi] = m_new;
        }
        // p in f32 for l; in two bf16 parts for p v (train: bf16 once)
        uint32_t p_hi[32], p_lo[32];
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 64; i += 2) {
          const int hi = (i % 4) / 2;
          const float p0 = expf(sc[i] - m[hi]);
          const float p1 = expf(sc[i + 1] - m[hi]);
          rs[hi] += p0;
          rs[hi] += p1;
          if constexpr (TRAIN)
            p_hi[i / 2] = bits(__floats2bfloat162_rn(p0, p1));
          else
            split_bf16(p0, p1, p_hi[i / 2], p_lo[i / 2]);
        }
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) l[hi] = alpha[hi] * l[hi] + rs[hi];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i % 4) / 2];

        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t dv = make_desc(sV + kk * 16 * ROW_BYTES, KV_PANEL, 1024);
          const uint32_t a_hi[4] = {p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2],
                                    p_hi[4 * kk + 3]};
          wgmma_rs_n128(acc, a_hi, dv);
          if constexpr (!TRAIN) {
            const uint32_t a_lo[4] = {p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2],
                                      p_lo[4 * kk + 3]};
            wgmma_rs_n128(acc, a_lo, dv);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }
      // this warp is done with the stage (its wgmmas have completed)
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }

    if (active) {
      __nv_bfloat16* ob = o + b * o_b + h * o_h;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
        l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
        l[hi] = fmaxf(l[hi], 1e-30f);
      }
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int hi = (i % 4) / 2;
        const int row = row0 + r_lo + 8 * hi;
        const int col = 8 * (i / 4) + c_lo;
        if (row < Sq && col < D) {
          const long long at = (long long)row * o_s + col;
          if constexpr (TRAIN) {
            uint32_t o_hi2, o_lo2;
            split_bf16(acc[i] / l[hi], acc[i + 1] / l[hi], o_hi2, o_lo2);
            *reinterpret_cast<uint32_t*>(ob + at) = o_hi2;
            if (o_lo) *reinterpret_cast<uint32_t*>(o_lo + b * o_b + h * o_h + at) = o_lo2;
          } else {
            *reinterpret_cast<__nv_bfloat162*>(ob + at) =
                __floats2bfloat162_rn(acc[i] / l[hi], acc[i + 1] / l[hi]);
          }
        }
      }
      if constexpr (TRAIN) {
        if (lse && c_lo == 0) {  // a row's four threads hold the same m and l
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int row = row0 + r_lo + 8 * hi;
            if (row < Sq) lse[(long long)(b * Hq + h) * lse_len + row] = m[hi] + logf(l[hi]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 backward
// ---------------------------------------------------------------------------

constexpr int BQB = 64;                      // query rows per step of the dK/dV kernel
constexpr int QB_PANEL = BQB * ROW_BYTES;    // one 64-row panel
constexpr int QB_BYTES = PANELS * QB_PANEL;  // a 64-row tile of 128 columns
constexpr int B_STAGES = 3;                  // the Q/dO ring of the dK/dV kernel
constexpr int B_STAGE_BYTES = 2 * QB_BYTES;  // Q, then dO
constexpr int VEC_BYTES = 2 * BQB * 4;       // the step's lse, then its delta (f32)
// dK/dV shared memory: K, V, the stages' tiles, their vectors, the mbarriers
constexpr int DKV_BARS = 2 * K_BYTES + B_STAGES * (B_STAGE_BYTES + VEC_BYTES);
constexpr int DKV_SMEM_BYTES = DKV_BARS + 8 * (1 + 2 * B_STAGES) + 1024;
// dQ shared memory: Q, dO, the K/V ring, the mbarriers
constexpr int DQ_BARS = 2 * Q_BYTES + STAGES * STAGE_BYTES;
constexpr int DQ_SMEM_BYTES = DQ_BARS + 8 * (1 + 2 * STAGES) + 1024;

// delta[bh * lse_len + i] = sum_d (o + o_lo)[i, d] * dout[i, d] in f32 for
// i < S (o_lo: o's remainder, o's strides), 0 on the padding rows up to
// lse_len; one warp a row, a fixed butterfly.
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ o_lo,
                       const __nv_bfloat16* __restrict__ dout, long long o_b, long long o_h,
                       long long o_s, long long d_b, long long d_h, long long d_s,
                       float* __restrict__ delta, int Hq, int S, int lse_len, int D,
                       long long rows) {
  const long long r = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long bh = r / lse_len;
  const int i = (int)(r - bh * lse_len);
  const int b = (int)(bh / Hq), h = (int)(bh % Hq);
  float acc = 0.f;
  if (i < S) {
    const long long at = b * o_b + h * o_h + i * o_s;
    const __nv_bfloat16* drow = dout + b * d_b + h * d_h + i * d_s;
    for (int c = 2 * lane; c < D; c += 64) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + at + c));
      const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o_lo + at + c));
      const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(drow + c));
      acc = fmaf(a.x + r.x, g.x, acc);
      acc = fmaf(a.y + r.y, g.y, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

struct GradStrides {
  long long dk[3], dv[3];  // batch, head, row (elements)
};

// dK and dV of one (batch, kv head, 128-key tile); see the file's head.
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse, const float* __restrict__ delta, int lse_len,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                      GradStrides gs, int Hq, int group, int Sq, int Sk, int D, int causal,
                      int offset) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base;
  const uint32_t sV = base + K_BYTES;
  const uint32_t sStage = base + 2 * K_BYTES;
  const uint32_t sVec = sStage + B_STAGES * B_STAGE_BYTES;
  const uint32_t bar_kv = base + DKV_BARS;
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_full + 8 * B_STAGES;

  const int Hkv = Hq / group;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int k0 = blockIdx.y * BK;  // key tiles near the start have the most query rows
  const int nq = (Sq + BQB - 1) / BQB;
  const int i0 = causal ? max(0, (k0 - offset) / BQB) : 0;  // first step that reaches k0
  const int per_head = nq - i0;
  const int n_steps = group * per_head;
  const int role = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (role == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_kv, 2 * K_BYTES);
#pragma unroll
      for (int p = 0; p < PANELS; ++p) {
        tma_load(sK + p * KV_PANEL, &tk, bar_kv, p * PANEL, k0, hk, b);
        tma_load(sV + p * KV_PANEL, &tv, bar_kv, p * PANEL, k0, hk, b);
      }
      for (int n = 0; n < n_steps; ++n) {
        const int h = hk * group + n / per_head;
        const int q0 = (i0 + n % per_head) * BQB;
        const int s = n % B_STAGES;
        if (n >= B_STAGES) mbar_wait(bar_empty + 8 * s, (n / B_STAGES - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t sQs = sStage + s * B_STAGE_BYTES;
        mbar_expect_tx(full, B_STAGE_BYTES + VEC_BYTES);
#pragma unroll
        for (int p = 0; p < PANELS; ++p) {
          tma_load(sQs + p * QB_PANEL, &tq, full, p * PANEL, q0, h, b);
          tma_load(sQs + QB_BYTES + p * QB_PANEL, &tdo, full, p * PANEL, q0, h, b);
        }
        const long long row = (long long)(b * Hq + h) * lse_len + q0;
        bulk_load(sVec + s * VEC_BYTES, lse + row, BQB * 4, full);
        bulk_load(sVec + s * VEC_BYTES + BQB * 4, delta + row, BQB * 4, full);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r_lo = (t / 32) * 16 + lane / 4;  // this thread's keys: r_lo and r_lo + 8
    const int c_lo = 2 * (lane % 4);            // its first query in every 8-column block
    const int kw0 = k0 + 64 * role;             // this warpgroup's 64 keys
    const uint32_t sKw = sK + 64 * role * ROW_BYTES;
    const uint32_t sVw = sV + 64 * role * ROW_BYTES;
    const float* vecs = reinterpret_cast<const float*>(smem_raw + (sVec - raw));

    float dk_acc[64], dv_acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(bar_kv, 0);
    for (int n = 0; n < n_steps; ++n) {
      const int q0 = (i0 + n % per_head) * BQB;
      const int s = n % B_STAGES;
      mbar_wait(bar_full + 8 * s, (n / B_STAGES) & 1);
      // a step whose every query is before this warpgroup's first key adds 0
      if (kw0 < Sk && (!causal || kw0 <= q0 + BQB - 1 + offset)) {
        const uint32_t sQs = sStage + s * B_STAGE_BYTES;
        const uint32_t sdO = sQs + QB_BYTES;
        const float* lse_s = vecs + s * (VEC_BYTES / 4);
        const float* dl_s = lse_s + BQB;
        float pt[32], dp[32];  // s^T (then p^T) and dP^T: rows keys, columns queries
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss_n64(pt, make_desc(sKw + (kk / 4) * KV_PANEL + off, 16, 1024),
                       make_desc(sQs + (kk / 4) * QB_PANEL + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss_n64(dp, make_desc(sVw + (kk / 4) * KV_PANEL + off, 16, 1024),
                       make_desc(sdO + (kk / 4) * QB_PANEL + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(pt);

        // p = exp(s - lse), 0 where masked; bf16 pairs of p^T for dV
        const bool mask = q0 + BQB > Sq || kw0 + 64 > Sk || (causal && kw0 + 63 > q0 + offset);
        uint32_t pb[16];
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int key = kw0 + r_lo + 8 * ((i % 4) / 2);
          const int col = 8 * (i / 4) + c_lo;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = q0 + col + e;
            const bool ok = !mask || (q < Sq && key < Sk && (!causal || key <= q + offset));
            pt[i + e] = ok ? expf(pt[i + e] - lse_s[col + e]) : 0.f;
          }
          pb[i / 2] = bits(__floats2bfloat162_rn(pt[i], pt[i + 1]));
        }
        fence_regs(dv_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQB / 16; ++kk) {
          const uint32_t a[4] = {pb[4 * kk], pb[4 * kk + 1], pb[4 * kk + 2], pb[4 * kk + 3]};
          wgmma_rs_n128(dv_acc, a, make_desc(sdO + kk * 16 * ROW_BYTES, QB_PANEL, 1024));
        }
        wgmma_commit();
        wgmma_wait<1>();  // dP^T has landed (dV may still run)
        fence_regs(dp);

        // dS = p (dP - delta) in two bf16 parts (split_bf16)
        uint32_t ds_hi[16], ds_lo[16];
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int col = 8 * (i / 4) + c_lo;
          split_bf16(pt[i] * (dp[i] - dl_s[col]), pt[i + 1] * (dp[i + 1] - dl_s[col + 1]),
                     ds_hi[i / 2], ds_lo[i / 2]);
        }
        fence_regs(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQB / 16; ++kk) {
          const uint64_t q_desc = make_desc(sQs + kk * 16 * ROW_BYTES, QB_PANEL, 1024);
          const uint32_t a_hi[4] = {ds_hi[4 * kk], ds_hi[4 * kk + 1], ds_hi[4 * kk + 2],
                                    ds_hi[4 * kk + 3]};
          const uint32_t a_lo[4] = {ds_lo[4 * kk], ds_lo[4 * kk + 1], ds_lo[4 * kk + 2],
                                    ds_lo[4 * kk + 3]};
          wgmma_rs_n128(dk_acc, a_hi, q_desc);
          wgmma_rs_n128(dk_acc, a_lo, q_desc);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }

    __nv_bfloat16* dkb = dk + b * gs.dk[0] + hk * gs.dk[1];
    __nv_bfloat16* dvb = dv + b * gs.dv[0] + hk * gs.dv[1];
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int key = kw0 + r_lo + 8 * ((i % 4) / 2);
      const int col = 8 * (i / 4) + c_lo;
      if (key < Sk && col < D) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + (long long)key * gs.dk[2] + col) =
            __floats2bfloat162_rn(dk_acc[i], dk_acc[i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dvb + (long long)key * gs.dv[2] + col) =
            __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
      }
    }
  }
}

// dQ of one (128 query rows, batch * query head); see the file's head.
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, const float* __restrict__ delta, int lse_len,
                    __nv_bfloat16* __restrict__ dq, long long dq_b, long long dq_h, long long dq_s,
                    int Hq, int group, int Sq, int Sk, int D, int causal, int offset) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sdO = base + Q_BYTES;
  const uint32_t sKV = base + 2 * Q_BYTES;
  const uint32_t bar_q = base + DQ_BARS;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest query tiles first
  const int last_row = min(q0 + BQ, Sq) - 1;
  const int kend = causal ? min(Sk, last_row + offset + 1) : Sk;
  const int n_tiles = (kend + BK - 1) / BK;
  const int role = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (role == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q, 2 * Q_BYTES);
#pragma unroll
      for (int p = 0; p < PANELS; ++p) {
        tma_load(sQ + p * Q_PANEL, &tq, bar_q, p * PANEL, q0, h, b);
        tma_load(sdO + p * Q_PANEL, &tdo, bar_q, p * PANEL, q0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(bar_empty + 8 * s, (j / STAGES - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t sK = sKV + s * STAGE_BYTES;
        mbar_expect_tx(full, STAGE_BYTES);
#pragma unroll
        for (int p = 0; p < PANELS; ++p) {
          tma_load(sK + p * KV_PANEL, &tk, full, p * PANEL, j * BK, hk, b);
          tma_load(sK + K_BYTES + p * KV_PANEL, &tv, full, p * PANEL, j * BK, hk, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r_lo = (t / 32) * 16 + lane / 4;
    const int c_lo = 2 * (lane % 4);
    const int row0 = q0 + 64 * role;
    const bool active = row0 < Sq;
    const int wend = !active ? 0 : causal ? min(Sk, min(row0 + 64, Sq) + offset) : Sk;
    const uint32_t sQw = sQ + 64 * role * ROW_BYTES;
    const uint32_t sdOw = sdO + 64 * role * ROW_BYTES;

    float lse_r[2], dl_r[2];  // rows r_lo, r_lo + 8 (0 past Sq: those rows are masked)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = row0 + r_lo + 8 * hi;
      const long long at = (long long)(b * Hq + h) * lse_len + row;
      lse_r[hi] = row < Sq ? lse[at] : 0.f;
      dl_r[hi] = row < Sq ? delta[at] : 0.f;
    }
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const int k0 = j * BK;
      mbar_wait(bar_full + 8 * s, (j / STAGES) & 1);
      if (k0 < wend) {
        const uint32_t sK = sKV + s * STAGE_BYTES;
        const uint32_t sV = sK + K_BYTES;
        float sc[64], dp[64];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss_n128(sc, make_desc(sQw + (kk / 4) * Q_PANEL + off, 16, 1024),
                        make_desc(sK + (kk / 4) * KV_PANEL + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss_n128(dp, make_desc(sdOw + (kk / 4) * Q_PANEL + off, 16, 1024),
                        make_desc(sV + (kk / 4) * KV_PANEL + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sc);

        const bool mask = row0 + 64 > Sq || k0 + BK > Sk || (causal && k0 + BK - 1 > row0 + offset);
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int hi = (i % 4) / 2;
          const int col = k0 + 8 * (i / 4) + c_lo + i % 2;
          const int row = row0 + r_lo + 8 * hi;
          const bool ok = !mask || (row < Sq && col < Sk && (!causal || col <= row + offset));
          sc[i] = ok ? expf(sc[i] - lse_r[hi]) : 0.f;
        }
        wgmma_wait<0>();
        fence_regs(dp);
        // dS = p (dP - delta) in two bf16 parts: the A fragments of dS K
        uint32_t ds_hi[32], ds_lo[32];
#pragma unroll
        for (int i = 0; i < 64; i += 2) {
          const int hi = (i % 4) / 2;
          split_bf16(sc[i] * (dp[i] - dl_r[hi]), sc[i + 1] * (dp[i + 1] - dl_r[hi]),
                     ds_hi[i / 2], ds_lo[i / 2]);
        }
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t k_desc = make_desc(sK + kk * 16 * ROW_BYTES, KV_PANEL, 1024);
          const uint32_t a_hi[4] = {ds_hi[4 * kk], ds_hi[4 * kk + 1], ds_hi[4 * kk + 2],
                                    ds_hi[4 * kk + 3]};
          const uint32_t a_lo[4] = {ds_lo[4 * kk], ds_lo[4 * kk + 1], ds_lo[4 * kk + 2],
                                    ds_lo[4 * kk + 3]};
          wgmma_rs_n128(acc, a_hi, k_desc);
          wgmma_rs_n128(acc, a_lo, k_desc);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }

    if (active) {
      __nv_bfloat16* dqb = dq + b * dq_b + h * dq_h;
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int row = row0 + r_lo + 8 * ((i % 4) / 2);
        const int col = 8 * (i / 4) + c_lo;
        if (row < Sq && col < D)
          *reinterpret_cast<__nv_bfloat162*>(dqb + (long long)row * dq_s + col) =
              __floats2bfloat162_rn(acc[i], acc[i + 1]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 4-D map over a strided (B, H, S, D) bf16 view, dims innermost first
// (D, S, H, B), byte strides (row, head, batch); boxes of 64 columns x `rows`
// rows, 128-byte swizzle, zero fill out of bounds.
bool make_map(CUtensorMap* map, PFN_cuTensorMapEncodeTiled_v12000 encode, const void* ptr,
              const long long* st, int B, int H, int S, int D, int rows = BQ) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {PANEL, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool TRAIN>
cudaError_t launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* o,
                   const long long* so, int B, int Hq, int Hkv, int Sq, int Sk, int D, int causal,
                   int offset, float scale, float* lse, int lse_len, void* o_lo,
                   cudaStream_t stream) {
  static_assert(BQ == BK, "one box shape serves Q, K and V");
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<TRAIN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  flash_wgmma_kernel<TRAIN><<<grid, THREADS, SMEM_BYTES, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), so[0], so[1], so[2], Hq, Hq / Hkv, Sq, Sk, D,
      causal, offset, scale, lse, lse_len, static_cast<__nv_bfloat16*>(o_lo));
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled needs a context current on the calling thread.  The
// train entry points also run on autograd's device thread (the backward, and
// a layer's remat recompute), which may have reached them through cached
// allocations alone, with no runtime call that would have bound one: bind
// the current device's primary context first.
cudaError_t bind_context() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  return err == cudaSuccess ? cudaSetDevice(dev) : err;
}

// delta, then dK/dV, then dQ, on one stream.  st: q, k, v, o, dout, dq, dk,
// dv, each (batch, head, row) in elements.
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* o_lo, const void* dout, const float* lse, float* delta,
                       void* dq, void* dk, void* dv, const long long* st, int B, int Hq, int Hkv,
                       int S, int D, int causal, int lse_len, cudaStream_t stream) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (!encode) return cudaErrorNotSupported;
  cudaError_t err = bind_context();
  if (err != cudaSuccess) return err;
  CUtensorMap mq64, mdo64, mq, mdo, mk, mv;
  if (!make_map(&mq64, encode, q, st, B, Hq, S, D, BQB) ||
      !make_map(&mdo64, encode, dout, st + 12, B, Hq, S, D, BQB) ||
      !make_map(&mq, encode, q, st, B, Hq, S, D) ||
      !make_map(&mdo, encode, dout, st + 12, B, Hq, S, D) ||
      !make_map(&mk, encode, k, st + 3, B, Hkv, S, D) ||
      !make_map(&mv, encode, v, st + 6, B, Hkv, S, D))
    return cudaErrorInvalidValue;
  const int group = Hq / Hkv;
  const long long rows = (long long)B * Hq * lse_len;
  flash_bwd_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(o_lo),
      static_cast<const __nv_bfloat16*>(dout), st[9], st[10], st[11], st[12], st[13], st[14],
      delta, Hq, S, lse_len, D, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DKV_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  GradStrides gs;
  for (int i = 0; i < 3; ++i) {
    gs.dk[i] = st[18 + i];
    gs.dv[i] = st[21 + i];
  }
  flash_bwd_dkdv_kernel<<<dim3(B * Hkv, (S + BK - 1) / BK), THREADS, DKV_SMEM_BYTES, stream>>>(
      mq64, mk, mv, mdo64, lse, delta, lse_len, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), gs, Hq, group, S, S, D, causal, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DQ_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<<<dim3(B * Hq, (S + BQ - 1) / BQ), THREADS, DQ_SMEM_BYTES, stream>>>(
      mq, mk, mv, mdo, lse, delta, lse_len, static_cast<__nv_bfloat16*>(dq), st[15], st[16],
      st[17], Hq, group, S, S, D, causal, 0);
  return cudaGetLastError();
}

}  // namespace wg

int launch_f32(const void* q, const void* k, const void* v, void* o, const long long* strides,
               int B, int Hq, int Hkv, int Sq, int Sk, int D, int causal, int offset, float scale,
               cudaStream_t stream) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaError_t err = cudaFuncSetAttribute(flash_kernel_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  flash_kernel_f32<<<grid, THREADS, SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), st, Hq, Hq / Hkv, Sq, Sk, D, causal, offset, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   const long long* strides, int B, int Hq, int Hkv, int Sq,
                                   int Sk, int D, int causal, int offset, float scale,
                                   void* stream) {
  return launch_f32(q, k, v, o, strides, B, Hq, Hkv, Sq, Sk, D, causal, offset, scale,
                    static_cast<cudaStream_t>(stream));
}

// strides: q, k, v, o, each (batch, head, row) in elements; D <= 128 and a
// multiple of 8; q, k and v 16-byte aligned with strides of 8-element
// multiples (the wrapper checks).  A tensor map cuTensorMapEncodeTiled
// refuses returns cudaErrorInvalidValue; no cuTensorMapEncodeTiled at all,
// cudaErrorNotSupported.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    const long long* strides, int B, int Hq, int Hkv, int Sq,
                                    int Sk, int D, int causal, int offset, float scale,
                                    void* stream) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = wg::encode_fn();
  if (!encode) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!wg::make_map(&mq, encode, q, strides, B, Hq, Sq, D) ||
      !wg::make_map(&mk, encode, k, strides + 3, B, Hkv, Sk, D) ||
      !wg::make_map(&mv, encode, v, strides + 6, B, Hkv, Sk, D))
    return cudaErrorInvalidValue;
  return wg::launch<false>(mq, mk, mv, o, strides + 9, B, Hq, Hkv, Sq, Sk, D, causal, offset,
                           scale, nullptr, 0, nullptr, static_cast<cudaStream_t>(stream));
}

// The train instance of flash_attention_bf16 (self-attention: Sq = Sk = S):
// the same arguments, o_lo (o's remainder, o's shape and strides), and lse
// (B, Hq, lse_len) f32, lse_len >= S, whose rows past S are left as they are.
// Null o_lo and lse (a forward that no backward follows) skip those stores.
extern "C" int flash_attention_bf16_train(const void* q, const void* k, const void* v, void* o,
                                          void* o_lo, void* lse, const long long* strides,
                                          int B, int Hq, int Hkv, int S, int D, int causal,
                                          float scale, int lse_len, void* stream) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = wg::encode_fn();
  if (!encode) return cudaErrorNotSupported;
  const cudaError_t err = wg::bind_context();
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv;
  if (!wg::make_map(&mq, encode, q, strides, B, Hq, S, D) ||
      !wg::make_map(&mk, encode, k, strides + 3, B, Hkv, S, D) ||
      !wg::make_map(&mv, encode, v, strides + 6, B, Hkv, S, D))
    return cudaErrorInvalidValue;
  return wg::launch<true>(mq, mk, mv, o, strides + 9, B, Hq, Hkv, S, S, D, causal, 0, scale,
                          static_cast<float*>(lse), lse_len, o_lo,
                          static_cast<cudaStream_t>(stream));
}

// The backward of flash_attention_bf16_train at scale 1 (the caller scales
// q): dq, dk, dv in bf16 from q, k, v, its outputs o, o_lo (o's strides) and
// lse, and the output's gradient dout.  delta: (B, Hq, lse_len) f32 scratch,
// lse_len a multiple of 128.  strides: q, k, v, o, dout, dq, dk, dv, each
// (batch, head, row) in elements; the bf16 inputs as flash_attention_bf16
// takes them.
extern "C" int flash_attention_bf16_bwd(const void* q, const void* k, const void* v,
                                        const void* o, const void* o_lo, const void* dout,
                                        const void* lse, void* delta, void* dq, void* dk,
                                        void* dv, const long long* strides, int B, int Hq,
                                        int Hkv, int S, int D, int causal, int lse_len,
                                        void* stream) {
  return wg::launch_bwd(q, k, v, o, o_lo, dout, static_cast<const float*>(lse),
                        static_cast<float*>(delta), dq, dk, dv, strides, B, Hq, Hkv, S, D, causal,
                        lse_len, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of the bf16 kernel's launch.
extern "C" int flash_attention_bf16_smem_bytes() { return wg::SMEM_BYTES; }

// Dynamic shared memory of the backward's launches: 0 the dK/dV kernel, 1 dQ.
extern "C" int flash_attention_bf16_bwd_smem_bytes(int which) {
  return which == 0 ? wg::DKV_SMEM_BYTES : wg::DQ_SMEM_BYTES;
}
