// Flash attention forward (K4), route 1: bf16 q, k and v on Hopper's
// tensor cores (sm_90a), fed by TMA.
//
// Replaces the TPU kernel `flash_attention_kernel` (`_kernel`) of
// src/repro/kernels/flash_attention/kernel.py for bf16 inputs: blocked
// online-softmax attention with GQA (query head h reads kv head h*Hkv/H),
// causal and sliding-window masks on global positions (query row i sits at
// q_offset + i, for chunked prefill against a longer kv cache), kv tiles
// skipped when wholly past the causal frontier or outside the window
// (kernel.py:40-44), f32 scores and accumulators, l clamped at 1e-30
// (kernel.py:71). f32 inputs, and bf16 q over an f32 kv cache, take route
// 2 (csrc/flash_attention.cu, f32 on the CUDA cores).
//
// Layout: q [B, H, Sq, dh], k and v [B, Hkv, Skv, dh], each with any
// strides over (b, head, position) that are multiples of 16 bytes, a
// contiguous last axis and a 16-byte aligned base (the wrapper copies a
// tensor that breaks this); the output is contiguous [B, H, Sq, dh] bf16.
// dh is 32, 64, 112 (zamba2-7b) or 128.
//
// Bound. At the largest shape of the serving path (B=4, H=12, Hkv=2,
// S=2048, dh=128, causal) the work is 4*B*H*dh flops for each (q, k) pair
// the masks keep, 51.6 GFLOP, against 58.7 MB of inputs and output: 0.052
// ms at the tensor cores' 989 TFLOP/s (bf16) against 0.018 ms at 3.35
// TB/s. The bound is operations on the tensor cores, so both products run
// there, and the loads stay off the threads that issue them.
//
// Design (FlashAttention-3's shape, without its pingpong scheduling or its
// softmax/product overlap). One block of 384 threads per (128 query rows,
// head, batch row); q tiles run latest first so the long causal rows
// start early. Warpgroup 0 is the producer: one thread loads Q once and
// then K and V tiles of 128 positions through a 2-stage ring in shared
// memory with TMA (4-D tensor maps over (dh, position, head, batch) built
// from the caller's strides, so transposed views and a slice of the KV
// cache load without a copy; the ragged Sq and Skv edges and the columns
// past dh read as zeros). Each stage has a full barrier (TMA's byte count)
// and an empty one (one arrival from each consumer warp). Warpgroups 1
// and 2 each own 64 query rows and take the registers the producer gives
// up (setmaxnreg). For each kv tile: S = Q.K^T by wgmma from shared
// memory (both K-major, 128-byte swizzle); S scaled in f32 and masked in
// registers, only on tiles that straddle the diagonal, the window edge or
// Skv; the online softmax's row max and sum across the 4 threads of a
// row's quad; P rounded to bf16 in registers and used as wgmma's register
// A operand of O += P.V, with V the transposed B operand from shared
// memory. P never goes to shared memory. The epilogue divides by
// max(l, 1e-30) and stores bf16. At dh=112 the tiles are 128 wide in
// shared memory (two 64-element TMA boxes, columns 112-127 zero): Q.K^T
// takes 7 k-steps, P.V computes 128 columns and 112 are stored.
//
// Known difference from the JAX order: kernel.py:48 scales q before the
// product. Here the f32 scores are scaled after it, since q*scale is not
// a bf16 value; the two differ by rounding only. P is rounded to bf16
// before P.V, and l sums the unrounded f32 P.
#include <cuda.h>            // CUtensorMap (the type only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---- Hopper building blocks in inline PTX --------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// arrive once and expect `bytes` more from TMA before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Spin until the phase of parity `parity` has completed. A phase that has
// not completed after 10 s never will (a fault in the pipeline's counts):
// trap, so the launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 10000000000ull) __trap();
}

// ---- TMA ----------------------------------------------------------------

// one box of a 4-D tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma --------------------------------------------------------------

// Shared-memory matrix descriptor of a tile stored in 128-byte swizzle
// atoms (8 rows of 128 bytes, 1024-byte aligned, as TMA's SWIZZLE_128B
// writes them). K-major (K contiguous): sbo = 1024 (the next 8 rows),
// lbo unused; a k-step of 16 bf16 inside the atom adds 32 bytes to the
// address. MN-major (MN contiguous, transposed): lbo = the stride between
// 64-element MN chunks, sbo = 1024 (the next 8 rows along K).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;              // SWIZZLE_128B
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product (CUTLASS's warpgroup_fence_operand)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <uint32_t REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(REGS));
}
template <uint32_t REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

// two f32 as the packed bf16 pair of an A fragment (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The products, f32 += bf16 x bf16 on 64 rows of a warpgroup. The
// accumulator fragment: thread t (warp w, lane l) holds, for each 8-column
// group j, d[4j + 2i + e] = D[16w + l/4 + 8i][8j + 2(l%4) + e].

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B from shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (the bf16
// fragment of the accumulator layout), B from shared memory, N-major
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A from registers (the bf16
// fragment of the accumulator layout), B from shared memory, N-major
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// ---- the kernel ---------------------------------------------------------

constexpr int BQ = 128;           // query rows per block (2 x 64)
constexpr int BK = 128;           // kv positions per tile (wgmma N of S)
constexpr int STAGES = 2;         // K/V ring depth
constexpr int THREADS = 384;      // producer + 2 consumer warpgroups
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 128*40 + 256*232 <= 65,536
constexpr float NEG_INF = -1e30f;   // kernel.py's mask value
constexpr int ATOM = 64;          // bf16 columns in one 128-byte swizzle row

template <int DH>
struct Shape {
  static_assert(DH % 16 == 0 && DH <= 128, "16-column k-steps, dh <= 128");
  static constexpr int DHP = DH <= 64 ? 64 : 128;   // columns in smem
  static constexpr int CHUNKS = DHP / ATOM;         // 64-column boxes
  static constexpr uint32_t Q_BYTES = BQ * DHP * 2;
  static constexpr uint32_t KV_BYTES = BK * DHP * 2;  // one of K or V
  // Q, then K and V of each stage, then 1 + 2*STAGES barriers; +1024 to
  // align the start to the 1024-byte swizzle atom
  static constexpr size_t smem = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 64;
  static_assert(smem <= 232448, "above the opt-in shared memory limit");
};

// the kv tiles the block visits: [lo, hi)
__device__ __forceinline__ void tile_range(int qlo, int qhi, int Skv,
                                           int causal, int window, int& lo,
                                           int& hi) {
  hi = (Skv + BK - 1) / BK;
  if (causal) hi = min(hi, qhi / BK + 1);
  lo = 0;
  if (window) {
    const int first = qlo - window + 1;      // lowest key row qlo may see
    lo = first > 0 ? first / BK : 0;
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  wgmma_rs_n64_tb(d, a, b);
}
template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  wgmma_rs_n128_tb(d, a, b);
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, int H, int Hkv, int Sq,
               int Skv, int q_offset, int causal, int window,
               float scale_log2) {
  using T = Shape<DH>;
  constexpr int DHP = T::DHP;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + T::Q_BYTES;                 // + stage * KV_BYTES
  const uint32_t sV = sK + STAGES * T::KV_BYTES;
  const uint32_t bars = sV + STAGES * T::KV_BYTES;
  const uint32_t barQ = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };

  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = (int)((long long)h * Hkv / H);
  const int qlo = q_offset + q0;                     // global position
  const int qhi = q_offset + min(q0 + BQ, Sq) - 1;
  int t_lo, t_hi;
  tile_range(qlo, qhi, Skv, causal, window, t_lo, t_hi);
  const int ntiles = max(t_hi - t_lo, 0);

  if (threadIdx.x == 0) {
    mbar_init(barQ, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);                 // one per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load -------------------
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(barQ, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::CHUNKS; ++c)
        tma_load_4d(sQ + c * BQ * 128, &tq, barQ, c * ATOM, q0, h, b);
      for (int n = 0; n < ntiles; ++n) {
        const int s = n % STAGES;
        const int k0 = (t_lo + n) * BK;
        mbar_wait(empty(s), ((n / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), 2 * T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < T::CHUNKS; ++c) {
          tma_load_4d(sK + s * T::KV_BYTES + c * BK * 128, &tk, full(s),
                      c * ATOM, k0, kvh, b);
          tma_load_4d(sV + s * T::KV_BYTES + c * BK * 128, &tv, full(s),
                      c * ATOM, k0, kvh, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns query rows 64w .. 64w + 63 -----------
  setmaxnreg_inc<CONSUMER_REGS>();
  const int w = wg - 1;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int row = 16 * (tid / 32) + lane / 4;        // and row + 8
  const int wlo = qlo + 64 * w;                      // global positions
  const int whi = wlo + 63;
  const int qpos0 = wlo + row;

  float acc[DHP / 2];
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  mbar_wait(barQ, 0);
  for (int n = 0; n < ntiles; ++n) {
    const int s = n % STAGES;
    const int k0 = (t_lo + n) * BK;
    mbar_wait(full(s), (n / STAGES) & 1);
    // this warpgroup's rows see nothing of a tile wholly past them
    if (!(causal && k0 > whi)) {
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int c = kk / 4, off = (kk % 4) * 32;
        const uint64_t da = desc_sw128(
            sQ + c * BQ * 128 + w * 64 * 128 + off, 16, 1024);
        const uint64_t db = desc_sw128(
            sK + s * T::KV_BYTES + c * BK * 128 + off, 16, 1024);
        wgmma_ss_n128(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > wlo) ||
                        (window && k0 <= whi - window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kpos = k0 + 8 * j + 2 * (lane % 4) + e;
              const int qpos = qpos0 + 8 * i;
              bool ok = kpos < Skv;              // the true Skv
              if (causal) ok = ok && kpos <= qpos;
              if (window) ok = ok && kpos > qpos - window;
              if (!ok) sc[4 * j + 2 * i + e] = NEG_INF;
            }
      }
      uint32_t p[BK / 16][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
        const float m_new = fmaxf(m[i], quad_max(mx));
        const float corr = exp2f((m[i] - m_new) * scale_log2);
        float sum = 0.f;
        // (x - m) first, not fma(x, scale, -m*scale): while a row has seen
        // only masked keys, x = m = -1e30 must give exp(0) = 1 exactly, as
        // in kernel.py, where the fma's rounding would give exp(+-1e22)
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[4 * j + 2 * i + e];
            x = exp2f((x - m_new) * scale_log2);
            sum += x;
          }
        l[i] = l[i] * corr + sum;            // this thread's columns only
        m[i] = m_new;
#pragma unroll
        for (int j = 0; j < DHP / 8; ++j) {
          acc[4 * j + 2 * i] *= corr;
          acc[4 * j + 2 * i + 1] *= corr;
        }
      }
      // the accumulator fragment of S is wgmma's A fragment of P
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        p[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        p[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        p[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        p[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = desc_sw128(
            sV + s * T::KV_BYTES + kk * 16 * 128, BK * 128, 1024);
        mma_rs<DHP>(acc, p[kk], dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // ---- epilogue: O / max(l, 1e-30) as bf16 ------------------------------
  __nv_bfloat16* ob = o + ((long long)b * H + h) * Sq * DH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = fmaxf(quad_sum(l[i]), 1e-30f);
    const int r = q0 + 64 * w + row + 8 * i;
    if (r >= Sq) continue;
#pragma unroll
    for (int j = 0; j < DHP / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < DH)
        *reinterpret_cast<__nv_bfloat162*>(&ob[(long long)r * DH + col]) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] / li,
                                  acc[4 * j + 2 * i + 1] / li);
    }
  }
}

// cuTensorMapEncodeTiled, through the runtime's driver entry point (no
// -lcuda at link time)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [batch, heads, seq, dh] bf16 view as a 4-D map over (dh, seq, head,
// batch), in boxes of 64 columns by `rows` positions, 128-byte swizzled
int encode(CUtensorMap* map, const void* ptr, int B, int heads, int seq,
           int dh, const long long* strides, int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return -1;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)seq,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t bytes[3] = {(cuuint64_t)strides[2] * 2,
                               (cuuint64_t)strides[1] * 2,
                               (cuuint64_t)strides[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)ATOM, (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, bytes, box, step,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - (int)r;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int Sq, int Skv, const long long* qs,
           const long long* ks, const long long* vs, int q_offset,
           int causal, int window, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int rc = encode(&tq, q, B, H, Sq, DH, qs, BQ);
  if (rc == 0) rc = encode(&tk, k, B, Hkv, Skv, DH, ks, BK);
  if (rc == 0) rc = encode(&tv, v, B, Hkv, Skv, DH, vs, BK);
  if (rc != 0) return rc;
  auto kern = flash_fwd_sm90<DH>;
  const size_t bytes = Shape<DH>::smem;
  static bool opted_in = false;   // above 48 KB only after opting in
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, Hkv, Sq, Skv, q_offset,
      causal, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: {batch, head, position} of q, k and v, in elements, each a
// multiple of 8 (16 bytes); q, k and v 16-byte aligned.
extern "C" int flash_attention_sm90_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Hkv, int Sq, int Skv, int dh, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, int q_offset, int causal, int window,
    float scale, void* stream) {
  const long long qs[3] = {qsb, qsh, qss};
  const long long ks[3] = {ksb, ksh, kss};
  const long long vs[3] = {vsb, vsh, vss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return launch<32>(q, k, v, o, B, H, Hkv, Sq, Skv, qs, ks, vs, q_offset,
                        causal, window, scale, st);
    case 64:
      return launch<64>(q, k, v, o, B, H, Hkv, Sq, Skv, qs, ks, vs, q_offset,
                        causal, window, scale, st);
    case 112:
      return launch<112>(q, k, v, o, B, H, Hkv, Sq, Skv, qs, ks, vs,
                         q_offset, causal, window, scale, st);
    case 128:
      return launch<128>(q, k, v, o, B, H, Hkv, Sq, Skv, qs, ks, vs,
                         q_offset, causal, window, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
