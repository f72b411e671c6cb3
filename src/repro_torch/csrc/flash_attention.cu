// Flash attention forward (K4), route 2: f32 q over f32 k and v, and bf16
// q over an f32 kv cache (and f32 q over bf16 k and v), on Hopper's tensor
// cores (sm_90a) in 3xTF32, fed by TMA. bf16 q over bf16 k and v take
// route 1 (csrc/flash_attention_sm90.cu); this file has no instance for
// that pair, so neither route falls back to the other.
//
// Replaces the TPU kernel `flash_attention_kernel` (`_kernel`) of
// src/repro/kernels/flash_attention/kernel.py: blocked online-softmax
// attention with GQA (query head h reads kv head h*Hkv/H), causal and
// sliding-window masks on global positions (query row i sits at
// q_offset + i, for chunked prefill against a longer kv cache), kv tiles
// skipped when wholly past the causal frontier or outside the window
// (kernel.py:40-44), f32 scores with an f32 q scaled before the product
// (kernel.py:48), f32 accumulators, and l clamped at 1e-30 (kernel.py:71).
//
// Layout: q [B, H, Sq, dh], k and v [B, Hkv, Skv, dh], each with any
// strides over (b, head, position) that are multiples of 16 bytes, a
// contiguous last axis and a 16-byte aligned base (the wrapper copies a
// tensor that breaks this, ops.launch_plan); the output is contiguous
// [B, H, Sq, dh] in q's type. dh is 32, 64, 112 (zamba2-7b) or 128.
//
// Bound. At qwen2-1.5b's prefill shape in f32 (B=4, H=12, Hkv=2, S=2048,
// dh=128, causal) the work is 4*B*H*dh flops for each (q, k) pair the
// masks keep, 51.6 GFLOP against 117 MB of inputs and output: 0.77 ms at
// the 67 TFLOP/s of f32 FMA on the CUDA cores, 0.31 ms for three tf32
// products of each at the tensor cores' 495 TFLOP/s, 0.035 ms at 3.35
// TB/s. The bound is operations on the tensor cores, so both products run
// there, and the loads stay off the threads that issue them.
//
// Products: 3xTF32. An f32 operand x is split into hi = tf32(x) and lo =
// tf32(x - hi), rounded to nearest, and lo.hi + hi.lo + hi.hi is
// accumulated in f32: ~22 bits of each operand are kept. A bf16 operand is
// exact in tf32 (8 significant bits of tf32's 11), so its lo is 0 and its
// lo product is skipped at compile time; a bf16 q is therefore not scaled
// before the product (q*scale would not be exact) but its f32 scores are
// scaled after it, which differs from kernel.py's order by rounding only.
//
// Design. One block of 160 threads per (64 query rows, head, batch row);
// q tiles run latest first so the long causal rows start early. Warp 4
// is the producer: one thread loads Q once, then K and V tiles of 32
// positions through a 3-stage ring with TMA (4-D tensor maps over (dh,
// position, head, batch) built from the caller's strides, so the model's
// transposed views and a slice of the KV cache load without a copy; rows
// past Sq or Skv and columns past dh read as zeros). Warps 0-3 are one
// consumer warpgroup. They write Q once (scaled) as K-major tf32 hi and lo
// operand tiles (128-byte swizzle, as TMA writes the raw ones), and each
// K tile the same way. tf32 wgmma reads B only K-major, and V arrives
// with its reduction axis (position) outermost, so V is written
// transposed, with its positions permuted within each group of 8 to match
// the P fragment below. Per kv tile: S = Q.K^T by wgmma m64n32k8 from
// shared memory; the scores masked in registers (only on tiles that
// straddle the diagonal, the window edge or Skv); the online softmax's row
// max and sum across the 4 threads of a row's quad; P split into hi and lo
// in registers and used as wgmma's register A operand of O += P.V: an
// accumulator thread holds columns 2q, 2q+1 of each 8-column group where
// a tf32 A fragment holds k = q, q+4, which the permutation of V's
// positions (s % 8 = 2u + e at k = u + 4e) absorbs. P never goes to
// shared memory. The products are asynchronous: the split of the next K
// tile runs under this tile's P.V, the split of V under Q.K^T, and each
// iteration retires its P.V before the loop's back edge (a product in
// flight across it makes ptxas serialise every wgmma: warning C7515). The
// epilogue divides by max(l, 1e-30) and stores q's type.
//
// Shared memory at dh=128, f32 (dh=112 takes the same 128-wide tiles; TMA
// zero-fills columns 112-127): Q hi and lo 64 KB, K hi and lo 32 KB, V^T
// hi and lo 32 KB, the ring 3 x 32 KB: 225 KB of the 227 KB opt-in. Q
// arrives through the K and V^T tiles before the first K tile is split.
// Registers: O (dh/2), S (16), P's fragments (32) a thread.
//
// Measured (tools/kernel_experiments.py k4r2 and chip_smoke.py, an H100
// 80GB HBM3 at 700 W, PERF.md): 0.94-1.03 ms at qwen2-1.5b's shape above,
// 3.0-3.3x the 3xTF32 bound and ~5x faster than
// scaled_dot_product_attention in f32; 2.30-2.41 ms at zamba2-7b's (B=4,
// H=32, S=2048, dh=112), against 3.22-3.24. Cutting pieces out at
// qwen2's shape: the Q.K^T products (m64n32k8 from shared memory) take
// ~0.25 ms, the K and V splits ~0.16 ms, and what remains with every
// product and split cut (TMA loads, barriers, the softmax) ~0.30 ms, much
// of it K and V read again by every 64-row block.
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;            // query rows per block: one warpgroup
constexpr int BK = 32;            // kv positions per tile (wgmma N of S)
constexpr int STAGES = 3;         // raw K/V ring depth
constexpr int CONSUMERS = 128;    // warps 0-3
constexpr int THREADS = 160;      // + the TMA producer, warp 4
constexpr int BAR_C = 1;          // named barrier of the consumer warps
constexpr int MAX_SMEM = 232448;  // the opt-in limit of a block
constexpr float NEG_INF = -1e30f; // kernel.py's mask value

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Shared memory of one instance: Q hi (lo), K hi (lo), V^T hi (lo), the
// raw K/V ring, barriers; lo tiles only for f32 operands
template <int DH, typename TQ, typename TKV>
struct Geo {
  static_assert(DH % 8 == 0 && DH <= 128, "8-column k-steps, dh <= 128");
  static constexpr bool Q_F32 = sizeof(TQ) == 4, KV_F32 = sizeof(TKV) == 4;
  static constexpr int CH = (DH + 31) / 32;   // 32-float chunks of a row
  static constexpr int DHP = 32 * CH;         // columns of an operand tile
  static constexpr int Q_OP = BQ * CH * 128;  // one of Q hi, lo
  static constexpr int K_OP = BK * CH * 128;  // one of K hi, lo
  static constexpr int V_OP = DH * BK * 4;    // one of V^T hi, lo
  static constexpr int EQ = 128 / sizeof(TQ), EKV = 128 / sizeof(TKV);
  static constexpr int Q_BOXES = (DH + EQ - 1) / EQ;     // 128-byte boxes
  static constexpr int KV_BOXES = (DH + EKV - 1) / EKV;
  static constexpr int Q_RAW = BQ * Q_BOXES * 128;
  static constexpr int KV_RAW = BK * KV_BOXES * 128;     // one of K, V
  static constexpr int OFF_QLO = Q_OP;
  static constexpr int OFF_K = OFF_QLO + (Q_F32 ? Q_OP : 0);
  static constexpr int OFF_V = OFF_K + (KV_F32 ? 2 : 1) * K_OP;
  // raw Q is staged where K and V^T go (as far as it needs)
  static constexpr int END_V = OFF_V + (KV_F32 ? 2 : 1) * V_OP;
  static constexpr int OFF_RING = END_V > OFF_K + Q_RAW ? END_V : OFF_K + Q_RAW;
  static constexpr int STAGE = 2 * KV_RAW;
  static constexpr int OFF_BAR = OFF_RING + STAGES * STAGE;
  static constexpr int BYTES = 1024 + OFF_BAR + 8 * (1 + 2 * STAGES);
  static_assert(BYTES <= MAX_SMEM, "above the opt-in shared memory limit");
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

template <int DH, typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tf32(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, TQ* __restrict__ o,
               int H, int Hkv, int Sq, int Skv, int q_offset, int causal,
               int window, float scale) {
  using G = Geo<DH, TQ, TKV>;
  constexpr bool Q_F32 = G::Q_F32, KV_F32 = G::KV_F32;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* sQhi = base;
  unsigned char* sQlo = base + G::OFF_QLO;
  unsigned char* sKhi = base + G::OFF_K;
  unsigned char* sKlo = sKhi + G::K_OP;
  unsigned char* sVhi = base + G::OFF_V;
  unsigned char* sVlo = sVhi + G::V_OP;
  unsigned char* sQraw = sKhi;                  // until the first K tile
  unsigned char* ring = base + G::OFF_RING;
  const uint32_t bars = smem_addr(base + G::OFF_BAR);
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
      mbar_init(empty(s), CONSUMERS / 32);    // one per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: one thread issues every TMA load -------------------
    if (threadIdx.x == CONSUMERS) {
      mbar_arrive_expect_tx(barQ, G::Q_RAW);
      for (int c = 0; c < G::Q_BOXES; ++c)
        tma_load_4d(smem_addr(sQraw) + c * BQ * 128, &tq, barQ, c * G::EQ,
                    q0, h, b);
      for (int n = 0; n < ntiles; ++n) {
        const int s = n % STAGES;
        const int k0 = (t_lo + n) * BK;
        const uint32_t dst = smem_addr(ring) + s * G::STAGE;
        mbar_wait(empty(s), ((n / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), G::STAGE);
        for (int c = 0; c < G::KV_BOXES; ++c) {
          tma_load_4d(dst + c * BK * 128, &tk, full(s), c * G::EKV, k0, kvh,
                      b);
          tma_load_4d(dst + G::KV_RAW + c * BK * 128, &tv, full(s),
                      c * G::EKV, k0, kvh, b);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup: 64 query rows ------------------------------
  const int tid = threadIdx.x, lane = tid % 32;
  const int g = lane / 4, q4 = lane % 4;
  const int r0 = 16 * (tid / 32) + g;               // and r0 + 8
  // exp((s - m) * sscale): an f32 q was scaled before the product
  const float sscale = Q_F32 ? 1.f : scale;

  // Q as K-major tf32 operand tiles, scaled in f32 (kernel.py:48); a bf16
  // q as it is (exact), its scores scaled after the product
  mbar_wait(barQ, 0);
  if constexpr (Q_F32) {
    // the raw tile and the operand tiles share one geometry (64 rows of
    // 128-byte chunks), so a 16-byte piece keeps its offset
    for (int u = tid; u < BQ * G::CH * 8; u += CONSUMERS) {
      const float4 x = *reinterpret_cast<const float4*>(sQraw + 16 * u);
      put4(sQhi, sQlo, 16 * u, x.x * scale, x.y * scale, x.z * scale,
           x.w * scale);
    }
  } else {
    for (int u = tid; u < BQ * G::DHP / 4; u += CONSUMERS) {
      const int row = u / (G::DHP / 4), d = 4 * (u % (G::DHP / 4));
      *reinterpret_cast<float4*>(sQhi + sw128_off(row, 4 * d, BQ)) =
          make_float4(raw_at<TQ>(sQraw, row, d, BQ),
                      raw_at<TQ>(sQraw, row, d + 1, BQ),
                      raw_at<TQ>(sQraw, row, d + 2, BQ),
                      raw_at<TQ>(sQraw, row, d + 3, BQ));
    }
  }
  fence_proxy_async();
  bar_sync(BAR_C, CONSUMERS);            // raw Q is read; its space is free

  // K of the tile in ring stage s as hi and lo operand tiles. Every load
  // is issued before the first store (one warp a scheduler hides little
  // latency, and the compiler cannot move a load past a store that may
  // alias it)
  auto split_k = [&](int s) {
    const unsigned char* kr = ring + s * G::STAGE;
    if constexpr (KV_F32) {
      constexpr int N = BK * G::CH * 8 / CONSUMERS;   // 16-byte pieces
      float4 x[N];
#pragma unroll
      for (int i = 0; i < N; ++i)
        x[i] = *reinterpret_cast<const float4*>(kr + 16 * (tid + CONSUMERS * i));
#pragma unroll
      for (int i = 0; i < N; ++i)
        put4(sKhi, sKlo, 16 * (tid + CONSUMERS * i), x[i].x, x[i].y, x[i].z,
             x[i].w);
    } else {
      for (int u = tid; u < BK * G::DHP / 4; u += CONSUMERS) {
        const int row = u / (G::DHP / 4), d = 4 * (u % (G::DHP / 4));
        *reinterpret_cast<float4*>(sKhi + sw128_off(row, 4 * d, BK)) =
            make_float4(raw_at<TKV>(kr, row, d, BK),
                        raw_at<TKV>(kr, row, d + 1, BK),
                        raw_at<TKV>(kr, row, d + 2, BK),
                        raw_at<TKV>(kr, row, d + 3, BK));
      }
    }
    fence_proxy_async();
  };

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  uint32_t ph[BK / 8][4], pl[BK / 8][4];

  if (ntiles > 0) {
    mbar_wait(full(0), 0);
    split_k(0);
  }
  // Each iteration ends with its P.V retired, so that no product is in
  // flight across the loop's back edge: the next K tile is split under it
  for (int n = 0; n < ntiles; ++n) {
    const int s = n % STAGES;
    const int k0 = (t_lo + n) * BK;
    const unsigned char* vr = ring + s * G::STAGE + G::KV_RAW;
    bar_sync(BAR_C, CONSUMERS);          // K is written; V^T is free

    // S = Q.K^T: 3 products a k-step (2 where an operand is bf16), the
    // first overwriting S. Nothing but wgmma writes S or O between a fence
    // and the wait that retires the products (ptxas serialises them else)
    float sc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < DH / 8; ++k) {
      const uint64_t qh = kstep_desc(sQhi, k, BQ);
      const uint64_t kh = kstep_desc(sKhi, k, BK);
      if (Q_F32) wgmma_tf32_ss_n32(sc, kstep_desc(sQlo, k, BQ), kh, k > 0);
      if (KV_F32)
        wgmma_tf32_ss_n32(sc, qh, kstep_desc(sKlo, k, BK), k > 0 || Q_F32);
      wgmma_tf32_ss_n32(sc, qh, kh, k > 0 || Q_F32 || KV_F32);
    }
    wgmma_commit();

    // V^T hi and lo (under Q.K^T): V[s][d] at row d, column k(s) =
    // 8(s/8) + (s%8)/2 + 4(s%2): the even positions of 8 form one 16-byte
    // run, the odd ones the next
    // (units of 8 positions of one column; every load first, as in K's)
    constexpr int VU = DH * (BK / 8), NV = (VU + CONSUMERS - 1) / CONSUMERS;
    float x[NV][8];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int u = tid + CONSUMERS * i, d = u % DH, s8 = 8 * (u / DH);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        x[i][e] = u < VU ? raw_at<TKV>(vr, s8 + e, d, BK) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int u = tid + CONSUMERS * i, d = u % DH, s8 = 8 * (u / DH);
      if (u >= VU) continue;
      const uint32_t even = sw128_off(d, 4 * s8, DH);
      const uint32_t odd = sw128_off(d, 4 * s8 + 16, DH);
      if constexpr (KV_F32) {
        put4(sVhi, sVlo, even, x[i][0], x[i][2], x[i][4], x[i][6]);
        put4(sVhi, sVlo, odd, x[i][1], x[i][3], x[i][5], x[i][7]);
      } else {
        *reinterpret_cast<float4*>(sVhi + even) =
            make_float4(x[i][0], x[i][2], x[i][4], x[i][6]);
        *reinterpret_cast<float4*>(sVhi + odd) =
            make_float4(x[i][1], x[i][3], x[i][5], x[i][7]);
      }
    }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));      // the raw tiles are read
    wgmma_wait<0>();
    fence_regs(sc);
    bar_sync(BAR_C, CONSUMERS);          // V^T is written; K is free

    // the masks on global positions, only where the tile needs them
    const bool edge = k0 + BK > Skv || (causal && k0 + BK - 1 > qlo) ||
                      (window && k0 <= qlo + BQ - 1 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = k0 + 8 * j + 2 * q4 + e;
            const int qpos = qlo + r0 + 8 * i;
            bool ok = kpos < Skv;                // the true Skv
            if (causal) ok = ok && kpos <= qpos;
            if (window) ok = ok && kpos > qpos - window;
            if (!ok) sc[4 * j + 2 * i + e] = NEG_INF;
          }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
      const float m_new = fmaxf(m[i], quad_max(mx));
      // exp(s - m) as kernel.py: while a row has seen only masked keys,
      // s = m = -1e30 gives exp(0) = 1, and a real key then scales those
      // terms by exp(-1e30 - m) = 0
      const float corr = expf((m[i] - m_new) * sscale);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * i + e];
          x = expf((x - m_new) * sscale);
          sum += x;
        }
      l[i] = l[i] * corr + sum;            // this thread's columns only
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        acc[4 * j + 2 * i] *= corr;
        acc[4 * j + 2 * i + 1] *= corr;
      }
    }
    // the accumulator fragment of S as the A fragment of P, split: a[v] is
    // P[r0 + 8(v%2)][k = q4 + 4(v/2)], column 2 q4 + v/2 of the group
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      tf32_split(sc[4 * kk + 0], ph[kk][0], pl[kk][0]);
      tf32_split(sc[4 * kk + 2], ph[kk][1], pl[kk][1]);
      tf32_split(sc[4 * kk + 1], ph[kk][2], pl[kk][2]);
      tf32_split(sc[4 * kk + 3], ph[kk][3], pl[kk][3]);
    }
    fence_regs(acc);                     // the rescaled O before the fence
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t vh = kstep_desc(sVhi, kk, DH);
      wgmma_tf32<DH>(acc, pl[kk], vh);
      if (KV_F32) wgmma_tf32<DH>(acc, ph[kk], kstep_desc(sVlo, kk, DH));
      wgmma_tf32<DH>(acc, ph[kk], vh);
    }
    wgmma_commit();

    if (n + 1 < ntiles) {                // the next K tile, under P.V
      mbar_wait(full((n + 1) % STAGES), ((n + 1) / STAGES) & 1);
      split_k((n + 1) % STAGES);
    }
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // ---- epilogue: O / max(l, 1e-30) in q's type ----------------------------
  TQ* ob = o + ((long long)b * H + h) * Sq * DH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = fmaxf(quad_sum(l[i]), 1e-30f);
    const int r = q0 + r0 + 8 * i;
    if (r >= Sq) continue;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      store2(&ob[(long long)r * DH + 8 * j + 2 * q4], acc[4 * j + 2 * i] / li,
             acc[4 * j + 2 * i + 1] / li);
  }
}

// a [batch, heads, seq, dh] view as a 4-D map over (dh, seq, head, batch),
// in boxes of 128 bytes by `rows` positions, 128-byte swizzled; reads past
// dh or seq are zeros
template <typename T>
int encode(CUtensorMap* map, const void* ptr, int B, int heads, int seq,
           int dh, const long long* strides, int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return -1;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)seq,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t bytes[3] = {(cuuint64_t)strides[2] * sizeof(T),
                               (cuuint64_t)strides[1] * sizeof(T),
                               (cuuint64_t)strides[0] * sizeof(T)};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / sizeof(T)), (cuuint32_t)rows,
                             1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  CUresult r = fn(map,
                  sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  4, const_cast<void*>(ptr), dims, bytes, box, step,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - (int)r;
}

template <int DH, typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int Sq, int Skv, const long long* qs,
           const long long* ks, const long long* vs, int q_offset,
           int causal, int window, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int rc = encode<TQ>(&tq, q, B, H, Sq, DH, qs, BQ);
  if (rc == 0) rc = encode<TKV>(&tk, k, B, Hkv, Skv, DH, ks, BK);
  if (rc == 0) rc = encode<TKV>(&tv, v, B, Hkv, Skv, DH, vs, BK);
  if (rc != 0) return rc;
  auto kern = flash_fwd_tf32<DH, TQ, TKV>;
  const int bytes = Geo<DH, TQ, TKV>::BYTES;
  static bool opted_in = false;   // above 48 KB only after opting in
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, bytes, stream>>>(tq, tk, tv, static_cast<TQ*>(o), H,
                                         Hkv, Sq, Skv, q_offset, causal,
                                         window, scale);
  return (int)cudaGetLastError();
}

// F<DH, TQ, TKV>::run(args...) for the instance of (dh, q's type, k/v's
// type); `missing` for route 1's pair (bf16 q over bf16 k/v) and for a head
// dim this file has no instance of.
template <template <int, typename, typename> class F, typename... A>
int dispatch(int missing, int dh, int q_bf16, int kv_bf16, A... args) {
  using bf = __nv_bfloat16;
  if (q_bf16 && kv_bf16) return missing;
  switch (dh) {
#define ROUTE2_DH(D)                                                     \
  case D:                                                                \
    if (q_bf16) return F<D, bf, float>::run(args...);                    \
    if (kv_bf16) return F<D, float, bf>::run(args...);                   \
    return F<D, float, float>::run(args...);
    ROUTE2_DH(32)
    ROUTE2_DH(64)
    ROUTE2_DH(112)
    ROUTE2_DH(128)
#undef ROUTE2_DH
    default:
      return missing;
  }
}

template <int DH, typename TQ, typename TKV>
struct Launch {
  static int run(const void* q, const void* k, const void* v, void* o, int B,
                 int H, int Hkv, int Sq, int Skv, const long long* qs,
                 const long long* ks, const long long* vs, int q_offset,
                 int causal, int window, float scale, cudaStream_t st) {
    return launch<DH, TQ, TKV>(q, k, v, o, B, H, Hkv, Sq, Skv, qs, ks, vs,
                               q_offset, causal, window, scale, st);
  }
};

template <int DH, typename TQ, typename TKV>
struct SmemBytes {
  static int run() { return Geo<DH, TQ, TKV>::BYTES; }
};

}  // namespace

// strides: {batch, head, position} of q, k and v, in elements, each a
// multiple of 16 bytes; q, k and v 16-byte aligned.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int q_bf16,
    int kv_bf16, int B, int H, int Hkv, int Sq, int Skv, int dh,
    long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss, int q_offset,
    int causal, int window, float scale, void* stream) {
  const long long qs[3] = {qsb, qsh, qss};
  const long long ks[3] = {ksb, ksh, kss};
  const long long vs[3] = {vsb, vsh, vss};
  return dispatch<Launch>(
      (int)cudaErrorInvalidValue, dh, q_bf16, kv_bf16, q, k, v, o, B, H, Hkv,
      Sq, Skv, qs, ks, vs, q_offset, causal, window, scale,
      static_cast<cudaStream_t>(stream));
}

// dynamic shared memory of an instance (-1: no instance)
extern "C" int flash_attention_smem_bytes(int dh, int q_bf16, int kv_bf16) {
  return dispatch<SmemBytes>(-1, dh, q_bf16, kv_bf16);
}
