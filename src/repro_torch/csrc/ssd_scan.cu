// Mamba2 SSD chunked scan (K5) for NVIDIA Hopper (sm_90a): chunk-parallel,
// tiles loaded by TMA, every product in 3xTF32 on the tensor cores (wgmma).
//
// Replaces the TPU kernel `ssd_scan_kernel` (`_kernel`) of
// src/repro/kernels/ssm_scan/kernel.py, which computes the jnp
// `ssd_chunked` of src/repro/models/mamba2.py. Per batch row b and head h,
// over chunks of Q = 128 steps with la = dt*A and cum its inclusive sum
// within the chunk:
//   y[t]  = sum_{s<=t} (C_t.B_s) exp(cum_t - cum_s) dt_s x_s
//         + exp(cum_t) C_t.h^T + D x_t
//   h'    = exp(cum_{Q-1}) h + sum_t exp(cum_{Q-1} - cum_t) dt_t x_t B_t^T
// with the state h [P, N] carried from chunk to chunk, started from h0
// (zeros when none is given), and written out as h_final when asked.
// Positions past S are read as dt = 0, x = B = C = 0 (TMA fills a box's
// rows past S with zeros): a decay of 1 and nothing injected, so h_final is
// h at S exactly. Nothing is padded in memory and nothing is written past S.
//
// Layout: xh [B, S, H, P] (f32 or bf16), dt [B, S, H], Bm and Cm [B, S, N]
// (dt, Bm and Cm of one type, f32 or bf16); xh, Bm and Cm with any strides
// over their leading axes that are multiples of 16 bytes, a contiguous
// last axis and a 16-byte aligned base (the wrapper copies a tensor that
// breaks this, ops.launch_plan); dt with any strides; A, D [H] f32; h0 and
// h_final contiguous [B, H, P, N] f32; y contiguous [B, S, H, P] in xh's
// type. Every input is read in its own type and computed in f32. P is a
// multiple of 32; N is 16, 32, 64 or 128.
//
// Bound. At the slice's largest shape (B=4, S=2048, H=112, P=64, N=64,
// f32) the useful work is 22.67 GFLOP against 477.6 MB of inputs and
// output: 0.338 ms at 67 TFLOP/s (f32 on the CUDA cores), 0.137 ms for the
// three tf32 products of each at 495 TFLOP/s, 0.143 ms at 3.35 TB/s. On the
// tensor cores the bytes bound it. The chunk-parallel form adds its f32
// state scratch: written by pass 1, read and rewritten by pass 2, read by
// pass 3 (117 MB each at that shape), and pass 3 reads x again: 1.18 GB
// in all, 0.353 ms at 3.35 TB/s, the floor of this design.
//
// Design: three kernels on one stream, the order of the plain version
// (ref.ssd_chunked).
// (1) `ssd_chunk_state`, grid (head group, chunk, batch row x P tile):
//     each chunk's state s_c = (coeff x)^T B, coeff_t = exp(cum_{Q-1} -
//     cum_t) dt_t, and its decay exp(cum_{Q-1}). A producer warp loads B
//     once and each head's x tile through a 4-stage TMA ring; two consumer
//     warpgroups take alternate heads. B^T is written once per block as the
//     K-major tf32 hi/lo operand; (coeff x)^T is wgmma's register A operand.
// (2) `ssd_state_pass`, one thread per (b, h, p, n): the only sequential
//     axis, over chunks: h_in[c] = exp(cum_{Q-1, c-1}) h_in[c-1] + s_{c-1}
//     from h0, written in place over s_c, and h_final.
// (3) `ssd_chunk_out`, grid as (1): C and B are loaded once per block and
//     C.B^T is computed once for all the block's heads, into registers (no
//     global scratch). Then for each head, through a 2-stage TMA ring of x
//     and h_in tiles: y = (exp(cum) C) h_in^T + M x + D x with M = C.B^T
//     (.) exp(cum_t - cum_s) dt_s on and below the diagonal. The two
//     consumer warpgroups own 64 rows of the chunk each, rows {0..31,
//     96..127} and {32..95}, so that each has the same share of the
//     triangle (contiguous halves measured slower). M is formed from the
//     C.B^T accumulator in registers and used as wgmma's register A
//     operand: an accumulator thread holds columns 2q, 2q+1 of each
//     8-column group where a tf32 A fragment holds k = q, q+4, so x^T is
//     written with its k positions permuted to match (s % 8 = 2u + e at
//     k = u + 4e). Left of a warp's first row R, where cum never rises
//     (dt A <= 0, checked per head), exp(cum_t - cum_s) is formed as
//     exp(cum_t - cum_R) exp(cum_R - cum_s), both factors <= 1: two exps a
//     row and one a column (shared by shuffles) instead of one a pair.
// Products: 3xTF32. Each f32 operand is split into hi = tf32(a) and lo =
// tf32(a - hi) (round to nearest), and hi.hi + hi.lo + lo.hi is accumulated
// in f32, the small terms first. A bf16 operand is exact in tf32, so its lo
// products are skipped at compile time. wgmma reads tf32 only K-major,
// while x and B arrive with the reduction axis (t) outermost: the threads
// that split them write the transposed operand tiles (128-byte swizzle, as
// TMA writes the row-major ones), so the transpose costs no extra pass.
// exp(seg) is never evaluated above the diagonal (seg is -inf there, as in
// ref.ssd_chunked): at zamba2's decays it overflows. No fast math (expf
// stays accurate, denormals are kept).
//
// Measured (chip_smoke.py and tools/kernel_experiments.py, an H100 80GB
// HBM3 at 700 W, PERF.md): ~0.75 ms of device time at the top shape,
// pass 3 two thirds of it. Its pieces run one after another (one block an
// SM): the TMA loads alone take ~0.14 ms, and each of the three M x
// products ~0.09 ms, 59 ns an SM for a m64n64k8 tf32 wgmma against 17.5
// ns at the nominal 495 TFLOP/s: at N = P = 64 the tensor cores run at
// about 30% of their tf32 peak.
//
// What the design does about the first version's causes (a CUDA-core loop
// over all chunks in a block, 896 blocks at the top shape, at 12.5x the
// f32 bound): the chunk axis is parallel in passes 1 and 3 (7,168 (b,
// chunk, head) items at the top shape, 1,792 at B=1); every tile is
// loaded by TMA into a ring ahead of its use, since no load depends on
// the carried state; C.B^T stays in registers and is shared by a block's
// heads; all products run on the tensor cores.
#include "hopper.cuh"

namespace {

constexpr int Q = 128;              // chunk length
constexpr int THREADS = 384;        // TMA producer + 2 consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 128*40 + 256*232 <= 65,536
constexpr int MAX_SMEM = 232448;    // the opt-in limit of a block
constexpr int BAR_ALL = 1;          // named barrier of the 256 consumers
constexpr int BAR_WG = 2;           // + warpgroup: one warpgroup's 128
constexpr int PASS2_THREADS = 256;
constexpr int SETS = 2;             // pass 3: fragment sets, groups in flight

__host__ __device__ constexpr int row_bytes(int cols, int esize) {
  return (cols * esize + 127) / 128 * 128;
}
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// This lane's four steps of a chunk's dt in f32 (steps 4 lane .. 4 lane +
// 3); steps at or past `valid` read 0. Issued a head ahead of their use.
template <typename TS>
__device__ __forceinline__ void load_dt(const TS* dtp, long long dss,
                                        int valid, int lane, float (&d)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = 4 * lane + k;
    d[k] = t < valid ? to_f32(dtp[t * dss]) : 0.f;
  }
}

// The chunk's cum (inclusive sum of dt*A) by one warp, four steps a lane,
// from load_dt's values. Returns cum at the chunk's last step. Passes 1
// and 3 both take it from here, so the decays of one pass match the
// other's bit for bit. `mono`: every dt*A <= 0 (cum never rises).
__device__ __forceinline__ float chunk_cum(const float (&d)[4], float Ah,
                                           int lane, float (&cum)[4],
                                           bool& mono) {
  cum[0] = d[0] * Ah;
  bool down = cum[0] <= 0.f;
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    const float la = d[k] * Ah;
    down = down && la <= 0.f;
    cum[k] = cum[k - 1] + la;
  }
  mono = __all_sync(0xffffffffu, down);
  float incl = cum[3];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) cum[k] += excl;
  return __shfl_sync(0xffffffffu, cum[3], 31);
}

// NP: state columns on chip (N, at least 32); PT: P columns a block; KB:
// n columns of one C.B^T step of pass 3
template <int NP>
struct Dims {
  static_assert(NP == 32 || NP == 64 || NP == 128, "N of 16-128");
  static constexpr int PT = NP > 64 ? 32 : 64;
  static constexpr int KB = NP < 64 ? NP : 64;
};

// pass 1's shared memory: B^T hi and lo, then the ring (B first, then x)
template <int NP, typename TX, typename TS>
struct StateGeo {
  static constexpr int STAGES = 4;
  static constexpr int BT = NP * Q * 4;
  static constexpr int XRAW = Q * row_bytes(Dims<NP>::PT, sizeof(TX));
  static constexpr int BRAW = Q * row_bytes(NP, sizeof(TS));
  static constexpr int RING = STAGES * XRAW;
  static_assert(RING >= BRAW, "B is loaded into the ring");
  static constexpr int OFF_RING = 2 * BT;
  static constexpr int OFF_COEF = OFF_RING + RING;     // 2 x Q floats
  static constexpr int OFF_BAR = OFF_COEF + 2 * Q * 4;
  static constexpr int BYTES = 1024 + OFF_BAR + 8 * (2 + 2 * STAGES);
  static_assert(BYTES <= MAX_SMEM, "above the opt-in shared memory limit");
};

// pass 3's: C, region R (B hi/lo of a C.B^T step, then each head's x^T
// hi/lo and h_in hi/lo), the ring (B first, then x and h_in), cum and dt
template <int NP, typename TX, typename TS>
struct OutGeo {
  using D = Dims<NP>;
  static constexpr int STAGES = 2;
  static constexpr int CRAW = Q * row_bytes(NP, sizeof(TS));
  static constexpr int BRAW = CRAW;
  static constexpr int XRAW = Q * row_bytes(D::PT, sizeof(TX));
  static constexpr int SRAW = D::PT * row_bytes(NP, 4);
  static constexpr int STAGE = XRAW + SRAW;
  static constexpr int RING = STAGES * STAGE;
  static_assert(RING >= BRAW, "B is loaded into the ring");
  static constexpr int RB = Q * D::KB * 4;       // one of B hi, lo
  static constexpr int RXT = D::PT * Q * 4;      // one of x^T hi, lo
  static constexpr int RST = D::PT * NP * 4;     // one of h_in hi, lo
  static constexpr int R = cmax(2 * RB, 2 * RXT + 2 * RST);
  static constexpr int OFF_R = CRAW;
  static constexpr int OFF_RING = OFF_R + R;
  static constexpr int OFF_CUM = OFF_RING + RING;
  static constexpr int OFF_DT = OFF_CUM + Q * 4;
  static constexpr int OFF_MONO = OFF_DT + Q * 4;      // one int
  static constexpr int OFF_BAR = OFF_MONO + 16;
  static constexpr int BYTES = 1024 + OFF_BAR + 8 * (2 + 2 * STAGES);
  static_assert(BYTES <= MAX_SMEM, "above the opt-in shared memory limit");
};

// ---- pass 1: chunk states ------------------------------------------------

template <int NP, typename TX, typename TS>
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_state(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tb,
                const TS* __restrict__ dt, const float* __restrict__ A,
                float* __restrict__ states, float* __restrict__ decays,
                int S, int H, int P, int N, int nc, int G, long long dsb,
                long long dss, long long dsh) {
  using T = StateGeo<NP, TX, TS>;
  constexpr int PT = Dims<NP>::PT, STAGES = T::STAGES;
  constexpr bool S_F32 = sizeof(TS) == 4;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* sBThi = base;
  unsigned char* sBTlo = base + T::BT;
  unsigned char* sRing = base + T::OFF_RING;
  float* scoef = reinterpret_cast<float*>(base + T::OFF_COEF);
  const uint32_t bars = smem_addr(base + T::OFF_BAR);
  const uint32_t barB = bars, barFree = bars + 8;
  auto full = [&](int s) { return bars + 16 + 8 * s; };
  auto empty = [&](int s) { return bars + 16 + 8 * (STAGES + s); };

  const int hg0 = blockIdx.x * G, nh = min(G, H - hg0);
  const int c = blockIdx.y, t0 = c * Q;
  const int npt = (P + PT - 1) / PT;
  const int b = blockIdx.z / npt, p0 = (blockIdx.z % npt) * PT;

  if (threadIdx.x == 0) {
    mbar_init(barB, 1);
    mbar_init(barFree, CONSUMERS / 32);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);          // the consuming warpgroup's warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: B once, then each head's x tile ----------------------
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      constexpr int ES = 128 / sizeof(TS), EX = 128 / sizeof(TX);
      mbar_arrive_expect_tx(barB, T::BRAW);
      for (int k = 0; k < T::BRAW / (Q * 128); ++k)
        tma_load_3d(smem_addr(sRing) + k * Q * 128, &tb, barB, k * ES, t0, b);
      mbar_wait(barFree, 0);
      for (int i = 0; i < nh; ++i) {
        const int s = i % STAGES;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), T::XRAW);
        for (int k = 0; k < T::XRAW / (Q * 128); ++k)
          tma_load_4d(smem_addr(sRing) + s * T::XRAW + k * Q * 128, &tx,
                      full(s), p0 + k * EX, hg0 + i, t0, b);
      }
    }
    return;
  }

  // ---- consumers ----------------------------------------------------------
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1, ctid = threadIdx.x - 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;

  // B^T[n][t] (hi, lo) from B[t][n]: 8 steps of one column a unit, two
  // 16-byte runs of each tile
  mbar_wait(barB, 0);
  for (int u = ctid; u < NP * (Q / 8); u += CONSUMERS) {
    const int n = u % NP, t8 = (u / NP) * 8;
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = raw_at<TS>(sRing, t8 + k, n, Q);
    put4(sBThi, sBTlo, sw128_off(n, t8 * 4, NP), v[0], v[1], v[2], v[3]);
    put4(sBThi, sBTlo, sw128_off(n, t8 * 4 + 16, NP), v[4], v[5], v[6], v[7]);
  }
  fence_proxy_async();
  bar_sync(BAR_ALL, CONSUMERS);
  if (lane == 0) mbar_arrive(barFree);

  float* coef = scoef + cw * Q;
  const int pa = 16 * warp + g, pb = pa + 8;     // this thread's rows of P
  const TS* dtc = dt + b * dsb + (long long)t0 * dss;
  const int valid = min(Q, S - t0);
  float dnext[4];                 // warp 0: dt of this warpgroup's next head
  if (warp == 0 && cw < nh) load_dt(dtc + (hg0 + cw) * dsh, dss, valid, lane,
                                    dnext);
  for (int i = cw; i < nh; i += 2) {
    const int h = hg0 + i, st = i % STAGES;
    if (warp == 0) {
      float cum[4], d[4] = {dnext[0], dnext[1], dnext[2], dnext[3]};
      if (i + 2 < nh) load_dt(dtc + (h + 2) * dsh, dss, valid, lane, dnext);
      bool mono;
      const float last = chunk_cum(d, A[h], lane, cum, mono);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        coef[4 * lane + k] = expf(last - cum[k]) * d[k];
      if (lane == 0 && p0 == 0)
        decays[((long long)b * nc + c) * H + h] = expf(last);
    }
    bar_sync(BAR_WG + cw, 128);
    mbar_wait(full(st), (i / STAGES) & 1);
    const unsigned char* xr = sRing + st * T::XRAW;

    float acc[NP / 2];
#pragma unroll
    for (int k = 0; k < NP / 2; ++k) acc[k] = 0.f;
    uint32_t fh[2][4][4], fl[2][4][4];
    // s^T... s[p][n] = sum_t (coeff x)^T[p][t] B[t][n]: 16 k-steps over t,
    // in 4 groups of 4; group k's fragments are formed while group k-1's
    // products run
#pragma unroll
    for (int grp = 0; grp < 4; ++grp) {
      const int set = grp & 1;
      if (grp >= 2) wgmma_wait<1>();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int ta = 8 * (4 * grp + kk) + q, tb2 = ta + 4;
        const float ca = coef[ta], cb = coef[tb2];
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (pa < PT) {
          v[0] = raw_at<TX>(xr, ta, pa, Q) * ca;
          v[1] = raw_at<TX>(xr, ta, pb, Q) * ca;
          v[2] = raw_at<TX>(xr, tb2, pa, Q) * cb;
          v[3] = raw_at<TX>(xr, tb2, pb, Q) * cb;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tf32_split(v[e], fh[set][kk][e], fl[set][kk][e]);
      }
      if (grp == 3) {                  // this warp is done with the x tile
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = 4 * grp + kk;
        const uint64_t dhi = kstep_desc(sBThi, k, NP);
        wgmma_tf32<NP>(acc, fl[set][kk], dhi);
        if (S_F32) wgmma_tf32<NP>(acc, fh[set][kk], kstep_desc(sBTlo, k, NP));
        wgmma_tf32<NP>(acc, fh[set][kk], dhi);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // the accumulator: acc[4j + 2r + e] = s[pa + 8r][8j + 2q + e]
    float* out = states + (((long long)b * nc + c) * H + h) * P * N;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pl = pa + 8 * r, p = p0 + pl, n = 8 * j + 2 * q;
        if (pl < PT && p < P && n < N)
          *reinterpret_cast<float2*>(&out[(long long)p * N + n]) =
              make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    bar_sync(BAR_WG + cw, 128);          // coef is the next head's
  }
}

// ---- pass 2: the state passed across chunks -------------------------------

// states [B, nc, H, P, N]: s_c for c < nc1 in, h_in[c] (the state before
// chunk c) out for every c; decays [B, nc, H]. h0 and hfin may be null;
// all four 16-byte aligned. One thread per four values of one (b, h).
__global__ void __launch_bounds__(PASS2_THREADS)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ decays,
               const float* __restrict__ h0, float* __restrict__ hfin, int B,
               int H, int PN, int nc, int nc1) {
  const long long i =
      4 * (blockIdx.x * (long long)PASS2_THREADS + threadIdx.x);
  if (i >= (long long)B * H * PN) return;
  const int e = (int)(i % PN);
  const int bh = (int)(i / PN);
  const int hh = bh % H, b = bh / H;
  const long long cs = (long long)H * PN;
  float* sp = states + (long long)b * nc * cs + (long long)hh * PN + e;
  const float* dp = decays + (long long)b * nc * H + hh;
  float4 h = h0 ? *reinterpret_cast<const float4*>(h0 + i)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += 8) {
    float4 s[8];
    float d[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {      // every load ahead of the chain
      const int c = c0 + k;
      s[k] = c < nc1 ? *reinterpret_cast<const float4*>(sp + c * cs)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      d[k] = c < nc1 ? dp[(long long)c * H] : 1.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = c0 + k;
      if (c < nc) {
        *reinterpret_cast<float4*>(sp + c * cs) = h;
        h = make_float4(d[k] * h.x + s[k].x, d[k] * h.y + s[k].y,
                        d[k] * h.z + s[k].z, d[k] * h.w + s[k].w);
      }
    }
  }
  if (hfin) *reinterpret_cast<float4*>(hfin + i) = h;
}

// ---- pass 3: chunk outputs -------------------------------------------------

template <int NP, typename TX, typename TS>
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_out(const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tb,
              const __grid_constant__ CUtensorMap tc,
              const __grid_constant__ CUtensorMap tst,
              const TS* __restrict__ dt, const float* __restrict__ A,
              const float* __restrict__ Dv, TX* __restrict__ y, int S, int H,
              int P, int nc, int G, long long dsb, long long dss,
              long long dsh) {
  using T = OutGeo<NP, TX, TS>;
  constexpr int PT = Dims<NP>::PT, KB = Dims<NP>::KB, STAGES = T::STAGES;
  constexpr bool X_F32 = sizeof(TX) == 4, S_F32 = sizeof(TS) == 4;
  constexpr int G2 = NP / 32;          // k-step groups of (exp(cum) C) h^T
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* sC = base;
  unsigned char* sR = base + T::OFF_R;
  unsigned char* sRing = base + T::OFF_RING;
  float* scum = reinterpret_cast<float*>(base + T::OFF_CUM);
  float* sdt = reinterpret_cast<float*>(base + T::OFF_DT);
  int* smono = reinterpret_cast<int*>(base + T::OFF_MONO);
  const uint32_t bars = smem_addr(base + T::OFF_BAR);
  const uint32_t barCB = bars, barFree = bars + 8;
  auto full = [&](int s) { return bars + 16 + 8 * s; };
  auto empty = [&](int s) { return bars + 16 + 8 * (STAGES + s); };

  const int hg0 = blockIdx.x * G, nh = min(G, H - hg0);
  const int c = blockIdx.y, t0 = c * Q;
  const int npt = (P + PT - 1) / PT;
  const int b = blockIdx.z / npt, p0 = (blockIdx.z % npt) * PT;

  if (threadIdx.x == 0) {
    mbar_init(barCB, 1);
    mbar_init(barFree, CONSUMERS / 32);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: C and B once, then each head's x and h_in tiles ------
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      constexpr int ES = 128 / sizeof(TS), EX = 128 / sizeof(TX);
      mbar_arrive_expect_tx(barCB, T::CRAW + T::BRAW);
      for (int k = 0; k < T::CRAW / (Q * 128); ++k) {
        tma_load_3d(smem_addr(sC) + k * Q * 128, &tc, barCB, k * ES, t0, b);
        tma_load_3d(smem_addr(sRing) + k * Q * 128, &tb, barCB, k * ES, t0,
                    b);
      }
      mbar_wait(barFree, 0);
      for (int i = 0; i < nh; ++i) {
        const int s = i % STAGES;
        const uint32_t xdst = smem_addr(sRing) + s * T::STAGE;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), T::STAGE);
        for (int k = 0; k < T::XRAW / (Q * 128); ++k)
          tma_load_4d(xdst + k * Q * 128, &tx, full(s), p0 + k * EX, hg0 + i,
                      t0, b);
        for (int k = 0; k < T::SRAW / (PT * 128); ++k)
          tma_load_4d(xdst + T::XRAW + k * PT * 128, &tst, full(s), k * 32,
                      p0, hg0 + i, b * nc + c);
      }
    }
    return;
  }

  // ---- consumers ----------------------------------------------------------
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1, ctid = threadIdx.x - 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  // this thread's rows of the chunk, r0 and r0 + 8: warpgroup 0 owns rows
  // 0..31 and 96..127, warpgroup 1 rows 32..95
  const int m0 = 16 * warp + g;
  const int r0 = cw == 0 ? (warp < 2 ? m0 : m0 + 64) : m0 + 32;
  const int r1 = r0 + 8;
  const int row_last = r0 - g + 15;     // this warp's last row
  const int nks = cw == 0 ? 16 : 12;    // k-steps of M x (s <= row_last)

  // ---- C.B^T, once for the block's heads --------------------------------
  // cbv[4j + 2r + e] = C_t . B_s at t = r0 + 8r, s = 8j + 2q + e
  mbar_wait(barCB, 0);
  float cbv[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) cbv[k] = 0.f;
  unsigned char* sBhi = sR;
  unsigned char* sBlo = sR + T::RB;
#pragma unroll
  for (int hf = 0; hf < NP / KB; ++hf) {
    // B[s][n] hi, lo for n in [hf KB, hf KB + KB): K-major as it stands
    for (int u = ctid; u < Q * KB / 4; u += CONSUMERS) {
      const int s = u / (KB / 4), n4 = (u % (KB / 4)) * 4;
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = raw_at<TS>(sRing, s, hf * KB + n4 + k, Q);
      put4(sBhi, sBlo, sw128_off(s, n4 * 4, Q), v[0], v[1], v[2], v[3]);
    }
    fence_proxy_async();
    bar_sync(BAR_ALL, CONSUMERS);
    uint32_t ah[KB / 8][4], al[KB / 8][4];
#pragma unroll
    for (int j = 0; j < KB / 8; ++j) {
      const int n = hf * KB + 8 * j + q;
      tf32_split(raw_at<TS>(sC, r0, n, Q), ah[j][0], al[j][0]);
      tf32_split(raw_at<TS>(sC, r1, n, Q), ah[j][1], al[j][1]);
      tf32_split(raw_at<TS>(sC, r0, n + 4, Q), ah[j][2], al[j][2]);
      tf32_split(raw_at<TS>(sC, r1, n + 4, Q), ah[j][3], al[j][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KB / 8; ++j) {
      const uint64_t dhi = kstep_desc(sBhi, j, Q);
      if (S_F32) {
        wgmma_tf32<128>(cbv, al[j], dhi);
        wgmma_tf32<128>(cbv, ah[j], kstep_desc(sBlo, j, Q));
      }
      wgmma_tf32<128>(cbv, ah[j], dhi);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(cbv);
    bar_sync(BAR_ALL, CONSUMERS);       // region R and B are free
  }
  if (lane == 0) mbar_arrive(barFree);

  unsigned char* sXhi = sR;
  unsigned char* sXlo = sR + T::RXT;
  unsigned char* sShi = sR + 2 * T::RXT;
  unsigned char* sSlo = sShi + T::RST;
  const TS* dtc = dt + b * dsb + (long long)t0 * dss;
  const int valid = min(Q, S - t0);
  float dnext[4];                       // warp 0: the next head's dt
  if (ctid < 32) load_dt(dtc + hg0 * dsh, dss, valid, lane, dnext);
  for (int i = 0; i < nh; ++i) {
    const int h = hg0 + i, st = i % STAGES;
    if (ctid < 32) {
      float cum[4], d[4] = {dnext[0], dnext[1], dnext[2], dnext[3]};
      if (i + 1 < nh) load_dt(dtc + (h + 1) * dsh, dss, valid, lane, dnext);
      bool mono;
      chunk_cum(d, A[h], lane, cum, mono);
      *reinterpret_cast<float4*>(&scum[4 * lane]) =
          make_float4(cum[0], cum[1], cum[2], cum[3]);
      *reinterpret_cast<float4*>(&sdt[4 * lane]) =
          make_float4(d[0], d[1], d[2], d[3]);
      if (lane == 0) *smono = mono;
    }
    mbar_wait(full(st), (i / STAGES) & 1);
    const unsigned char* xr = sRing + st * T::STAGE;
    const unsigned char* hr = xr + T::XRAW;
    // x^T[p][k] (hi, lo) from x[s][p], k(s) = 8(s/8) + (s%8)/2 + 4(s%2):
    // the even steps of 8 form one 16-byte run, the odd ones the next
    for (int u = ctid; u < PT * (Q / 8); u += CONSUMERS) {
      const int p = u % PT, s8 = (u / PT) * 8;
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = raw_at<TX>(xr, s8 + k, p, Q);
      put4(sXhi, sXlo, sw128_off(p, s8 * 4, PT), v[0], v[2], v[4], v[6]);
      put4(sXhi, sXlo, sw128_off(p, s8 * 4 + 16, PT), v[1], v[3], v[5], v[7]);
    }
    // h_in[p][n] (hi, lo): K-major as it stands, same tile geometry
    for (int u = ctid; u < PT * NP / 4; u += CONSUMERS) {
      const float4 v = *reinterpret_cast<const float4*>(hr + 16 * u);
      put4(sShi, sSlo, 16 * u, v.x, v.y, v.z, v.w);
    }
    fence_proxy_async();
    bar_sync(BAR_ALL, CONSUMERS);

    const float Dh = Dv[h];
    const float cum0 = scum[r0], cum1 = scum[r1];
    const float ec0 = expf(cum0), ec1 = expf(cum1);
    // Left of this warp's first row R every (t, s) has s < R <= t, and
    // where cum never rises exp(cum_t - cum_s) = exp(cum_t - cum_R)
    // exp(cum_R - cum_s), both factors <= 1: two exps a row, one a column
    const int R = r0 - g;
    const bool sep = *smono != 0;
    const float cumR = scum[R];
    const float u0 = expf(cum0 - cumR), u1 = expf(cum1 - cumR);
    float acc[PT / 2];
#pragma unroll
    for (int k = 0; k < PT / 2; ++k) acc[k] = 0.f;
    uint32_t fh[SETS][4][4], fl[SETS][4][4];
    const int ngrp = G2 + nks / 4;
    // groups of 4 k-steps: first (exp(cum) C) h_in^T over n, then M x over
    // s; a group's fragments are formed while the SETS - 1 groups before it
    // run
#pragma unroll
    for (int grp = 0; grp < G2 + 4; ++grp) {
      if (grp < ngrp) {
        const int set = grp % SETS;
        if (grp >= SETS) wgmma_wait<SETS - 1>();
        if (grp < G2) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int n = 8 * (4 * grp + kk) + q;
            tf32_split(raw_at<TS>(sC, r0, n, Q) * ec0, fh[set][kk][0],
                       fl[set][kk][0]);
            tf32_split(raw_at<TS>(sC, r1, n, Q) * ec1, fh[set][kk][1],
                       fl[set][kk][1]);
            tf32_split(raw_at<TS>(sC, r0, n + 4, Q) * ec0, fh[set][kk][2],
                       fl[set][kk][2]);
            tf32_split(raw_at<TS>(sC, r1, n + 4, Q) * ec1, fh[set][kk][3],
                       fl[set][kk][3]);
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int k = 4 * grp + kk;
            const uint64_t dhi = kstep_desc(sShi, k, PT);
            wgmma_tf32<PT>(acc, fl[set][kk], dhi);
            wgmma_tf32<PT>(acc, fh[set][kk], kstep_desc(sSlo, k, PT));
            wgmma_tf32<PT>(acc, fh[set][kk], dhi);
          }
        } else {
          // exp(cum_R - cum_s) dt_s of the group's columns: lane (g, q) takes
          // column 2q + (g % 2) of k-step g / 2; the others fetch it
          const int kb = grp - G2;
          const int sv = 8 * (4 * kb + g / 2) + 2 * q + (g % 2);
          const float vmine =
              expf(sv < R ? cumR - scum[sv] : -INFINITY) * sdt[sv];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int kj = 4 * kb + kk, s0 = 8 * kj + 2 * q;
            // a[0..3] = M at (r0, s0), (r1, s0), (r0, s0+1), (r1, s0+1)
            float m[4] = {0.f, 0.f, 0.f, 0.f};
            if (sep && 8 * kj + 8 <= R) {         // warp-uniform
              const float v0 = __shfl_sync(0xffffffffu, vmine, 8 * kk + q);
              const float v1 =
                  __shfl_sync(0xffffffffu, vmine, 8 * kk + 4 + q);
              m[0] = cbv[4 * kj] * (u0 * v0);
              m[1] = cbv[4 * kj + 2] * (u1 * v0);
              m[2] = cbv[4 * kj + 1] * (u0 * v1);
              m[3] = cbv[4 * kj + 3] * (u1 * v1);
            } else if (8 * kj <= row_last) {
              const float2 cs = *reinterpret_cast<const float2*>(&scum[s0]);
              const float2 ds = *reinterpret_cast<const float2*>(&sdt[s0]);
              const float NEG = -INFINITY;
              m[0] = cbv[4 * kj] * expf(s0 <= r0 ? cum0 - cs.x : NEG) * ds.x;
              m[1] =
                  cbv[4 * kj + 2] * expf(s0 <= r1 ? cum1 - cs.x : NEG) * ds.x;
              m[2] = cbv[4 * kj + 1] *
                     expf(s0 + 1 <= r0 ? cum0 - cs.y : NEG) * ds.y;
              m[3] = cbv[4 * kj + 3] *
                     expf(s0 + 1 <= r1 ? cum1 - cs.y : NEG) * ds.y;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e)
              tf32_split(m[e], fh[set][kk][e], fl[set][kk][e]);
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int k = 4 * (grp - G2) + kk;
            const uint64_t dhi = kstep_desc(sXhi, k, PT);
            wgmma_tf32<PT>(acc, fl[set][kk], dhi);
            if (X_F32)
              wgmma_tf32<PT>(acc, fh[set][kk], kstep_desc(sXlo, k, PT));
            wgmma_tf32<PT>(acc, fh[set][kk], dhi);
          }
        }
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    bar_sync(BAR_ALL, CONSUMERS);       // region R, cum and dt are free

    // y = acc + D x (x from the ring stage), rows past S and columns past
    // P not written; then the stage is free
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r0 + 8 * r, gt = t0 + t;
      if (gt >= S) continue;
      TX* yrow = y + (((long long)b * S + gt) * H + h) * P + p0;
#pragma unroll
      for (int j = 0; j < PT / 8; ++j) {
        const int p = 8 * j + 2 * q;
        if (p0 + p >= P) continue;
        const float y0 = acc[4 * j + 2 * r] + Dh * raw_at<TX>(xr, t, p, Q);
        const float y1 =
            acc[4 * j + 2 * r + 1] + Dh * raw_at<TX>(xr, t, p + 1, Q);
        if constexpr (X_F32)
          *reinterpret_cast<float2*>(&yrow[p]) = make_float2(y0, y1);
        else
          *reinterpret_cast<__nv_bfloat162*>(&yrow[p]) =
              __floats2bfloat162_rn(y0, y1);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));    // the ring stage is free
  }
}

// ---- host ------------------------------------------------------------------

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// a tensor map of `rank` dims (innermost first) with element strides
// `strides` of dims 1.., in boxes of 128 bytes by `box[1..]`, 128-byte
// swizzled; reads past a dim are zeros
template <typename T>
int encode(CUtensorMap* map, const void* ptr, int rank, const long long* dims,
           const long long* strides, const int* box) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return -1;
  cuuint64_t gd[4], gs[3];
  cuuint32_t bx[4], step[4];
  for (int i = 0; i < rank; ++i) {
    gd[i] = (cuuint64_t)dims[i];
    bx[i] = (cuuint32_t)box[i];
    step[i] = 1;
  }
  for (int i = 0; i + 1 < rank; ++i) gs[i] = (cuuint64_t)strides[i] * sizeof(T);
  CUresult r = fn(map, tma_type<T>(), rank, const_cast<void*>(ptr), gd, gs,
                  bx, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - (int)r;
}

template <typename K>
int opt_in(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int NP, typename TX, typename TS>
int launch(const void* xh, const void* dt, const float* A, const void* Bm,
           const void* Cm, const float* D, const float* h0, void* y,
           float* hfin, float* states, float* decays, int B, int S, int H,
           int P, int N, int g_state, int g_out, int want_state,
           const long long* xs, const long long* ds, const long long* bs,
           const long long* cs, cudaStream_t stream) {
  using SG = StateGeo<NP, TX, TS>;
  using OG = OutGeo<NP, TX, TS>;
  constexpr int PT = Dims<NP>::PT;
  constexpr int EX = 128 / sizeof(TX), ES = 128 / sizeof(TS);
  auto k1 = ssd_chunk_state<NP, TX, TS>;
  auto k3 = ssd_chunk_out<NP, TX, TS>;
  static bool opted_in = false;   // above 48 KB only after opting in
  if (!opted_in) {
    int e = opt_in(k1, SG::BYTES);
    if (e == 0) e = opt_in(k3, OG::BYTES);
    if (e != 0) return e;
    opted_in = true;
  }
  const int nc = (S + Q - 1) / Q, nc1 = want_state ? nc : nc - 1;
  const int npt = (P + PT - 1) / PT;
  CUtensorMap tx, tb, tc, tst;
  const long long xd[4] = {P, H, S, B}, xst[3] = {xs[2], xs[1], xs[0]};
  const int xbox[4] = {EX, 1, Q, 1};
  const long long bd[3] = {N, S, B};
  const long long bst[2] = {bs[1], bs[0]}, cst[2] = {cs[1], cs[0]};
  const int bbox[3] = {ES, Q, 1};
  const long long sd[4] = {N, P, H, (long long)B * nc};
  const long long sst[3] = {N, (long long)P * N, (long long)H * P * N};
  const int sbox[4] = {32, PT, 1, 1};
  int rc = encode<TX>(&tx, xh, 4, xd, xst, xbox);
  if (rc == 0) rc = encode<TS>(&tb, Bm, 3, bd, bst, bbox);
  if (rc == 0) rc = encode<TS>(&tc, Cm, 3, bd, cst, bbox);
  if (rc == 0) rc = encode<float>(&tst, states, 4, sd, sst, sbox);
  if (rc != 0) return rc;
  const TS* d = static_cast<const TS*>(dt);
  if (nc1 > 0) {
    k1<<<dim3((H + g_state - 1) / g_state, nc1, B * npt), THREADS, SG::BYTES,
         stream>>>(tx, tb, d, A, states, decays, S, H, P, N, nc, g_state,
                   ds[0], ds[1], ds[2]);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long n2 = (long long)B * H * P * N / 4;
  ssd_state_pass<<<(unsigned)((n2 + PASS2_THREADS - 1) / PASS2_THREADS),
                   PASS2_THREADS, 0, stream>>>(states, decays, h0, hfin, B, H,
                                               P * N, nc, nc1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  k3<<<dim3((H + g_out - 1) / g_out, nc, B * npt), THREADS, OG::BYTES,
       stream>>>(tx, tb, tc, tst, d, A, D, static_cast<TX*>(y), S, H, P, nc,
                 g_out, ds[0], ds[1], ds[2]);
  return (int)cudaGetLastError();
}

template <typename TX, typename TS>
int dispatch_state(int N, const void* xh, const void* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D,
                   const float* h0, void* y, float* hfin, float* states,
                   float* decays, int B, int S, int H, int P, int g_state,
                   int g_out, int want_state, const long long* xs,
                   const long long* ds, const long long* bs,
                   const long long* cs, cudaStream_t st) {
  switch (N) {
    case 16:
    case 32:
      return launch<32, TX, TS>(xh, dt, A, Bm, Cm, D, h0, y, hfin, states,
                                decays, B, S, H, P, N, g_state, g_out,
                                want_state, xs, ds, bs, cs, st);
    case 64:
      return launch<64, TX, TS>(xh, dt, A, Bm, Cm, D, h0, y, hfin, states,
                                decays, B, S, H, P, N, g_state, g_out,
                                want_state, xs, ds, bs, cs, st);
    case 128:
      return launch<128, TX, TS>(xh, dt, A, Bm, Cm, D, h0, y, hfin, states,
                                 decays, B, S, H, P, N, g_state, g_out,
                                 want_state, xs, ds, bs, cs, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename TX, typename TS>
int smem_bytes(int N, int pass) {
  switch (N) {
    case 16:
    case 32:
      return pass == 1 ? StateGeo<32, TX, TS>::BYTES
                       : OutGeo<32, TX, TS>::BYTES;
    case 64:
      return pass == 1 ? StateGeo<64, TX, TS>::BYTES
                       : OutGeo<64, TX, TS>::BYTES;
    case 128:
      return pass == 1 ? StateGeo<128, TX, TS>::BYTES
                       : OutGeo<128, TX, TS>::BYTES;
    default:
      return -1;
  }
}

}  // namespace

// h0 and hfin may be null; states is a [B, ceil(S/128), H, P, N] f32
// scratch, decays [B, ceil(S/128), H] f32. g_state, g_out: heads a block in
// passes 1 and 3. Strides in elements: xh {batch, position, head}, dt
// {batch, position, head}, Bm and Cm {batch, position}; xh's, Bm's and Cm's
// multiples of 16 bytes, their bases 16-byte aligned.
extern "C" int ssd_scan_launch(
    const void* xh, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, const void* h0, void* y, void* hfin,
    void* states, void* decays, int x_bf16, int s_bf16, int B, int S, int H,
    int P, int N, int g_state, int g_out, int want_state, long long xsb,
    long long xss, long long xsh, long long dsb, long long dss, long long dsh,
    long long bsb, long long bss, long long csb, long long css, void* stream) {
  if (S <= 0 || P % 32 || g_state < 1 || g_out < 1)
    return (int)cudaErrorInvalidValue;
  const long long xs[3] = {xsb, xss, xsh};
  const long long ds[3] = {dsb, dss, dsh};
  const long long bs[2] = {bsb, bss};
  const long long cs[2] = {csb, css};
  const float* a = static_cast<const float*>(A);
  const float* d = static_cast<const float*>(D);
  const float* hi = static_cast<const float*>(h0);
  float* ho = static_cast<float*>(hfin);
  float* sc = static_cast<float*>(states);
  float* dc = static_cast<float*>(decays);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (x_bf16 && s_bf16)
    return dispatch_state<bf, bf>(N, xh, dt, a, Bm, Cm, d, hi, y, ho, sc, dc,
                                  B, S, H, P, g_state, g_out, want_state, xs,
                                  ds, bs, cs, st);
  if (x_bf16)
    return dispatch_state<bf, float>(N, xh, dt, a, Bm, Cm, d, hi, y, ho, sc,
                                     dc, B, S, H, P, g_state, g_out,
                                     want_state, xs, ds, bs, cs, st);
  if (s_bf16)
    return dispatch_state<float, bf>(N, xh, dt, a, Bm, Cm, d, hi, y, ho, sc,
                                     dc, B, S, H, P, g_state, g_out,
                                     want_state, xs, ds, bs, cs, st);
  return dispatch_state<float, float>(N, xh, dt, a, Bm, Cm, d, hi, y, ho, sc,
                                      dc, B, S, H, P, g_state, g_out,
                                      want_state, xs, ds, bs, cs, st);
}

// dynamic shared memory of pass 1 or 3 for an instance (-1: no instance)
extern "C" int ssd_scan_smem_bytes(int N, int x_bf16, int s_bf16, int pass) {
  using bf = __nv_bfloat16;
  if (x_bf16 && s_bf16) return smem_bytes<bf, bf>(N, pass);
  if (x_bf16) return smem_bytes<bf, float>(N, pass);
  if (s_bf16) return smem_bytes<float, bf>(N, pass);
  return smem_bytes<float, float>(N, pass);
}
