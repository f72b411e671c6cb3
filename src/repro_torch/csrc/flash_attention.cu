// Flash attention forward (K4), route 2: f32 q, k and v, and bf16 q over
// an f32 kv cache, on the CUDA cores of Hopper (sm_90a). bf16 q over bf16
// k and v take route 1 (csrc/flash_attention_sm90.cu, wgmma + TMA); this
// file has no instance for that pair, so neither route falls back to the
// other.
//
// Replaces the TPU kernel `flash_attention_kernel` (`_kernel`) of
// src/repro/kernels/flash_attention/kernel.py: blocked online-softmax
// attention with GQA (query head h reads kv head h*Hkv/H), causal and
// sliding-window masks on global positions (query row i sits at
// q_offset + i, for chunked prefill against a longer kv cache), kv tiles
// skipped when wholly past the causal frontier or outside the window
// (kernel.py:40-44), f32 scores with q scaled in f32 before the product
// (kernel.py:48), f32 accumulators, and l clamped at 1e-30 (kernel.py:71).
//
// Layout: q [B, H, Sq, dh], k and v [B, Hkv, Skv, dh], each with any
// strides over (b, head, position) and a contiguous last axis; the output
// is contiguous [B, H, Sq, dh] in q's type. q and k/v are read each in its
// own type and computed in f32, so bf16 q over an f32 kv cache rounds as
// the JAX package does. dh is 32, 64, 112 (zamba2-7b) or 128: a multiple
// of 16, since each of a row's 16 lanes owns dh/16 output columns, and of
// 4, for the float4 loads of the q.k loop.
//
// Design. One block of 256 threads per (q tile of 64 rows, head, batch);
// the sequential kv grid axis of the TPU kernel, which carries acc, m and
// l in VMEM scratch, becomes a loop inside the block, with the three in
// registers. Thread t owns rows 4*(t/16)..+3 of the tile; for the scores
// it owns columns (t%16) + 16*j of the kv tile, for the output columns
// (t%16) + 16*n of dh. The 16 threads of a row sit in one half-warp, so
// the row max and row sum are shuffle reductions. Q (scaled), K and V
// tiles and the probabilities P live in shared memory as f32; Q and K
// rows are padded by 4 floats so the 16-byte loads of 8 neighbouring
// threads hit 32 distinct banks. The true Sq and Skv edges are masked in
// the kernel: nothing is padded, so no zero key ever enters the softmax
// (the JAX wrapper's padding does, for causal=False with a ragged Skv).
// Q tiles run latest first, so the long causal rows start early.
//
// Bound. At qwen2-1.5b's prefill shape in f32 (B=4, H=12, Hkv=2, S=2048,
// dh=128, causal) the work is 4*B*H*dh flops for each visited (q, k)
// pair, 51.6 GFLOP: 0.77 ms at the 67 TFLOP/s of f32 FMA outside the
// tensor cores, which is where full f32 products run. This kernel does
// not overlap the tile loads with compute. Products in 3xTF32 on wgmma
// are later work (ROADMAP Queue 2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // kv rows per tile
constexpr int THREADS = 256;    // 16 row groups x 16 column lanes
constexpr float NEG_INF = -1e30f;   // kernel.py's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int DH>
struct Tile {
  static_assert(DH % 16 == 0, "16 lanes a row, dh/16 columns each");
  static constexpr int QS = DH + 4;   // row strides in floats
  static constexpr int KS = DH + 4;
  static constexpr int VS = DH;
  static constexpr int PS = BK + 4;
  static constexpr size_t bytes =
      sizeof(float) * (BQ * QS + BK * KS + BK * VS + BQ * PS);
  // 105,472 bytes at dh=112, 117,760 at dh=128: under the 227 KB opt-in
  static_assert(bytes <= 232448, "above the opt-in shared memory limit");
};

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DH, typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const TQ* __restrict__ q, const TKV* __restrict__ k,
          const TKV* __restrict__ v, TQ* __restrict__ o, int H, int Hkv,
          int Sq, int Skv, long long qsb, long long qsh, long long qss,
          long long ksb, long long ksh, long long kss, long long vsb,
          long long vsh, long long vss, int q_offset, int causal,
          int window, float scale) {
  using T = Tile<DH>;
  constexpr int NC = DH / 16;                 // output columns per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * T::QS;
  float* sV = sK + BK * T::KS;
  float* sP = sV + BK * T::VS;

  const int tid = threadIdx.x;
  const int r4 = 4 * (tid >> 4);              // first of the thread's rows
  const int c = tid & 15;
  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = (int)((long long)h * Hkv / H);
  const TQ* qb = q + b * qsb + h * qsh;
  const TKV* kb = k + b * ksb + kvh * ksh;
  const TKV* vb = v + b * vsb + kvh * vsh;
  const int qlo = q_offset + q0;              // global position of row 0

  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int row = i / DH, d = i % DH;
    float x = 0.f;
    if (q0 + row < Sq) x = to_f32(qb[(long long)(q0 + row) * qss + d]) * scale;
    sQ[row * T::QS + d] = x;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  const int nk = (Skv + BK - 1) / BK;
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    // the skip conditions of kernel.py:40-44, on this kernel's tiles
    if (causal && k0 > qlo + BQ - 1) break;
    if (window && k0 + BK - 1 <= qlo - window) continue;

    __syncthreads();                          // last tile's readers are done
    for (int i = tid; i < BK * DH; i += THREADS) {
      const int row = i / DH, d = i % DH;
      float kx = 0.f, vx = 0.f;
      if (k0 + row < Skv) {
        kx = to_f32(kb[(long long)(k0 + row) * kss + d]);
        vx = to_f32(vb[(long long)(k0 + row) * vss + d]);
      }
      sK[row * T::KS + d] = kx;
      sV[row * T::VS + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&sQ[(r4 + i) * T::QS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(&sK[(c + 16 * j) * T::KS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qa[i].x * ka[j].x + qa[i].y * ka[j].y +
                     qa[i].z * ka[j].z + qa[i].w * ka[j].w;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = qlo + r4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + c + 16 * j;
        bool ok = kpos < Skv;                 // the true Skv, no padding
        if (causal) ok = ok && kpos <= qpos;
        if (window) ok = ok && kpos > qpos - window;
        if (!ok) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(r4 + i) * T::PS + c + 16 * j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&sP[(r4 + i) * T::PS + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = &sV[(j + jj) * T::VS + c];
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const float vx = vrow[16 * n];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = jj == 0 ? pa[i].x : jj == 1 ? pa[i].y
                          : jj == 2 ? pa[i].z : pa[i].w;
            acc[i][n] += p * vx;
          }
        }
      }
    }
  }

  TQ* ob = o + ((long long)b * H + h) * Sq * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r4 + i;
    if (row >= Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NC; ++n)
      store(&ob[(long long)row * DH + c + 16 * n], acc[i][n] / li);
  }
}

template <int DH, typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Hkv, int Sq, int Skv, const long long* qs,
           const long long* ks, const long long* vs, int q_offset,
           int causal, int window, float scale, cudaStream_t stream) {
  auto kern = flash_fwd<DH, TQ, TKV>;
  const size_t bytes = Tile<DH>::bytes;
  static bool opted_in = false;   // above 48 KB only after opting in
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<TQ*>(o), H, Hkv, Sq, Skv,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      q_offset, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int dispatch_types(int q_bf16, int kv_bf16, const void* q, const void* k,
                   const void* v, void* o, int B, int H, int Hkv, int Sq,
                   int Skv, const long long* qs, const long long* ks,
                   const long long* vs, int q_offset, int causal, int window,
                   float scale, cudaStream_t st) {
  using bf = __nv_bfloat16;
  if (q_bf16 && kv_bf16)          // route 1's pair: flash_attention_sm90.cu
    return (int)cudaErrorInvalidValue;
  if (q_bf16)
    return launch<DH, bf, float>(q, k, v, o, B, H, Hkv, Sq, Skv, qs, ks, vs,
                                 q_offset, causal, window, scale, st);
  if (kv_bf16)
    return launch<DH, float, bf>(q, k, v, o, B, H, Hkv, Sq, Skv, qs, ks, vs,
                                 q_offset, causal, window, scale, st);
  return launch<DH, float, float>(q, k, v, o, B, H, Hkv, Sq, Skv, qs, ks, vs,
                                  q_offset, causal, window, scale, st);
}

}  // namespace

// strides: {batch, head, position} of q, k and v, in elements.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int q_bf16,
    int kv_bf16, int B, int H, int Hkv, int Sq, int Skv, int dh,
    long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss, int q_offset,
    int causal, int window, float scale, void* stream) {
  const long long qs[3] = {qsb, qsh, qss};
  const long long ks[3] = {ksb, ksh, kss};
  const long long vs[3] = {vsb, vsh, vss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32:
      return dispatch_types<32>(q_bf16, kv_bf16, q, k, v, o, B, H, Hkv, Sq,
                                Skv, qs, ks, vs, q_offset, causal, window,
                                scale, st);
    case 64:
      return dispatch_types<64>(q_bf16, kv_bf16, q, k, v, o, B, H, Hkv, Sq,
                                Skv, qs, ks, vs, q_offset, causal, window,
                                scale, st);
    case 112:
      return dispatch_types<112>(q_bf16, kv_bf16, q, k, v, o, B, H, Hkv, Sq,
                                 Skv, qs, ks, vs, q_offset, causal, window,
                                 scale, st);
    case 128:
      return dispatch_types<128>(q_bf16, kv_bf16, q, k, v, o, B, H, Hkv, Sq,
                                 Skv, qs, ks, vs, q_offset, causal, window,
                                 scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
