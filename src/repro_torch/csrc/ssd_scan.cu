// Mamba2 SSD chunked scan (K5) for NVIDIA Hopper (sm_90a).
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
// (zeros when none is given), and written out as h_final when asked: what
// `ssd_chunked(..., h0=)` takes and returns, so chunked prefill stays on
// the kernel. Positions past S are read as dt = 0, x = B = C = 0: a decay
// of 1 and nothing injected, so h_final is h at S exactly, and nothing is
// written there. Nothing is padded in memory.
//
// Layout: xh [B, S, H, P] (f32 or bf16), dt [B, S, H], Bm and Cm [B, S, N]
// (dt, Bm and Cm of one type, f32 or bf16), each with any strides over its
// leading axes and (xh, Bm, Cm) a contiguous last axis; A, D [H] f32; h0
// and h_final contiguous [B, H, P, N] f32; y contiguous [B, S, H, P] in
// xh's type. Every input is read in its own type and computed in f32.
// P is a multiple of 32; N is 16, 32, 64 or 128 (an instance each).
//
// Design. Two kernels on one stream.
// (1) `chunk_cb`: C.B^T does not depend on the head (one group: B and C are
//     shared across heads), so it is computed once per (b, chunk), lower
//     triangle only, into a [B, nc, Q, Q] f32 scratch (4 MB at B=4,
//     S=2048), where the Pallas kernel recomputes it for every head.
// (2) `ssd_chunk_scan`: one block of 128 threads per (32 columns of P,
//     head, batch row): the P columns of y and rows of h are independent,
//     so splitting P doubles the blocks at P=64 (896 at B=4, H=112; 224 at
//     B=1). The sequential chunk axis of the TPU grid, which carries h in
//     VMEM scratch, becomes a loop inside the block, with h (transposed,
//     [N][32]) in shared memory. For each chunk the block
//       - reads dt and forms cum with a warp scan (seg is always formed as
//         a difference of this one cum array, so its rounding cancels);
//       - forms M[t,s] = CB[t,s] exp(cum_t - cum_s) dt_s in shared memory,
//         evaluating exp only where s <= t (above the diagonal seg > 0 can
//         overflow, and inf * 0 would be NaN) and writing 0 there;
//       - y = M x: thread (g, c) owns rows 2g, 2g+1, Q-2-2g, Q-1-2g and 8
//         columns, so every thread walks 130 (t, s) pairs of the triangle;
//       - y += (exp(cum) C) h^T, then y + D x is written (masked at S);
//       - h = exp(cum_{Q-1}) h + (coeff x)^T B: thread (p, c) owns row p
//         of h and N/4 of its columns.
//     M, exp(cum) C and B take turns in one shared buffer, so a block
//     needs 92.8 KB at N=64 and two blocks fit on an SM (8 warps). With
//     so few warps the loads of each chunk (x, CB, C, B) cannot hide
//     behind other blocks' work: their loops have fixed trip counts and
//     are unrolled, so each thread has eight loads in flight at once. All
//     products are f32 FMA on the CUDA cores: TF32's 10-bit mantissa would
//     break the 1e-4 parity with the plain version. No fast math (expf
//     stays accurate, denormals are kept).
//
// Bound. At the slice's largest shape (B=4, S=2048, H=112, P=64, N=64,
// f32) the useful work is 22.68 GFLOP (the triangular M.x, C.h^T and the
// state injection for each (b, h, chunk), C.B^T once per (b, chunk))
// against 477.7 MB of inputs and output: 0.339 ms at 67 TFLOP/s (f32 on
// the CUDA cores) against 0.143 ms at 3.35 TB/s, so operations bound it.
// This first version does not overlap its loads with compute and keeps
// 8 warps an SM; it is expected at 1-4 ms. Tensor-core products (3xTF32
// or bf16 splits, wgmma) are later work (ROADMAP Queue 2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int Q = 128;          // chunk length
constexpr int PB = 32;          // columns of P per block
constexpr int THREADS = 128;    // one thread per step of the chunk
constexpr int NMAX = 128;
constexpr int LDM = Q + 1;      // M row stride: a warp's rows on distinct banks
constexpr int CB_THREADS = 256;

static_assert(THREADS == Q, "the cumsum gives one step to each thread");
static_assert(THREADS == 4 * PB, "4 threads to a row of h");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// floats of the scan kernel's dynamic shared memory for state size N
__host__ __device__ constexpr int r_floats(int N) {
  return Q * (LDM > N + 4 ? LDM : N + 4);
}
__host__ __device__ constexpr int scan_floats(int N) {
  return r_floats(N) + Q * PB + N * PB + 4 * Q + 32;
}

// CB[b, c, t, s] = C_t . B_s for s <= t (the rest is never read).
template <typename TS>
__global__ void __launch_bounds__(CB_THREADS)
chunk_cb(const TS* __restrict__ Bm, const TS* __restrict__ Cm,
         float* __restrict__ cb, int S, int N, int nc, long long bsb,
         long long bss, long long csb, long long css) {
  extern __shared__ float4 smem4[];
  const int ld = N + 4;
  float* sC = reinterpret_cast<float*>(smem4);
  float* sB = sC + Q * ld;
  const int c = blockIdx.x, b = blockIdx.y, t0 = c * Q;
  const int tid = threadIdx.x;
#pragma unroll 4
  for (int i = tid; i < Q * N; i += CB_THREADS) {
    const int t = i / N, n = i % N, g = t0 + t;
    float cv = 0.f, bv = 0.f;
    if (g < S) {
      cv = to_f32(Cm[b * csb + (long long)g * css + n]);
      bv = to_f32(Bm[b * bsb + (long long)g * bss + n]);
    }
    sC[t * ld + n] = cv;
    sB[t * ld + n] = bv;
  }
  __syncthreads();
  float* out = cb + ((long long)b * nc + c) * Q * Q;
  for (int i = tid; i < Q * Q; i += CB_THREADS) {
    const int t = i / Q, s = i % Q;
    if (s > t) continue;
    float acc = 0.f;
    for (int n = 0; n < N; n += 4) {
      const float4 cv = *reinterpret_cast<const float4*>(&sC[t * ld + n]);
      const float4 bv = *reinterpret_cast<const float4*>(&sB[s * ld + n]);
      acc += cv.x * bv.x + cv.y * bv.y + cv.z * bv.z + cv.w * bv.w;
    }
    out[i] = acc;
  }
}

template <int N, typename TX, typename TS>
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_scan(const TX* __restrict__ xh, const TS* __restrict__ dt,
               const float* __restrict__ A, const TS* __restrict__ Bm,
               const TS* __restrict__ Cm, const float* __restrict__ D,
               const float* __restrict__ cb, const float* __restrict__ h0,
               TX* __restrict__ y, float* __restrict__ hfin, int S, int H,
               int P, int nc, long long xsb, long long xss,
               long long xsh, long long dsb, long long dss, long long dsh,
               long long bsb, long long bss, long long csb, long long css) {
  extern __shared__ float4 smem4[];
  float* R = reinterpret_cast<float*>(smem4);   // M, then exp(cum) C, then B
  float* sx = R + r_floats(N);                   // x chunk [Q][PB]
  float* hT = sx + Q * PB;                       // state, transposed [N][PB]
  float* scum = hT + N * PB;
  float* sdt = scum + Q;
  float* secum = sdt + Q;                        // exp(cum_t)
  float* scoef = secum + Q;                      // exp(cum_{Q-1} - cum_t) dt_t
  float* swarp = scoef + Q;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const float Ah = A[h], Dh = D[h];
  const TX* xb = xh + b * xsb + h * xsh + p0;
  const TS* db = dt + b * dsb + h * dsh;
  const TS* bb = Bm + b * bsb;
  const TS* cbase = Cm + b * csb;
  constexpr int ldc = N + 4;
  constexpr int nj = N / 16;

  // y: rows 2g, 2g+1 (loop 1) and Q-2-2g, Q-1-2g (loop 2), columns cy..+7
  const int g = tid >> 2, cy = (tid & 3) * 8;
  const int rows[4] = {2 * g, 2 * g + 1, Q - 2 - 2 * g, Q - 1 - 2 * g};
  // h: row ph, columns 16j + nq .. +3 for j < N/16
  const int ph = tid >> 2, nq = (tid & 3) * 4;

  for (int i = tid; i < PB * N; i += THREADS) {
    const int pp = i / N, n = i % N;
    hT[n * PB + pp] =
        h0 ? h0[(((long long)b * H + h) * P + p0 + pp) * N + n] : 0.f;
  }

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * Q;
    __syncthreads();                 // last chunk's readers are done

    // ---- dt, x, and the inclusive cumsum of la = dt*A ----------------
    const int gt = t0 + tid;
    const float dtv = gt < S ? to_f32(db[(long long)gt * dss]) : 0.f;
    float v = dtv * Ah;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += up;
    }
    if (lane == 31) swarp[warp] = v;
#pragma unroll 8
    for (int k = 0; k < Q * PB / THREADS; ++k) {
      const int i = tid + k * THREADS, t = i / PB, pp = i % PB;
      sx[i] = t0 + t < S ? to_f32(xb[(long long)(t0 + t) * xss + pp]) : 0.f;
    }
    __syncthreads();
    for (int w = 0; w < warp; ++w) v += swarp[w];
    scum[tid] = v;
    sdt[tid] = dtv;
    __syncthreads();
    const float last = scum[Q - 1];
    secum[tid] = expf(v);
    scoef[tid] = expf(last - v) * dtv;

    // ---- M[t,s] = CB[t,s] exp(cum_t - cum_s) dt_s, s <= t --------------
    const float* cbc = cb + ((long long)b * nc + c) * Q * Q;
#pragma unroll 8
    for (int k = 0; k < Q * Q / THREADS; ++k) {
      const int i = tid + k * THREADS, t = i / Q, s = i % Q;
      float m = 0.f;
      if (s <= t) m = cbc[i] * expf(scum[t] - scum[s]) * sdt[s];
      R[t * LDM + s] = m;
    }
    __syncthreads();

    // ---- y = M x ------------------------------------------------------
    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[r][k] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ra = rows[2 * half], rb = rows[2 * half + 1];
#pragma unroll 4
      for (int s = 0; s <= rb; ++s) {      // M[ra][ra+1] is 0
        const float4 x0 = *reinterpret_cast<const float4*>(&sx[s * PB + cy]);
        const float4 x1 =
            *reinterpret_cast<const float4*>(&sx[s * PB + cy + 4]);
        const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float ma = R[ra * LDM + s], mb = R[rb * LDM + s];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          acc[2 * half][k] += ma * xs[k];
          acc[2 * half + 1][k] += mb * xs[k];
        }
      }
    }
    __syncthreads();                 // done with M

    // ---- y += (exp(cum) C) h^T -----------------------------------------
#pragma unroll 8
    for (int k = 0; k < Q * N / THREADS; ++k) {
      const int i = tid + k * THREADS, t = i / N, n = i % N, gg = t0 + t;
      const float cv = gg < S ? to_f32(cbase[(long long)gg * css + n]) : 0.f;
      R[t * ldc + n] = cv * secum[t];
    }
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < N; n += 4) {
      float4 cr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        cr[r] = *reinterpret_cast<const float4*>(&R[rows[r] * ldc + n]);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const float4 h0v =
            *reinterpret_cast<const float4*>(&hT[(n + nn) * PB + cy]);
        const float4 h1v =
            *reinterpret_cast<const float4*>(&hT[(n + nn) * PB + cy + 4]);
        const float hs[8] = {h0v.x, h0v.y, h0v.z, h0v.w,
                             h1v.x, h1v.y, h1v.z, h1v.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float cvv = nn == 0 ? cr[r].x : nn == 1 ? cr[r].y
                          : nn == 2 ? cr[r].z : cr[r].w;
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[r][k] += cvv * hs[k];
        }
      }
    }

    // ---- write y + D x ----------------------------------------------------
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gg = t0 + rows[r];
      if (gg >= S) continue;
      TX* yr = y + (((long long)b * S + gg) * H + h) * P + p0 + cy;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        store(&yr[k], acc[r][k] + sx[rows[r] * PB + cy + k] * Dh);
    }
    __syncthreads();                 // done with exp(cum) C

    // ---- h = exp(cum_{Q-1}) h + (coeff x)^T B ------------------------------
#pragma unroll 8
    for (int k = 0; k < Q * N / THREADS; ++k) {
      const int i = tid + k * THREADS, t = i / N, n = i % N, gg = t0 + t;
      R[i] = gg < S ? to_f32(bb[(long long)gg * bss + n]) : 0.f;
    }
    __syncthreads();
    float hacc[nj][4];
#pragma unroll
    for (int j = 0; j < nj; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) hacc[j][k] = 0.f;
#pragma unroll 4
    for (int t = 0; t < Q; ++t) {
      const float a = sx[t * PB + ph] * scoef[t];
#pragma unroll
      for (int j = 0; j < nj; ++j) {
        const float4 bv =
            *reinterpret_cast<const float4*>(&R[t * N + 16 * j + nq]);
        hacc[j][0] += a * bv.x;
        hacc[j][1] += a * bv.y;
        hacc[j][2] += a * bv.z;
        hacc[j][3] += a * bv.w;
      }
    }
    const float dl = expf(last);
#pragma unroll
    for (int j = 0; j < nj; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float* hp = &hT[(16 * j + nq + k) * PB + ph];
        *hp = dl * *hp + hacc[j][k];
      }
    }
  }

  if (hfin) {
    __syncthreads();
    for (int i = tid; i < PB * N; i += THREADS) {
      const int pp = i / N, n = i % N;
      hfin[(((long long)b * H + h) * P + p0 + pp) * N + n] = hT[n * PB + pp];
    }
  }
}

template <int N, typename TX, typename TS>
int launch(const void* xh, const void* dt, const float* A, const void* Bm,
           const void* Cm, const float* D, const float* h0, void* y,
           float* hfin, float* cb, int B, int S, int H, int P,
           const long long* xs, const long long* ds, const long long* bs,
           const long long* cs, cudaStream_t stream) {
  auto cbk = chunk_cb<TS>;
  auto scan = ssd_chunk_scan<N, TX, TS>;
  static bool opted_in = false;   // above 48 KB only after opting in
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        cbk, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * 2 * Q * (NMAX + 4)));
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(scan,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(sizeof(float) * scan_floats(NMAX)));
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int nc = (S + Q - 1) / Q;
  const TS* bm = static_cast<const TS*>(Bm);
  const TS* cm = static_cast<const TS*>(Cm);
  cbk<<<dim3(nc, B), CB_THREADS, sizeof(float) * 2 * Q * (N + 4), stream>>>(
      bm, cm, cb, S, N, nc, bs[0], bs[1], cs[0], cs[1]);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan<<<dim3(P / PB, H, B), THREADS, sizeof(float) * scan_floats(N),
         stream>>>(static_cast<const TX*>(xh), static_cast<const TS*>(dt),
                   A, bm, cm, D, cb, h0, static_cast<TX*>(y), hfin, S, H, P,
                   nc, xs[0], xs[1], xs[2], ds[0], ds[1], ds[2], bs[0],
                   bs[1], cs[0], cs[1]);
  return (int)cudaGetLastError();
}

template <typename TX, typename TS>
int dispatch_state(int N, const void* xh, const void* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D,
                   const float* h0, void* y, float* hfin, float* cb, int B,
                   int S, int H, int P, const long long* xs,
                   const long long* ds, const long long* bs,
                   const long long* cs, cudaStream_t st) {
  switch (N) {
    case 16:
      return launch<16, TX, TS>(xh, dt, A, Bm, Cm, D, h0, y, hfin, cb, B, S,
                                H, P, xs, ds, bs, cs, st);
    case 32:
      return launch<32, TX, TS>(xh, dt, A, Bm, Cm, D, h0, y, hfin, cb, B, S,
                                H, P, xs, ds, bs, cs, st);
    case 64:
      return launch<64, TX, TS>(xh, dt, A, Bm, Cm, D, h0, y, hfin, cb, B, S,
                                H, P, xs, ds, bs, cs, st);
    case 128:
      return launch<128, TX, TS>(xh, dt, A, Bm, Cm, D, h0, y, hfin, cb, B,
                                 S, H, P, xs, ds, bs, cs, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// h0 and hfin may be null; cb is a [B, ceil(S/128), 128, 128] f32 scratch.
// Strides in elements: xh {batch, position, head}, dt {batch, position,
// head}, Bm and Cm {batch, position}.
extern "C" int ssd_scan_launch(
    const void* xh, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* D, const void* h0, void* y, void* hfin,
    void* cb, int x_bf16, int s_bf16, int B, int S, int H, int P, int N,
    long long xsb, long long xss, long long xsh, long long dsb,
    long long dss, long long dsh, long long bsb, long long bss,
    long long csb, long long css, void* stream) {
  if (S <= 0 || P % PB) return (int)cudaErrorInvalidValue;
  const long long xs[3] = {xsb, xss, xsh};
  const long long ds[3] = {dsb, dss, dsh};
  const long long bs[2] = {bsb, bss};
  const long long cs[2] = {csb, css};
  const float* a = static_cast<const float*>(A);
  const float* d = static_cast<const float*>(D);
  const float* hi = static_cast<const float*>(h0);
  float* ho = static_cast<float*>(hfin);
  float* c = static_cast<float*>(cb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (x_bf16 && s_bf16)
    return dispatch_state<bf, bf>(N, xh, dt, a, Bm, Cm, d, hi, y, ho, c, B, S,
                                  H, P, xs, ds, bs, cs, st);
  if (x_bf16)
    return dispatch_state<bf, float>(N, xh, dt, a, Bm, Cm, d, hi, y, ho, c, B,
                                     S, H, P, xs, ds, bs, cs, st);
  if (s_bf16)
    return dispatch_state<float, bf>(N, xh, dt, a, Bm, Cm, d, hi, y, ho, c, B,
                                     S, H, P, xs, ds, bs, cs, st);
  return dispatch_state<float, float>(N, xh, dt, a, Bm, Cm, d, hi, y, ho, c,
                                      B, S, H, P, xs, ds, bs, cs, st);
}
