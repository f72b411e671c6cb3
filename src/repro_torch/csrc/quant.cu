// Fused per-channel affine quantize with error feedback (K2) and its
// dequantize (K3): the int8-fused wire tier of the live runtime, over a
// boundary tensor viewed as [rows, C] with channel = last axis.
//
//   K2:  z = x + res;  lo, hi = min, max of z over rows (per channel)
//        scale = (hi - lo) * inv_levels      (0 if not finite or <= 0)
//        q = clip(rint((z - lo) / scale), 0, levels)   (0 if scale == 0)
//        res' = z - (lo + scale * q)
//   K3:  x = lo + scale * q
//
// Replaces the TPU kernels src/repro/kernels/quant/kernel.py:
// quantize_kernel (Pallas body _quant_kernel) and dequantize_kernel
// (_dequant_kernel). The Pallas tile holds all rows of a channel tile at
// once and the caller pads C to a block multiple. Here 65,536 rows do not
// fit a block, so K2 runs in passes:
//   A. quant_minmax: each block reduces a tile of rows over a tile of 32
//      channels in shared memory, then folds into per-channel keys with
//      atomicMin/atomicMax on order-preserving integer keys of the floats
//      (exact, so any order gives the same bits), and flags non-finite z;
//   F. quant_params: one thread per channel decodes the keys into lo and
//      computes scale; thread 0 writes ok;
//   B. quant_apply: elementwise over the flat index, c = i % C.
// Nothing is padded: every kernel masks its ragged edge.
//
// Bound: memory. K2 reads x and res and writes q and res' (13 bytes an
// element; 9 without res), as the Pallas kernel it replaces does; z is
// written only when the caller asks for it (17 bytes then), which the
// live runtime does not. K3 reads q and writes x (5 bytes). At the
// largest MobileNetV2 boundary, [65536, 32], that is 27.3 MB (8.1 us) and
// 10.5 MB (3.1 us) at the H100 SXM's 3.35 TB/s. This first version reads
// x and res twice (passes A and B) with plain 4-byte loads; fusing the
// passes is later work.
//
// Every operation is rounded on its own (__fadd_rn, __fsub_rn, __fmul_rn,
// __fdiv_rn; rintf rounds half to even), in the plain PyTorch version's
// order, so nvcc contracts nothing into an FMA and the kernels are
// bit-identical to kernels/quant/ref.py. K2's dequantized value and K3
// are the same expression, so res' == z - K3(q) holds bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;           // channels of a reduction tile
constexpr int kRowLanes = 8;         // rows a reduction block walks at once
constexpr int kRowsPerBlock = 256;   // rows of a reduction tile
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;   // 16 blocks on each H100 SM

// Order-preserving map f32 -> u32: a < b as floats iff key(a) < key(b)
// (with -0 below +0), so integer min/max give the float min/max exactly.
__device__ __forceinline__ uint32_t key_of(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__global__ void quant_minmax(const float* __restrict__ x,
                             const float* __restrict__ res, long long rows,
                             int C, uint32_t* __restrict__ lo_key,
                             uint32_t* __restrict__ hi_key,
                             uint32_t* __restrict__ bad) {
  __shared__ uint32_t s_lo[kRowLanes][kLanes];
  __shared__ uint32_t s_hi[kRowLanes][kLanes];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.y * kLanes + tx;
  const long long r0 = (long long)blockIdx.x * kRowsPerBlock;
  long long r1 = r0 + kRowsPerBlock;
  if (r1 > rows) r1 = rows;
  uint32_t lo = 0xffffffffu, hi = 0u;
  bool nonfinite = false;
  if (c < C) {
    for (long long r = r0 + ty; r < r1; r += kRowLanes) {
      const long long i = r * C + c;
      const float z = res ? __fadd_rn(x[i], res[i]) : x[i];
      nonfinite |= !isfinite(z);
      const uint32_t k = key_of(z);
      lo = min(lo, k);
      hi = max(hi, k);
    }
  }
  s_lo[ty][tx] = lo;
  s_hi[ty][tx] = hi;
  if (nonfinite) atomicOr(bad, 1u);
  __syncthreads();
  if (ty == 0 && c < C) {
    for (int k = 1; k < kRowLanes; ++k) {
      lo = min(lo, s_lo[k][tx]);
      hi = max(hi, s_hi[k][tx]);
    }
    atomicMin(lo_key + c, lo);
    atomicMax(hi_key + c, hi);
  }
}

__global__ void quant_params(const uint32_t* __restrict__ lo_key,
                             const uint32_t* __restrict__ hi_key,
                             const uint32_t* __restrict__ bad, int C,
                             float inv_levels, float* __restrict__ lo_out,
                             float* __restrict__ scale_out,
                             unsigned char* __restrict__ ok) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c == 0) *ok = (*bad == 0u) ? 1 : 0;
  if (c >= C) return;
  const float lo = float_of(lo_key[c]);
  const float hi = float_of(hi_key[c]);
  float scale = __fmul_rn(__fsub_rn(hi, lo), inv_levels);
  if (!(isfinite(scale) && scale > 0.0f)) scale = 0.0f;
  lo_out[c] = lo;
  scale_out[c] = scale;
}

__global__ void quant_apply(const float* __restrict__ x,
                            const float* __restrict__ res,
                            const float* __restrict__ lo,
                            const float* __restrict__ scale, long long n,
                            int C, float levels,
                            unsigned char* __restrict__ q,
                            float* __restrict__ res_out,
                            float* __restrict__ z_out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int c = (int)(i % C);
    float z = x[i];
    if (res) {
      z = __fadd_rn(z, res[i]);
      if (z_out) z_out[i] = z;
    }
    const float l = lo[c], s = scale[c];
    float qf = 0.0f;
    if (s > 0.0f) {
      qf = rintf(__fdiv_rn(__fsub_rn(z, l), s));
      qf = fminf(fmaxf(qf, 0.0f), levels);
    }
    q[i] = (unsigned char)qf;
    res_out[i] = __fsub_rn(z, __fadd_rn(l, __fmul_rn(s, qf)));
  }
}

__global__ void dequant_apply(const unsigned char* __restrict__ q,
                              const float* __restrict__ lo,
                              const float* __restrict__ scale, long long n,
                              int C, float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int c = (int)(i % C);
    out[i] = __fadd_rn(lo[c], __fmul_rn(scale[c], (float)q[i]));
  }
}

unsigned elementwise_blocks(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

// K2 on `stream`; returns cudaGetLastError() (0 on success). x, res (or
// null), q, res_out and z_out (or null: z is not written; unused when res
// is null) hold rows*C elements; lo_out and scale_out C floats; ok one
// byte; scratch 2*C+1 u32. The caller owns every buffer; nothing is
// allocated.
extern "C" int quantize_ef_launch(const float* x, const float* res,
                                  long long rows, int C, int levels,
                                  float inv_levels, unsigned char* q,
                                  float* lo_out, float* scale_out,
                                  float* res_out, float* z_out,
                                  unsigned char* ok, uint32_t* scratch,
                                  cudaStream_t stream) {
  if (rows <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  uint32_t* lo_key = scratch;
  uint32_t* hi_key = scratch + C;
  uint32_t* bad = scratch + 2 * (long long)C;
  cudaError_t err = cudaMemsetAsync(lo_key, 0xff, sizeof(uint32_t) * C,
                                    stream);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(hi_key, 0, sizeof(uint32_t) * (C + 1), stream);
  if (err != cudaSuccess) return (int)err;
  const long long row_tiles = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const int chan_tiles = (C + kLanes - 1) / kLanes;
  if (row_tiles > 0x7fffffffLL || chan_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)row_tiles, (unsigned)chan_tiles);
  quant_minmax<<<grid, dim3(kLanes, kRowLanes), 0, stream>>>(
      x, res, rows, C, lo_key, hi_key, bad);
  quant_params<<<(C + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      lo_key, hi_key, bad, C, inv_levels, lo_out, scale_out, ok);
  const long long n = rows * C;
  quant_apply<<<elementwise_blocks(n), kThreads, 0, stream>>>(
      x, res, lo_out, scale_out, n, C, (float)levels, q, res_out, z_out);
  return (int)cudaGetLastError();
}

// K3 on `stream`; returns cudaGetLastError(). q and out hold n elements
// (n a multiple of C), lo and scale C floats.
extern "C" int dequantize_launch(const unsigned char* q, const float* lo,
                                 const float* scale, long long n, int C,
                                 float* out, cudaStream_t stream) {
  if (n <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  dequant_apply<<<elementwise_blocks(n), kThreads, 0, stream>>>(
      q, lo, scale, n, C, out);
  return (int)cudaGetLastError();
}
