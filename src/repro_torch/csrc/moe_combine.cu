// The expert layer's gather back and weighted sum over the top-k
// (models/moe.py:_moe_ffn), forward and backward:
//
//     out[t]  = sum_j w[t,j] * y[slot[t,j]]          over slot[t,j] < rows
//     dy[r]   = w[t,j] * dout[t]                      where r = slot[t,j]
//     dw[t,j] = sum_d dout[t] * y[slot[t,j]]          (0 where slot = rows)
//
// y is the experts' output [rows = E_local * C, d]; a route dropped by
// capacity, or owned by another tensor shard, has slot = rows (the trash
// row of the plain version, kernels/moe_combine/ref.py, which is a zero
// row), and adds nothing. The JAX package has no kernel here (it gathers
// with jnp indexing): this pair replaces PyTorch's advanced indexing,
// whose backward is an accumulating index_put_ that sorts the indices and
// walks each run of equal ones serially. With random weights 70% of the
// routes index the trash row, and that walk took ~23 ms a call at
// olmoe-1b-7b's shape.
//
// Bound: memory. A call moves the kept rows of y, out, dout and dy once:
// at olmoe's shape (T 4,096, k 8, rows 40,960, d 2,048, bf16) the
// backward writes 168 MB of dy and reads 17 MB of dout and the kept rows
// of y; ~0.07 ms at 3.35 TB/s with 70% of routes dropped.
//
// Design. The precondition the plain version's dispatch gives: each
// non-trash slot appears once (a kept route owns its row). So the
// backward needs no atomics and no sort: an owner map, rows -> route
// (a memset to -1 and one scatter of the routes), then one warp a row
// writes w * dout into a kept row, or zeros into an unowned one, and the
// dot product for dw, reduced across the warp in a fixed order, so two
// calls give the same bits; three launches in all, the memset included.
// The forward is one warp a token, each lane 16 bytes of the row at a
// time, four routes' loads in flight. Products and sums in f32 with one
// rounding to the output type per element, dw's too (the plain version
// rounds each product to bf16 before the sum); dy's products are exact
// in f32, so dy is the plain version's bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // items (tokens or rows) a block
constexpr int kThreads = 32 * kWarps;
constexpr int kRoutesAtOnce = 4;          // forward: loads in flight a lane

// 16 bytes of a row: 8 bf16 or 4 f32, widened to f32 and back
template <typename T> struct Vec;

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(uint4 u, float* f) {
    const uint32_t h[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(h[i] << 16);
      f[2 * i + 1] = __uint_as_float(h[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 store(const float* f) {
    uint32_t h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      h[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    return make_uint4(h[0], h[1], h[2], h[3]);
  }
  static __device__ __forceinline__ float scalar(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 round(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 store(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  static __device__ __forceinline__ float scalar(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

__device__ __forceinline__ bool kept(long long r, long long rows) {
  return (unsigned long long)r < (unsigned long long)rows;
}

// one warp a token: out[t] = sum over its kept routes of w * y[slot]
template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_combine_fwd(const uint4* __restrict__ y, const long long* __restrict__ slot,
                const T* __restrict__ w, uint4* __restrict__ out,
                long long tokens, int k, long long rows, int nvec) {
  constexpr int N = Vec<T>::N;
  const long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= tokens) return;
  const int lane = threadIdx.x & 31;
  const long long* st = slot + t * k;
  const T* wt = w + t * k;
  for (int v = lane; v < nvec; v += 32) {
    float acc[N] = {};
    for (int j0 = 0; j0 < k; j0 += kRoutesAtOnce) {
      uint4 u[kRoutesAtOnce];
      float wj[kRoutesAtOnce];
      bool on[kRoutesAtOnce];
#pragma unroll
      for (int q = 0; q < kRoutesAtOnce; ++q) {
        const int j = j0 + q;
        const long long r = j < k ? st[j] : rows;
        on[q] = kept(r, rows);
        if (on[q]) {
          wj[q] = Vec<T>::scalar(wt[j]);
          u[q] = __ldg(y + r * nvec + v);
        }
      }
#pragma unroll
      for (int q = 0; q < kRoutesAtOnce; ++q) {
        if (!on[q]) continue;
        float f[N];
        Vec<T>::load(u[q], f);
#pragma unroll
        for (int e = 0; e < N; ++e) acc[e] = fmaf(wj[q], f[e], acc[e]);
      }
    }
    out[t * nvec + v] = Vec<T>::store(acc);
  }
}

// the owner map (owner[slot] = route, set to -1 before), and dw = 0 for
// the routes that own no row
template <typename T>
__global__ void moe_combine_bwd_owner(const long long* __restrict__ slot,
                                      int* __restrict__ owner,
                                      T* __restrict__ dw,
                                      long long routes, long long rows) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= routes) return;
  const long long r = slot[i];
  if (kept(r, rows))
    owner[r] = (int)i;
  else
    dw[i] = Vec<T>::round(0.f);
}

// one warp a row of dy: w * dout[t] for its route, or zeros; and that
// route's dw, the warp's dot product of dout[t] and the row of y
template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_combine_bwd(const uint4* __restrict__ dout, const uint4* __restrict__ y,
                const int* __restrict__ owner, const T* __restrict__ w,
                uint4* __restrict__ dy, T* __restrict__ dw,
                long long rows, int k, int nvec) {
  constexpr int N = Vec<T>::N;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  uint4* dst = dy + row * nvec;
  const int i = owner[row];
  if (i < 0) {
    for (int v = lane; v < nvec; v += 32) dst[v] = make_uint4(0, 0, 0, 0);
    return;
  }
  const float wi = Vec<T>::scalar(w[i]);
  const uint4* g = dout + (long long)(i / k) * nvec;
  const uint4* yr = y + row * nvec;
  float acc = 0.f;
  for (int v = lane; v < nvec; v += 32) {
    float gf[N], yf[N], o[N];
    Vec<T>::load(__ldg(g + v), gf);
    Vec<T>::load(__ldg(yr + v), yf);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      o[e] = __fmul_rn(wi, gf[e]);
      acc = fmaf(gf[e], yf[e], acc);
    }
    dst[v] = Vec<T>::store(o);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dw[i] = Vec<T>::round(acc);
}

unsigned blocks(long long items, int per_block) {
  return (unsigned)((items + per_block - 1) / per_block);
}

template <typename T>
int fwd(const void* y, const long long* slot, const void* w, void* out,
        long long tokens, int k, long long rows, int d,
        cudaStream_t stream) {
  const int nvec = d / Vec<T>::N;
  if (tokens > 0)
    moe_combine_fwd<T><<<blocks(tokens, kWarps), kThreads, 0, stream>>>(
        static_cast<const uint4*>(y), slot, static_cast<const T*>(w),
        static_cast<uint4*>(out), tokens, k, rows, nvec);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* dout, const void* y, const long long* slot,
        const void* w, void* dy, void* dw, int* owner, long long tokens,
        int k, long long rows, int d, cudaStream_t stream) {
  const int nvec = d / Vec<T>::N;
  const long long routes = tokens * k;
  cudaError_t rc = cudaMemsetAsync(owner, 0xff, rows * sizeof(int), stream);
  if (rc != cudaSuccess) return (int)rc;
  if (routes > 0)
    moe_combine_bwd_owner<T><<<blocks(routes, kThreads), kThreads, 0,
                               stream>>>(slot, owner, static_cast<T*>(dw),
                                         routes, rows);
  moe_combine_bwd<T><<<blocks(rows, kWarps), kThreads, 0, stream>>>(
      static_cast<const uint4*>(dout), static_cast<const uint4*>(y), owner,
      static_cast<const T*>(w), static_cast<uint4*>(dy), static_cast<T*>(dw),
      rows, k, nvec);
  return (int)cudaGetLastError();
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 on
// success). bf16 = 1: y, w, out (dout, dy, dw) are bf16, else f32. y [rows,
// d], out [tokens, d], slot and w [tokens * k], contiguous, y, out, dout
// and dy 16-byte aligned, d a multiple of 8, tokens * k < 2^31; the
// caller owns every buffer (the owner map too: rows ints).
extern "C" int moe_combine_fwd_launch(int bf16, const void* y,
                                      const long long* slot, const void* w,
                                      void* out, long long tokens, int k,
                                      long long rows, int d,
                                      cudaStream_t stream) {
  return bf16 ? fwd<__nv_bfloat16>(y, slot, w, out, tokens, k, rows, d, stream)
              : fwd<float>(y, slot, w, out, tokens, k, rows, d, stream);
}

extern "C" int moe_combine_bwd_launch(int bf16, const void* dout,
                                      const void* y, const long long* slot,
                                      const void* w, void* dy, void* dw,
                                      int* owner, long long tokens, int k,
                                      long long rows, int d,
                                      cudaStream_t stream) {
  return bf16 ? bwd<__nv_bfloat16>(dout, y, slot, w, dy, dw, owner, tokens,
                                   k, rows, d, stream)
              : bwd<float>(dout, y, slot, w, dy, dw, owner, tokens, k, rows,
                           d, stream);
}
