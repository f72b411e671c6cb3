// Fused SGD + momentum + weight decay (the paper's optimizer, §IV-B) over
// one flat f32 parameter buffer:
//
//     g' = g + wd * p;   m' = mu * m + g';   p' = p - lr * m'
//
// Replaces the TPU kernel src/repro/kernels/fused_sgd/kernel.py:
// fused_sgd_kernel (its Pallas body _kernel). That kernel walks the buffer
// in blocks of 65536 and needs the caller to pad N to a block multiple;
// here a grid-stride loop covers any n with a masked tail, so nothing is
// padded or copied.
//
// Bound: memory. Each element reads p, g, m and writes p', m' (20 bytes)
// for 6 flops. The whole MobileNetV2-CIFAR chain (2,236,746 params) moves
// 44.7 MB, about 13 us at the H100 SXM's 3.35 TB/s. This first version
// makes plain 4-byte loads; 16-byte vector loads are left for a later,
// faster version.
//
// Every operation is rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn), in the plain PyTorch version's order, so nvcc cannot
// contract a multiply and an add into an FMA: the kernel is bit-identical
// to kernels/fused_sgd/ref.py on the card.
//
// The outputs are new buffers. The live runtime's vertical-sync stash and
// replica stores keep references to the inputs, which must not change.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;   // 16 blocks on each H100 SM

__global__ void fused_sgd_kernel(const float* __restrict__ p,
                                 const float* __restrict__ g,
                                 const float* __restrict__ m,
                                 float* __restrict__ p_out,
                                 float* __restrict__ m_out,
                                 long long n, float lr, float mu, float wd) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float pi = p[i];
    const float gi = __fadd_rn(g[i], __fmul_rn(wd, pi));
    const float mi = __fadd_rn(__fmul_rn(mu, m[i]), gi);
    m_out[i] = mi;
    p_out[i] = __fsub_rn(pi, __fmul_rn(lr, mi));
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). The
// caller owns all five buffers, each of n floats; nothing is allocated.
extern "C" int fused_sgd_launch(const float* p, const float* g,
                                const float* m, float* p_out, float* m_out,
                                long long n, float lr, float mu, float wd,
                                cudaStream_t stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fused_sgd_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      p, g, m, p_out, m_out, n, lr, mu, wd);
  return (int)cudaGetLastError();
}
