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
// (_dequant_kernel). The Pallas tile holds all rows of a channel tile in
// VMEM, so one pass reduces and applies. Here the rows of a channel are
// spread over the whole card, so the reduction crosses blocks.
//
// Bound: memory. K2 reads x and res and writes q and res' (13 bytes an
// element; 9 without res; 17 when z is written too), K3 reads q and
// writes x (5 bytes). At the largest MobileNetV2 boundary, [65536, 32],
// that is 27.3 MB (8.1 us) and 10.5 MB (3.1 us) at 3.35 TB/s.
//
// K2 is one cooperative launch (every block resident, one a SM):
//   1. each block walks its share of the 16-byte units of x (and res)
//      once (kUnroll units a thread in flight, streaming loads), forms
//      z, keeps it in shared memory when the plan says it fits (the
//      re-read branch otherwise), and reduces min and max per
//      channel on order-preserving integer keys (exact in any order, -0
//      below +0) and a non-finite flag into its own partials, all C of
//      them, so nothing needs zeroing first;
//   2. grid barrier (cooperative_groups);
//   3. every block folds all blocks' partials into lo and scale for every
//      channel (the plan keeps blocks * C small), stages them in shared
//      memory, and writes q and res' from the z it kept (or re-reads x
//      and res). Block 0 writes lo, scale and ok.
// The flat index is cut into periods of lcm(C, 4) elements: a unit j of
// a period always holds the same four channels, so a thread keeps its
// unit column j and walks periods, with no modulo per element.
//
// K3 reads 16 codes with one 16-byte load, on the same periods of
// lcm(C, 16) elements, with its 16 channels' lo and scale in registers,
// and writes them with four float4 stores. Where a warp's 32 units are
// contiguous (it checks), it passes its outputs through shared memory
// first: each
// of its four stores then writes 512 contiguous bytes, where storing
// straight from the registers would leave 64 bytes between neighbouring
// threads (half sectors, twice the write transactions).
//
// Every operation is rounded on its own (__fadd_rn, __fsub_rn, __fmul_rn,
// __fdiv_rn; rintf rounds half to even), in the plain PyTorch version's
// order, so nvcc contracts nothing into an FMA and the kernels are
// bit-identical to kernels/quant/ref.py. K2's dequantized value and K3
// are the same expression, so res' == z - K3(q) holds bit for bit.
//
// A pointer's first elements up to its 16-byte boundary (the head) and
// the elements after its last whole unit (the tail) are taken one at a
// time by block 0. kernels/quant/ops.py plans the grid, the shares and
// the branch, and places the outputs at x's (K2) or the codes' (K3)
// 16-byte phase; the launchers check what the kernels assume.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kQuantThreads = 1024;    // K2: one block an SM
constexpr int kDequantThreads = 256;   // K3
constexpr int kUnroll = 2;             // K2 units a thread loads at once
constexpr int kKeysMax = 8192;         // channels whose keys stay on chip
constexpr int kSmemMax = 231424;       // dynamic shared memory (H100: 227
                                       // KB a block, less 1 KB static)

struct QuantArgs {
  const float* x;          // [n]
  const float* res;        // [n] or null
  unsigned char* q;        // [n]
  float* res_out;          // [n]
  float* z_out;            // [n] or null
  float* lo_out;           // [C]
  float* scale_out;        // [C]
  unsigned char* ok;       // one byte
  uint32_t* part;          // [grid][2C] keys (lo, hi), then [grid] flags
  long long units;         // whole 16-byte units of x after the head
  long long periods;       // ceil(units / J)
  long long per_block;     // periods a block takes
  int C, J, Jt, Rt;        // units a period; threads across, down
  int head, tail;          // single elements before and after the units
  float levels, inv_levels;
  int res_vec;             // res + head is 16-byte aligned
  int z_on_chip;           // z kept in shared memory across the barrier
  int keys_on_chip;        // per-channel keys in shared memory
};

struct DequantArgs {
  const unsigned char* q;  // [n]
  const float* lo;         // [C]
  const float* scale;      // [C]
  float* out;              // [n]
  long long units;         // whole 16-code units after the head
  long long periods;
  long long per_block;
  int C, J, Jt, Rt, head, tail;
};

// Order-preserving map f32 -> u32: a < b as floats iff key(a) < key(b)
// (with -0 below +0), so integer min/max give the float min/max exactly.
__device__ __forceinline__ uint32_t key_of(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ int next_channel(int c, int C) {
  return ++c == C ? 0 : c;
}

// z of one element, with its code and residual: the plain version's order
__device__ __forceinline__ float dequant1(float l, float s, float qf) {
  return __fadd_rn(l, __fmul_rn(s, qf));
}

__device__ __forceinline__ uint32_t quant1(float z, float l, float s,
                                           float levels, float* r) {
  float qf = 0.0f;
  if (s > 0.0f) {
    qf = rintf(__fdiv_rn(__fsub_rn(z, l), s));
    qf = fminf(fmaxf(qf, 0.0f), levels);
  }
  *r = __fsub_rn(z, dequant1(l, s, qf));
  return (uint32_t)qf;
}

// the keys of four elements into a thread's running min and max
__device__ __forceinline__ void reduce4(const float (&z)[4], uint32_t (&lo)[4],
                                        uint32_t (&hi)[4], bool& bad) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bad |= !isfinite(z[i]);
    const uint32_t key = key_of(z[i]);
    lo[i] = min(lo[i], key);
    hi[i] = max(hi[i], key);
  }
}

// Up to kUnroll units of a thread (unit k at p + k * Rt periods, if
// have[k]): every load of x and res is issued before any value is used,
// with the streaming hint (each is read once where z stays on chip).
template <bool RES, bool RES_VEC>
__device__ __forceinline__ void load_units(const QuantArgs& a, long long p,
                                           long long p1, int j,
                                           long long (&u)[kUnroll],
                                           bool (&have)[kUnroll],
                                           float (&z)[kUnroll][4]) {
  const float4* x4 = reinterpret_cast<const float4*>(a.x + a.head);
  float4 xv[kUnroll], rv[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long pk = p + (long long)k * a.Rt;
    u[k] = pk * a.J + j;
    have[k] = pk < p1 && u[k] < a.units;
    if (!have[k]) continue;
    xv[k] = __ldcs(x4 + u[k]);
    if (RES_VEC) {
      rv[k] = __ldcs(reinterpret_cast<const float4*>(a.res + a.head) + u[k]);
    } else if (RES) {
      const float* rp = a.res + a.head + 4 * u[k];
      rv[k] = make_float4(__ldg(rp), __ldg(rp + 1), __ldg(rp + 2),
                          __ldg(rp + 3));
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    if (!have[k]) continue;
    z[k][0] = xv[k].x; z[k][1] = xv[k].y; z[k][2] = xv[k].z;
    z[k][3] = xv[k].w;
    if (RES) {
      z[k][0] = __fadd_rn(z[k][0], rv[k].x);
      z[k][1] = __fadd_rn(z[k][1], rv[k].y);
      z[k][2] = __fadd_rn(z[k][2], rv[k].z);
      z[k][3] = __fadd_rn(z[k][3], rv[k].w);
    }
  }
}

// element e of the head or tail, taken by thread tid of block 0: threads
// 0..head-1 the head, threads 32..32+tail-1 the tail; -1 for the others
__device__ __forceinline__ long long single_element(int tid, int head,
                                                    int tail, long long
                                                    first_tail) {
  if (tid < head) return tid;
  if (tid >= 32 && tid < 32 + tail) return first_tail + (tid - 32);
  return -1;
}

__device__ __forceinline__ uint32_t load_key(const uint32_t* k, int c,
                                             bool on_chip) {
  return on_chip ? k[c] : __ldcg(k + c);
}

__device__ __forceinline__ float load_param(const float* p, int c,
                                            bool on_chip) {
  return on_chip ? p[c] : __ldcg(p + c);
}

// RES: a residual is added; RES_VEC: it is read 16 bytes at a time
template <bool RES, bool RES_VEC>
__global__ void __launch_bounds__(kQuantThreads, 1)
quantize_ef_kernel(const QuantArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, tid = threadIdx.x, b = blockIdx.x, G = gridDim.x;
  const bool kc = a.keys_on_chip;
  uint32_t* const own = a.part + (size_t)b * 2 * C;
  uint32_t* const flags = a.part + (size_t)G * 2 * C;
  uint32_t* const klo = kc ? reinterpret_cast<uint32_t*>(smem) : own;
  uint32_t* const khi = klo + C;
  float4* const zs = reinterpret_cast<float4*>(
      smem + (kc ? ((8 * C + 15) & ~15) : 0));
  const int jt = tid % a.Jt, rt = tid / a.Jt;
  const bool active = rt < a.Rt;
  // a unit column a thread, and whole warps of it: fold lanes by shuffles
  const bool shuffle = a.Jt < 32 && (a.Jt & (a.Jt - 1)) == 0 && a.J == a.Jt;
  const long long p0 = (long long)b * a.per_block;
  const long long p1 = min(p0 + a.per_block, a.periods);
  const long long u0 = p0 * a.J, u1 = min(p1 * a.J, a.units);
  float4* const zo = a.z_out
      ? reinterpret_cast<float4*>(a.z_out + a.head) : nullptr;
  const long long first_tail = a.head + 4 * a.units;
  bool bad = false;
  for (int c = tid; c < 2 * C; c += kQuantThreads)
    klo[c] = c < C ? 0xffffffffu : 0u;
  __syncthreads();

  // ---- 1. read x and res once: z, its keys, its non-finite flag ----
  for (int j = jt; active && j < a.J; j += a.Jt) {
    int ch[4];
    ch[0] = (int)((a.head + 4LL * j) % C);
#pragma unroll
    for (int i = 1; i < 4; ++i) ch[i] = next_channel(ch[i - 1], C);
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) { lo[i] = 0xffffffffu; hi[i] = 0u; }
    for (long long p = p0 + rt; p < p1; p += kUnroll * a.Rt) {
      long long u[kUnroll];
      bool have[kUnroll];
      float z[kUnroll][4];
      load_units<RES, RES_VEC>(a, p, p1, j, u, have, z);
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (!have[k]) continue;
        const float4 v = make_float4(z[k][0], z[k][1], z[k][2], z[k][3]);
        if (a.z_on_chip) zs[u[k] - u0] = v;
        if (zo) zo[u[k]] = v;
        reduce4(z[k], lo, hi, bad);
      }
    }
    if (shuffle) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        for (int m = a.Jt; m < 32; m <<= 1) {
          lo[i] = min(lo[i], __shfl_xor_sync(0xffffffffu, lo[i], m));
          hi[i] = max(hi[i], __shfl_xor_sync(0xffffffffu, hi[i], m));
        }
      if ((tid & 31) >= a.Jt) continue;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      atomicMin(klo + ch[i], lo[i]);
      atomicMax(khi + ch[i], hi[i]);
    }
  }
  if (b == 0) {
    const long long e = single_element(tid, a.head, a.tail, first_tail);
    if (e >= 0) {
      const float z = a.res ? __fadd_rn(a.x[e], a.res[e]) : a.x[e];
      if (a.z_out) a.z_out[e] = z;
      bad |= !isfinite(z);
      const int c = (int)(e % C);
      atomicMin(klo + c, key_of(z));
      atomicMax(khi + c, key_of(z));
    }
  }
  bad = __syncthreads_or(bad);
  if (kc)
    for (int c = tid; c < 2 * C; c += kQuantThreads) own[c] = klo[c];
  if (tid == 0) flags[b] = bad ? 1u : 0u;

  // ---- 2. every block's partials are written ----
  cg::this_grid().sync();

  // ---- 3. fold all blocks' partials into lo and scale ----
  if (kc) {
    // this block's own keys are in klo/khi: fold the other blocks' in
    const int Ct = C < kQuantThreads ? C : kQuantThreads;
    const int L = kQuantThreads / Ct, l = tid / Ct;
    for (int c = tid % Ct; l < L && c < C; c += Ct) {
      uint32_t lo = 0xffffffffu, hi = 0u;
      for (int g = l; g < G; g += L) {
        if (g == b) continue;
        const uint32_t* pg = a.part + (size_t)g * 2 * C;
        lo = min(lo, __ldcg(pg + c));
        hi = max(hi, __ldcg(pg + C + c));
      }
      atomicMin(klo + c, lo);
      atomicMax(khi + c, hi);
    }
  }
  bool any = false;
  for (int g = tid; g < G; g += kQuantThreads) any |= __ldcg(flags + g) != 0u;
  any = __syncthreads_or(any);
  float* const plo = kc ? reinterpret_cast<float*>(klo) : a.lo_out;
  float* const psc = kc ? reinterpret_cast<float*>(khi) : a.scale_out;
  for (int c = tid; c < C; c += kQuantThreads) {
    const float lo = float_of(load_key(klo, c, kc));
    const float hi = float_of(load_key(khi, c, kc));
    float scale = __fmul_rn(__fsub_rn(hi, lo), a.inv_levels);
    if (!(isfinite(scale) && scale > 0.0f)) scale = 0.0f;
    plo[c] = lo;                    // in place over the keys when on chip
    psc[c] = scale;
    if (b == 0 && kc) {
      a.lo_out[c] = lo;
      a.scale_out[c] = scale;
    }
  }
  if (b == 0 && tid == 0) *a.ok = any ? 0 : 1;
  __syncthreads();

  // ---- 4. q and res' from the z kept (or x and res read again) ----
  uint32_t* const qv = reinterpret_cast<uint32_t*>(a.q + a.head);
  float4* const ro = reinterpret_cast<float4*>(a.res_out + a.head);
  for (int j = jt; active && j < a.J; j += a.Jt) {  // apply
    float l[4], s[4];
    int c = (int)((a.head + 4LL * j) % C);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l[i] = load_param(plo, c, kc);
      s[i] = load_param(psc, c, kc);
      c = next_channel(c, C);
    }
    for (long long p = p0 + rt; p < p1; p += kUnroll * a.Rt) {
      long long u[kUnroll];
      bool have[kUnroll];
      float z[kUnroll][4];
      if (a.z_on_chip) {
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const long long pk = p + (long long)k * a.Rt;
          u[k] = pk * a.J + j;
          have[k] = pk < p1 && u[k] < a.units;
          if (!have[k]) continue;
          const float4 v = zs[u[k] - u0];
          z[k][0] = v.x; z[k][1] = v.y; z[k][2] = v.z; z[k][3] = v.w;
        }
      } else {
        load_units<RES, RES_VEC>(a, p, p1, j, u, have, z);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (!have[k]) continue;
        float r[4];
        uint32_t codes = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          codes |= quant1(z[k][i], l[i], s[i], a.levels, &r[i]) << (8 * i);
        qv[u[k]] = codes;
        ro[u[k]] = make_float4(r[0], r[1], r[2], r[3]);
      }
    }
  }
  if (b == 0) {
    const long long e = single_element(tid, a.head, a.tail, first_tail);
    if (e >= 0) {
      const float z = a.res ? __fadd_rn(a.x[e], a.res[e]) : a.x[e];
      const int c = (int)(e % C);
      float r;
      a.q[e] = (unsigned char)quant1(z, load_param(plo, c, kc),
                                     load_param(psc, c, kc), a.levels, &r);
      a.res_out[e] = r;
    }
  }
}

// at most 85 registers, so that 3 blocks an SM (the plan's grid) are
// resident at once
__global__ void __launch_bounds__(kDequantThreads, 3)
dequantize_kernel(const DequantArgs a) {
  const int C = a.C, tid = threadIdx.x;
  const int jt = tid % a.Jt, rt = tid / a.Jt;
  const long long p0 = (long long)blockIdx.x * a.per_block;
  const long long p1 = min(p0 + a.per_block, a.periods);
  // a warp's 32 units of output, transposed so that each of its four
  // stores writes 512 contiguous bytes (swizzled: no bank conflicts)
  __shared__ float4 stage[kDequantThreads / 32][128];
  const int lane = tid & 31;
  float4* const st = stage[tid >> 5];
  const uint4* const qv = reinterpret_cast<const uint4*>(a.q + a.head);
  float4* const ov = reinterpret_cast<float4*>(a.out + a.head);
  for (int j = jt; rt < a.Rt && j < a.J; j += a.Jt) {
    // the first unit's codes are in flight while lo and scale load
    long long p = p0 + rt, u = p * a.J + j;
    bool have = p < p1 && u < a.units;
    uint4 v = have ? __ldcs(qv + u) : make_uint4(0u, 0u, 0u, 0u);
    float l[16], s[16];
    int c = (int)((a.head + 16LL * j) % C);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      l[i] = __ldg(a.lo + c);
      s[i] = __ldg(a.scale + c);
      c = next_channel(c, C);
    }
    while (have) {
      p += a.Rt;
      const long long un = p * a.J + j;
      const bool next = p < p1 && un < a.units;
      const uint4 vn = next ? __ldcs(qv + un) : v;
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      float4 o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float f[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          f[i] = dequant1(l[4 * k + i], s[4 * k + i],
                          (float)((w[k] >> (8 * i)) & 0xffu));
        o[k] = make_float4(f[0], f[1], f[2], f[3]);
      }
      // the warp's units are u0 + lane for every lane: transpose
      const unsigned act = __activemask();
      long long ua = -1;
      if (act == 0xffffffffu) {
        ua = __shfl_sync(act, u, 0);
        if (!__all_sync(act, u == ua + lane)) ua = -1;
      }
      if (ua >= 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          st[4 * lane + (k ^ ((lane >> 1) & 3))] = o[k];
        __syncwarp();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int f = 32 * k + lane, sl = f >> 2;
          ov[4 * ua + f] = st[4 * sl + ((f & 3) ^ ((sl >> 1) & 3))];
        }
        __syncwarp();
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) ov[4 * u + k] = o[k];
      }
      v = vn;
      u = un;
      have = next;
    }
  }
  if (blockIdx.x == 0) {
    const long long e = single_element(tid, a.head, a.tail,
                                       a.head + 16 * a.units);
    if (e >= 0) {
      const int c = (int)(e % C);
      a.out[e] = dequant1(a.lo[c], a.scale[c], (float)a.q[e]);
    }
  }
}

int gcd_of(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// K2 on `stream`: one cooperative launch; returns the CUDA error (0 on
// success). x, res (or null), q, res_out and z_out (or null: z is not
// written; null too when res is) hold n elements of C channels; lo_out
// and scale_out C floats; ok one byte; part (grid * (2C + 1)) u32, its
// contents unused. The plan (kernels/quant/ops.py) gives grid, per_block
// (periods a block takes), head (elements before x's 16-byte boundary),
// res_vec (res + head 16-byte aligned), z_on_chip and smem_bytes. The
// caller owns every buffer; nothing is allocated.
extern "C" int quantize_ef_launch(
    const float* x, const float* res, long long n, int C, int levels,
    float inv_levels, unsigned char* q, float* lo_out, float* scale_out,
    float* res_out, float* z_out, unsigned char* ok, uint32_t* part,
    int grid, long long per_block, int head, int res_vec, int z_on_chip,
    int smem_bytes, cudaStream_t stream) {
  if (n <= 0 || C <= 0 || grid <= 0 || head < 0 || head > 3 ||
      head > n || smem_bytes < 0 || smem_bytes > kSmemMax)
    return (int)cudaErrorInvalidValue;
  QuantArgs a;
  a.x = x; a.res = res; a.q = q; a.res_out = res_out;
  a.z_out = res ? z_out : nullptr;
  a.lo_out = lo_out; a.scale_out = scale_out; a.ok = ok; a.part = part;
  a.C = C;
  a.J = C / gcd_of(C, 4);
  a.Jt = a.J < kQuantThreads ? a.J : kQuantThreads;
  a.Rt = kQuantThreads / a.Jt;
  a.head = head;
  a.units = (n - head) / 4;
  a.tail = (int)((n - head) % 4);
  a.periods = (a.units + a.J - 1) / a.J;
  a.per_block = per_block;
  a.levels = (float)levels;
  a.inv_levels = inv_levels;
  a.res_vec = res_vec;
  a.z_on_chip = z_on_chip;
  a.keys_on_chip = C <= kKeysMax;
  const long long keys = a.keys_on_chip ? ((8LL * C + 15) & ~15LL) : 0;
  const bool fits = (long long)grid * per_block >= a.periods &&
      (a.keys_on_chip || grid == 1) &&
      smem_bytes >= keys + (z_on_chip ? per_block * a.J * 16 : 0);
  const bool vec = a.units == 0 ||
      (aligned(x + head, 16) && aligned(res_out + head, 16) &&
       aligned(q + head, 4) && (!a.z_out || aligned(z_out + head, 16)) &&
       (!res || !res_vec || aligned(res + head, 16)));
  if (!fits || !vec) return (int)cudaErrorInvalidValue;
  void (*const kernels[3])(QuantArgs) = {quantize_ef_kernel<false, false>,
                                         quantize_ef_kernel<true, false>,
                                         quantize_ef_kernel<true, true>};
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaSuccess;
    for (auto k : kernels)
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    return e;
  }();
  if (attr != cudaSuccess) return (int)attr;
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)kernels[res ? 1 + (res_vec != 0) : 0], dim3(grid),
      dim3(kQuantThreads), args, (size_t)smem_bytes, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// K3 on `stream`; returns the CUDA error. q and out hold n elements (n a
// multiple of C), lo and scale C floats. The plan gives grid, per_block
// and head (codes before q's 16-byte boundary); out + head must be
// 16-byte aligned.
extern "C" int dequantize_launch(const unsigned char* q, const float* lo,
                                 const float* scale, long long n, int C,
                                 float* out, int grid, long long per_block,
                                 int head, cudaStream_t stream) {
  if (n <= 0 || C <= 0 || grid <= 0 || head < 0 || head > 15 || head > n)
    return (int)cudaErrorInvalidValue;
  DequantArgs a;
  a.q = q; a.lo = lo; a.scale = scale; a.out = out;
  a.C = C;
  a.J = C / gcd_of(C, 16);
  a.Jt = a.J < kDequantThreads ? a.J : kDequantThreads;
  a.Rt = kDequantThreads / a.Jt;
  a.head = head;
  a.units = (n - head) / 16;
  a.tail = (int)((n - head) % 16);
  a.periods = (a.units + a.J - 1) / a.J;
  a.per_block = per_block;
  if ((long long)grid * per_block < a.periods ||
      (a.units > 0 && !(aligned(q + head, 16) && aligned(out + head, 16))))
    return (int)cudaErrorInvalidValue;
  dequantize_kernel<<<grid, kDequantThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
