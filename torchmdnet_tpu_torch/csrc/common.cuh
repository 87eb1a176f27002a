// Device helpers shared by the fused edge-phase kernels (et_message.cu,
// t_message.cu, tn_message.cu): bf16 rounding, the activations and their first and second
// derivatives, head and warp sums, the tensor-core (mma.sync, ldmatrix)
// tiles of the filter products, and the per-group named barrier.  Each
// source includes it once; ops/kernels/build.py hashes it with every source
// that includes it, so an edit rebuilds them all.
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {
constexpr int KC = 16;  // edges per chunk: the M of one tensor-core tile

constexpr int MAX_GROUPS = 15;  // named barriers 1..15, one a row group
constexpr float kLog2 = 0.69314718055994530942f;

enum { ACT_SILU = 0, ACT_SSP = 1, ACT_TANH = 2, ACT_SIGMOID = 3 };

// x rounded to bf16 (nearest even), as f32.  The packed conversion
// (cvt.rn.bf16x2.f32, F2FP) issues at a higher rate than the scalar one
// (F2F) on this card; the bits are the same.
__device__ __forceinline__ float bfr(float x) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(0.0f), "f"(x));
  return __uint_as_float(r << 16);
}

// a and b rounded to bf16 by one conversion
__device__ __forceinline__ void bfr2(float& a, float& b) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(a), "f"(b));
  a = __uint_as_float(r & 0xffff0000u);
  b = __uint_as_float(r << 16);
}

// a bf16-valued f32 as bf16: its upper half, no conversion
__device__ __forceinline__ bf16 bf16_exact(float x) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(__float_as_uint(x) >> 16));
}

__device__ __forceinline__ float ldb(const bf16* p) { return __bfloat162float(*p); }

// fast exp and reciprocal (MUFU): ~2 ulp in f32, far below the bf16
// rounding every activation goes through
__device__ __forceinline__ float sigmoid_f(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }

__device__ __forceinline__ float act_fn(int a, float x) {
  switch (a) {
    case ACT_SILU: return x * sigmoid_f(x);
    case ACT_SSP: return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x))) - kLog2;
    case ACT_TANH: return tanhf(x);
    default: return sigmoid_f(x);
  }
}

// f(x), f'(x) and f''(x) of an activation, in f32
__device__ __forceinline__ void act3(int a, float x, float* f, float* f1, float* f2) {
  switch (a) {
    case ACT_SILU: {
      const float s = sigmoid_f(x);
      *f = x * s;
      *f1 = s * (1.0f + x * (1.0f - s));
      *f2 = s * (1.0f - s) * (2.0f + x * (1.0f - 2.0f * s));
      return;
    }
    case ACT_SSP: {
      const float s = sigmoid_f(x);
      *f = fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x))) - kLog2;
      *f1 = s;
      *f2 = s * (1.0f - s);
      return;
    }
    case ACT_TANH: {
      const float t = tanhf(x);
      *f = t;
      *f1 = 1.0f - t * t;
      *f2 = -2.0f * t * (1.0f - t * t);
      return;
    }
    default: {
      const float s = sigmoid_f(x);
      *f = s;
      *f1 = s * (1.0f - s);
      *f2 = s * (1.0f - s) * (1.0f - 2.0f * s);
    }
  }
}

__device__ __forceinline__ float dact_fn(int a, float x) {
  switch (a) {
    case ACT_SILU: {
      const float s = sigmoid_f(x);
      return s * (1.0f + x * (1.0f - s));
    }
    case ACT_SSP: return sigmoid_f(x);
    case ACT_TANH: {
      const float t = tanhf(x);
      return 1.0f - t * t;
    }
    default: {
      const float s = sigmoid_f(x);
      return s * (1.0f - s);
    }
  }
}

// Sum over an aligned group of `width` lanes (a power of two <= 32).  The
// butterfly gives every lane of the group the same bits.
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__host__ __device__ inline int rbf_pad(int rbf) { return (rbf + 15) / 16 * 16; }
// row stride (bf16 elements) of the weight and ea tiles: a multiple of 8, as
// wmma wants, and 8 past the padded RBF so rows start on different banks
__host__ __device__ inline int w_ld(int rbf) { return rbf_pad(rbf) + 8; }
__host__ __device__ inline size_t align32(size_t x) { return (x + 31) & ~size_t(31); }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(const void* p, unsigned r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(const void* p, unsigned r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row major) . b (16x8 bf16, column major)
__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the named barrier of row group g (its H threads only; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int g, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "r"(threads) : "memory");
}

// Four sums over a warp at once: lane l ends with the sum of v[(l >> 3) & 3]
// over the warp.  The pairs (l, l^16), (l, l^8), then 4, 2, 1 are those of
// group_sum(v[i], 32), so (addition being commutative) the bits are the
// same; 6 shuffles instead of 20.
__device__ __forceinline__ float warp_sum4(float v0, float v1, float v2, float v3, int lane) {
  const bool hi = lane & 16, h8 = lane & 8;
  float a = hi ? v2 : v0, b = hi ? v3 : v1;
  a += __shfl_xor_sync(0xffffffffu, hi ? v0 : v2, 16);
  b += __shfl_xor_sync(0xffffffffu, hi ? v1 : v3, 16);
  float s = h8 ? b : a;
  s += __shfl_xor_sync(0xffffffffu, h8 ? a : b, 8);
  for (int off = 4; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// Two sums over each aligned group of `width` lanes at once (a power of
// two <= 32): the pairs are group_sum's, so the bits are the same;
// log2(width) + 1 shuffles instead of 2 log2(width).
__device__ __forceinline__ void group_sum2(float& a, float& b, int width, int lane) {
  if (width < 2) return;
  const int half = width >> 1;
  const bool up = lane & half;
  float s = up ? b : a;
  s += __shfl_xor_sync(0xffffffffu, up ? a : b, half);
  for (int off = half >> 1; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float o = __shfl_xor_sync(0xffffffffu, s, half);
  a = up ? o : s;
  b = up ? s : o;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ unsigned ldg_u32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned*>(p));
}

// p[0] and p[ld] packed (a column pair of a row-major matrix)
__device__ __forceinline__ unsigned ldg_pair_t(const bf16* p, int ld) {
  const unsigned lo = __ldg(reinterpret_cast<const unsigned short*>(p));
  const unsigned hi = __ldg(reinterpret_cast<const unsigned short*>(p + ld));
  return lo | (hi << 16);
}

// out (KC, F) bf16 = bf16(sum over npairs of A_p (KC, RBFP; shared, ld ldw)
// . B_p^T), B_p (F, RBFP) the filters as rows: pair 0's in shared memory
// (bs0, ld ldw) or in device memory (bg0, ld RBFP), pair 1's in device
// memory.  The group's nw warps take 16-column blocks warp, warp + nw, ...,
// two at a time; the sum over RBF runs in k steps of 16 in order (pair 0
// first): the order of the forward's wmma products, so the filters are
// bitwise the forward's.
__device__ void filter_tile(int npairs, const bf16* a0, const bf16* bs0, const bf16* bg0,
                            const bf16* a1, const bf16* bg1, int ldw, int rbfp, int f, bf16* out,
                            int ldp, int warp, int nw, int lane) {
  const int g = lane >> 2, t = lane & 3, blocks = f / 16;
  for (int u0 = warp; u0 < blocks; u0 += 2 * nw) {
    float c[2][2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int x = 0; x < 8; ++x) c[q][x / 4][x % 4] = 0.0f;
    for (int pr = 0; pr < npairs; ++pr) {
      const bf16* a = pr ? a1 : a0;
      const bf16* bs = pr ? nullptr : bs0;
      const bf16* bg = pr ? bg1 : bg0;
      for (int k0 = 0; k0 < rbfp; k0 += 16) {
        unsigned af[4];
        ldsm_x4(a + (lane & 15) * ldw + k0 + ((lane >> 4) << 3), af);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int u = u0 + q * nw;
          if (u >= blocks) continue;
          unsigned b[4];
          if (bs) {
            ldsm_x4(bs + (size_t)(u * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldw + k0 +
                        (((lane >> 3) & 1) << 3),
                    b);
          } else {
            const bf16* r = bg + (size_t)(u * 16 + g) * rbfp + k0 + 2 * t;
            b[0] = ldg_u32(r);
            b[1] = ldg_u32(r + 8);
            b[2] = ldg_u32(r + (size_t)8 * rbfp);
            b[3] = ldg_u32(r + (size_t)8 * rbfp + 8);
          }
          mma_bf16(c[q][0], af, b[0], b[1]);
          mma_bf16(c[q][1], af, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int u = u0 + q * nw;
      if (u >= blocks) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int col = u * 16 + hf * 8 + 2 * t;
        *reinterpret_cast<unsigned*>(out + g * ldp + col) = pack_bf16(c[q][hf][0], c[q][hf][1]);
        *reinterpret_cast<unsigned*>(out + (g + 8) * ldp + col) = pack_bf16(c[q][hf][2], c[q][hf][3]);
      }
    }
  }
}

// d ea of a chunk: out rows e0 .. e0 + kn (RBF bf16 each) = sum over npairs
// of A_p (KC, F; shared, ld ldp) . B_p, B_p the filters (F, RBFP): pair 0's
// in shared memory (bs0, (F, ldw) rows read transposed) or device memory
// (bg0, ld RBFP), pair 1's in device memory.  Warps take 16-column blocks;
// the sum over F runs in k steps of 16 in order, pair 0 first.
__device__ void dea_tile(int npairs, const bf16* a0, const bf16* bs0, const bf16* bg0,
                         const bf16* a1, const bf16* bg1, int f, int ldp, int ldw, int rbf,
                         int rbfp, bf16* out, size_t e0, int kn, int warp, int nw, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int v = warp; v < rbfp / 16; v += nw) {
    float c[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    for (int pr = 0; pr < npairs; ++pr) {
      const bf16* a = pr ? a1 : a0;
      const bf16* bs = pr ? nullptr : bs0;
      const bf16* bg = pr ? bg1 : bg0;
      for (int k0 = 0; k0 < f; k0 += 16) {
        unsigned af[4], b[4];
        ldsm_x4(a + (lane & 15) * ldp + k0 + ((lane >> 4) << 3), af);
        if (bs) {
          ldsm_x4_t(bs + (size_t)(k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ldw + v * 16 +
                        ((lane >> 4) << 3),
                    b);
        } else {
          const bf16* col = bg + (size_t)(k0 + 2 * t) * rbfp + v * 16 + g;
          b[0] = ldg_pair_t(col, rbfp);
          b[1] = ldg_pair_t(col + (size_t)8 * rbfp, rbfp);
          b[2] = ldg_pair_t(col + 8, rbfp);
          b[3] = ldg_pair_t(col + (size_t)8 * rbfp + 8, rbfp);
        }
        mma_bf16(c[0], af, b[0], b[1]);
        mma_bf16(c[1], af, b[2], b[3]);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int col = v * 16 + hf * 8 + 2 * t;  // even, and RBF is even
      if (col >= rbf) continue;
      if (g < kn)
        *reinterpret_cast<__nv_bfloat162*>(out + (e0 + g) * rbf + col) =
            __floats2bfloat162_rn(c[hf][0], c[hf][1]);
      if (g + 8 < kn)
        *reinterpret_cast<__nv_bfloat162*>(out + (e0 + g + 8) * rbf + col) =
            __floats2bfloat162_rn(c[hf][2], c[hf][3]);
    }
  }
}

// a chunk's rows of the (KC, F) bf16 tile to rows e0 .. e0 + kn of a (E, F)
// array, 16 bytes at a time
__device__ __forceinline__ void store_tile(const bf16* tile, int ldp, int f, bf16* out, size_t e0,
                                           int kn, int hh, int threads) {
  const int per_row = f / 8;
  for (int x = hh; x < kn * per_row; x += threads) {
    const int r = x / per_row, c8 = x % per_row;
    *reinterpret_cast<uint4*>(out + (e0 + r) * f + c8 * 8) =
        *reinterpret_cast<const uint4*>(tile + r * ldp + c8 * 8);
  }
}

// Round a staged chunk's first n edge scalars (rows of KC) to bf16 in
// place, once for the group, between the barrier that lands the chunk and
// the one after the filter tile.
__device__ __forceinline__ void round_scalars(float* sc_s, int n, int hh, int threads) {
  for (int x = hh; x < n * KC; x += threads) sc_s[x] = bfr(sc_s[x]);
}

}  // namespace
