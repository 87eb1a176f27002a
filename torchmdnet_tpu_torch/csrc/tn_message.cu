// Fused TensorNet message phase for Hopper (sm_90a): forward, backward and
// second order.
//
// Replaces the Pallas TPU kernels of torchmdnet_tpu/ops/pallas/tn_message.py:
//   tn_fwd_kernel  <- _fwd_kernel (:77, launched by fused_tn_messages at :710)
//   tn_bwd_kernel  <- _bwd_kernel (:107, launched by _tn_bwd_op at :302)
//   tn_bwd2_kernel <- _tn_bwd2_kernel (:455, launched by _tn_bwd2_op at :624)
//   tn_src_sum_kernel <- _table_scatter, the second order's source-row sum
//   tn_wgrad_kernel, tn_colsum_kernel <- the kernels' weight-gradient
//                    accumulators (dw*_acc, db*_acc), as a reduction over edges
//
// What one layer computes, per receiver atom i and neighbor slot k (j = idx[i, k]):
//   w  = act(L3(act(L2(act(L1(ea[i,k])))))) * cutm[i,k]      (3H: thirds I, A, S)
//   m_i[c] = sum_k cat[j, c] * w[third(c)]                    (9H)
// with cat's nine components [lam, a10, a20, a21, s00, s11, s01, s02, s12]
// and third(c) = I, A, A, A, S, S, S, S, S.  Precision is the JAX kernel's:
// bf16 operands; each layer's f32 product rounded to bf16 before + b in
// bf16; activations in f32 rounded to bf16; w and every product with a
// gathered row rounded to bf16; f32 sums over the K slots; f32 outputs.
//
// What bounds it on an H100 at the DHFR shapes (N = 2496, K = 65, H = 128,
// RBF = 32): the edge MLP is 2 * (32*128 + 128*256 + 256*384) = 0.27 MFLOP
// per edge, 44 GFLOP per forward: 0.044 ms on the bf16 tensor cores; the
// bytes are ~28 MB (ea 10 MB, the gathered rows from L2), 0.009 ms.  So it
// is bound by operations.
//
// What the design does about it (a first, simple design):
//   * a block owns a contiguous range of receiver rows and walks their edges
//     (flattened i*K + k) in tiles of M edges; the three layers of each tile
//     run on the tensor cores (wmma bf16 16x16x16, f32 accumulation), the
//     activations live in shared memory between layers, and nothing of the
//     MLP goes to device memory.  The weights (W2 64 KB and W3 192 KB in
//     bf16 at H = 128: more than a block's shared memory next to the tile)
//     are read by the wmma loads from L2, where they stay resident;
//   * 3H threads: thread (third, h) owns channel h of one third of w and the
//     components that third multiplies (1, 3 or 5), gathers those source
//     values by index (no block plan, no one-hot product: TPU layout
//     workarounds) and keeps its f32 row sums in registers, written when the
//     row ends.  No float atomics anywhere: every result is bitwise the same
//     from run to run;
//   * the backward recomputes the MLP per tile, as the TPU kernel does.  Its
//     source-row cotangent d_cat[j] = sum over slots pointing at j of
//     ct_i * w[i,k] needs no scatter: w depends only on the edge's distance
//     and cutoff, the same for (i, j) and (j, i), so on the symmetric list
//     the port requires d_cat[j] = sum_k' ct[idx[j,k']] * w[j,k'], the
//     forward's gather form with ct as the source table;
//   * the second order is the VJP of the backward with respect to (inputs,
//     ct) given cotangents Z on its outputs: S = <vjp_f(a)(ct), Z> =
//     <ct, J_f(a) . Z>, so g_ct = J_f(a) . Z is a dual-number forward (every
//     MLP value carries a tangent driven by Z) and g_inputs is the reverse of
//     that forward seeded with ct, written out per layer with the
//     activations' second derivatives.  Its source-row gradient depends on Z
//     (not symmetric), so the kernel writes the tangent of w per edge (3H
//     f32) and tn_src_sum_kernel sums ct_i * w_dot through the transpose
//     permutation;
//   * weight cotangents, when wanted, are not accumulated in the kernels
//     (W3's alone is 384 KB in f32): the kernels write each edge's layer
//     inputs and pre-activation cotangents (bf16, as they are already) and
//     tn_wgrad_kernel reduces A^T B over the edges on the tensor cores in
//     a few edge splits, whose f32 partials the caller sums once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;
using namespace nvcuda;

namespace {

constexpr int FWD_M = 64;   // edges per tile: forward
constexpr int BWD_M = 32;   // backward and second order
constexpr int MAX_H = 128;  // 3H threads per block
constexpr int MAX_RBFP = 128;
constexpr float kLog2 = 0.69314718055994530942f;

enum { ACT_SILU = 0, ACT_SSP = 1, ACT_TANH = 2, ACT_SIGMOID = 3 };

__device__ __forceinline__ float bfr(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
__device__ __forceinline__ float ldb(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ bf16 f2b(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ float sigmoid_f(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }

__device__ __forceinline__ float act_fn(int a, float x) {
  switch (a) {
    case ACT_SILU: return x * sigmoid_f(x);
    case ACT_SSP: return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x))) - kLog2;
    case ACT_TANH: return tanhf(x);
    default: return sigmoid_f(x);
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__host__ __device__ inline int pad16(int x) { return (x + 15) / 16 * 16; }
// shared-memory row stride (bf16 elements) of a tile `w` wide: a multiple of
// 8, as wmma wants, and 8 past it so that rows start on different banks
__host__ __device__ inline int sld(int w) { return w + 8; }
__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// the components thread `third` owns: I -> [0], A -> [1, 4), S -> [4, 9)
__device__ __forceinline__ int comp_first(int third) { return third == 0 ? 0 : (third == 1 ? 1 : 4); }
__device__ __forceinline__ int comp_count(int third) { return third == 0 ? 1 : (third == 1 ? 3 : 5); }

enum Mode {
  SINGLE = 0,    // c0 = A.B
  DUAL_FWD = 1,  // c0 = A.B, c1 = Ad.B + A.ZB   (a value and its tangent)
  DUAL_REV = 2,  // c0 = A.B + Ad.ZB, c1 = Ad.B (a cotangent and the tangent's)
  DUAL_REV0 = 3  // c0 = A.B + Ad.ZB only
};

// One dense layer of an MT*16-row tile on the tensor cores.  A (and Ad) are
// (MT*16, kdim) bf16 row-major tiles in shared memory with row stride lda;
// B (and ZB) are read from device memory (L2): row-major (kdim, ncols) with
// row stride ldb, or with BCOL the transpose of a row-major (ncols, kdim)
// matrix of row stride ldb.  The block's warps split the 16-column tiles;
// each warp keeps MT accumulators (two sets for the dual modes) and hands
// each finished 16x16 tile, stored row-major in its f32 scratch (s0, and s1
// for the second set), to epi(rt, ct, s0, s1).  Called by all threads.
template <int MT, bool BCOL, int MODE, class Epi>
__device__ void mma_layer(const bf16* A, const bf16* Ad, int lda, const bf16* B, const bf16* ZB,
                          int ldb, int kdim, int ncols, float* scratch, Epi epi) {
  using BL = typename std::conditional<BCOL, wmma::col_major, wmma::row_major>::type;
  constexpr bool TWO = MODE == DUAL_FWD || MODE == DUAL_REV;
  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  float* s0 = scratch + warp * 512;
  float* s1 = s0 + 256;
  const int ctiles = ncols / 16;
  for (int ct = warp; ct < ctiles; ct += nwarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c0[MT], c1[TWO ? MT : 1];
#pragma unroll
    for (int r = 0; r < MT; ++r) wmma::fill_fragment(c0[r], 0.0f);
#pragma unroll
    for (int r = 0; r < (TWO ? MT : 1); ++r) wmma::fill_fragment(c1[r], 0.0f);
    for (int k0 = 0; k0 < kdim; k0 += 16) {
      const size_t boff = BCOL ? (size_t)ct * 16 * ldb + k0 : (size_t)k0 * ldb + ct * 16;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BL> fb, fz;
      wmma::load_matrix_sync(fb, B + boff, ldb);
      if (MODE != SINGLE) wmma::load_matrix_sync(fz, ZB + boff, ldb);
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, A + (size_t)r * 16 * lda + k0, lda);
        wmma::mma_sync(c0[r], fa, fb, c0[r]);
        if (MODE != SINGLE) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fd;
          wmma::load_matrix_sync(fd, Ad + (size_t)r * 16 * lda + k0, lda);
          if (MODE == DUAL_FWD) {
            wmma::mma_sync(c1[r], fd, fb, c1[r]);
            wmma::mma_sync(c1[r], fa, fz, c1[r]);
          } else {
            wmma::mma_sync(c0[r], fd, fz, c0[r]);
            if (MODE == DUAL_REV) wmma::mma_sync(c1[TWO ? r : 0], fd, fb, c1[TWO ? r : 0]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      wmma::store_matrix_sync(s0, c0[r], 16, wmma::mem_row_major);
      if (TWO) wmma::store_matrix_sync(s1, c1[TWO ? r : 0], 16, wmma::mem_row_major);
      __syncwarp();
      epi(r, ct, s0, s1);
      __syncwarp();
    }
  }
}

struct Args {
  const int32_t* idx;
  int n, k, h, rbf, rbfp, act, rows_per_block;
  const bf16 *cat, *ea;
  const float* cutm;
  const bf16 *w1, *b1, *w2, *b2, *w3, *b3;  // w1 (RBFP, H) with zero padding rows
  const float* ct;                           // backward and second order: (N, 9H)
  // second order: the Z cotangents (tangents of the dual forward)
  const bf16 *zcat, *zea;
  const float* zcutm;
  const bf16 *zw1, *zb1, *zw2, *zb2, *zw3, *zb3;
};

// Stage a tile of `mv` edges from edge t0: ea rows (and z_ea) into (M, RBFP)
// tiles, zero past RBF and past mv; neighbor ids and edge scalars.
__device__ void stage_tile(const Args& p, long t0, int mv, int M, bf16* ea_s, bf16* zea_s,
                           int* idx_s, float* cm_s, float* zcm_s) {
  const int ld = sld(p.rbfp);
  for (int q = threadIdx.x; q < M * p.rbfp; q += blockDim.x) {
    const int r = q / p.rbfp, c = q % p.rbfp;
    const bool in = r < mv && c < p.rbf;
    const size_t src = (size_t)(t0 + r) * p.rbf + c;
    ea_s[r * ld + c] = in ? p.ea[src] : f2b(0.0f);
    if (zea_s) zea_s[r * ld + c] = in ? p.zea[src] : f2b(0.0f);
  }
  for (int r = threadIdx.x; r < M; r += blockDim.x) {
    idx_s[r] = r < mv ? p.idx[t0 + r] : 0;
    cm_s[r] = r < mv ? p.cutm[t0 + r] : 0.0f;
    if (zcm_s) zcm_s[r] = r < mv ? p.zcutm[t0 + r] : 0.0f;
  }
}

// Copy `mv` rows of a (M, w) shared tile into columns [col, col + w) of the
// per-edge rows of `save` (row stride ld_save), starting at edge t0.
__device__ void save_rows(const bf16* tile, int w, int mv, bf16* save, int ld_save, long t0, int col) {
  const int ld = sld(w);
  for (int q = threadIdx.x; q < mv * w; q += blockDim.x) {
    const int r = q / w, c = q % w;
    save[(size_t)(t0 + r) * ld_save + col + c] = tile[r * ld + c];
  }
}

// Shared-memory layout of a kernel's tile: bf16 tiles (M rows each, row
// stride sld(width)), then the warps' f32 epilogue scratch, the per-edge
// warp partials of the edge scalars, neighbor ids and edge scalars.
enum Kind { FWD = 0, BWD = 1, BWD2 = 2 };

struct Smem {
  // offsets in bytes; 0-width tiles are absent
  size_t ea, zea, p1, pd1, t1, td1, p2, pd2, t2, td2, p3, pd3, scratch, red, idx, cm, zcm, total;
};

__host__ __device__ inline Smem smem_layout(int kind, int h, int rbfp) {
  const int M = kind == FWD ? FWD_M : BWD_M;
  const int nwarps = 3 * h / 32;
  Smem s;
  size_t o = 0;
  auto tile = [&](int w, bool present) {
    const size_t at = o;
    if (present) o = align128(o + (size_t)M * sld(w) * sizeof(bf16));
    return at;
  };
  const bool two = kind == BWD2;
  s.ea = tile(rbfp, true);
  s.zea = tile(rbfp, two);
  s.p1 = tile(h, kind != FWD);
  s.pd1 = tile(h, two);
  s.t1 = tile(h, true);
  s.td1 = tile(h, two);
  s.p2 = tile(2 * h, kind != FWD);
  s.pd2 = tile(2 * h, two);
  s.t2 = tile(2 * h, true);
  s.td2 = tile(2 * h, two);
  s.p3 = tile(3 * h, true);  // the forward keeps w here
  s.pd3 = tile(3 * h, two);
  s.scratch = o;
  o = align128(o + (size_t)nwarps * 512 * sizeof(float));
  s.red = o;
  o = align128(o + (size_t)M * nwarps * sizeof(float));
  s.idx = o;
  o = align128(o + (size_t)M * sizeof(int));
  s.cm = o;
  o = align128(o + (size_t)M * sizeof(float));
  s.zcm = o;
  o = align128(o + (size_t)M * sizeof(float));
  s.total = o;
  return s;
}

#define TILE(name) reinterpret_cast<bf16*>(smem + L.name)

__global__ void __launch_bounds__(3 * MAX_H, 1) tn_fwd_kernel(Args p, float* __restrict__ m_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int M = FWD_M, MT = M / 16;
  const int H = p.h, F9 = 9 * H;
  const int third = threadIdx.x / H, hh = threadIdx.x % H;
  const int lane = threadIdx.x % 32;
  const Smem L = smem_layout(FWD, H, p.rbfp);
  bf16 *ea_s = TILE(ea), *t1 = TILE(t1), *t2 = TILE(t2), *w_s = TILE(p3);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  int* idx_s = reinterpret_cast<int*>(smem + L.idx);
  float* cm_s = reinterpret_cast<float*>(smem + L.cm);
  const int ld1 = sld(H), ld2 = sld(2 * H), ld3 = sld(3 * H);
  const int row0 = blockIdx.x * p.rows_per_block;
  const int row1 = min(p.n, row0 + p.rows_per_block);
  if (row0 >= row1) return;
  const long e0 = (long)row0 * p.k, e1 = (long)row1 * p.k;
  const int cf = comp_first(third), cc = comp_count(third);
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int cur = row0;
  for (long t0 = e0; t0 < e1; t0 += M) {
    const int mv = (int)min((long)M, e1 - t0);
    stage_tile(p, t0, mv, M, ea_s, nullptr, idx_s, cm_s, nullptr);
    __syncthreads();
    mma_layer<MT, false, SINGLE>(ea_s, nullptr, sld(p.rbfp), p.w1, nullptr, H, p.rbfp, H, scratch,
                                 [&](int rt, int ct, const float* s0, const float*) {
                                   for (int q = lane; q < 256; q += 32) {
                                     const int r = rt * 16 + q / 16, c = ct * 16 + q % 16;
                                     const float pre = bfr(bfr(s0[q]) + ldb(p.b1 + c));
                                     t1[r * ld1 + c] = f2b(act_fn(p.act, pre));
                                   }
                                 });
    __syncthreads();
    mma_layer<MT, false, SINGLE>(t1, nullptr, ld1, p.w2, nullptr, 2 * H, H, 2 * H, scratch,
                                 [&](int rt, int ct, const float* s0, const float*) {
                                   for (int q = lane; q < 256; q += 32) {
                                     const int r = rt * 16 + q / 16, c = ct * 16 + q % 16;
                                     const float pre = bfr(bfr(s0[q]) + ldb(p.b2 + c));
                                     t2[r * ld2 + c] = f2b(act_fn(p.act, pre));
                                   }
                                 });
    __syncthreads();
    mma_layer<MT, false, SINGLE>(t2, nullptr, ld2, p.w3, nullptr, 3 * H, 2 * H, 3 * H, scratch,
                                 [&](int rt, int ct, const float* s0, const float*) {
                                   for (int q = lane; q < 256; q += 32) {
                                     const int r = rt * 16 + q / 16, c = ct * 16 + q % 16;
                                     const float pre = bfr(bfr(s0[q]) + ldb(p.b3 + c));
                                     const float t3 = bfr(act_fn(p.act, pre));
                                     w_s[r * ld3 + c] = f2b(t3 * bfr(cm_s[r]));
                                   }
                                 });
    __syncthreads();
    for (int e = 0; e < mv; ++e) {
      const int row = (int)((t0 + e) / p.k);
      if (row != cur) {
        for (int c = 0; c < cc; ++c) m_out[(size_t)cur * F9 + (cf + c) * H + hh] = acc[c];
#pragma unroll
        for (int c = 0; c < 5; ++c) acc[c] = 0.0f;
        cur = row;
      }
      const float w = __bfloat162float(w_s[e * ld3 + third * H + hh]);
      const bf16* src = p.cat + (size_t)idx_s[e] * F9 + cf * H + hh;
#pragma unroll
      for (int c = 0; c < 5; ++c)
        if (c < cc) acc[c] += bfr(ldb(src + c * H) * w);
    }
    __syncthreads();  // the next tile's staging overwrites this one
  }
  for (int c = 0; c < cc; ++c) m_out[(size_t)cur * F9 + (cf + c) * H + hh] = acc[c];
}

// The backward: d_cat (N, 9H) bf16, d_ea (N, K, RBF) bf16, d_cutm (N, K)
// f32; with `save` (per-edge rows [ea | t1 | d_p1 | t2 | d_p2 | d_p3], bf16,
// row stride rbfp + 9H) the operands of the weight cotangents.
__global__ void __launch_bounds__(3 * MAX_H, 1)
    tn_bwd_kernel(Args p, bf16* __restrict__ dcat, bf16* __restrict__ dea, float* __restrict__ dcutm,
                  bf16* __restrict__ save) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int M = BWD_M, MT = M / 16;
  const int H = p.h, F9 = 9 * H;
  const int third = threadIdx.x / H, hh = threadIdx.x % H, col = threadIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const Smem L = smem_layout(BWD, H, p.rbfp);
  bf16 *ea_s = TILE(ea), *p1 = TILE(p1), *t1 = TILE(t1), *p2 = TILE(p2), *t2 = TILE(t2), *p3 = TILE(p3);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  float* red = reinterpret_cast<float*>(smem + L.red);
  int* idx_s = reinterpret_cast<int*>(smem + L.idx);
  float* cm_s = reinterpret_cast<float*>(smem + L.cm);
  const int lde = sld(p.rbfp), ld1 = sld(H), ld2 = sld(2 * H), ld3 = sld(3 * H);
  const int ld_save = p.rbfp + 9 * H;
  const int row0 = blockIdx.x * p.rows_per_block;
  const int row1 = min(p.n, row0 + p.rows_per_block);
  if (row0 >= row1) return;
  const long e0 = (long)row0 * p.k, e1 = (long)row1 * p.k;
  const int cf = comp_first(third), cc = comp_count(third);
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float cti[5];
  int cur = row0;
#pragma unroll
  for (int c = 0; c < 5; ++c) cti[c] = c < cc ? bfr(p.ct[(size_t)cur * F9 + (cf + c) * H + hh]) : 0.0f;
  for (long t0 = e0; t0 < e1; t0 += M) {
    const int mv = (int)min((long)M, e1 - t0);
    stage_tile(p, t0, mv, M, ea_s, nullptr, idx_s, cm_s, nullptr);
    __syncthreads();
    // the forward, recomputed: pre-activations and activations of L1, L2; L3's pre-activation
    mma_layer<MT, false, SINGLE>(ea_s, nullptr, lde, p.w1, nullptr, H, p.rbfp, H, scratch,
                                 [&](int rt, int ct, const float* s0, const float*) {
                                   for (int q = lane; q < 256; q += 32) {
                                     const int r = rt * 16 + q / 16, c = ct * 16 + q % 16;
                                     const float pre = bfr(bfr(s0[q]) + ldb(p.b1 + c));
                                     p1[r * ld1 + c] = f2b(pre);
                                     t1[r * ld1 + c] = f2b(act_fn(p.act, pre));
                                   }
                                 });
    __syncthreads();
    mma_layer<MT, false, SINGLE>(t1, nullptr, ld1, p.w2, nullptr, 2 * H, H, 2 * H, scratch,
                                 [&](int rt, int ct, const float* s0, const float*) {
                                   for (int q = lane; q < 256; q += 32) {
                                     const int r = rt * 16 + q / 16, c = ct * 16 + q % 16;
                                     const float pre = bfr(bfr(s0[q]) + ldb(p.b2 + c));
                                     p2[r * ld2 + c] = f2b(pre);
                                     t2[r * ld2 + c] = f2b(act_fn(p.act, pre));
                                   }
                                 });
    __syncthreads();
    mma_layer<MT, false, SINGLE>(t2, nullptr, ld2, p.w3, nullptr, 3 * H, 2 * H, 3 * H, scratch,
                                 [&](int rt, int ct, const float* s0, const float*) {
                                   for (int q = lane; q < 256; q += 32) {
                                     const int r = rt * 16 + q / 16, c = ct * 16 + q % 16;
                                     p3[r * ld3 + c] = f2b(bfr(s0[q]) + ldb(p.b3 + c));
                                   }
                                 });
    __syncthreads();
    // per edge: d_cat (symmetric gather form), d_w, d_cutm's terms, d_p3 in place of p3
    for (int e = 0; e < mv; ++e) {
      const int row = (int)((t0 + e) / p.k);
      if (row != cur) {
        for (int c = 0; c < cc; ++c) dcat[(size_t)cur * F9 + (cf + c) * H + hh] = f2b(acc[c]);
        cur = row;
#pragma unroll
        for (int c = 0; c < 5; ++c) {
          acc[c] = 0.0f;
          cti[c] = c < cc ? bfr(p.ct[(size_t)cur * F9 + (cf + c) * H + hh]) : 0.0f;
        }
      }
      const int j = idx_s[e];
      const float pre = __bfloat162float(p3[e * ld3 + col]);
      const float t3 = bfr(act_fn(p.act, pre));
      const float cmb = bfr(cm_s[e]);
      const float wb = bfr(t3 * cmb);
      const bf16* src = p.cat + (size_t)j * F9 + cf * H + hh;
      const float* ctj = p.ct + (size_t)j * F9 + cf * H + hh;
      float dw = 0.0f;
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        if (c < cc) {
          acc[c] += bfr(bfr(ctj[c * H]) * wb);
          dw += bfr(cti[c] * ldb(src + c * H));
        }
      }
      dw = bfr(dw);
      const float term = warp_sum(bfr(dw * t3));
      if (lane == 0) red[e * nwarps + warp] = term;
      const float dt3 = bfr(dw * cmb);
      p3[e * ld3 + col] = f2b(bfr(dact_fn(p.act, pre)) * dt3);
    }
    __syncthreads();
    if ((int)threadIdx.x < mv) {
      float s = 0.0f;
      for (int w = 0; w < nwarps; ++w) s += red[threadIdx.x * nwarps + w];
      dcutm[t0 + threadIdx.x] = s;
    }
    // the MLP's reverse: d_t2 = d_p3 . W3^T, d_t1 = d_p2 . W2^T, d_ea = d_p1 . W1^T
    mma_layer<MT, true, SINGLE>(p3, nullptr, ld3, p.w3, nullptr, 3 * H, 3 * H, 2 * H, scratch,
                                [&](int rt, int ct, const float* s0, const float*) {
                                  for (int q = lane; q < 256; q += 32) {
                                    const int r = rt * 16 + q / 16, c = ct * 16 + q % 16;
                                    const float pre2 = __bfloat162float(p2[r * ld2 + c]);
                                    p2[r * ld2 + c] = f2b(bfr(dact_fn(p.act, pre2)) * bfr(s0[q]));
                                  }
                                });
    __syncthreads();
    mma_layer<MT, true, SINGLE>(p2, nullptr, ld2, p.w2, nullptr, 2 * H, 2 * H, H, scratch,
                                [&](int rt, int ct, const float* s0, const float*) {
                                  for (int q = lane; q < 256; q += 32) {
                                    const int r = rt * 16 + q / 16, c = ct * 16 + q % 16;
                                    const float pre1 = __bfloat162float(p1[r * ld1 + c]);
                                    p1[r * ld1 + c] = f2b(bfr(dact_fn(p.act, pre1)) * bfr(s0[q]));
                                  }
                                });
    __syncthreads();
    mma_layer<MT, true, SINGLE>(p1, nullptr, ld1, p.w1, nullptr, H, H, p.rbfp, scratch,
                                [&](int rt, int ct, const float* s0, const float*) {
                                  for (int q = lane; q < 256; q += 32) {
                                    const int r = rt * 16 + q / 16, c = ct * 16 + q % 16;
                                    if (r < mv && c < p.rbf) dea[(size_t)(t0 + r) * p.rbf + c] = f2b(s0[q]);
                                  }
                                });
    if (save) {
      save_rows(ea_s, p.rbfp, mv, save, ld_save, t0, 0);
      save_rows(t1, H, mv, save, ld_save, t0, p.rbfp);
      save_rows(p1, H, mv, save, ld_save, t0, p.rbfp + H);
      save_rows(t2, 2 * H, mv, save, ld_save, t0, p.rbfp + 2 * H);
      save_rows(p2, 2 * H, mv, save, ld_save, t0, p.rbfp + 4 * H);
      save_rows(p3, 3 * H, mv, save, ld_save, t0, p.rbfp + 6 * H);
    }
    __syncthreads();
  }
  for (int c = 0; c < cc; ++c) dcat[(size_t)cur * F9 + (cf + c) * H + hh] = f2b(acc[c]);
}

// The second order: g_ea (N, K, RBF) bf16, g_cutm (N, K) f32, g_ct (N, 9H)
// f32, the tangent of w per edge wdot (N*K, 3H) f32 (tn_src_sum_kernel turns
// it into g_cat), and with `save` (per-edge rows [ea | z_ea | t1 | t1' |
// p1_bar | p1'_bar | t2 | t2' | p2_bar | p2'_bar | p3_bar | p3'_bar], bf16,
// row stride 2 rbfp + 18H; x' is the tangent of x, x_bar its cotangent) the
// operands of the weight gradients.
__global__ void __launch_bounds__(3 * MAX_H, 1)
    tn_bwd2_kernel(Args p, bf16* __restrict__ gea, float* __restrict__ gcutm, float* __restrict__ gct,
                   float* __restrict__ wdot, bf16* __restrict__ save) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int M = BWD_M, MT = M / 16;
  const int H = p.h, F9 = 9 * H;
  const int third = threadIdx.x / H, hh = threadIdx.x % H, col = threadIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  const Smem L = smem_layout(BWD2, H, p.rbfp);
  bf16 *ea_s = TILE(ea), *zea_s = TILE(zea);
  bf16 *p1 = TILE(p1), *pd1 = TILE(pd1), *t1 = TILE(t1), *td1 = TILE(td1);
  bf16 *p2 = TILE(p2), *pd2 = TILE(pd2), *t2 = TILE(t2), *td2 = TILE(td2);
  bf16 *p3 = TILE(p3), *pd3 = TILE(pd3);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch);
  float* red = reinterpret_cast<float*>(smem + L.red);
  int* idx_s = reinterpret_cast<int*>(smem + L.idx);
  float* cm_s = reinterpret_cast<float*>(smem + L.cm);
  float* zcm_s = reinterpret_cast<float*>(smem + L.zcm);
  const int lde = sld(p.rbfp), ld1 = sld(H), ld2 = sld(2 * H), ld3 = sld(3 * H);
  const int ld_save = 2 * p.rbfp + 18 * H;
  const int row0 = blockIdx.x * p.rows_per_block;
  const int row1 = min(p.n, row0 + p.rows_per_block);
  if (row0 >= row1) return;
  const long e0 = (long)row0 * p.k, e1 = (long)row1 * p.k;
  const int cf = comp_first(third), cc = comp_count(third);
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float cti[5];
  int cur = row0;
#pragma unroll
  for (int c = 0; c < 5; ++c) cti[c] = c < cc ? bfr(p.ct[(size_t)cur * F9 + (cf + c) * H + hh]) : 0.0f;
  // the dual forward's epilogue of L1 and L2: value and tangent of the
  // pre-activation, then of the activation
  auto dual_epi = [&](bf16* pp, bf16* ppd, bf16* tt, bf16* ttd, int ld, const bf16* b, const bf16* zb) {
    return [=, &p](int rt, int ct, const float* s0, const float* s1) {
      for (int q = lane; q < 256; q += 32) {
        const int r = rt * 16 + q / 16, c = ct * 16 + q % 16;
        const float pre = bfr(bfr(s0[q]) + ldb(b + c));
        const float pred = bfr(bfr(s1[q]) + ldb(zb + c));
        float f, f1, f2;
        act3(p.act, pre, &f, &f1, &f2);
        pp[r * ld + c] = f2b(pre);
        ppd[r * ld + c] = f2b(pred);
        tt[r * ld + c] = f2b(f);
        ttd[r * ld + c] = f2b(f1 * pred);
      }
    };
  };
  // the reverse's epilogue through a layer's activation: from the cotangents
  // of its value (s0) and its tangent (s1) to those of its pre-activation
  auto rev_epi = [&](bf16* pp, bf16* ppd, int ld) {
    return [=, &p](int rt, int ct, const float* s0, const float* s1) {
      for (int q = lane; q < 256; q += 32) {
        const int r = rt * 16 + q / 16, c = ct * 16 + q % 16;
        const float pre = __bfloat162float(pp[r * ld + c]);
        const float pred = __bfloat162float(ppd[r * ld + c]);
        float f, f1, f2;
        act3(p.act, pre, &f, &f1, &f2);
        pp[r * ld + c] = f2b(s0[q] * f1 + s1[q] * f2 * pred);
        ppd[r * ld + c] = f2b(s1[q] * f1);
      }
    };
  };
  for (long t0 = e0; t0 < e1; t0 += M) {
    const int mv = (int)min((long)M, e1 - t0);
    stage_tile(p, t0, mv, M, ea_s, zea_s, idx_s, cm_s, zcm_s);
    __syncthreads();
    mma_layer<MT, false, DUAL_FWD>(ea_s, zea_s, lde, p.w1, p.zw1, H, p.rbfp, H, scratch,
                                   dual_epi(p1, pd1, t1, td1, ld1, p.b1, p.zb1));
    __syncthreads();
    mma_layer<MT, false, DUAL_FWD>(t1, td1, ld1, p.w2, p.zw2, 2 * H, H, 2 * H, scratch,
                                   dual_epi(p2, pd2, t2, td2, ld2, p.b2, p.zb2));
    __syncthreads();
    mma_layer<MT, false, DUAL_FWD>(t2, td2, ld2, p.w3, p.zw3, 3 * H, 2 * H, 3 * H, scratch,
                                   [&](int rt, int ct, const float* s0, const float* s1) {
                                     for (int q = lane; q < 256; q += 32) {
                                       const int r = rt * 16 + q / 16, c = ct * 16 + q % 16;
                                       p3[r * ld3 + c] = f2b(bfr(s0[q]) + ldb(p.b3 + c));
                                       pd3[r * ld3 + c] = f2b(bfr(s1[q]) + ldb(p.zb3 + c));
                                     }
                                   });
    __syncthreads();
    // per edge: g_ct (the tangent of the messages), the cotangents of w and
    // of its tangent, g_cutm's terms, and the cotangents of p3 and p3'
    for (int e = 0; e < mv; ++e) {
      const int row = (int)((t0 + e) / p.k);
      if (row != cur) {
        for (int c = 0; c < cc; ++c) gct[(size_t)cur * F9 + (cf + c) * H + hh] = acc[c];
        cur = row;
#pragma unroll
        for (int c = 0; c < 5; ++c) {
          acc[c] = 0.0f;
          cti[c] = c < cc ? bfr(p.ct[(size_t)cur * F9 + (cf + c) * H + hh]) : 0.0f;
        }
      }
      const int j = idx_s[e];
      const float pre = __bfloat162float(p3[e * ld3 + col]);
      const float pred = __bfloat162float(pd3[e * ld3 + col]);
      float f, f1, f2;
      act3(p.act, pre, &f, &f1, &f2);
      const float t3 = bfr(f), td3 = bfr(f1 * pred);
      const float cmb = bfr(cm_s[e]), zcmb = bfr(zcm_s[e]);
      const float w = bfr(t3 * cmb);
      const float wd = bfr(td3 * cmb + t3 * zcmb);
      const bf16* src = p.cat + (size_t)j * F9 + cf * H + hh;
      const bf16* zsrc = p.zcat + (size_t)j * F9 + cf * H + hh;
      float wbar = 0.0f, wdbar = 0.0f;
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        if (c < cc) {
          const float g = ldb(src + c * H), zg = ldb(zsrc + c * H);
          acc[c] += bfr(zg * w) + bfr(g * wd);
          wbar += cti[c] * zg;
          wdbar += cti[c] * g;
        }
      }
      wdot[(size_t)(t0 + e) * 3 * H + col] = wd;
      const float t3bar = wbar * cmb + wdbar * zcmb;
      const float td3bar = wdbar * cmb;
      const float term = warp_sum(wbar * t3 + wdbar * td3);
      if (lane == 0) red[e * nwarps + warp] = term;
      p3[e * ld3 + col] = f2b(t3bar * f1 + td3bar * f2 * pred);
      pd3[e * ld3 + col] = f2b(td3bar * f1);
    }
    __syncthreads();
    if ((int)threadIdx.x < mv) {
      float s = 0.0f;
      for (int w = 0; w < nwarps; ++w) s += red[threadIdx.x * nwarps + w];
      gcutm[t0 + threadIdx.x] = s;
    }
    mma_layer<MT, true, DUAL_REV>(p3, pd3, ld3, p.w3, p.zw3, 3 * H, 3 * H, 2 * H, scratch,
                                  rev_epi(p2, pd2, ld2));
    __syncthreads();
    mma_layer<MT, true, DUAL_REV>(p2, pd2, ld2, p.w2, p.zw2, 2 * H, 2 * H, H, scratch,
                                  rev_epi(p1, pd1, ld1));
    __syncthreads();
    mma_layer<MT, true, DUAL_REV0>(p1, pd1, ld1, p.w1, p.zw1, H, H, p.rbfp, scratch,
                                   [&](int rt, int ct, const float* s0, const float*) {
                                     for (int q = lane; q < 256; q += 32) {
                                       const int r = rt * 16 + q / 16, c = ct * 16 + q % 16;
                                       if (r < mv && c < p.rbf) gea[(size_t)(t0 + r) * p.rbf + c] = f2b(s0[q]);
                                     }
                                   });
    if (save) {
      const int w1 = p.rbfp;
      save_rows(ea_s, w1, mv, save, ld_save, t0, 0);
      save_rows(zea_s, w1, mv, save, ld_save, t0, w1);
      save_rows(t1, H, mv, save, ld_save, t0, 2 * w1);
      save_rows(td1, H, mv, save, ld_save, t0, 2 * w1 + H);
      save_rows(p1, H, mv, save, ld_save, t0, 2 * w1 + 2 * H);
      save_rows(pd1, H, mv, save, ld_save, t0, 2 * w1 + 3 * H);
      save_rows(t2, 2 * H, mv, save, ld_save, t0, 2 * w1 + 4 * H);
      save_rows(td2, 2 * H, mv, save, ld_save, t0, 2 * w1 + 6 * H);
      save_rows(p2, 2 * H, mv, save, ld_save, t0, 2 * w1 + 8 * H);
      save_rows(pd2, 2 * H, mv, save, ld_save, t0, 2 * w1 + 10 * H);
      save_rows(p3, 3 * H, mv, save, ld_save, t0, 2 * w1 + 12 * H);
      save_rows(pd3, 3 * H, mv, save, ld_save, t0, 2 * w1 + 15 * H);
    }
    __syncthreads();
  }
  for (int c = 0; c < cc; ++c) gct[(size_t)cur * F9 + (cf + c) * H + hh] = acc[c];
}

// g_cat (N, 9H) bf16: g_cat[j, c] = sum over the K slots (i, k) pointing at
// j (perm[j*K + k'] = i*K + k) of bf16(ct[i, c]) * wdot[i*K + k, third(c)],
// summed in f32 in slot order and rounded once.  One block per row, 3H threads.
__global__ void tn_src_sum_kernel(const int32_t* __restrict__ perm, int k, int h,
                                  const float* __restrict__ ct, const float* __restrict__ wdot,
                                  bf16* __restrict__ gcat) {
  const int j = blockIdx.x, F9 = 9 * h;
  const int third = threadIdx.x / h, hh = threadIdx.x % h;
  const int cf = comp_first(third), cc = comp_count(third);
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int s = 0; s < k; ++s) {
    const int pe = perm[(size_t)j * k + s];
    const int i = pe / k;
    const float wd = wdot[(size_t)pe * 3 * h + threadIdx.x];
    const float* c_i = ct + (size_t)i * F9 + cf * h + hh;
#pragma unroll
    for (int c = 0; c < 5; ++c)
      if (c < cc) acc[c] += bfr(c_i[c * h]) * wd;
  }
  for (int c = 0; c < cc; ++c) gcat[(size_t)j * F9 + (cf + c) * h + hh] = f2b(acc[c]);
}

// part[s] (P, Q) f32 = sum over the edges of split s of a1[e]^T b1[e] (+
// a2[e]^T b2[e]): a (E_pad, P) and b (E_pad, Q) bf16 rows of strides lda
// and ldb (zero rows past the last edge).  A block of 4 warps computes a
// 64 x 64 output tile, each warp a 16-row strip of four 16x16 tiles,
// reading its operands through L1/L2 straight into wmma fragments.
__global__ void __launch_bounds__(128) tn_wgrad_kernel(const bf16* __restrict__ a1, const bf16* __restrict__ b1,
                                                      const bf16* __restrict__ a2, const bf16* __restrict__ b2,
                                                      int lda, int ldb, int e_pad, int per_split, int pn,
                                                      int qn, float* __restrict__ part) {
  const int warp = threadIdx.x / 32;
  const int prow = blockIdx.x * 64 + warp * 16;
  const int q0 = blockIdx.y * 64;
  const int s = blockIdx.z;
  if (prow >= pn) return;  // whole warps
  const int eb = s * per_split, ee = min(e_pad, eb + per_split);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) wmma::fill_fragment(acc[c], 0.0f);
  for (int e = eb; e < ee; e += 16) {
#pragma unroll
    for (int pair = 0; pair < 2; ++pair) {
      const bf16* a = pair ? a2 : a1;
      const bf16* b = pair ? b2 : b1;
      if (a == nullptr) continue;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::load_matrix_sync(fa, a + (size_t)e * lda + prow, lda);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qc = q0 + 16 * c;
        if (qc < qn) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, b + (size_t)e * ldb + qc, ldb);
          wmma::mma_sync(acc[c], fa, fb, acc[c]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int qc = q0 + 16 * c;
    if (qc < qn)
      wmma::store_matrix_sync(part + (size_t)s * pn * qn + (size_t)prow * qn + qc, acc[c], qn,
                              wmma::mem_row_major);
  }
}

// part[s] (Q) f32 = sum over the edges of split s of b[e] (bf16 rows of
// stride ldb): the bias cotangents.  One thread per column.
__global__ void tn_colsum_kernel(const bf16* __restrict__ b, int ldb, int e_n, int per_split, int qn,
                                 float* __restrict__ part) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (q >= qn) return;
  const int eb = s * per_split, ee = min(e_n, eb + per_split);
  float acc = 0.0f;
  for (int e = eb; e < ee; ++e) acc += __bfloat162float(b[(size_t)e * ldb + q]);
  part[(size_t)s * qn + q] = acc;
}

bool valid_shape(int n, int k, int h, int rbf) {
  return n > 0 && k > 0 && h >= 32 && h <= MAX_H && h % 32 == 0 && rbf > 0 && pad16(rbf) <= MAX_RBFP;
}

// The grid of a row kernel: rows per block such that every SM gets as many
// blocks as its shared memory and threads hold, each block its own rows.
cudaError_t plan_rows(int kind, Args* p, size_t* smem, int* blocks) {
  int dev = 0, sms = 0, smem_max = 0, smem_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return err;
  *smem = smem_layout(kind, p->h, p->rbfp).total;
  if (*smem > (size_t)smem_max) return cudaErrorInvalidValue;
  int per_sm = (int)(smem_sm / (*smem + 1024));  // 1 KB reserved per block
  per_sm = per_sm < 1 ? 1 : per_sm;
  const int by_threads = 2048 / (3 * p->h);
  per_sm = per_sm < by_threads ? per_sm : by_threads;
  const int target = sms * per_sm;
  p->rows_per_block = (p->n + target - 1) / target;
  *blocks = (p->n + p->rows_per_block - 1) / p->rows_per_block;
  return cudaSuccess;
}

Args make_args(const void* idx, int n, int k, int h, int rbf, const void* cat, const void* ea,
               const void* cutm, const void* w1, const void* b1, const void* w2, const void* b2,
               const void* w3, const void* b3, int act) {
  Args p = {};
  p.idx = static_cast<const int32_t*>(idx);
  p.n = n;
  p.k = k;
  p.h = h;
  p.rbf = rbf;
  p.rbfp = pad16(rbf);
  p.act = act;
  p.cat = static_cast<const bf16*>(cat);
  p.ea = static_cast<const bf16*>(ea);
  p.cutm = static_cast<const float*>(cutm);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const bf16*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const bf16*>(b2);
  p.w3 = static_cast<const bf16*>(w3);
  p.b3 = static_cast<const bf16*>(b3);
  return p;
}

}  // namespace

extern "C" {

const char* tn_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// All functions return a cudaError_t (0 on success), launch on `stream` and
// do not synchronise.  Operands: idx (N, K) int32; cat (N, 9H), ea (N, K,
// RBF), w1 (RBFP, H) with zero rows past RBF, w2 (H, 2H), w3 (2H, 3H) and
// the biases (F) bf16; cutm (N, K) f32; act 0 silu, 1 ssp, 2 tanh, 3 sigmoid.
// m_out (N, 9H) f32.
int tn_fwd(const void* idx, int n, int k, int h, int rbf, const void* cat, const void* ea,
           const void* cutm, const void* w1, const void* b1, const void* w2, const void* b2,
           const void* w3, const void* b3, int act, void* m_out, void* stream) {
  if (!valid_shape(n, k, h, rbf)) return (int)cudaErrorInvalidValue;
  Args p = make_args(idx, n, k, h, rbf, cat, ea, cutm, w1, b1, w2, b2, w3, b3, act);
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = plan_rows(FWD, &p, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(tn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tn_fwd_kernel<<<blocks, 3 * h, smem, static_cast<cudaStream_t>(stream)>>>(p, static_cast<float*>(m_out));
  return (int)cudaGetLastError();
}

// ct (N, 9H) f32 -> dcat (N, 9H) bf16, dea (N, K, RBF) bf16, dcutm (N, K)
// f32; save (N*K, RBFP + 9H) bf16 or null (tn_bwd_kernel's rows).
int tn_bwd(const void* idx, int n, int k, int h, int rbf, const void* cat, const void* ea,
           const void* cutm, const void* w1, const void* b1, const void* w2, const void* b2,
           const void* w3, const void* b3, int act, const void* ct, void* dcat, void* dea, void* dcutm,
           void* save, void* stream) {
  if (!valid_shape(n, k, h, rbf)) return (int)cudaErrorInvalidValue;
  Args p = make_args(idx, n, k, h, rbf, cat, ea, cutm, w1, b1, w2, b2, w3, b3, act);
  p.ct = static_cast<const float*>(ct);
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = plan_rows(BWD, &p, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(tn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tn_bwd_kernel<<<blocks, 3 * h, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<bf16*>(dcat), static_cast<bf16*>(dea), static_cast<float*>(dcutm),
      static_cast<bf16*>(save));
  return (int)cudaGetLastError();
}

// The second order.  z_* are the cotangents on tn_bwd's outputs (all
// non-null: absent ones are zeros; zw1 (RBFP, H) padded as w1).  Outputs:
// gea (N, K, RBF) bf16, gcutm (N, K), gct (N, 9H), wdot (N*K, 3H) f32;
// save (N*K, 2 RBFP + 18H) bf16 or null (tn_bwd2_kernel's rows).
int tn_bwd2(const void* idx, int n, int k, int h, int rbf, const void* cat, const void* ea,
            const void* cutm, const void* w1, const void* b1, const void* w2, const void* b2,
            const void* w3, const void* b3, int act, const void* ct, const void* zcat, const void* zea,
            const void* zcutm, const void* zw1, const void* zb1, const void* zw2, const void* zb2,
            const void* zw3, const void* zb3, void* gea, void* gcutm, void* gct, void* wdot, void* save,
            void* stream) {
  if (!valid_shape(n, k, h, rbf)) return (int)cudaErrorInvalidValue;
  Args p = make_args(idx, n, k, h, rbf, cat, ea, cutm, w1, b1, w2, b2, w3, b3, act);
  p.ct = static_cast<const float*>(ct);
  p.zcat = static_cast<const bf16*>(zcat);
  p.zea = static_cast<const bf16*>(zea);
  p.zcutm = static_cast<const float*>(zcutm);
  p.zw1 = static_cast<const bf16*>(zw1);
  p.zb1 = static_cast<const bf16*>(zb1);
  p.zw2 = static_cast<const bf16*>(zw2);
  p.zb2 = static_cast<const bf16*>(zb2);
  p.zw3 = static_cast<const bf16*>(zw3);
  p.zb3 = static_cast<const bf16*>(zb3);
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = plan_rows(BWD2, &p, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(tn_bwd2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tn_bwd2_kernel<<<blocks, 3 * h, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<bf16*>(gea), static_cast<float*>(gcutm), static_cast<float*>(gct),
      static_cast<float*>(wdot), static_cast<bf16*>(save));
  return (int)cudaGetLastError();
}

// gcat (N, 9H) bf16 from ct (N, 9H) f32 and wdot (N*K, 3H) f32 through the
// transpose permutation perm (N*K) int32.
int tn_src_sum(const void* perm, int n, int k, int h, const void* ct, const void* wdot, void* gcat,
               void* stream) {
  if (!valid_shape(n, k, h, 16)) return (int)cudaErrorInvalidValue;
  tn_src_sum_kernel<<<n, 3 * h, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(perm), k, h, static_cast<const float*>(ct),
      static_cast<const float*>(wdot), static_cast<bf16*>(gcat));
  return (int)cudaGetLastError();
}

// part (splits, P, Q) f32: see tn_wgrad_kernel.  a2/b2 null for one pair.
// P, Q, lda, ldb and the column offsets of a and b are multiples of 16;
// e_pad is a multiple of 16 and the rows past the last edge are zero.
int tn_wgrad(const void* a1, const void* b1, const void* a2, const void* b2, int lda, int ldb, int e_pad,
             int pn, int qn, int splits, void* part, void* stream) {
  if (pn <= 0 || qn <= 0 || pn % 16 || qn % 16 || lda % 16 || ldb % 16 || e_pad % 16 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  const int per_split = ((e_pad / 16 + splits - 1) / splits) * 16;
  dim3 grid((pn + 63) / 64, (qn + 63) / 64, splits);
  tn_wgrad_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a1), static_cast<const bf16*>(b1), static_cast<const bf16*>(a2),
      static_cast<const bf16*>(b2), lda, ldb, e_pad, per_split, pn, qn, static_cast<float*>(part));
  return (int)cudaGetLastError();
}

// part (splits, Q) f32: see tn_colsum_kernel.
int tn_colsum(const void* b, int ldb, int e_n, int qn, int splits, void* part, void* stream) {
  if (qn <= 0 || e_n <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  const int per_split = (e_n + splits - 1) / splits;
  dim3 grid((qn + 127) / 128, splits);
  tn_colsum_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(b), ldb, e_n, per_split, qn, static_cast<float*>(part));
  return (int)cudaGetLastError();
}

}  // extern "C"
