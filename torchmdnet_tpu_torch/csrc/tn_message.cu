// Fused TensorNet message phase for Hopper (sm_90a): forward, backward and
// second order.
//
// Replaces the Pallas TPU kernels of torchmdnet_tpu/ops/pallas/tn_message.py:
//   tn_fwd_kernel  <- _fwd_kernel (:77, launched by fused_tn_messages at :710)
//   tn_bwd_kernel  <- _bwd_kernel (:107, launched by _tn_bwd_op at :302)
//   tn_bwd2_kernel <- _tn_bwd2_kernel (:455, launched by _tn_bwd2_op at :624)
//   tn_src_sum_kernel <- _table_scatter, the second order's source-row sum
// The kernels' weight-gradient accumulators (dw*_acc, db*_acc) become a
// reduction over edges, et_message.cu's et_dw_kernel, as for ET and the
// Transformer.
// The device helpers they share with et_message.cu and t_message.cu are in
// common.cuh.
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
// is bound by operations, the backward (twice the products) most of all.
//
// The forward and the second order (the first port's design):
//   * a block owns a contiguous range of receiver rows and walks their edges
//     (flattened i*K + k) in tiles of M edges; the three layers of each tile
//     run on the tensor cores (wmma bf16 16x16x16, f32 accumulation), the
//     activations live in shared memory between layers, and nothing of the
//     MLP goes to device memory; the weights are read by the wmma loads
//     from L2, where they stay resident;
//   * 3H threads: thread (third, h) owns channel h of one third of w and the
//     components that third multiplies (1, 3 or 5), gathers those source
//     values by index (no block plan, no one-hot product: TPU layout
//     workarounds) and keeps its f32 row sums in registers, written when the
//     row ends.  No float atomics anywhere: every result is bitwise the same
//     from run to run;
//   * the second order is the VJP of the backward with respect to (inputs,
//     ct) given cotangents Z on its outputs: S = <vjp_f(a)(ct), Z> =
//     <ct, J_f(a) . Z>, so g_ct = J_f(a) . Z is a dual-number forward (every
//     MLP value carries a tangent driven by Z) and g_inputs is the reverse of
//     that forward seeded with ct, written out per layer with the
//     activations' second derivatives.  Its source-row gradient depends on Z
//     (not symmetric), so the kernel writes the tangent of w per edge (3H
//     f32) and tn_src_sum_kernel sums ct_i * w_dot through the transpose
//     permutation.
//
// The backward recomputes the MLP per tile, as the TPU kernel does.  Its
// source-row cotangent d_cat[j] = sum over slots pointing at j of ct_i *
// w[i,k] needs no scatter: w depends only on the edge's distance and
// cutoff, the same for (i, j) and (j, i), so on the symmetric list the port
// requires d_cat[j] = sum_k' ct[idx[j,k']] * w[j,k'], the forward's gather
// form with ct as the source table.  Its first port ran at 4.5 % of its
// bound at DHFR (2.9 ms); what bounded it, and what this design does:
//   * the weights read from L2 in every wmma load of every 32-edge tile
//     (528 KB a tile at H = 128, 2.7 GB a launch at DHFR), each load
//     serialised in front of its mma.  Now tiles of 64 edges; W1 stays in
//     shared memory for the launch, W2 and W3 stream through a two-slice
//     cp.async ring of 32 k rows (forward) or k columns (reverse), 512 KB a
//     64-edge tile (1.3 GB a launch), copied while the previous slice
//     computes.  W2 whole does not fit beside the 64-edge tiles at H = 128
//     (157 KB of tiles + 66 KB): the ring lives in tiles that are dead at the
//     time (p3 in the forward products and L2's reverse, t1..t2 in L3's
//     reverse), and L3's forward holds its outputs in registers until the
//     ring in p3 is free.  The products are mma.sync m16n8k16 with ldmatrix
//     from shared memory, in the k order of the old wmma products;
//   * idle warps and block-wide barriers: 384 threads, and layers narrower
//     than 12 column tiles left warps waiting (L1 8 tiles, d_ea 2).  Now 512
//     threads; every layer of width N splits into H/8 items of 32 rows by
//     N/(H/16) columns (16, 32 or 48), one a warp at H = 128, so every warp
//     works in every layer but d_ea's;
//   * an f32 scratch epilogue with a global bias load and scalar conversions
//     per element: now the epilogue works on the mma fragments in registers,
//     biases from shared memory (f32), two values a packed conversion;
//   * a slow per-edge loop: now the next edge's ct/cat values are loaded
//     while the current one computes, four edges' d_cutm terms are summed
//     over the warp at once (warp_sum4, the same pairs as a warp sum), the
//     conversions are packed, and the kernel is compiled for silu beside a
//     build that reads the activation at run time;
//   * weight cotangents: the kernel writes each edge's layer inputs and
//     pre-activation cotangents (bf16, as they are already; W3's f32
//     cotangent alone is 384 KB, too large to keep on chip) and
//     et_dw_kernel (et_message.cu) reduces them: cp.async-staged 64-edge
//     tiles, f32 accumulators in registers for a whole split, all three
//     products in one launch, the bias sums folded in as a tile of ones on
//     the tensor cores.  The first port re-read its strips
//     from device memory once per 64x64 output tile with direct wmma loads
//     and summed the biases one thread a column at a 2,368-byte stride.
// Every rounding point and every f32 sum's order is the first port's, so
// d_cat, d_ea and d_cutm are bitwise the first port's (checked on the card
// at the DHFR and training shapes, tools/time_bwd.py --compare); the weight
// cotangents are summed in another order.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int FWD_M = 64;   // edges per tile: forward
constexpr int BWD_M = 32;   // second order
constexpr int MAX_H = 128;  // 3H threads per block (forward, second order)
constexpr int MAX_RBFP = 128;

__device__ __forceinline__ bf16 f2b(float x) { return __float2bfloat16_rn(x); }

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
enum Kind { FWD = 0, BWD2 = 2 };

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

// ---------------------------------------------------------------------------
// The backward (#9): see the header for its design.

constexpr int BWD_TILE = 64;      // edges a tile
constexpr int BWD_THREADS = 512;  // 16 warps; the first 3H threads run the per-edge phase
constexpr int KS = 32;            // k rows (forward) or columns (reverse) of a weight slice

// The backward's shared memory (bytes): W1 as (RBFP, H + 8) bf16 and the
// three biases in f32, for the whole launch; two staging buffers of ea rows,
// neighbor ids and cutm; the activation tiles (BWD_TILE rows of row stride
// sld(width); t1 and t2 adjacent); the warp partials of d_cutm.  The ring of
// W2/W3 slices lives in tiles that are dead at the time: p3 in L2's and
// L3's forward products and L2's reverse, t1..t2 in L3's reverse.
struct BLayout {
  size_t w1, bias, ea, idx, cm, p1, t1, t2, p2, p3, red, total;
};

__host__ __device__ inline BLayout bwd_layout(int h, int rbfp) {
  BLayout s;
  const size_t m = BWD_TILE;
  size_t o = 0;
  auto take = [&](size_t bytes) {
    const size_t at = o;
    o = align128(o + bytes);
    return at;
  };
  s.w1 = take((size_t)rbfp * sld(h) * sizeof(bf16));
  s.bias = take((size_t)6 * h * sizeof(float));
  s.ea = take(2 * m * sld(rbfp) * sizeof(bf16));
  s.idx = take(2 * m * sizeof(int));
  s.cm = take(2 * m * sizeof(float));
  s.p1 = take(m * sld(h) * sizeof(bf16));
  s.t1 = take(m * sld(h) * sizeof(bf16));  // a multiple of 128 bytes: t2 follows at once
  s.t2 = take(m * sld(2 * h) * sizeof(bf16));
  s.p2 = take(m * sld(2 * h) * sizeof(bf16));
  s.p3 = take(m * sld(3 * h) * sizeof(bf16));
  s.red = take(m * (3 * h / 32) * sizeof(float));
  s.total = o;
  return s;
}

// two bf16-valued f32 as a bf16 pair (a at the lower address), no conversion
__device__ __forceinline__ unsigned pack_exact(float a, float b) {
  return (__float_as_uint(a) >> 16) | (__float_as_uint(b) & 0xffff0000u);
}

// A warp's item of a product: 32 rows (two m16 tiles) by 16 CW columns of a
// (BWD_TILE, ncols) output.  acc += A (rows row0.., ld lda) . B over ksteps
// k steps of 16 in order (the old wmma products' order), B in shared
// memory: TRANS, stored k-major (row k, ld ldb; ldmatrix.trans), else
// n-major (row n, ld ldb: the rows of a row-major weight used transposed).
template <int CW, bool TRANS>
__device__ __forceinline__ void mma_steps(float (&acc)[2][2 * CW][4], const bf16* A, int lda, const bf16* B,
                                          int ldb, int ksteps, int row0, int col0, int lane) {
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k = ks * 16;
    unsigned af[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      ldsm_x4(A + (size_t)(row0 + r * 16 + (lane & 15)) * lda + k + ((lane >> 4) << 3), af[r]);
#pragma unroll
    for (int q = 0; q < CW; ++q) {
      unsigned b[4];
      if (TRANS)
        ldsm_x4_t(B + (size_t)(k + (lane & 7) + (((lane >> 3) & 1) << 3)) * ldb + col0 + q * 16 + ((lane >> 4) << 3),
                  b);
      else
        ldsm_x4(B + (size_t)(col0 + q * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldb + k + (((lane >> 3) & 1) << 3),
                b);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mma_bf16(acc[r][2 * q], af[r], b[0], b[1]);
        mma_bf16(acc[r][2 * q + 1], af[r], b[2], b[3]);
      }
    }
  }
}

// epi(row, col, v0, v1) for each pair of adjacent columns of the item's
// accumulators (col even), in registers
template <int CW, class Epi>
__device__ __forceinline__ void item_epilogue(float (&acc)[2][2 * CW][4], int row0, int col0, int lane, Epi epi) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 2 * CW; ++j) {
      const int row = row0 + r * 16 + g, col = col0 + j * 8 + 2 * t;
      epi(row, col, acc[r][j][0], acc[r][j][1]);
      epi(row + 8, col, acc[r][j][2], acc[r][j][3]);
    }
}

// acc += A (BWD_TILE, kdim) . W over kdim in slices of KS, each slice staged
// by all threads with cp.async into a ring of two at `ring`: TRANS, slice s
// is rows [s KS, (s+1) KS) of a row-major (kdim, ncols) W, stored (KS,
// ncols + 8); else columns [s KS, (s+1) KS) of a row-major (ncols, kdim) W,
// stored (ncols, KS + 8).  Warps with an item accumulate; all threads stage
// and synchronise; the ring is free again on return.
template <int CW, bool TRANS>
__device__ void ring_product(float (&acc)[2][2 * CW][4], bool has_item, const bf16* A, int lda,
                             const bf16* __restrict__ W, int kdim, int ncols, bf16* ring, int row0, int col0,
                             int lane) {
  const int slices = kdim / KS;
  const int ld = TRANS ? ncols + 8 : KS + 8;
  const size_t slice_elems = TRANS ? (size_t)KS * ld : (size_t)ncols * ld;
  auto stage = [&](int s) {
    bf16* dst = ring + (s & 1) * slice_elems;
    if (TRANS) {
      const int per_row = ncols / 8;
      for (int x = threadIdx.x; x < KS * per_row; x += blockDim.x) {
        const int r = x / per_row, c8 = x % per_row;
        __pipeline_memcpy_async(dst + r * ld + c8 * 8, W + (size_t)(s * KS + r) * ncols + c8 * 8, 16);
      }
    } else {
      constexpr int per_row = KS / 8;
      for (int x = threadIdx.x; x < ncols * per_row; x += blockDim.x) {
        const int r = x / per_row, c8 = x % per_row;
        __pipeline_memcpy_async(dst + r * ld + c8 * 8, W + (size_t)r * kdim + s * KS + c8 * 8, 16);
      }
    }
    __pipeline_commit();
  };
  stage(0);
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) {
      stage(s + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // slice s has landed for every thread
    if (has_item)
      mma_steps<CW, TRANS>(acc, A + s * KS, lda, ring + (s & 1) * slice_elems, ld, KS / 16, row0, col0, lane);
    __syncthreads();  // every warp is done with this slice's buffer before it is refilled
  }
}

// a forward layer's epilogue for two columns: pre = bf16(bf16(acc) + b),
// t = bf16(act(pre)), stored to pp and tt
__device__ __forceinline__ void fwd_epi(int act, float v0, float v1, const float* b, bf16* pp, bf16* tt) {
  bfr2(v0, v1);
  v0 += b[0];
  v1 += b[1];
  bfr2(v0, v1);
  float f0 = act_fn(act, v0), f1 = act_fn(act, v1);
  bfr2(f0, f1);
  *reinterpret_cast<unsigned*>(pp) = pack_exact(v0, v1);
  *reinterpret_cast<unsigned*>(tt) = pack_exact(f0, f1);
}

// a reverse layer's epilogue for two columns: the pre-activations at pp
// become their cotangents bf16(bf16(act'(pre)) * bf16(acc))
__device__ __forceinline__ void rev_epi(int act, float v0, float v1, bf16* pp) {
  const unsigned w = *reinterpret_cast<const unsigned*>(pp);
  float d0 = dact_fn(act, __uint_as_float(w << 16)), d1 = dact_fn(act, __uint_as_float(w & 0xffff0000u));
  bfr2(d0, d1);
  bfr2(v0, v1);
  *reinterpret_cast<__nv_bfloat162*>(pp) = __floats2bfloat162_rn(d0 * v0, d1 * v1);
}

// mv rows of a (BWD_TILE, w) tile (row stride w + 8) to columns [col, col +
// w) of the per-edge rows of `save` from edge t0, 16 bytes at a time
__device__ __forceinline__ void save_tile(const bf16* tile, int w, int mv, bf16* save, int ld_save, long t0,
                                          int col) {
  const int per_row = w / 8, ld = sld(w);
  for (int x = threadIdx.x; x < mv * per_row; x += blockDim.x) {
    const int r = x / per_row, c8 = x % per_row;
    *reinterpret_cast<uint4*>(save + (size_t)(t0 + r) * ld_save + col + c8 * 8) =
        *reinterpret_cast<const uint4*>(tile + r * ld + c8 * 8);
  }
}

// the gathered values of one edge for one thread: ct[j] rounded to bf16 and
// cat[j] on the thread's components
struct Gath {
  float ct[5], cat[5];
};

__device__ __forceinline__ Gath gather(const Args& p, int j, int cf, int cc, int hh) {
  Gath v;
  const size_t row = (size_t)j * 9 * p.h + cf * p.h + hh;
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    v.ct[c] = c < cc ? p.ct[row + c * p.h] : 0.0f;
    v.cat[c] = c < cc ? ldb(p.cat + row + c * p.h) : 0.0f;
  }
  bfr2(v.ct[0], v.ct[1]);
  bfr2(v.ct[2], v.ct[3]);
  v.ct[4] = bfr(v.ct[4]);
  return v;
}

// The backward: d_cat (N, 9H) bf16, d_ea (N, K, RBF) bf16, d_cutm (N, K)
// f32; with `save` (per-edge rows [ea | t1 | d_p1 | t2 | d_p2 | d_p3], bf16,
// row stride rbfp + 9H) the operands of the weight cotangents
// (et_dw_kernel).  A block owns a contiguous range of receiver rows and
// walks their edges in tiles of BWD_TILE.
template <int ACT>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    tn_bwd_kernel(Args p, bf16* __restrict__ dcat, bf16* __restrict__ dea, float* __restrict__ dcutm,
                  bf16* __restrict__ save) {
  extern __shared__ __align__(128) unsigned char smem[];
  // the activation: a compile-time constant where the instantiation names it
  const int act = ACT >= 0 ? ACT : p.act;
  const int H = p.h, F9 = 9 * H, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const BLayout L = bwd_layout(H, p.rbfp);
  bf16* w1_s = reinterpret_cast<bf16*>(smem + L.w1);
  float* b_s = reinterpret_cast<float*>(smem + L.bias);  // b1 | b2 | b3
  bf16* ea_buf = reinterpret_cast<bf16*>(smem + L.ea);
  int* idx_buf = reinterpret_cast<int*>(smem + L.idx);
  float* cm_buf = reinterpret_cast<float*>(smem + L.cm);
  bf16 *p1 = TILE(p1), *t1 = TILE(t1), *t2 = TILE(t2), *p2 = TILE(p2), *p3 = TILE(p3);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const int lde = sld(p.rbfp), ld1 = sld(H), ld2 = sld(2 * H), ld3 = sld(3 * H);
  const int ld_save = p.rbfp + 9 * H;
  const int nw3 = 3 * H / 32;
  // the products' items: warp w takes rows (w & 1) * 32 and column group w >> 1
  const int row0 = (warp & 1) * 32, cg = warp >> 1;
  const bool big_item = warp < H / 8;  // H/8 items in L1-L3 forward and reverse

  for (int x = tid; x < p.rbfp * H; x += blockDim.x) w1_s[(x / H) * ld1 + x % H] = p.w1[x];
  for (int x = tid; x < 6 * H; x += blockDim.x)
    b_s[x] = x < H ? ldb(p.b1 + x) : (x < 3 * H ? ldb(p.b2 + x - H) : ldb(p.b3 + x - 3 * H));
  for (int x = tid; x < 2 * BWD_TILE * lde; x += blockDim.x) ea_buf[x] = f2b(0.0f);
  __syncthreads();  // the RBF padding is zero before any copy lands

  const int r0 = blockIdx.x * p.rows_per_block, r1 = min(p.n, r0 + p.rows_per_block);
  if (r0 >= r1) return;  // the whole block
  const long e0 = (long)r0 * p.k, e1 = (long)r1 * p.k;
  const int ntiles = (int)((e1 - e0 + BWD_TILE - 1) / BWD_TILE);
  // start copying tile t (ea rows, ids, cutm) into staging buffer t & 1
  auto stage = [&](int t) {
    const long t0 = e0 + (long)t * BWD_TILE;
    const int mv = (int)min((long)BWD_TILE, e1 - t0);
    bf16* ea_s = ea_buf + (t & 1) * BWD_TILE * lde;
    if (p.rbf % 2 == 0) {
      const int words = p.rbf / 2;
      for (int x = tid; x < mv * words; x += blockDim.x) {
        const int r = x / words, w = x % words;
        __pipeline_memcpy_async(ea_s + r * lde + 2 * w, p.ea + (size_t)(t0 + r) * p.rbf + 2 * w, 4);
      }
    } else {  // rows not 4-byte aligned: plain copies
      for (int x = tid; x < mv * p.rbf; x += blockDim.x) {
        const int r = x / p.rbf, c = x % p.rbf;
        ea_s[r * lde + c] = p.ea[(size_t)(t0 + r) * p.rbf + c];
      }
    }
    for (int r = tid; r < mv; r += blockDim.x) {
      __pipeline_memcpy_async(idx_buf + (t & 1) * BWD_TILE + r, p.idx + t0 + r, 4);
      __pipeline_memcpy_async(cm_buf + (t & 1) * BWD_TILE + r, p.cutm + t0 + r, 4);
    }
    __pipeline_commit();
  };

  // the per-edge phase's thread: channel hh of third `third` (the first 3H
  // threads, whole warps); its receiver row `cur`, at slot `slot`
  const bool edge_thread = tid < 3 * H;
  const int third = edge_thread ? tid / H : 0, hh = tid % H;
  const int cf = comp_first(third), cc = comp_count(third);
  int cur = r0, slot = 0;
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, cti[5];
  auto load_cti = [&]() {
#pragma unroll
    for (int c = 0; c < 5; ++c) cti[c] = c < cc ? bfr(p.ct[(size_t)cur * F9 + (cf + c) * H + hh]) : 0.0f;
  };
  if (edge_thread) load_cti();

  stage(0);
  for (int t = 0; t < ntiles; ++t) {
    const long t0 = e0 + (long)t * BWD_TILE;
    const int mv = (int)min((long)BWD_TILE, e1 - t0);
    const bf16* ea_s = ea_buf + (t & 1) * BWD_TILE * lde;
    const int* idx_s = idx_buf + (t & 1) * BWD_TILE;
    float* cm_s = cm_buf + (t & 1) * BWD_TILE;
    __pipeline_wait_prior(0);
    __syncthreads();  // tile t has landed; the last tile is done with every tile buffer
    if (t + 1 < ntiles) stage(t + 1);
    for (int r = tid; r < mv; r += blockDim.x) cm_s[r] = bfr(cm_s[r]);
    if (save) save_tile(ea_s, p.rbfp, mv, save, ld_save, t0, 0);

    // the forward, recomputed.  L1 (W1 resident): p1 = bf16(bf16(ea . W1) + b1), t1 = bf16(act(p1))
    {
      float a[2][2][4] = {};
      if (big_item) {
        mma_steps<1, true>(a, ea_s, lde, w1_s, ld1, p.rbfp / 16, row0, cg * 16, lane);
        item_epilogue<1>(a, row0, cg * 16, lane, [&](int r, int c, float v0, float v1) {
          fwd_epi(act, v0, v1, b_s + c, p1 + r * ld1 + c, t1 + r * ld1 + c);
        });
      }
    }
    __syncthreads();
    // L2 (W2 through the ring in p3): p2, t2
    {
      float a[2][4][4] = {};
      ring_product<2, true>(a, big_item, t1, ld1, p.w2, H, 2 * H, p3, row0, cg * 32, lane);
      if (big_item)
        item_epilogue<2>(a, row0, cg * 32, lane, [&](int r, int c, float v0, float v1) {
          fwd_epi(act, v0, v1, b_s + H + c, p2 + r * ld2 + c, t2 + r * ld2 + c);
        });
    }
    __syncthreads();
    if (save) save_tile(t1, H, mv, save, ld_save, t0, p.rbfp);
    // L3 (W3 through the ring in p3, the outputs held in registers until it
    // is free): p3 = bf16(bf16(t2 . W3) + b3)
    {
      float a[2][6][4] = {};
      ring_product<3, true>(a, big_item, t2, ld2, p.w3, 2 * H, 3 * H, p3, row0, cg * 48, lane);
      if (big_item)
        item_epilogue<3>(a, row0, cg * 48, lane, [&](int r, int c, float v0, float v1) {
          bfr2(v0, v1);
          v0 += b_s[3 * H + c];
          v1 += b_s[3 * H + c + 1];
          bfr2(v0, v1);
          *reinterpret_cast<unsigned*>(p3 + r * ld3 + c) = pack_exact(v0, v1);
        });
    }
    if (save) save_tile(t2, 2 * H, mv, save, ld_save, t0, p.rbfp + 2 * H);
    __syncthreads();  // p3 is complete

    // per edge: d_cat (symmetric gather form, each row's sums in slot
    // order), d_w, d_cutm's terms (four edges' warp sums at once), d_p3 in
    // place of p3; the next edge's gathered values in flight
    if (edge_thread) {
      Gath g = gather(p, idx_s[0], cf, cc, hh);
      for (int eb = 0; eb < mv; eb += 4) {
        float term[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = eb + u;
          term[u] = 0.0f;
          if (e >= mv) continue;  // the same for the whole warp
          Gath nxt = g;
          if (e + 1 < mv) nxt = gather(p, idx_s[e + 1], cf, cc, hh);
          if (slot == p.k) {  // the next receiver row
#pragma unroll
            for (int c = 0; c < 5; ++c) {
              if (c < cc) dcat[(size_t)cur * F9 + (cf + c) * H + hh] = f2b(acc[c]);
              acc[c] = 0.0f;
            }
            ++cur;
            slot = 0;
            load_cti();
          }
          ++slot;
          const float pre = ldb(p3 + e * ld3 + tid);
          float t3 = act_fn(act, pre), d3 = dact_fn(act, pre);
          bfr2(t3, d3);
          const float cmb = cm_s[e];
          const float wb = bfr(t3 * cmb);
          float dw = 0.0f;
#pragma unroll
          for (int c = 0; c < 5; ++c) {
            if (c < cc) {
              float x = g.ct[c] * wb, y = cti[c] * g.cat[c];
              bfr2(x, y);
              acc[c] += x;
              dw += y;
            }
          }
          dw = bfr(dw);
          float tm = dw * t3, dt3 = dw * cmb;
          bfr2(tm, dt3);
          term[u] = tm;
          p3[e * ld3 + tid] = f2b(d3 * dt3);
          g = nxt;
        }
        const float r = warp_sum4(term[0], term[1], term[2], term[3], lane);
        if ((lane & 7) == 0 && eb + (lane >> 3) < mv) red[(eb + (lane >> 3)) * nw3 + warp] = r;
      }
    }
    __syncthreads();  // d_p3 and the warp partials are complete
    if (tid < mv) {
      float s = 0.0f;
      for (int w = 0; w < nw3; ++w) s += red[tid * nw3 + w];
      dcutm[t0 + tid] = s;
    }
    if (save) save_tile(p3, 3 * H, mv, save, ld_save, t0, p.rbfp + 6 * H);

    // the MLP's reverse.  L3 (W3^T through the ring in t1..t2): d_p2 in place of p2
    {
      float a[2][4][4] = {};
      ring_product<2, false>(a, big_item, p3, ld3, p.w3, 3 * H, 2 * H, t1, row0, cg * 32, lane);
      if (big_item)
        item_epilogue<2>(a, row0, cg * 32, lane,
                         [&](int r, int c, float v0, float v1) { rev_epi(act, v0, v1, p2 + r * ld2 + c); });
    }
    __syncthreads();
    if (save) save_tile(p2, 2 * H, mv, save, ld_save, t0, p.rbfp + 4 * H);
    // L2 (W2^T through the ring in p3): d_p1 in place of p1
    {
      float a[2][2][4] = {};
      ring_product<1, false>(a, big_item, p2, ld2, p.w2, 2 * H, H, p3, row0, cg * 16, lane);
      if (big_item)
        item_epilogue<1>(a, row0, cg * 16, lane,
                         [&](int r, int c, float v0, float v1) { rev_epi(act, v0, v1, p1 + r * ld1 + c); });
    }
    __syncthreads();
    if (save) save_tile(p1, H, mv, save, ld_save, t0, p.rbfp + H);
    // L1 (W1^T resident): d_ea
    if (warp < p.rbfp / 8) {
      float a[2][2][4] = {};
      mma_steps<1, false>(a, p1, ld1, w1_s, ld1, H / 16, row0, cg * 16, lane);
      item_epilogue<1>(a, row0, cg * 16, lane, [&](int r, int c, float v0, float v1) {
        if (r >= mv) return;
        bf16* o = dea + (size_t)(t0 + r) * p.rbf + c;
        if (c < p.rbf) o[0] = f2b(v0);
        if (c + 1 < p.rbf) o[1] = f2b(v1);
      });
    }
  }
  if (edge_thread) {
#pragma unroll
    for (int c = 0; c < 5; ++c)
      if (c < cc) dcat[(size_t)cur * F9 + (cf + c) * H + hh] = f2b(acc[c]);
  }
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
      const float term = group_sum(wbar * t3 + wdbar * td3, 32);
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

// The backward's grid: one block an SM (its shared memory), each block a
// contiguous range of rows.
cudaError_t plan_bwd(Args* p, size_t* smem, int* blocks) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *smem = bwd_layout(p->h, p->rbfp).total;
  if (*smem > (size_t)smem_max) return cudaErrorInvalidValue;
  p->rows_per_block = (p->n + sms - 1) / sms;
  *blocks = (p->n + p->rows_per_block - 1) / p->rows_per_block;
  return cudaSuccess;
}

// the backward compiled for silu (the configurations' choice), with the
// activation folded into its arithmetic, and for any activation read at
// run time
const void* bwd_kernel(int act) {
  return act == ACT_SILU ? reinterpret_cast<const void*>(tn_bwd_kernel<ACT_SILU>)
                         : reinterpret_cast<const void*>(tn_bwd_kernel<-1>);
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
  cudaError_t err = plan_bwd(&p, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_kernel(act), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16 *o_dcat = static_cast<bf16*>(dcat), *o_dea = static_cast<bf16*>(dea), *o_save = static_cast<bf16*>(save);
  float* o_dcutm = static_cast<float*>(dcutm);
  if (act == ACT_SILU)
    tn_bwd_kernel<ACT_SILU><<<blocks, BWD_THREADS, smem, st>>>(p, o_dcat, o_dea, o_dcutm, o_save);
  else
    tn_bwd_kernel<-1><<<blocks, BWD_THREADS, smem, st>>>(p, o_dcat, o_dea, o_dcutm, o_save);
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

// The backward's (tn_bwd_kernel for silu) resources at a shape: out =
// registers a thread, local (spill) bytes a thread, threads a block, dynamic
// shared memory a block, resident blocks an SM.
int tn_resources(int n, int k, int h, int rbf, int* out) {
  if (!valid_shape(n, k, h, rbf)) return (int)cudaErrorInvalidValue;
  Args p = make_args(nullptr, n, k, h, rbf, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     nullptr, nullptr, ACT_SILU);
  size_t smem = 0;
  int blocks = 0;
  const void* fn = bwd_kernel(ACT_SILU);
  cudaError_t err = plan_bwd(&p, &smem, &blocks);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  int per_sm = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, BWD_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = BWD_THREADS;
  out[3] = (int)smem;
  out[4] = per_sm;
  return 0;
}

}  // extern "C"
