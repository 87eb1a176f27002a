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
// The forward (#8).  Its first port ran at 4.4 % of its bound at DHFR (1.32
// ms; the backward, which recomputes this forward with the machinery below
// and then runs its reverse, took 1.31).  What bounded it, and what this
// design does:
//   * the weights read from L2 by the wmma B loads at every k step of every
//     64-edge tile (about 270 KB a tile, 0.7 GB a launch at DHFR), each load
//     serialised in front of its mma.  Now the backward's products: W1
//     resident in shared memory for the launch, W2 and W3 through the
//     two-slice cp.async ring of 32 k rows in the tile that holds w (dead
//     until L3's epilogue; L3's outputs wait in registers until the ring is
//     done), mma.sync m16n8k16 items with ldmatrix in the old wmma k order;
//   * an f32 scratch epilogue with a global bias load and a scalar
//     conversion per element: now the register epilogues, biases in f32
//     shared memory, two values a packed conversion, w = bf16(t3 * cutm)
//     written straight from L3's fragments;
//   * synchronous scalar staging and four block barriers a tile: now the next
//     tile's ea rows, ids and cutm are staged with cp.async (the backward's
//     stage_edges) while the current one computes;
//   * 3H = 384 threads, one block an SM, where L1's 8 column tiles left 4
//     of 12 warps idle and the per-edge thread of channel h of third S did
//     five products an edge to third I's one: now 9H/2 = 576 threads at H
//     = 128 (18 warps), every layer split into H/8 items (one a warp for 16
//     of them);
//   * a per-edge loop that walked one edge at a time with 2-byte gathers of
//     cat, nothing loaded ahead: now the phase's units are (component,
//     channel pair), one a thread, so every thread gathers 4 bytes of one
//     component an edge and the work is even across the components; the
//     next FWD_AHEAD edges' pairs are in flight in a register ring, refilled
//     without a condition (a predicated refill is loaded into a temporary
//     and moved into the ring, and the move waits for the load: an L2
//     round trip an edge); the pair's two products are one mul.rn.bf16x2
//     (the exact product rounded once, as bf16(f32 product)).  Each (row,
//     channel) sum stays in one thread in ascending slot order.
// Every rounding point and every f32 sum's order is the first port's, so m
// is bitwise the first port's (tools/time_bwd.py --compare on the card at
// the DHFR and training shapes).  No float atomics anywhere: every result is
// bitwise the same from run to run.
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
//
// The second order (#10) is the VJP of the backward with respect to
// (inputs, ct) given cotangents Z on its outputs: S = <vjp_f(a)(ct), Z> =
// <ct, J_f(a) . Z>, so g_ct = J_f(a) . Z is a dual-number forward (every MLP
// value carries a tangent driven by Z) and g_inputs is the reverse of that
// forward seeded with ct, written out per layer with the activations'
// second derivatives.  Its source-row gradient depends on Z (not
// symmetric), so the kernel writes the tangent of w per edge (3H f32) and
// tn_src_sum_kernel sums ct_i * w_dot through the transpose permutation.
// Its first port ran at 1.71 ms at the training shapes (N = 1152, K = 33,
// H = 128), 7 % of its bound; what bounded it, and what this design does
// (the backward's machinery, with a tangent beside every value):
//   * W and Z_W read from L2 in every wmma load of all six dual products of
//     every 32-edge tile (about 1.1 MB a tile, 1.3 GB a launch), each load in
//     front of its mma.  Now W1 and Z_W1 stay in shared memory for the
//     launch, and W2/Z_W2 and W3/Z_W3 stream through a two-slice cp.async
//     ring whose slices of 16 k rows (forward) or k columns (reverse) hold
//     W and Z_W together, copied while the previous slice computes.  The
//     value and tangent tiles of the layers would take 153 KB at H = 128,
//     so tiles whose lives do not overlap share shared memory, and the ring
//     lives in what is dead at the time: one region holds L2's forward
//     ring, then t2/t2', then p3/p3'; another t1/t1', then the rings of
//     L3's forward and of the reverse (188 KB in all at RBF = 32; the
//     second order takes RBF <= 80 at H = 128);
//   * 3H threads (384 at H = 128, 96 at H = 32) and an f32 scratch epilogue
//     (24 KB) with a global bias load per element: now 512 threads, every
//     layer split into H/8 items of 16 rows by N/(H/16) columns (one a warp
//     at H = 128), mma.sync m16n8k16 with ldmatrix in the k order of the old
//     wmma products, dual accumulators in registers with register
//     epilogues, biases in f32 shared memory, two values a packed
//     conversion;
//   * ten __syncthreads a tile with synchronous scalar staging: now the next
//     tile's ea/z_ea rows, ids, cutm and z_cutm are staged with cp.async
//     while the current one computes;
//   * a per-edge loop of one edge at a time with one warp sum each: now the
//     next edge's cat/z_cat values are gathered while the current one
//     computes, four edges' g_cutm terms are summed over the warp at once
//     (warp_sum4, the same pairs), and the kernel is compiled for silu
//     beside a build that reads the activation at run time;
//   * per-edge rows saved 2 bytes at a time with a division per element
//     (2 RBFP + 18H = 2368 columns an edge): now 16 bytes at a time, each
//     tile's columns saved as soon as they are final.
// Every rounding point and every f32 sum's order is the first port's, so
// g_cat, g_ea, g_cutm, g_ct and the per-edge rows are bitwise the first
// port's (tools/time_bwd.py --compare on the card), and with them the
// weight gradients et_dw_kernel reduces.
#include "common.cuh"

namespace {

constexpr int MAX_H = 128;
constexpr int MAX_RBFP = 128;

__device__ __forceinline__ bf16 f2b(float x) { return __float2bfloat16_rn(x); }

__host__ __device__ inline int pad16(int x) { return (x + 15) / 16 * 16; }
// shared-memory row stride (bf16 elements) of a tile `w` wide: a multiple of
// 8 (16-byte rows, as ldmatrix and cp.async want), and 8 past it so that
// rows start on different banks
__host__ __device__ inline int sld(int w) { return w + 8; }
__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// the components thread `third` owns: I -> [0], A -> [1, 4), S -> [4, 9)
__device__ __forceinline__ int comp_first(int third) { return third == 0 ? 0 : (third == 1 ? 1 : 4); }
__device__ __forceinline__ int comp_count(int third) { return third == 0 ? 1 : (third == 1 ? 3 : 5); }
// the third of w that component c multiplies
__device__ __forceinline__ int third_of(int c) { return c == 0 ? 0 : (c < 4 ? 1 : 2); }

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

#define TILE(name) reinterpret_cast<bf16*>(smem + L.name)

// ---------------------------------------------------------------------------
// The forward (#8) and the backward (#9): see the header for their design.

constexpr int EDGE_TILE = 64;                  // edges a tile
constexpr int EDGE_THREADS = 512;              // the backward's: 16 warps
constexpr int FWD_THREADS = 9 * MAX_H / 2;     // the forward's: one per-edge unit a thread at H = 128
constexpr int KS = 32;                         // k rows (forward) or columns (reverse) of a weight slice
constexpr int FWD_AHEAD = 4;                   // edges whose gathered cat pairs are in flight (forward)

// The forward's (fwd) and the backward's shared memory (bytes): W1 as (RBFP,
// H + 8) bf16 and the three biases in f32, for the whole launch; two staging
// buffers of ea rows, neighbor ids and cutm; the activation tiles (EDGE_TILE
// rows of row stride sld(width); t1 and t2 adjacent; p3 holds the forward's
// w); the backward's pre-activation tiles p1 and p2 and the warp partials of
// d_cutm (none in the forward).  The ring of W2/W3 slices lives in tiles
// that are dead at the time: p3 in L2's and L3's forward products and L2's
// reverse, t1..t2 in L3's reverse.
struct BLayout {
  size_t w1, bias, ea, idx, cm, p1, t1, t2, p2, p3, red, total;
};

__host__ __device__ inline BLayout edge_layout(int h, int rbfp, bool fwd) {
  BLayout s;
  const size_t m = EDGE_TILE;
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
  s.p1 = take(fwd ? 0 : m * sld(h) * sizeof(bf16));
  s.t1 = take(m * sld(h) * sizeof(bf16));  // a multiple of 128 bytes: t2 follows at once
  s.t2 = take(m * sld(2 * h) * sizeof(bf16));
  s.p2 = take(fwd ? 0 : m * sld(2 * h) * sizeof(bf16));
  s.p3 = take(m * sld(3 * h) * sizeof(bf16));
  s.red = take(fwd ? 0 : m * (3 * h / 32) * sizeof(float));
  s.total = o;
  return s;
}

// W1 (RBFP, H) into rows of H + 8 and the biases b1 | b2 | b3 in f32 for
// the whole launch, and both ea staging buffers zeroed, so that their RBF
// padding columns stay zero.  Called by all threads; ends with a barrier.
__device__ void load_resident(const Args& p, bf16* w1_s, float* b_s, bf16* ea_buf, int lde) {
  const int H = p.h, ld1 = sld(H);
  for (int x = threadIdx.x; x < p.rbfp * H; x += blockDim.x) w1_s[(x / H) * ld1 + x % H] = p.w1[x];
  for (int x = threadIdx.x; x < 6 * H; x += blockDim.x)
    b_s[x] = x < H ? ldb(p.b1 + x) : (x < 3 * H ? ldb(p.b2 + x - H) : ldb(p.b3 + x - 3 * H));
  for (int x = threadIdx.x; x < 2 * EDGE_TILE * lde; x += blockDim.x) ea_buf[x] = f2b(0.0f);
  __syncthreads();  // the RBF padding is zero before any copy lands
}

// Start copying tile t of the edges [e0, e1) (ea rows, neighbor ids, cutm)
// into staging buffer t & 1 with cp.async, one commit group.  Called by all
// threads.
__device__ void stage_edges(const Args& p, long e0, long e1, int t, bf16* ea_buf, int* idx_buf, float* cm_buf,
                            int lde) {
  const int tid = threadIdx.x;
  const long t0 = e0 + (long)t * EDGE_TILE;
  const int mv = (int)min((long)EDGE_TILE, e1 - t0);
  bf16* ea_s = ea_buf + (t & 1) * EDGE_TILE * lde;
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
    __pipeline_memcpy_async(idx_buf + (t & 1) * EDGE_TILE + r, p.idx + t0 + r, 4);
    __pipeline_memcpy_async(cm_buf + (t & 1) * EDGE_TILE + r, p.cutm + t0 + r, 4);
  }
  __pipeline_commit();
}

// the two products of bf16 pairs, each rounded once to bf16 (an exact
// product rounded to nearest even: bf16(f32(a) * f32(b)) for bf16 a, b)
__device__ __forceinline__ unsigned mul_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// two bf16-valued f32 as a bf16 pair (a at the lower address), no conversion
__device__ __forceinline__ unsigned pack_exact(float a, float b) {
  return (__float_as_uint(a) >> 16) | (__float_as_uint(b) & 0xffff0000u);
}

// A warp's item of a product: 32 rows (two m16 tiles) by 16 CW columns of a
// (EDGE_TILE, ncols) output.  acc += A (rows row0.., ld lda) . B over ksteps
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

// acc += A (EDGE_TILE, kdim) . W over kdim in slices of KS, each slice staged
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

// a layer's pre-activations for two columns: pre = bf16(bf16(acc) + b)
__device__ __forceinline__ void pre_epi(float& v0, float& v1, const float* b) {
  bfr2(v0, v1);
  v0 += b[0];
  v1 += b[1];
  bfr2(v0, v1);
}

// a forward layer's epilogue for two columns: pre = bf16(bf16(acc) + b),
// t = bf16(act(pre)), stored to tt and, unless it is null, pre to pp
__device__ __forceinline__ void fwd_epi(int act, float v0, float v1, const float* b, bf16* pp, bf16* tt) {
  pre_epi(v0, v1, b);
  float f0 = act_fn(act, v0), f1 = act_fn(act, v1);
  bfr2(f0, f1);
  if (pp) *reinterpret_cast<unsigned*>(pp) = pack_exact(v0, v1);
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

// mv rows of a (EDGE_TILE, w) tile (row stride w + 8) to columns [col, col +
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

// The forward: m (N, 9H) f32.  A block owns a contiguous range of receiver
// rows and walks their edges in tiles of EDGE_TILE: the edge MLP as the
// backward recomputes it, w = bf16(t3 * cutm) in p3, then the per-edge
// phase.  Its units are (component c, channel pair q), 9H/2 of them, one a
// thread; a unit sums bf16(cat[j, c, pair] * w[third(c), pair]) over its
// row's slots in ascending order, the next FWD_AHEAD edges' cat pairs in
// flight.
template <int ACT>
__global__ void __launch_bounds__(FWD_THREADS, 1) tn_fwd_kernel(Args p, float* __restrict__ m_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  // the activation: a compile-time constant where the instantiation names it
  const int act = ACT >= 0 ? ACT : p.act;
  const int H = p.h, F9 = 9 * H, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const BLayout L = edge_layout(H, p.rbfp, true);
  bf16* w1_s = TILE(w1);
  float* b_s = reinterpret_cast<float*>(smem + L.bias);  // b1 | b2 | b3
  bf16* ea_buf = TILE(ea);
  int* idx_buf = reinterpret_cast<int*>(smem + L.idx);
  float* cm_buf = reinterpret_cast<float*>(smem + L.cm);
  bf16 *t1 = TILE(t1), *t2 = TILE(t2), *w_s = TILE(p3);
  const int lde = sld(p.rbfp), ld1 = sld(H), ld2 = sld(2 * H), ld3 = sld(3 * H);
  // the products' items: warp w takes rows (w & 1) * 32 and column group w >> 1
  const int row0 = (warp & 1) * 32, cg = warp >> 1;
  const bool big_item = warp < H / 8;  // H/8 items in L1-L3
  load_resident(p, w1_s, b_s, ea_buf, lde);

  const int r0 = blockIdx.x * p.rows_per_block, r1 = min(p.n, r0 + p.rows_per_block);
  if (r0 >= r1) return;  // the whole block
  const long e0 = (long)r0 * p.k, e1 = (long)r1 * p.k;
  const int ntiles = (int)((e1 - e0 + EDGE_TILE - 1) / EDGE_TILE);

  // this thread's unit (none past 9H/2): component c, pair q; its receiver
  // row `cur`, at slot `slot`, and the row's two f32 sums
  const bool unit = tid < 9 * H / 2;
  const int comp = tid / (H / 2), q = tid % (H / 2);
  const int ccol = comp * H + 2 * q, wcol = third_of(comp) * H + 2 * q;
  int cur = r0, slot = 0;
  float acc0 = 0.0f, acc1 = 0.0f;

  stage_edges(p, e0, e1, 0, ea_buf, idx_buf, cm_buf, lde);
  for (int t = 0; t < ntiles; ++t) {
    const long t0 = e0 + (long)t * EDGE_TILE;
    const int mv = (int)min((long)EDGE_TILE, e1 - t0);
    const bf16* ea_s = ea_buf + (t & 1) * EDGE_TILE * lde;
    const int* idx_s = idx_buf + (t & 1) * EDGE_TILE;
    float* cm_s = cm_buf + (t & 1) * EDGE_TILE;
    __pipeline_wait_prior(0);
    __syncthreads();  // tile t has landed; the last tile is done with every tile buffer
    if (t + 1 < ntiles) stage_edges(p, e0, e1, t + 1, ea_buf, idx_buf, cm_buf, lde);
    for (int r = tid; r < mv; r += blockDim.x) cm_s[r] = bfr(cm_s[r]);

    // L1 (W1 resident): t1 = bf16(act(bf16(bf16(ea . W1) + b1)))
    if (big_item) {
      float a[2][2][4] = {};
      mma_steps<1, true>(a, ea_s, lde, w1_s, ld1, p.rbfp / 16, row0, cg * 16, lane);
      item_epilogue<1>(a, row0, cg * 16, lane, [&](int r, int c, float v0, float v1) {
        fwd_epi(act, v0, v1, b_s + c, nullptr, t1 + r * ld1 + c);
      });
    }
    __syncthreads();
    // L2 (W2 through the ring in p3): t2
    {
      float a[2][4][4] = {};
      ring_product<2, true>(a, big_item, t1, ld1, p.w2, H, 2 * H, w_s, row0, cg * 32, lane);
      if (big_item)
        item_epilogue<2>(a, row0, cg * 32, lane, [&](int r, int c, float v0, float v1) {
          fwd_epi(act, v0, v1, b_s + H + c, nullptr, t2 + r * ld2 + c);
        });
    }
    __syncthreads();
    // L3 (W3 through the ring in p3, the outputs held in registers until it
    // is free): w = bf16(bf16(act(bf16(bf16(t2 . W3) + b3))) * bf16(cutm)) in p3
    {
      float a[2][6][4] = {};
      ring_product<3, true>(a, big_item, t2, ld2, p.w3, 2 * H, 3 * H, w_s, row0, cg * 48, lane);
      if (big_item)
        item_epilogue<3>(a, row0, cg * 48, lane, [&](int r, int c, float v0, float v1) {
          pre_epi(v0, v1, b_s + 3 * H + c);
          float f0 = act_fn(act, v0), f1 = act_fn(act, v1);
          bfr2(f0, f1);
          const float cm = cm_s[r];
          *reinterpret_cast<__nv_bfloat162*>(w_s + r * ld3 + c) = __floats2bfloat162_rn(f0 * cm, f1 * cm);
        });
    }
    __syncthreads();  // w is complete

    // per edge, in slot order: the unit's two products, rounded to bf16,
    // into its row's f32 sums; the cat pairs of the next FWD_AHEAD edges in
    // flight (a register ring, slot u holding edge eb + u).  The refill is
    // unconditional (past the tile it re-reads the tile's last edge), so
    // each load lands in its ring register with nothing waiting on it.
    if (unit) {
      const bf16* cat_u = p.cat + ccol;
      auto fetch = [&](int e) { return ldg_u32(cat_u + (size_t)idx_s[min(e, mv - 1)] * F9); };
      const bf16* w_u = w_s + wcol;
      unsigned g[FWD_AHEAD];
#pragma unroll
      for (int u = 0; u < FWD_AHEAD; ++u) g[u] = fetch(u);
      for (int eb = 0; eb < mv; eb += FWD_AHEAD) {
#pragma unroll
        for (int u = 0; u < FWD_AHEAD; ++u) {
          const int e = eb + u;
          if (e >= mv) break;  // the same for the whole block
          if (slot == p.k) {   // the next receiver row
            *reinterpret_cast<float2*>(m_out + (size_t)cur * F9 + ccol) = make_float2(acc0, acc1);
            acc0 = acc1 = 0.0f;
            ++cur;
            slot = 0;
          }
          ++slot;
          const unsigned x = mul_bf16x2(g[u], *reinterpret_cast<const unsigned*>(w_u + e * ld3));
          g[u] = fetch(e + FWD_AHEAD);
          acc0 += __uint_as_float(x << 16);
          acc1 += __uint_as_float(x & 0xffff0000u);
        }
      }
    }
  }
  if (unit) *reinterpret_cast<float2*>(m_out + (size_t)cur * F9 + ccol) = make_float2(acc0, acc1);
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
// walks their edges in tiles of EDGE_TILE.
template <int ACT>
__global__ void __launch_bounds__(EDGE_THREADS, 1)
    tn_bwd_kernel(Args p, bf16* __restrict__ dcat, bf16* __restrict__ dea, float* __restrict__ dcutm,
                  bf16* __restrict__ save) {
  extern __shared__ __align__(128) unsigned char smem[];
  // the activation: a compile-time constant where the instantiation names it
  const int act = ACT >= 0 ? ACT : p.act;
  const int H = p.h, F9 = 9 * H, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const BLayout L = edge_layout(H, p.rbfp, false);
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

  load_resident(p, w1_s, b_s, ea_buf, lde);

  const int r0 = blockIdx.x * p.rows_per_block, r1 = min(p.n, r0 + p.rows_per_block);
  if (r0 >= r1) return;  // the whole block
  const long e0 = (long)r0 * p.k, e1 = (long)r1 * p.k;
  const int ntiles = (int)((e1 - e0 + EDGE_TILE - 1) / EDGE_TILE);
  auto stage = [&](int t) { stage_edges(p, e0, e1, t, ea_buf, idx_buf, cm_buf, lde); };

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
    const long t0 = e0 + (long)t * EDGE_TILE;
    const int mv = (int)min((long)EDGE_TILE, e1 - t0);
    const bf16* ea_s = ea_buf + (t & 1) * EDGE_TILE * lde;
    const int* idx_s = idx_buf + (t & 1) * EDGE_TILE;
    float* cm_s = cm_buf + (t & 1) * EDGE_TILE;
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
          pre_epi(v0, v1, b_s + 3 * H + c);
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

// ---------------------------------------------------------------------------
// The second order (#10): see the header for its design.

constexpr int BWD2_TILE = 32;      // edges a tile
constexpr int BWD2_THREADS = 512;  // 16 warps; the first 3H threads run the per-edge phase
constexpr int KS2 = 16;            // k rows (forward) or columns (reverse) of a dual weight slice

// bytes of a dual ring: two slices, each of W and Z_W, stored (KS2, ncols + 8)
// (TRANS: rows of a (kdim, ncols) weight) or (ncols, KS2 + 8) (columns of an
// (ncols, kdim) weight)
__host__ __device__ inline size_t dual_ring_bytes(int ncols, bool trans) {
  return (size_t)4 * (trans ? (size_t)KS2 * (ncols + 8) : (size_t)ncols * (KS2 + 8)) * sizeof(bf16);
}

// The second order's shared memory (bytes): W1 and Z_W1 as (RBFP, H + 8)
// bf16 and the six biases in f32 (b1 | b2 | b3 | z_b1 | z_b2 | z_b3), for
// the whole launch; two staging buffers of ea and z_ea rows, neighbor ids,
// cutm and z_cutm; the value and tangent tiles of each layer (BWD2_TILE
// rows of row stride sld(width)), where tiles whose lives do not overlap
// share a region: p1 | p1' and p2 | p2' for the tile; a region y that holds
// L2's forward ring, then t2 | t2' (L2's outputs, L3's inputs), then p3 |
// p3' (L3's outputs, the reverse's first input); a region x that holds t1 |
// t1' (L1's outputs, L2's inputs), then the ring of L3's forward and of the
// reverse; the warp partials of g_cutm.
struct B2Layout {
  size_t w1, zw1, bias, ea, zea, idx, cm, zcm, p1, pd1, p2, pd2, y, x, red, total;
};

__host__ __device__ inline B2Layout bwd2_layout(int h, int rbfp) {
  B2Layout s;
  const size_t m = BWD2_TILE;
  size_t o = 0;
  auto take = [&](size_t bytes) {
    const size_t at = o;
    o = align128(o + bytes);
    return at;
  };
  s.w1 = take((size_t)rbfp * sld(h) * sizeof(bf16));
  s.zw1 = take((size_t)rbfp * sld(h) * sizeof(bf16));
  s.bias = take((size_t)12 * h * sizeof(float));
  s.ea = take(2 * m * sld(rbfp) * sizeof(bf16));
  s.zea = take(2 * m * sld(rbfp) * sizeof(bf16));
  s.idx = take(2 * m * sizeof(int));
  s.cm = take(2 * m * sizeof(float));
  s.zcm = take(2 * m * sizeof(float));
  s.p1 = take(m * sld(h) * sizeof(bf16));
  s.pd1 = take(m * sld(h) * sizeof(bf16));
  s.p2 = take(m * sld(2 * h) * sizeof(bf16));
  s.pd2 = take(m * sld(2 * h) * sizeof(bf16));
  // each value tile is a multiple of 128 bytes, so its tangent follows at once;
  // p3 | p3' holds t2 | t2' and L2's forward ring
  s.y = take(2 * m * sld(3 * h) * sizeof(bf16));
  size_t x = 2 * m * sld(h) * sizeof(bf16);  // t1 | t1'
  const size_t fwd3 = dual_ring_bytes(3 * h, true), rev3 = dual_ring_bytes(2 * h, false);
  x = x > fwd3 ? x : fwd3;
  x = x > rev3 ? x : rev3;
  s.x = take(x);
  s.red = take(m * (3 * h / 32) * sizeof(float));
  s.total = o;
  return s;
}

enum Dual {
  DUAL_FWD = 0,  // c0 += A.B, then c1 += Ad.B, c1 += A.ZB  (a value and its tangent)
  DUAL_REV = 1,  // c0 += A.B, c0 += Ad.ZB, and c1 += Ad.B  (a cotangent and the tangent's)
  DUAL_REV0 = 2  // c0 += A.B, c0 += Ad.ZB
};

// A warp's item of a dual product: 16 rows by 16 CW columns of a
// (BWD2_TILE, ncols) output, from a value A and its tangent Ad (rows row0..,
// ld lda) against a weight B and its Z (ZB), both in shared memory with the
// layouts of mma_steps (TRANS: k-major; else n-major, ld ldb).  Per k step
// of 16, in order, the products of MODE in the order the first port's wmma
// products ran them, so every sum is bitwise its sum.
template <int CW, bool TRANS, int MODE>
__device__ __forceinline__ void dual_steps(float (&c0)[2 * CW][4], float (&c1)[2 * CW][4], const bf16* A,
                                           const bf16* Ad, int lda, const bf16* B, const bf16* ZB, int ldb,
                                           int ksteps, int row0, int col0, int lane) {
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k = ks * 16;
    const size_t aoff = (size_t)(row0 + (lane & 15)) * lda + k + ((lane >> 4) << 3);
    unsigned a[4], ad[4];
    ldsm_x4(A + aoff, a);
    ldsm_x4(Ad + aoff, ad);
#pragma unroll
    for (int q = 0; q < CW; ++q) {
      unsigned b[4], zb[4];
      if (TRANS) {
        const size_t boff = (size_t)(k + (lane & 7) + (((lane >> 3) & 1) << 3)) * ldb + col0 + q * 16 +
                            ((lane >> 4) << 3);
        ldsm_x4_t(B + boff, b);
        ldsm_x4_t(ZB + boff, zb);
      } else {
        const size_t boff = (size_t)(col0 + q * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldb + k +
                            (((lane >> 3) & 1) << 3);
        ldsm_x4(B + boff, b);
        ldsm_x4(ZB + boff, zb);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {  // the two 8-column halves
        const int j = 2 * q + hf;
        mma_bf16(c0[j], a, b[2 * hf], b[2 * hf + 1]);
        if (MODE == DUAL_FWD) {
          mma_bf16(c1[j], ad, b[2 * hf], b[2 * hf + 1]);
          mma_bf16(c1[j], a, zb[2 * hf], zb[2 * hf + 1]);
        } else {
          mma_bf16(c0[j], ad, zb[2 * hf], zb[2 * hf + 1]);
          if (MODE == DUAL_REV) mma_bf16(c1[j], ad, b[2 * hf], b[2 * hf + 1]);
        }
      }
    }
  }
}

// epi(row, col, v0, v1, u0, u1) for each pair of adjacent columns (col even)
// of a dual item's accumulators (v from c0, u from c1), in registers
template <int CW, class Epi>
__device__ __forceinline__ void dual_epilogue(float (&c0)[2 * CW][4], float (&c1)[2 * CW][4], int row0, int col0,
                                              int lane, Epi epi) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2 * CW; ++j) {
    const int row = row0 + g, col = col0 + j * 8 + 2 * t;
    epi(row, col, c0[j][0], c0[j][1], c1[j][0], c1[j][1]);
    epi(row + 8, col, c0[j][2], c0[j][3], c1[j][2], c1[j][3]);
  }
}

// The dual product of (A, Ad) (BWD2_TILE, kdim) and (W, Z_W) over kdim in
// slices of KS2, each slice of both weights staged by all threads with
// cp.async into a ring of two at `ring` (dual_ring_bytes): TRANS, slice s is
// rows [s KS2, (s+1) KS2) of row-major (kdim, ncols) weights; else columns
// [s KS2, (s+1) KS2) of row-major (ncols, kdim) ones.  Warps with an item
// accumulate; all threads stage and synchronise; the ring is free again on
// return.
template <int CW, bool TRANS, int MODE>
__device__ void ring_dual(float (&c0)[2 * CW][4], float (&c1)[2 * CW][4], bool has_item, const bf16* A,
                          const bf16* Ad, int lda, const bf16* __restrict__ W, const bf16* __restrict__ ZW, int kdim,
                          int ncols, bf16* ring, int row0, int col0, int lane) {
  const int slices = kdim / KS2;
  const int ld = TRANS ? ncols + 8 : KS2 + 8;
  const size_t mat = TRANS ? (size_t)KS2 * ld : (size_t)ncols * ld;  // one weight's part of a slice
  auto stage = [&](int s) {
    bf16* dst = ring + (s & 1) * 2 * mat;
    const int per_row = TRANS ? ncols / 8 : KS2 / 8, rows = TRANS ? KS2 : ncols;
    const int per_w = rows * per_row;
    for (int x = threadIdx.x; x < 2 * per_w; x += blockDim.x) {
      const int z = x >= per_w, y = x - z * per_w;
      const int r = y / per_row, c8 = y % per_row;
      const bf16* src = (z ? ZW : W) + (TRANS ? (size_t)(s * KS2 + r) * ncols : (size_t)r * kdim + s * KS2);
      __pipeline_memcpy_async(dst + z * mat + r * ld + c8 * 8, src + c8 * 8, 16);
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
    if (has_item) {
      const bf16* b = ring + (s & 1) * 2 * mat;
      dual_steps<CW, TRANS, MODE>(c0, c1, A + s * KS2, Ad + s * KS2, lda, b, b + mat, ld, 1, row0, col0, lane);
    }
    __syncthreads();  // every warp is done with this slice's buffer before it is refilled
  }
}

// The dual forward's epilogue of L1 and L2 for two columns, from the value
// (v) and tangent (u) accumulators: pre = bf16(bf16(v) + b), pre' =
// bf16(bf16(u) + z_b), t = bf16(act(pre)) and t' = bf16(act'(pre) pre'),
// stored to pp, ppd, tt and ttd
__device__ __forceinline__ void dual_fwd_epi(int act, float v0, float v1, float u0, float u1, const float* b,
                                             const float* zb, bf16* pp, bf16* ppd, bf16* tt, bf16* ttd) {
  bfr2(v0, v1);
  bfr2(u0, u1);
  v0 += b[0];
  v1 += b[1];
  u0 += zb[0];
  u1 += zb[1];
  bfr2(v0, v1);
  bfr2(u0, u1);
  float f[2], f1[2], f2[2];
  act3(act, v0, &f[0], &f1[0], &f2[0]);
  act3(act, v1, &f[1], &f1[1], &f2[1]);
  float d0 = f1[0] * u0, d1 = f1[1] * u1;
  bfr2(f[0], f[1]);
  bfr2(d0, d1);
  *reinterpret_cast<unsigned*>(pp) = pack_exact(v0, v1);
  *reinterpret_cast<unsigned*>(ppd) = pack_exact(u0, u1);
  *reinterpret_cast<unsigned*>(tt) = pack_exact(f[0], f[1]);
  *reinterpret_cast<unsigned*>(ttd) = pack_exact(d0, d1);
}

// A reverse layer's epilogue for two columns, through the activation: from
// the cotangents of its value (v) and of its tangent (u) to those of the
// pre-activation, bf16(v act'(pre) + u act''(pre) pre'), and of its
// tangent, bf16(u act'(pre)), in place of pre at pp and pre' at ppd
__device__ __forceinline__ void dual_rev_epi(int act, float v0, float v1, float u0, float u1, bf16* pp,
                                             bf16* ppd) {
  const unsigned w = *reinterpret_cast<const unsigned*>(pp), wd = *reinterpret_cast<const unsigned*>(ppd);
  const float pre0 = __uint_as_float(w << 16), pre1 = __uint_as_float(w & 0xffff0000u);
  const float pred0 = __uint_as_float(wd << 16), pred1 = __uint_as_float(wd & 0xffff0000u);
  float f, f1[2], f2[2];
  act3(act, pre0, &f, &f1[0], &f2[0]);
  act3(act, pre1, &f, &f1[1], &f2[1]);
  float a0 = v0 * f1[0] + u0 * f2[0] * pred0, a1 = v1 * f1[1] + u1 * f2[1] * pred1;
  float d0 = u0 * f1[0], d1 = u1 * f1[1];
  bfr2(a0, a1);
  bfr2(d0, d1);
  *reinterpret_cast<unsigned*>(pp) = pack_exact(a0, a1);
  *reinterpret_cast<unsigned*>(ppd) = pack_exact(d0, d1);
}

// the gathered source values of one edge for one thread: cat[j] and z_cat[j]
// on the thread's components
struct Gath2 {
  float cat[5], zcat[5];
};

__device__ __forceinline__ Gath2 gather2(const Args& p, int j, int cf, int cc, int hh) {
  Gath2 v;
  const size_t row = (size_t)j * 9 * p.h + cf * p.h + hh;
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    v.cat[c] = c < cc ? ldb(p.cat + row + c * p.h) : 0.0f;
    v.zcat[c] = c < cc ? ldb(p.zcat + row + c * p.h) : 0.0f;
  }
  return v;
}

// The second order: g_ea (N, K, RBF) bf16, g_cutm (N, K) f32, g_ct (N, 9H)
// f32, the tangent of w per edge wdot (N*K, 3H) f32 (tn_src_sum_kernel turns
// it into g_cat), and with `save` (per-edge rows [ea | z_ea | t1 | t1' |
// p1_bar | p1'_bar | t2 | t2' | p2_bar | p2'_bar | p3_bar | p3'_bar], bf16,
// row stride 2 rbfp + 18H; x' is the tangent of x, x_bar its cotangent) the
// operands of the weight gradients.  A block owns a contiguous range of
// receiver rows and walks their edges in tiles of BWD2_TILE.
template <int ACT>
__global__ void __launch_bounds__(BWD2_THREADS, 1)
    tn_bwd2_kernel(Args p, bf16* __restrict__ gea, float* __restrict__ gcutm, float* __restrict__ gct,
                   float* __restrict__ wdot, bf16* __restrict__ save) {
  extern __shared__ __align__(128) unsigned char smem[];
  // the activation: a compile-time constant where the instantiation names it
  const int act = ACT >= 0 ? ACT : p.act;
  constexpr int M = BWD2_TILE;
  const int H = p.h, F9 = 9 * H, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const B2Layout L = bwd2_layout(H, p.rbfp);
  bf16 *w1_s = TILE(w1), *zw1_s = TILE(zw1), *ea_buf = TILE(ea), *zea_buf = TILE(zea);
  float* b_s = reinterpret_cast<float*>(smem + L.bias);  // b1 | b2 | b3 | z_b1 | z_b2 | z_b3
  int* idx_buf = reinterpret_cast<int*>(smem + L.idx);
  float* cm_buf = reinterpret_cast<float*>(smem + L.cm);
  float* zcm_buf = reinterpret_cast<float*>(smem + L.zcm);
  bf16 *p1 = TILE(p1), *pd1 = TILE(pd1), *p2 = TILE(p2), *pd2 = TILE(pd2), *yr = TILE(y), *xr = TILE(x);
  bf16 *t1 = xr, *td1 = xr + M * sld(H);                    // in x until L3's forward
  bf16 *t2 = yr, *td2 = yr + M * sld(2 * H);                // in y from L2's forward epilogue
  bf16 *p3 = yr, *pd3 = yr + M * sld(3 * H);                // to the reverse of L3
  float* red = reinterpret_cast<float*>(smem + L.red);
  const int lde = sld(p.rbfp), ld1 = sld(H), ld2 = sld(2 * H), ld3 = sld(3 * H);
  const int ld_save = 2 * p.rbfp + 18 * H, o = 2 * p.rbfp;  // the rows' activation columns start at o
  const int nw3 = 3 * H / 32;
  // the products' items: warp w takes rows (w & 1) * 16 and column group w >> 1
  const int row0 = (warp & 1) * 16, cg = warp >> 1;
  const bool item = warp < H / 8;  // H/8 items in every layer but g_ea's

  for (int x = tid; x < p.rbfp * H; x += blockDim.x) {
    w1_s[(x / H) * ld1 + x % H] = p.w1[x];
    zw1_s[(x / H) * ld1 + x % H] = p.zw1[x];
  }
  for (int x = tid; x < 6 * H; x += blockDim.x) {
    b_s[x] = x < H ? ldb(p.b1 + x) : (x < 3 * H ? ldb(p.b2 + x - H) : ldb(p.b3 + x - 3 * H));
    b_s[6 * H + x] = x < H ? ldb(p.zb1 + x) : (x < 3 * H ? ldb(p.zb2 + x - H) : ldb(p.zb3 + x - 3 * H));
  }
  for (int x = tid; x < 2 * M * lde; x += blockDim.x) {
    ea_buf[x] = f2b(0.0f);
    zea_buf[x] = f2b(0.0f);
  }
  __syncthreads();  // the RBF padding is zero before any copy lands

  const int r0 = blockIdx.x * p.rows_per_block, r1 = min(p.n, r0 + p.rows_per_block);
  if (r0 >= r1) return;  // the whole block
  const long e0 = (long)r0 * p.k, e1 = (long)r1 * p.k;
  const int ntiles = (int)((e1 - e0 + M - 1) / M);
  // start copying tile t (ea and z_ea rows, ids, cutm and z_cutm) into staging buffer t & 1
  auto stage = [&](int t) {
    const long t0 = e0 + (long)t * M;
    const int mv = (int)min((long)M, e1 - t0);
    bf16* ea_s = ea_buf + (t & 1) * M * lde;
    bf16* zea_s = zea_buf + (t & 1) * M * lde;
    if (p.rbf % 2 == 0) {
      const int words = p.rbf / 2, per_w = mv * words;
      for (int x = tid; x < 2 * per_w; x += blockDim.x) {
        const int z = x >= per_w, y = x - z * per_w;
        const int r = y / words, w = y % words;
        __pipeline_memcpy_async((z ? zea_s : ea_s) + r * lde + 2 * w,
                                (z ? p.zea : p.ea) + (size_t)(t0 + r) * p.rbf + 2 * w, 4);
      }
    } else {  // rows not 4-byte aligned: plain copies
      for (int x = tid; x < mv * p.rbf; x += blockDim.x) {
        const int r = x / p.rbf, c = x % p.rbf;
        ea_s[r * lde + c] = p.ea[(size_t)(t0 + r) * p.rbf + c];
        zea_s[r * lde + c] = p.zea[(size_t)(t0 + r) * p.rbf + c];
      }
    }
    for (int r = tid; r < mv; r += blockDim.x) {
      __pipeline_memcpy_async(idx_buf + (t & 1) * M + r, p.idx + t0 + r, 4);
      __pipeline_memcpy_async(cm_buf + (t & 1) * M + r, p.cutm + t0 + r, 4);
      __pipeline_memcpy_async(zcm_buf + (t & 1) * M + r, p.zcutm + t0 + r, 4);
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
    const long t0 = e0 + (long)t * M;
    const int mv = (int)min((long)M, e1 - t0);
    const bf16* ea_s = ea_buf + (t & 1) * M * lde;
    const bf16* zea_s = zea_buf + (t & 1) * M * lde;
    const int* idx_s = idx_buf + (t & 1) * M;
    float* cm_s = cm_buf + (t & 1) * M;
    float* zcm_s = zcm_buf + (t & 1) * M;
    __pipeline_wait_prior(0);
    __syncthreads();  // tile t has landed; the last tile is done with every tile buffer
    if (t + 1 < ntiles) stage(t + 1);
    for (int r = tid; r < mv; r += blockDim.x) {
      cm_s[r] = bfr(cm_s[r]);
      zcm_s[r] = bfr(zcm_s[r]);
    }
    if (save) {
      save_tile(ea_s, p.rbfp, mv, save, ld_save, t0, 0);
      save_tile(zea_s, p.rbfp, mv, save, ld_save, t0, p.rbfp);
    }

    // the dual forward.  L1 (W1 and Z_W1 resident): p1, p1', t1, t1' (t1 | t1' in x)
    if (item) {
      float c0[2][4] = {}, c1[2][4] = {};
      dual_steps<1, true, DUAL_FWD>(c0, c1, ea_s, zea_s, lde, w1_s, zw1_s, ld1, p.rbfp / 16, row0, cg * 16, lane);
      dual_epilogue<1>(c0, c1, row0, cg * 16, lane, [&](int r, int c, float v0, float v1, float u0, float u1) {
        const int at = r * ld1 + c;
        dual_fwd_epi(act, v0, v1, u0, u1, b_s + c, b_s + 6 * H + c, p1 + at, pd1 + at, t1 + at, td1 + at);
      });
    }
    __syncthreads();
    if (save) {
      save_tile(t1, H, mv, save, ld_save, t0, o);
      save_tile(td1, H, mv, save, ld_save, t0, o + H);
    }
    // L2 (W2 and Z_W2 through the ring in y; the epilogue after the ring is
    // done): p2, p2', t2, t2' (in y)
    {
      float c0[4][4] = {}, c1[4][4] = {};
      ring_dual<2, true, DUAL_FWD>(c0, c1, item, t1, td1, ld1, p.w2, p.zw2, H, 2 * H, yr, row0, cg * 32, lane);
      if (item)
        dual_epilogue<2>(c0, c1, row0, cg * 32, lane, [&](int r, int c, float v0, float v1, float u0, float u1) {
          const int at = r * ld2 + c;
          dual_fwd_epi(act, v0, v1, u0, u1, b_s + H + c, b_s + 7 * H + c, p2 + at, pd2 + at, t2 + at, td2 + at);
        });
    }
    __syncthreads();  // t2 and t2' are complete; x is free (t1 | t1' saved before L2)
    if (save) {  // before L3's epilogue overwrites them
      save_tile(t2, 2 * H, mv, save, ld_save, t0, o + 4 * H);
      save_tile(td2, 2 * H, mv, save, ld_save, t0, o + 6 * H);
    }
    // L3 (W3 and Z_W3 through the ring in x): p3 = bf16(bf16(t2 . W3) + b3)
    // and p3', in y once the ring is done with t2 and t2'
    {
      float c0[6][4] = {}, c1[6][4] = {};
      ring_dual<3, true, DUAL_FWD>(c0, c1, item, t2, td2, ld2, p.w3, p.zw3, 2 * H, 3 * H, xr, row0, cg * 48, lane);
      if (item)
        dual_epilogue<3>(c0, c1, row0, cg * 48, lane, [&](int r, int c, float v0, float v1, float u0, float u1) {
          bfr2(v0, v1);
          bfr2(u0, u1);
          v0 += b_s[3 * H + c];
          v1 += b_s[3 * H + c + 1];
          u0 += b_s[9 * H + c];
          u1 += b_s[9 * H + c + 1];
          bfr2(v0, v1);
          bfr2(u0, u1);
          *reinterpret_cast<unsigned*>(p3 + r * ld3 + c) = pack_exact(v0, v1);
          *reinterpret_cast<unsigned*>(pd3 + r * ld3 + c) = pack_exact(u0, u1);
        });
    }
    __syncthreads();  // p3 and p3' are complete

    // per edge: g_ct (the tangent of the messages, each row's sums in slot
    // order), the cotangents of w and of its tangent, g_cutm's terms (four
    // edges' warp sums at once) and the cotangents of p3 and p3' in their
    // place; the next edge's gathered values in flight
    if (edge_thread) {
      Gath2 g = gather2(p, idx_s[0], cf, cc, hh);
      for (int eb = 0; eb < mv; eb += 4) {
        float term[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = eb + u;
          term[u] = 0.0f;
          if (e >= mv) continue;  // the same for the whole warp
          Gath2 nxt = g;
          if (e + 1 < mv) nxt = gather2(p, idx_s[e + 1], cf, cc, hh);
          if (slot == p.k) {  // the next receiver row
#pragma unroll
            for (int c = 0; c < 5; ++c) {
              if (c < cc) gct[(size_t)cur * F9 + (cf + c) * H + hh] = acc[c];
              acc[c] = 0.0f;
            }
            ++cur;
            slot = 0;
            load_cti();
          }
          ++slot;
          const float pre = ldb(p3 + e * ld3 + tid), pred = ldb(pd3 + e * ld3 + tid);
          float f, f1, f2;
          act3(act, pre, &f, &f1, &f2);
          float t3 = f, td3 = f1 * pred;
          bfr2(t3, td3);
          const float cmb = cm_s[e], zcmb = zcm_s[e];
          float w = t3 * cmb, wd = td3 * cmb + t3 * zcmb;
          bfr2(w, wd);
          float wbar = 0.0f, wdbar = 0.0f;
#pragma unroll
          for (int c = 0; c < 5; ++c) {
            if (c < cc) {
              float x = g.zcat[c] * w, y = g.cat[c] * wd;
              bfr2(x, y);
              acc[c] += x + y;
              wbar += cti[c] * g.zcat[c];
              wdbar += cti[c] * g.cat[c];
            }
          }
          wdot[(size_t)(t0 + e) * 3 * H + tid] = wd;
          const float t3bar = wbar * cmb + wdbar * zcmb;
          const float td3bar = wdbar * cmb;
          term[u] = wbar * t3 + wdbar * td3;
          float pb = t3bar * f1 + td3bar * f2 * pred, pdb = td3bar * f1;
          bfr2(pb, pdb);
          p3[e * ld3 + tid] = bf16_exact(pb);
          pd3[e * ld3 + tid] = bf16_exact(pdb);
          g = nxt;
        }
        const float r = warp_sum4(term[0], term[1], term[2], term[3], lane);
        if ((lane & 7) == 0 && eb + (lane >> 3) < mv) red[(eb + (lane >> 3)) * nw3 + warp] = r;
      }
    }
    __syncthreads();  // p3_bar, p3'_bar and the warp partials are complete
    if (tid < mv) {
      float sm = 0.0f;
      for (int w = 0; w < nw3; ++w) sm += red[tid * nw3 + w];
      gcutm[t0 + tid] = sm;
    }
    if (save) {
      save_tile(p3, 3 * H, mv, save, ld_save, t0, o + 12 * H);
      save_tile(pd3, 3 * H, mv, save, ld_save, t0, o + 15 * H);
    }

    // the reverse.  L3 (W3^T and Z_W3^T through the ring in x): p2_bar and
    // p2'_bar in place of p2 and p2'
    {
      float c0[4][4] = {}, c1[4][4] = {};
      ring_dual<2, false, DUAL_REV>(c0, c1, item, p3, pd3, ld3, p.w3, p.zw3, 3 * H, 2 * H, xr, row0, cg * 32,
                                    lane);
      if (item)
        dual_epilogue<2>(c0, c1, row0, cg * 32, lane, [&](int r, int c, float v0, float v1, float u0, float u1) {
          dual_rev_epi(act, v0, v1, u0, u1, p2 + r * ld2 + c, pd2 + r * ld2 + c);
        });
    }
    __syncthreads();
    if (save) {
      save_tile(p2, 2 * H, mv, save, ld_save, t0, o + 8 * H);
      save_tile(pd2, 2 * H, mv, save, ld_save, t0, o + 10 * H);
    }
    // L2 (W2^T and Z_W2^T through the ring in x): p1_bar and p1'_bar in place of p1 and p1'
    {
      float c0[2][4] = {}, c1[2][4] = {};
      ring_dual<1, false, DUAL_REV>(c0, c1, item, p2, pd2, ld2, p.w2, p.zw2, 2 * H, H, xr, row0, cg * 16, lane);
      if (item)
        dual_epilogue<1>(c0, c1, row0, cg * 16, lane, [&](int r, int c, float v0, float v1, float u0, float u1) {
          dual_rev_epi(act, v0, v1, u0, u1, p1 + r * ld1 + c, pd1 + r * ld1 + c);
        });
    }
    __syncthreads();
    if (save) {
      save_tile(p1, H, mv, save, ld_save, t0, o + 2 * H);
      save_tile(pd1, H, mv, save, ld_save, t0, o + 3 * H);
    }
    // L1 (W1^T and Z_W1^T resident): g_ea = p1_bar . W1^T + p1'_bar . Z_W1^T,
    // RBFP/8 items of 16 rows by 16 columns
    if (warp < p.rbfp / 8) {
      float c0[2][4] = {}, c1[2][4] = {};
      dual_steps<1, false, DUAL_REV0>(c0, c1, p1, pd1, ld1, w1_s, zw1_s, ld1, H / 16, row0, cg * 16, lane);
      dual_epilogue<1>(c0, c1, row0, cg * 16, lane, [&](int r, int c, float v0, float v1, float, float) {
        if (r >= mv) return;
        bf16* out = gea + (size_t)(t0 + r) * p.rbf + c;
        if (c < p.rbf) out[0] = f2b(v0);
        if (c + 1 < p.rbf) out[1] = f2b(v1);
      });
    }
  }
  if (edge_thread) {
#pragma unroll
    for (int c = 0; c < 5; ++c)
      if (c < cc) gct[(size_t)cur * F9 + (cf + c) * H + hh] = acc[c];
  }
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

// The grid of the forward (kind 0), the backward (1) and the second order
// (2): one block an SM (their shared memory), each block a contiguous range
// of rows.  A shape whose tiles do not fit in a block's shared memory (the
// second order past RBF = 80 at H = 128) is refused.
cudaError_t plan_tiles(int kind, Args* p, size_t* smem, int* blocks) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  *smem = kind == 2 ? bwd2_layout(p->h, p->rbfp).total : edge_layout(p->h, p->rbfp, kind == 0).total;
  if (*smem > (size_t)smem_max) return cudaErrorInvalidValue;
  p->rows_per_block = (p->n + sms - 1) / sms;
  *blocks = (p->n + p->rows_per_block - 1) / p->rows_per_block;
  return cudaSuccess;
}

// the forward (kind 0), the backward (1) or the second order (2), compiled
// for silu (the configurations' choice), with the activation folded into
// its arithmetic, and for any activation read at run time
const void* edge_kernel(int kind, int act) {
  const bool silu = act == ACT_SILU;
  if (kind == 0)
    return silu ? reinterpret_cast<const void*>(tn_fwd_kernel<ACT_SILU>)
                : reinterpret_cast<const void*>(tn_fwd_kernel<-1>);
  if (kind == 1)
    return silu ? reinterpret_cast<const void*>(tn_bwd_kernel<ACT_SILU>)
                : reinterpret_cast<const void*>(tn_bwd_kernel<-1>);
  return silu ? reinterpret_cast<const void*>(tn_bwd2_kernel<ACT_SILU>)
              : reinterpret_cast<const void*>(tn_bwd2_kernel<-1>);
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
  cudaError_t err = plan_tiles(0, &p, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(edge_kernel(0, act), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o_m = static_cast<float*>(m_out);
  if (act == ACT_SILU)
    tn_fwd_kernel<ACT_SILU><<<blocks, FWD_THREADS, smem, st>>>(p, o_m);
  else
    tn_fwd_kernel<-1><<<blocks, FWD_THREADS, smem, st>>>(p, o_m);
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
  cudaError_t err = plan_tiles(1, &p, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(edge_kernel(1, act), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16 *o_dcat = static_cast<bf16*>(dcat), *o_dea = static_cast<bf16*>(dea), *o_save = static_cast<bf16*>(save);
  float* o_dcutm = static_cast<float*>(dcutm);
  if (act == ACT_SILU)
    tn_bwd_kernel<ACT_SILU><<<blocks, EDGE_THREADS, smem, st>>>(p, o_dcat, o_dea, o_dcutm, o_save);
  else
    tn_bwd_kernel<-1><<<blocks, EDGE_THREADS, smem, st>>>(p, o_dcat, o_dea, o_dcutm, o_save);
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
  cudaError_t err = plan_tiles(2, &p, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(edge_kernel(2, act), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16 *o_gea = static_cast<bf16*>(gea), *o_save = static_cast<bf16*>(save);
  float *o_gcutm = static_cast<float*>(gcutm), *o_gct = static_cast<float*>(gct), *o_wdot = static_cast<float*>(wdot);
  if (act == ACT_SILU)
    tn_bwd2_kernel<ACT_SILU><<<blocks, BWD2_THREADS, smem, st>>>(p, o_gea, o_gcutm, o_gct, o_wdot, o_save);
  else
    tn_bwd2_kernel<-1><<<blocks, BWD2_THREADS, smem, st>>>(p, o_gea, o_gcutm, o_gct, o_wdot, o_save);
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

// The resources of the forward (kind 0), the backward (1) or the second
// order (2), as compiled for silu, at a shape: out = registers a thread,
// local (spill) bytes a thread, threads a block, dynamic shared memory a
// block, resident blocks an SM.
int tn_resources(int kind, int n, int k, int h, int rbf, int* out) {
  if (!valid_shape(n, k, h, rbf) || kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  Args p = make_args(nullptr, n, k, h, rbf, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     nullptr, nullptr, ACT_SILU);
  size_t smem = 0;
  int blocks = 0;
  const void* fn = edge_kernel(kind, ACT_SILU);
  const int threads = kind == 0 ? FWD_THREADS : (kind == 1 ? EDGE_THREADS : BWD2_THREADS);
  cudaError_t err = plan_tiles(kind, &p, &smem, &blocks);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  int per_sm = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = threads;
  out[3] = (int)smem;
  out[4] = per_sm;
  return 0;
}

}  // extern "C"
