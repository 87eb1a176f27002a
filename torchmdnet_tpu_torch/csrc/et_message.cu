// Fused ET attention edge phase for Hopper (sm_90a): forward, backward and
// second order.
//
// Replaces the Pallas TPU kernels of torchmdnet_tpu/ops/pallas/et_message.py:
//   et_fwd_kernel  <- _fwd_kernel (:227, launched by _run_fwd at :509)
//   et_bwd_kernel + et_bwd_src_kernel <- _bwd_kernel (:296, launched by
//                    _run_bwd at :563) and _inverse_scatter (:603), the sum
//                    of the per-edge source-row cotangents onto the atoms
//   et_bwd2_kernel + et_bwd2_src_kernel <- _bwd2_kernel (:685, launched by
//                    _run_bwd2 at :895) with its inverse scatter
//   et_dw_kernel   <- the weight-gradient accumulators of _bwd_kernel and
//                    _bwd2_kernel (dw_acc/db_acc), as a reduction over edges
//                    (the Transformer's backward and second order use it too)
// The device helpers they share with t_message.cu are in common.cuh.
//
// What one layer computes, per receiver atom i and neighbor slot k (j = idx[i, k]):
//   dk = act(ea[i,k] . Wdk + bdk)            (H)   distance filters, RBF -> H
//   dv = act(ea[i,k] . Wdv + bdv)            (3H)  and RBF -> 3H
//   attn = attn_act(per-head sum of q_i * k_j * dk) * cutm[i,k]
//   x_agg[i]   = sum_k v_j[0:H] * dv[0:H] * attn
//   vec_agg[i] = sum_k vec_j * (v_j * dv)[H:2H] * msk + (v_j * dv)[2H:3H] * dir[i,k]
// with the JAX kernel's precision: bf16 operands, every elementwise product
// rounded to bf16, the filter pre-activation rounded to bf16 before the f32
// activation, f32 accumulation of every sum, f32 outputs.
//
// What bounds it on an H100 at the DHFR shapes (N = 2496, K = 81, H = 128,
// 8 heads, RBF = 50): the bytes it must move are small (~35 MB forward: ea
// is 20 MB, the source rows 5 MB, the per-edge scalars 4 MB), 10 us at
// 3.35 TB/s.  The operations are the two filter products, 2 * RBF * 4H
// flops per edge = 10.4 GFLOP per forward (10 us on the bf16 tensor cores),
// and ~46 H flops of elementwise work per edge (1.2 GFLOP, 18 us on the f32
// CUDA cores).  So the kernel is bound by operations, and in practice by the
// latency of its row gathers and the per-edge elementwise chain.
//
// The forward's design:
//   * no (N, K, F) tensor in device memory: a group of H threads owns one
//     receiver row, one channel per thread, gathers the source rows k/v/vec
//     directly by index (no block plan, no one-hot product: those were TPU
//     layout workarounds) and keeps its f32 accumulators in registers; each
//     thread loads the next edge's source values before it computes the
//     current edge, so gathers overlap work;
//   * the filter products run on the tensor cores (wmma bf16 16x16x16, f32
//     accumulation) for KC = 16 edges at a time, against the filter weights
//     (4H x RBF bf16, 72 KB at DHFR) loaded into shared memory once per
//     block and shared by the block's row groups (4 at H = 128); the next
//     chunk's ea rows, neighbor ids and edge scalars are copied into a
//     second buffer asynchronously while the current chunk computes;
//   * the per-head sum is a butterfly over the head's lanes of one warp
//     (H/heads must be a power of two <= 32), no ones-block product.
//
// The backward (#2) and the second order (#3).  Both recompute each edge
// from the same inputs, as the TPU kernels do.  What bounded their first
// port on this card (2-4 % of their bounds) and what this design does about
// each:
//   * a per-edge source-row cotangent buffer, (N, K, 7H) bf16 (f32 for the
//     second order), written and read back by a transpose-sum: 362 MB at
//     DHFR, 6.1 GB on the STMV skin list, 2.8x the kernel's whole bound in
//     bytes.  Now two passes in gather form.  The receiver pass (the row
//     owner, as before) writes only what the source side needs per edge
//     and head: the head-summed d_prod and attn (bf16; the second order:
//     attn, its tangent and the two head-summed reverse seeds, f32).  The
//     source pass then owns atom j and walks the K slots of the transpose
//     permutation (perm[j*K + s] = the edge (i, k') with idx[i, k'] = j, in
//     ascending i), gathers that edge's ea row and the receiver's rows (q,
//     ct), recomputes the edge's filters on the tensor cores exactly as the
//     receiver pass does, and sums the 7H per-edge values in f32 in slot
//     order, rounded once.  The per-edge values and the order of the sum
//     are those of the buffer's transpose-sum, so the backward's outputs
//     are bitwise those of the buffer form (checked on the card against the
//     first port at the DHFR, training and STMV shapes; only the weight
//     cotangents, summed in another order, differ); the second order's are
//     equal up to the compiler's fused multiply-adds in its f32 formulas.
//     Padding and self slots add exact zeros, as in the buffer form;
//   * a weight-gradient partial read, updated and written back through L2
//     on every chunk (256 KB at H = 256: 3.5 GB of L2 traffic a launch at
//     the training shapes).  Now the receiver pass writes each edge's
//     filter cotangents d_pre (4H bf16: the values the old partial summed,
//     already bf16) when the weights want a gradient, and et_dw_kernel
//     reduces ea^T . d_pre over the edges on the tensor cores: blocks of
//     128 columns, a fixed split of the edges (a block's range walked in
//     tiles of 64 edges staged by cp.async into a ring of two), f32
//     accumulators in registers for the whole range, each split's partial
//     written once and summed by the caller in a fixed order.  Keeping the
//     partial on chip in the edge kernels does not fit at H = 256: the
//     (RBFP, 4H) f32 partial is 256 KB, more than a block's shared memory,
//     and 128 registers a thread at 512 threads;
//   * few warps in flight behind block-wide barriers: every chunk cost
//     three __syncthreads across all of a block's row groups, so the groups
//     ran in lockstep.  Now each group synchronises only its own H threads
//     (a named barrier per group, bar.sync g+1), so groups drift apart and
//     one group's tensor-core phase overlaps another's per-edge work; the
//     tensor-core epilogue goes from the mma.sync fragments straight to the
//     bf16 filter tile (no f32 scratch tile), and the backward's passes fit
//     96 registers, so 20 warps an SM at H = 128 (16 before) and 16 at
//     H = 256 (8 before: the scratch tiles no longer crowd out a second row
//     group next to the 147 KB of weights); the second order's receiver
//     pass runs two 256-thread blocks an SM (16 warps, 8 before);
//   * chunks padded per row (K = 33 took 48 chunk rows): a group now owns
//     a contiguous range of rows (or atoms) and cuts its flattened edges
//     (slots) into chunks of 16 that run across rows; the per-row sums (dq,
//     and the source pass's per-atom sums) stay sequential in one thread,
//     so nothing needs a float atomic and every result is bitwise the same
//     from run to run;
//   * what then bounds the passes is the issue rate of the per-edge chain
//     (about 300 instructions a slot in the source pass; the per-edge loops
//     take two thirds of #2's time, the tensor-core phases a seventh).  So
//     the chain rounds to bf16 with the packed conversion (cvt.rn.bf16x2,
//     F2FP, two values where two are ready; the scalar F2F issues at a
//     lower rate), stores already-rounded values by their upper half,
//     rounds each chunk's edge scalars once for the group in shared memory,
//     sums four per-edge scalars over a warp at once (warp_sum4: 6 shuffles
//     for 20) and the second order's head sums two at once (group_sum2),
//     both with the butterfly's pairs, so the same bits, and the passes
//     are compiled for silu in both activations (the configurations'
//     choice) with the activations folded into the chain, beside a build
//     that reads them at run time.  L1 prefetches of the next edges' rows
//     did not help (measured), so the gathers wait little; nor did two
//     channels a thread with packed bf16 arithmetic in the source pass (the
//     filter tiles in shared memory then cap a block at 12 warps);
//   * the products use mma.sync m16n8k16 (bf16, f32 accumulation) with
//     ldmatrix loads from shared memory: the filter weights (the backward)
//     are staged there once per block; the second order reads W and Z_W
//     (147 KB each at H = 256, not both in shared memory next to the chunk
//     state) through L1/L2.  The products are a small share of the work
//     (10 GFLOP a pass at DHFR, 10 us on the tensor cores), so the
//     warpgroup instructions (wgmma, 64-row tiles) would not move the
//     bound; the per-edge chain does.  The next chunk's ea rows, ids and
//     edge scalars are staged with cp.async while the current chunk
//     computes (ea rows are 100 bytes at RBF = 50, not the 16-byte
//     multiples that TMA and bulk copies take).
//
// The second order (force-loss training's outer pass) is the VJP of the
// backward with respect to (inputs, ct), given cotangents Z on the
// backward's outputs.  It uses the identity of the JAX kernel's docstring:
// S = <vjp_f(a)(ct), Z> = <ct, J_f(a) . Z>, so g_ct = J_f(a).Z is a
// forward-mode pass (each per-edge value carries a tangent, the Z on the
// source rows gathered by idx) and g_inputs is the reverse pass of that
// dual-number forward, seeded with ct on the tangent outputs.  The formulas
// are written out per edge (second derivatives of the four activations
// included); the three filter products of the dual forward (ea.W, z_ea.W +
// ea.Z_W), the two of g ea and the two of the weight gradient run on the
// tensor cores.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int FWD_MAX_THREADS = 512;
// Threads a block (one block an SM unless noted), from ptxas's register
// counts: the backward's receiver and source passes fit 96 registers a
// thread, so 640 threads (20 warps; 5 row groups at H = 128, 2 at H = 256,
// where shared memory takes 2).  The second order's receiver pass holds
// about twice the backward's per-edge state: blocks of at most 256 threads
// at 128 registers, two blocks an SM (W and Z_W stay in device memory, so
// the shared memory allows it); its source pass 512 at 128.
constexpr int RECV_MAX_THREADS = 640;
constexpr int SRC_MAX_THREADS = 640;
constexpr int RECV2_MAX_THREADS = 256;
constexpr int SRC2_MAX_THREADS = 512;

// The forward's shared memory: the filter weights, then one slice per row
// group.
struct Smem {
  size_t groups_base, group_stride, total;
  size_t ea, pre, scratch, idx, sc;
};

// row stride (bf16 elements) of the per-edge filter tile: 4H + 8, so the
// rows of a wmma load start on different banks
__host__ __device__ inline int pre_ld(int h) { return 4 * h + 8; }

__host__ __device__ inline Smem smem_layout(int h, int rbf, int groups) {
  Smem s;
  s.groups_base = align32((size_t)4 * h * w_ld(rbf) * sizeof(bf16));
  size_t o = 0;
  s.ea = o;  // two (KC, ldw) buffers: one is filled while the other is used
  o = align32(o + (size_t)2 * KC * w_ld(rbf) * sizeof(bf16));
  // (KC, 4H) bf16 filter accumulators (the kernel only ever uses them
  // rounded to bf16)
  s.pre = o;
  o = align32(o + (size_t)KC * pre_ld(h) * sizeof(bf16));
  s.scratch = o;  // one 16x16 f32 tile per warp: the wmma epilogue
  o = align32(o + (size_t)(h / 32) * 256 * sizeof(float));
  s.idx = o;  // two buffers of KC neighbor ids
  o = align32(o + 2 * KC * sizeof(int));
  s.sc = o;  // two (5, KC) f32 buffers of edge scalars
  o = align32(o + (size_t)2 * 5 * KC * sizeof(float));
  s.group_stride = o;
  s.total = s.groups_base + (size_t)groups * o;
  return s;
}

struct Params {
  const int32_t* idx;
  int n, k, h, hd, rbf;
  const bf16 *q, *kx, *v, *vec0, *vec1, *vec2, *ea;
  const float *cutm, *msk, *dir0, *dir1, *dir2;
  const bf16 *wk, *bk, *wv, *bv;  // wk (H, RBF), wv (3H, RBF); null: no filter
  int act, attn_act;
  // second order only: the Z cotangents (tangents of the dual forward)
  const bf16 *zq, *zk, *zv, *zvec0, *zvec1, *zvec2, *zea;
  const float *zcutm, *zdir0, *zdir1, *zdir2;
  const bf16 *w_all, *zw_all;  // (4H, RBFP) bf16, zero rows for absent filters
  const bf16 *zbk, *zbv;
  // row groups per block; the forward's rows per group and grid step, the
  // other passes' contiguous rows (atoms) per group
  int groups, iters;
};

// Filter weights into shared memory as (4H, ldw) bf16, one row per filter
// column: rows [0, H) dk, [H, 4H) dv.  Absent filters and the RBF padding
// are zeros.
__device__ void load_weights(const Params& p, bf16* w_s) {
  const int ldw = w_ld(p.rbf);
  const int total = 4 * p.h * ldw;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int f = e / ldw, r = e % ldw;
    bf16 w = __float2bfloat16_rn(0.0f);
    if (r < p.rbf) {
      if (f < p.h) {
        if (p.wk) w = p.wk[(size_t)f * p.rbf + r];
      } else if (p.wv) {
        w = p.wv[(size_t)(f - p.h) * p.rbf + r];
      }
    }
    w_s[e] = w;
  }
}

// Start copying chunk c0 of row i into one staging buffer (asynchronous:
// it lands while the current chunk computes): ea rows as 4-byte words (RBF
// is even), neighbor ids, edge scalars.  The RBF padding columns are zeroed
// once per block and never written; rows past the chunk's end keep stale
// values, which only reach filter rows nobody reads.
__device__ void stage_async(const Params& p, int i, int c0, int hh, bf16* ea_s, int* idx_s,
                            float* sc_s) {
  const int ldw = w_ld(p.rbf), words = p.rbf / 2, nw = p.h / 32;
  const int kn = min(KC, p.k - c0);
  const int warp = hh / 32, lane = hh % 32;
  const size_t off = ((size_t)i * p.k + c0) * p.rbf;
  for (int kc = warp; kc < kn; kc += nw)
    for (int w = lane; w < words; w += 32)
      __pipeline_memcpy_async(ea_s + kc * ldw + 2 * w, p.ea + off + (size_t)kc * p.rbf + 2 * w, 4);
  if (hh < kn) {
    const size_t e = (size_t)i * p.k + c0 + hh;
    __pipeline_memcpy_async(idx_s + hh, p.idx + e, 4);
    const float* scalars[5] = {p.cutm, p.msk, p.dir0, p.dir1, p.dir2};
    for (int c = 0; c < 5; ++c) __pipeline_memcpy_async(sc_s + c * KC + hh, scalars[c] + e, 4);
  }
  __pipeline_commit();
}

// The chunk a group works on after (i, c0): the next chunk of the row, else
// the first chunk of its next row (rows step by the block's group count).
__device__ __forceinline__ void next_chunk(const Params& p, int t, int i, int c0, int* i2, int* c2) {
  if (c0 + KC < p.k) {
    *i2 = i;
    *c2 = c0 + KC;
  } else {
    *i2 = t + 1 < p.iters ? i + p.groups : p.n;  // p.n: no more rows
    *c2 = 0;
  }
}

// pre_s (KC, 4H) = bf16(ea_s (KC, RBFP) . W^T) on the tensor cores; the
// group's H/32 warps split the 4H/16 column tiles.
__device__ void filter_mma(const Params& p, const bf16* w_s, const bf16* ea_s, bf16* pre_s,
                           float* scratch, int warp, int lane) {
  const int ldw = w_ld(p.rbf), rbfp = rbf_pad(p.rbf), ldp = pre_ld(p.h);
  const int tiles = 4 * p.h / 16, nw = p.h / 32;
  // 4 independent accumulators per warp (it owns 8 tiles in all)
  for (int t0 = warp; t0 < tiles; t0 += 4 * nw) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) wmma::fill_fragment(c[q], 0.0f);
    for (int k0 = 0; k0 < rbfp; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, ea_s + k0, ldw);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = t0 + q * nw;
        if (t < tiles) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(b, w_s + (size_t)t * 16 * ldw + k0, ldw);
          wmma::mma_sync(c[q], a, b, c[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int t = t0 + q * nw;
      if (t >= tiles) continue;
      wmma::store_matrix_sync(scratch, c[q], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)
        pre_s[(e / 16) * ldp + t * 16 + e % 16] = __float2bfloat16_rn(scratch[e]);
      __syncwarp();
    }
  }
}

// filter value act(bf16(acc + b)) from the bf16-rounded accumulator acc;
// its bf16 pre-activation in *pre
__device__ __forceinline__ float filter_val(int act, bf16 acc, float b, float* pre) {
  *pre = bfr(__bfloat162float(acc) + b);
  return bfr(act_fn(act, *pre));
}

// the source-row values one thread reads for one edge
struct Src {
  float k, v[3], vec[3];
};

__device__ __forceinline__ Src load_src(const Params& p, int j, int hh) {
  Src s;
  const size_t row = (size_t)j * p.h + hh;
  s.k = ldb(p.kx + row);
  const size_t vrow = (size_t)j * 3 * p.h + hh;
  s.v[0] = ldb(p.v + vrow);
  s.v[1] = ldb(p.v + vrow + p.h);
  s.v[2] = ldb(p.v + vrow + 2 * p.h);
  s.vec[0] = ldb(p.vec0 + row);
  s.vec[1] = ldb(p.vec1 + row);
  s.vec[2] = ldb(p.vec2 + row);
  return s;
}

__global__ void __launch_bounds__(FWD_MAX_THREADS, 1)
    et_fwd_kernel(Params p, float* __restrict__ x_out, float* __restrict__ vec_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = p.h;
  const int g = threadIdx.x / H, hh = threadIdx.x % H, warp = hh / 32, lane = hh % 32;
  const int ldp = pre_ld(H);
  const Smem L = smem_layout(H, p.rbf, p.groups);
  bf16* w_s = reinterpret_cast<bf16*>(smem);
  unsigned char* gs = smem + L.groups_base + g * L.group_stride;
  bf16* ea_buf = reinterpret_cast<bf16*>(gs + L.ea);
  bf16* pre_s = reinterpret_cast<bf16*>(gs + L.pre);
  float* scratch = reinterpret_cast<float*>(gs + L.scratch) + warp * 256;
  int* idx_buf = reinterpret_cast<int*>(gs + L.idx);
  float* sc_buf = reinterpret_cast<float*>(gs + L.sc);
  const int ldw = w_ld(p.rbf);
  const bool has_dk = p.wk != nullptr, has_dv = p.wv != nullptr;

  for (int e = hh; e < 2 * KC * ldw; e += H) ea_buf[e] = __float2bfloat16_rn(0.0f);
  load_weights(p, w_s);
  const float bk = has_dk ? ldb(p.bk + hh) : 0.0f;
  float bv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) bv[c] = has_dv ? ldb(p.bv + c * H + hh) : 0.0f;
  __syncthreads();  // zero padding in place before any copy lands
  const int first = blockIdx.x * p.iters * p.groups + g;
  if (first < p.n) stage_async(p, first, 0, hh, ea_buf, idx_buf, sc_buf);
  int buf = 0;

  for (int t = 0; t < p.iters; ++t) {
    const int i = (blockIdx.x * p.iters + t) * p.groups + g;
    const bool active = i < p.n;  // the same for the whole group (whole warps)
    const float qi = active ? ldb(p.q + (size_t)i * H + hh) : 0.0f;
    float x_acc = 0.0f, v_acc[3] = {0.0f, 0.0f, 0.0f};
    for (int c0 = 0; c0 < p.k; c0 += KC) {
      const int kn = min(KC, p.k - c0);
      const bf16* ea_s = ea_buf + buf * KC * ldw;
      const int* idx_s = idx_buf + buf * KC;
      const float* sc_s = sc_buf + buf * 5 * KC;
      __pipeline_wait_prior(0);
      __syncthreads();  // this chunk has landed; the last one is done with the other buffer
      if (active && (has_dk || has_dv)) filter_mma(p, w_s, ea_s, pre_s, scratch, warp, lane);
      int i2, c2;
      next_chunk(p, t, i, c0, &i2, &c2);
      buf ^= 1;
      if (i2 < p.n) stage_async(p, i2, c2, hh, ea_buf + buf * KC * ldw, idx_buf + buf * KC, sc_buf + buf * 5 * KC);
      __syncthreads();  // the filter tile is complete
      if (!active) continue;
      Src cur = load_src(p, idx_s[0], hh);
      for (int kc = 0; kc < kn; ++kc) {
        Src nxt = cur;
        if (kc + 1 < kn) nxt = load_src(p, idx_s[kc + 1], hh);  // in flight while this edge computes
        const bf16* a = pre_s + kc * ldp + hh;
        float pre, dk = 1.0f, dv[3] = {1.0f, 1.0f, 1.0f};
        if (has_dk) dk = filter_val(p.act, a[0], bk, &pre);
        if (has_dv) {
#pragma unroll
          for (int c = 0; c < 3; ++c) dv[c] = filter_val(p.act, a[(1 + c) * H], bv[c], &pre);
        }
        float vdv[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) vdv[c] = has_dv ? bfr(cur.v[c] * dv[c]) : cur.v[c];
        float prod = bfr(qi * cur.k);
        if (has_dk) prod = bfr(prod * dk);
        const float pre_a = bfr(group_sum(prod, p.hd));
        const float cm = bfr(sc_s[0 * KC + kc]);
        const float attn = bfr(bfr(act_fn(p.attn_act, pre_a)) * cm);
        x_acc += bfr(vdv[0] * attn);
        const float vm1 = bfr(vdv[1] * bfr(sc_s[1 * KC + kc]));
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          // vw2 * dir needs no mask: dir == 0 on self/invalid slots
          v_acc[c] += bfr(bfr(cur.vec[c] * vm1) + bfr(vdv[2] * bfr(sc_s[(2 + c) * KC + kc])));
        }
        cur = nxt;
      }
    }
    if (active) {
      x_out[(size_t)i * H + hh] = x_acc;
#pragma unroll
      for (int c = 0; c < 3; ++c) vec_out[(size_t)i * 3 * H + c * H + hh] = v_acc[c];
    }
  }
}

// the Z (tangent) values of one source row, one channel
struct ZSrc {
  float k, v[3], vec[3];
};

__device__ __forceinline__ ZSrc load_zsrc(const Params& p, int j, int hh) {
  ZSrc s;
  const size_t row = (size_t)j * p.h + hh;
  s.k = ldb(p.zk + row);
  const size_t vrow = (size_t)j * 3 * p.h + hh;
  s.v[0] = ldb(p.zv + vrow);
  s.v[1] = ldb(p.zv + vrow + p.h);
  s.v[2] = ldb(p.zv + vrow + 2 * p.h);
  s.vec[0] = ldb(p.zvec0 + row);
  s.vec[1] = ldb(p.zvec1 + row);
  s.vec[2] = ldb(p.zvec2 + row);
  return s;
}

// ---------------------------------------------------------------------------
// The backward (#2) and second order (#3): receiver passes, source passes and
// the weight-gradient reduction.

enum Pass { RECV = 0, RECV2 = 1, SRC = 2, SRC2 = 3 };

// One pass's shared memory: the filter weights (the backward's passes), then
// one slice per row group: two staging buffers of ea rows (and z_ea), the
// (KC, 4H) bf16 filter tile (and the tangent tile), two buffers of edge ids
// (and the source pass's receiver rows), of edge scalars and of the source
// pass's per-edge head scalars, and the warp partials of the per-edge
// scalar cotangents.
struct GLayout {
  size_t base, stride, total;
  size_t ea, zea, pre, pret, ids, sc, hs, red;
  int nsc, nred, hsw;  // edge scalars staged; scalar partials; 4-byte words a staged hs row
};

__host__ __device__ inline GLayout pass_layout(int h, int heads, int rbf, int groups, int pass) {
  GLayout s;
  const bool dual = pass == RECV2 || pass == SRC2;
  const size_t ea_bytes = (size_t)2 * KC * w_ld(rbf) * sizeof(bf16);
  const size_t tile_bytes = (size_t)KC * pre_ld(h) * sizeof(bf16);
  s.base = dual ? 0 : align32((size_t)4 * h * w_ld(rbf) * sizeof(bf16));
  // RECV: cutm, msk, dir0..2; RECV2: and z_cutm, z_dir0..2; SRC: msk,
  // dir0..2; SRC2: and z_dir0..2
  s.nsc = pass == RECV ? 5 : (pass == RECV2 ? 9 : (pass == SRC ? 4 : 7));
  s.nred = pass == RECV ? 4 : (pass == RECV2 ? 5 : 0);
  s.hsw = pass == SRC ? heads : (pass == SRC2 ? 4 * heads : 0);
  size_t o = 0;
  s.ea = o;
  o = align32(o + ea_bytes);
  s.zea = o;
  if (dual) o = align32(o + ea_bytes);
  s.pre = o;
  o = align32(o + tile_bytes);
  s.pret = o;
  if (dual) o = align32(o + tile_bytes);
  s.ids = o;
  o = align32(o + (size_t)2 * 2 * KC * sizeof(int));
  s.sc = o;
  o = align32(o + (size_t)2 * s.nsc * KC * sizeof(float));
  s.hs = o;
  o = align32(o + (size_t)2 * s.hsw * KC * sizeof(float));
  s.red = o;
  o = align32(o + (size_t)KC * s.nred * (h / 32) * sizeof(float));
  s.stride = o;
  s.total = s.base + (size_t)groups * o;
  return s;
}

// Receiver pass: start copying the kn edges e0.. (contiguous: ea rows,
// neighbor ids, nsc edge scalars) into a staging buffer.  Called by all H
// threads of a group.
__device__ void stage_edges(const Params& p, size_t e0, int kn, int hh, int nw, int nsc,
                            bf16* ea_s, bf16* zea_s, int* ids_s, float* sc_s) {
  const int ldw = w_ld(p.rbf), words = p.rbf / 2;
  const int warp = hh >> 5, lane = hh & 31;
  for (int kc = warp; kc < kn; kc += nw) {
    const size_t off = (e0 + kc) * p.rbf;
    for (int w = lane; w < words; w += 32) {
      __pipeline_memcpy_async(ea_s + kc * ldw + 2 * w, p.ea + off + 2 * w, 4);
      if (zea_s) __pipeline_memcpy_async(zea_s + kc * ldw + 2 * w, p.zea + off + 2 * w, 4);
    }
  }
  if (hh < kn) {
    const size_t e = e0 + hh;
    __pipeline_memcpy_async(ids_s + hh, p.idx + e, 4);
    const float* scalars[9] = {p.cutm, p.msk, p.dir0, p.dir1, p.dir2,
                               p.zcutm, p.zdir0, p.zdir1, p.zdir2};
    for (int c = 0; c < nsc; ++c) __pipeline_memcpy_async(sc_s + c * KC + hh, scalars[c] + e, 4);
  }
  __pipeline_commit();
}

// Source pass: start copying the kn slots whose edges are pv (lane s of
// every warp holds perm of slot s): the edges' ea rows (and z_ea), their
// hsw-word rows of per-edge head scalars, nsc edge scalars; the edge ids
// and receiver rows go to ids_s.  Called by all H threads of a group.
__device__ void stage_slots(const Params& p, int pv, int kn, int hh, int nw, int nsc, int hsw,
                            const float* hs, bf16* ea_s, bf16* zea_s, int* ids_s, float* sc_s,
                            float* hs_s) {
  const int ldw = w_ld(p.rbf), words = p.rbf / 2;
  const int warp = hh >> 5, lane = hh & 31;
  for (int kc = warp; kc < kn; kc += nw) {
    const int e = __shfl_sync(0xffffffffu, pv, kc);
    const size_t off = (size_t)e * p.rbf;
    for (int w = lane; w < words; w += 32) {
      __pipeline_memcpy_async(ea_s + kc * ldw + 2 * w, p.ea + off + 2 * w, 4);
      if (zea_s) __pipeline_memcpy_async(zea_s + kc * ldw + 2 * w, p.zea + off + 2 * w, 4);
    }
    for (int w = lane; w < hsw; w += 32)
      __pipeline_memcpy_async(hs_s + kc * hsw + w, hs + (size_t)e * hsw + w, 4);
  }
  if (warp == 0 && lane < kn) {
    ids_s[lane] = pv;
    ids_s[KC + lane] = pv / p.k;
    const float* scalars[7] = {p.msk, p.dir0, p.dir1, p.dir2, p.zdir0, p.zdir1, p.zdir2};
    for (int c = 0; c < nsc; ++c) __pipeline_memcpy_async(sc_s + c * KC + lane, scalars[c] + pv, 4);
  }
  __pipeline_commit();
}

// The four filters of an edge for this thread's channel, from the tile's
// bf16 accumulators a[0], a[H], a[2H], a[3H]: pre-activations bf16(acc + b)
// and values bf16(act(pre)) (filter_val's arithmetic, rounded two at a
// time).  Absent filters give values the caller ignores.
__device__ __forceinline__ void edge_filters(int act, const bf16* a, int H, float bk, const float bv[3],
                                             float pre[4], float val[4]) {
  pre[0] = ldb(a) + bk;
#pragma unroll
  for (int c = 0; c < 3; ++c) pre[1 + c] = ldb(a + (1 + c) * H) + bv[c];
  bfr2(pre[0], pre[1]);
  bfr2(pre[2], pre[3]);
#pragma unroll
  for (int c = 0; c < 4; ++c) val[c] = act_fn(act, pre[c]);
  bfr2(val[0], val[1]);
  bfr2(val[2], val[3]);
}

// The second order's dual filters of an edge for this thread's channel,
// from the filter tile a and the tangent tile at: f = bf16(act(pre)), its
// first and second derivatives f1, f2 at pre = bf16(acc + b), and the
// tangent pre-activation pt = bf16(acc' + z_b) (rounded two at a time).
// Absent filters give f = 1 and zeros, as the first port's defaults.
__device__ __forceinline__ void dual_filters(int act, const bf16* a, const bf16* at, int H, float bk,
                                             float zbk, const float bv[3], const float zbv[3],
                                             bool has_dk, bool has_dv, float f[4], float f1[4],
                                             float f2[4], float pt[4]) {
  float x[4];
  x[0] = ldb(a) + bk;
  pt[0] = ldb(at) + zbk;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    x[1 + c] = ldb(a + (1 + c) * H) + bv[c];
    pt[1 + c] = ldb(at + (1 + c) * H) + zbv[c];
  }
  bfr2(x[0], x[1]);
  bfr2(x[2], x[3]);
  bfr2(pt[0], pt[1]);
  bfr2(pt[2], pt[3]);
#pragma unroll
  for (int c = 0; c < 4; ++c) act3(act, x[c], &f[c], &f1[c], &f2[c]);
  bfr2(f[0], f[1]);
  bfr2(f[2], f[3]);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c == 0 ? has_dk : has_dv) continue;
    f[c] = 1.0f;
    f1[c] = f2[c] = pt[c] = 0.0f;
  }
}

// the receiver row values one thread reads (the backward), ct rounded to bf16
struct Recv {
  float q, ctx, ctv[3];
};

__device__ __forceinline__ Recv load_recv(const Params& p, const float* ct_x, const float* ct_vec,
                                          int i, int hh) {
  Recv r;
  r.q = ldb(p.q + (size_t)i * p.h + hh);
  r.ctx = ct_x[(size_t)i * p.h + hh];
#pragma unroll
  for (int c = 0; c < 3; ++c) r.ctv[c] = ct_vec[(size_t)i * 3 * p.h + c * p.h + hh];
  bfr2(r.ctx, r.ctv[0]);
  bfr2(r.ctv[1], r.ctv[2]);
  return r;
}

// The backward's receiver pass (#2): per edge the forward recomputed and its
// reverse on the receiver's side: dq, d ea, d cutm, d dir, the filter
// cotangents d_pre (written per edge when dpre is not null, for et_dw_kernel;
// the bias cotangents summed per group into db_part), and per edge and head
// the bf16 d_prod and attn (hs, (E, 2, heads)) that the source pass needs.
template <int ACT, int ATT>
__global__ void __launch_bounds__(RECV_MAX_THREADS, 1)
    et_bwd_kernel(Params p, const float* __restrict__ ct_x, const float* __restrict__ ct_vec,
                  float* __restrict__ dq, bf16* __restrict__ dea, float* __restrict__ dcutm,
                  float* __restrict__ ddir0, float* __restrict__ ddir1, float* __restrict__ ddir2,
                  bf16* __restrict__ hs, bf16* __restrict__ dpre, float* __restrict__ db_part) {
  extern __shared__ __align__(128) unsigned char smem[];
  // the activations: compile-time constants where the instantiation names them
  const int act = ACT >= 0 ? ACT : p.act, attn_act = ATT >= 0 ? ATT : p.attn_act;
  const int H = p.h, F = 4 * H, ldp = pre_ld(H), ldw = w_ld(p.rbf), rbfp = rbf_pad(p.rbf);
  const int g = threadIdx.x / H, hh = threadIdx.x % H;
  const int nw = H / 32, warp = hh / 32, lane = hh % 32;
  const int heads = H / p.hd, head = hh / p.hd;
  const GLayout L = pass_layout(H, heads, p.rbf, p.groups, RECV);
  const bf16* w_s = reinterpret_cast<const bf16*>(smem);
  unsigned char* gs = smem + L.base + g * L.stride;
  bf16* ea_buf = reinterpret_cast<bf16*>(gs + L.ea);
  bf16* pre_s = reinterpret_cast<bf16*>(gs + L.pre);  // the filters, then d_pre in place
  int* ids_buf = reinterpret_cast<int*>(gs + L.ids);
  float* sc_buf = reinterpret_cast<float*>(gs + L.sc);
  float* red_s = reinterpret_cast<float*>(gs + L.red);
  const bool has_dk = p.wk != nullptr, has_dv = p.wv != nullptr, has_w = has_dk || has_dv;
  float* ddirs[3] = {ddir0, ddir1, ddir2};
  float db_acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // this thread's filter columns

  for (int e = hh; e < 2 * KC * ldw; e += H) ea_buf[e] = __float2bfloat16_rn(0.0f);
  load_weights(p, reinterpret_cast<bf16*>(smem));
  const float bk = has_dk ? ldb(p.bk + hh) : 0.0f;
  float bv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) bv[c] = has_dv ? ldb(p.bv + c * H + hh) : 0.0f;
  __syncthreads();  // weights and zero padding in place before any copy lands

  const int r0 = ((int)blockIdx.x * p.groups + g) * p.iters;
  const int r1 = min(r0 + p.iters, p.n);
  if (r0 < r1) {  // the same for the whole group
    const size_t eb = (size_t)r0 * p.k;
    const int ne = (r1 - r0) * p.k, nch = (ne + KC - 1) / KC;
    stage_edges(p, eb, min(KC, ne), hh, nw, 5, ea_buf, nullptr, ids_buf, sc_buf);
    int i = r0, slot = 0;
    Recv rc = load_recv(p, ct_x, ct_vec, i, hh);
    float dq_acc = 0.0f;
    for (int ch = 0; ch < nch; ++ch) {
      const int buf = ch & 1;
      const size_t e0 = eb + (size_t)ch * KC;
      const int kn = min(KC, ne - ch * KC);
      const bf16* ea_s = ea_buf + buf * KC * ldw;
      const int* idx_s = ids_buf + buf * 2 * KC;
      const float* sc_s = sc_buf + buf * 5 * KC;
      __pipeline_wait_prior(0);
      group_sync(g, H);  // this chunk has landed; the last one is done with the other buffers
      if (ch + 1 < nch)
        stage_edges(p, e0 + KC, min(KC, ne - (ch + 1) * KC), hh, nw, 5,
                    ea_buf + (buf ^ 1) * KC * ldw, nullptr, ids_buf + (buf ^ 1) * 2 * KC,
                    sc_buf + (buf ^ 1) * 5 * KC);
      round_scalars(sc_buf + buf * 5 * KC, 5, hh, H);  // cutm, msk, dir0..2
      if (has_w) filter_tile(1, ea_s, w_s, nullptr, nullptr, nullptr, ldw, rbfp, F, pre_s, ldp, warp, nw, lane);
      group_sync(g, H);  // the filter tile and the rounded scalars are complete
      Src cur = load_src(p, idx_s[0], hh);
      for (int kc = 0; kc < kn; ++kc) {
        Src nxt = cur;
        if (kc + 1 < kn) nxt = load_src(p, idx_s[kc + 1], hh);  // in flight while this edge computes
        if (slot == p.k) {  // the next receiver row
          dq[(size_t)i * H + hh] = dq_acc;
          dq_acc = 0.0f;
          rc = load_recv(p, ct_x, ct_vec, ++i, hh);
          slot = 0;
        }
        ++slot;
        // ---- recompute the forward edge (the first port's rounding points,
        // two roundings per conversion where two values are ready)
        bf16* a = pre_s + kc * ldp + hh;
        float pre[4], val[4];
        edge_filters(act, a, H, bk, bv, pre, val);
        const float dk = has_dk ? val[0] : 1.0f;
        float dv[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) dv[c] = has_dv ? val[1 + c] : 1.0f;
        // bf16(v * dv) is v where dv is absent (1)
        float vdv[3] = {cur.v[0] * dv[0], cur.v[1] * dv[1], bfr(cur.v[2] * dv[2])};
        bfr2(vdv[0], vdv[1]);
        float prod = bfr(rc.q * cur.k);
        if (has_dk) prod = bfr(prod * dk);
        const float pre_a = bfr(group_sum(prod, p.hd));
        float a_act = act_fn(attn_act, pre_a), da = dact_fn(attn_act, pre_a);
        bfr2(a_act, da);
        const float cm = sc_s[0 * KC + kc], m = sc_s[1 * KC + kc];
        const float attn = bfr(a_act * cm);
        const float vw2 = vdv[2];
        // ---- backward through the edge (the receiver's side)
        float d_attn = rc.ctx * vdv[0], d_xm = rc.ctx * attn;
        bfr2(d_attn, d_xm);
        float t_cm = da * cm, r_arg = a_act * d_attn;
        bfr2(t_cm, r_arg);
        const float d_prea = bfr(t_cm * d_attn);
        const float d_prod = bfr(group_sum(d_prea, p.hd));
        float qk = d_prod * rc.q, pk = d_prod * cur.k;
        bfr2(qk, pk);
        float d_dk = 0.0f;
        if (has_dk) {
          d_dk = qk * cur.k;
          float t = pk * dk;
          bfr2(d_dk, t);
          dq_acc += t;
        } else {
          dq_acc += pk;
        }
        float d_vw1 = 0.0f, d_vw2 = 0.0f, r_dir[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float u = rc.ctv[c] * cur.vec[c], y = rc.ctv[c] * sc_s[(2 + c) * KC + kc];
          bfr2(u, y);
          float w = u * m;
          d_vw2 += y;
          bfr2(w, d_vw2);
          d_vw1 += w;
          r_dir[c] = rc.ctv[c] * vw2;
          bfr2(d_vw1, r_dir[c]);
        }
        // the warp's partials of d cutm and d dir0..2 (lanes 0, 8, 16, 24)
        const float r = warp_sum4(r_arg, r_dir[0], r_dir[1], r_dir[2], lane);
        if ((lane & 7) == 0) red_s[(kc * 4 + (lane >> 3)) * nw + warp] = r;
        const size_t e = e0 + kc;
        if (hh % p.hd == 0) {  // the source pass's per-edge head scalars
          hs[e * 2 * heads + head] = bf16_exact(d_prod);
          hs[e * 2 * heads + heads + head] = bf16_exact(attn);
        }
        // the filter cotangents d_pre = bf16(bf16(act'(pre)) * bf16(d_filter))
        float dd[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) dd[c] = dact_fn(act, pre[c]);
        bfr2(dd[0], dd[1]);
        bfr2(dd[2], dd[3]);
        float dvv[3] = {d_xm * cur.v[0], d_vw1 * cur.v[1], bfr(d_vw2 * cur.v[2])};
        bfr2(dvv[0], dvv[1]);
        float d_pre[4] = {dd[0] * d_dk, dd[1] * dvv[0], dd[2] * dvv[1], dd[3] * dvv[2]};
        bfr2(d_pre[0], d_pre[1]);
        bfr2(d_pre[2], d_pre[3]);
        if (!has_dk) d_pre[0] = 0.0f;
        if (!has_dv) d_pre[1] = d_pre[2] = d_pre[3] = 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // this thread read a[c * H] above: overwrite it with d_pre
          a[c * H] = bf16_exact(d_pre[c]);
          db_acc[c] += d_pre[c];
        }
        cur = nxt;
      }
      group_sync(g, H);  // d_pre and the warp partials are complete
      // per-edge scalar cotangents: fixed-order sums of the warp partials
      for (int s = hh; s < kn * 4; s += H) {
        const int kc = s / 4, which = s % 4;
        float sum = 0.0f;
        for (int w = 0; w < nw; ++w) sum += red_s[(kc * 4 + which) * nw + w];
        float* out = which == 0 ? dcutm : ddirs[which - 1];
        out[e0 + kc] = sum;
      }
      if (has_w) {
        dea_tile(1, pre_s, w_s, nullptr, nullptr, nullptr, F, ldp, ldw, p.rbf, rbfp, dea, e0, kn,
                 warp, nw, lane);
        if (dpre) store_tile(pre_s, ldp, F, dpre, e0, kn, hh, H);
      } else {
        for (int x = hh; x < kn * p.rbf; x += H) dea[e0 * p.rbf + x] = __float2bfloat16_rn(0.0f);
      }
    }
    dq[(size_t)i * H + hh] = dq_acc;
  }
  if (dpre) {
#pragma unroll
    for (int c = 0; c < 4; ++c) db_part[((size_t)blockIdx.x * p.groups + g) * F + c * H + hh] = db_acc[c];
  }
}

// The backward's source pass (#2): per atom j, the source-row cotangents
// d k_j, d v_j, d vec_j = sums over the K slots s of perm (the edges (i, k')
// with idx[i, k'] = j) of the per-edge values the receiver's side leaves
// to the source: from the edge's recomputed filters, the receiver's q and
// ct, the edge's msk and dir, and hs's d_prod and attn.  f32 sums in slot
// order, rounded once.
template <int ACT, int ATT>
__global__ void __launch_bounds__(SRC_MAX_THREADS, 1)
    et_bwd_src_kernel(Params p, const int32_t* __restrict__ perm, const float* __restrict__ ct_x,
                      const float* __restrict__ ct_vec, const bf16* __restrict__ hs,
                      bf16* __restrict__ dk_out, bf16* __restrict__ dv_out,
                      bf16* __restrict__ dvec0, bf16* __restrict__ dvec1, bf16* __restrict__ dvec2) {
  extern __shared__ __align__(128) unsigned char smem[];
  // the activations: compile-time constants where the instantiation names them
  const int act = ACT >= 0 ? ACT : p.act, attn_act = ATT >= 0 ? ATT : p.attn_act;
  const int H = p.h, F = 4 * H, ldp = pre_ld(H), ldw = w_ld(p.rbf), rbfp = rbf_pad(p.rbf);
  const int g = threadIdx.x / H, hh = threadIdx.x % H;
  const int nw = H / 32, warp = hh / 32, lane = hh % 32;
  const int heads = H / p.hd, head = hh / p.hd;
  const GLayout L = pass_layout(H, heads, p.rbf, p.groups, SRC);
  const bf16* w_s = reinterpret_cast<const bf16*>(smem);
  unsigned char* gs = smem + L.base + g * L.stride;
  bf16* ea_buf = reinterpret_cast<bf16*>(gs + L.ea);
  bf16* pre_s = reinterpret_cast<bf16*>(gs + L.pre);
  int* ids_buf = reinterpret_cast<int*>(gs + L.ids);
  float* sc_buf = reinterpret_cast<float*>(gs + L.sc);
  float* hs_buf = reinterpret_cast<float*>(gs + L.hs);
  const bool has_dk = p.wk != nullptr, has_dv = p.wv != nullptr, has_w = has_dk || has_dv;
  bf16* dvecs[3] = {dvec0, dvec1, dvec2};
  const float* hs_words = reinterpret_cast<const float*>(hs);  // (E, heads) words of two bf16

  for (int e = hh; e < 2 * KC * ldw; e += H) ea_buf[e] = __float2bfloat16_rn(0.0f);
  load_weights(p, reinterpret_cast<bf16*>(smem));
  const float bk = has_dk ? ldb(p.bk + hh) : 0.0f;
  float bv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) bv[c] = has_dv ? ldb(p.bv + c * H + hh) : 0.0f;
  __syncthreads();

  const int a0 = ((int)blockIdx.x * p.groups + g) * p.iters;
  const int a1 = min(a0 + p.iters, p.n);
  if (a0 >= a1) return;  // the same for the whole group
  const size_t sb = (size_t)a0 * p.k;
  const int ns = (a1 - a0) * p.k, nch = (ns + KC - 1) / KC;
  // perm of the next chunks, lane s holding slot s: one chunk ahead of its staging
  int pv = lane < min(KC, ns) ? __ldg(perm + sb + lane) : 0;
  stage_slots(p, pv, min(KC, ns), hh, nw, 4, heads, hs_words, ea_buf, nullptr, ids_buf, sc_buf, hs_buf);
  pv = (nch > 1 && lane < min(KC, ns - KC)) ? __ldg(perm + sb + KC + lane) : 0;
  int j = a0, slot = 0;
  Src own = load_src(p, j, hh);
  float acc_k = 0.0f, acc_v[3] = {0.0f, 0.0f, 0.0f}, acc_vec[3] = {0.0f, 0.0f, 0.0f};
  for (int ch = 0; ch < nch; ++ch) {
    const int buf = ch & 1;
    const int kn = min(KC, ns - ch * KC);
    const int* eid_s = ids_buf + buf * 2 * KC;
    const float* sc_s = sc_buf + buf * 4 * KC;
    const bf16* hs_s = reinterpret_cast<const bf16*>(hs_buf + buf * heads * KC);
    __pipeline_wait_prior(0);
    group_sync(g, H);  // this chunk has landed; the last one is done with the other buffers
    if (ch + 1 < nch) {
      stage_slots(p, pv, min(KC, ns - (ch + 1) * KC), hh, nw, 4, heads, hs_words,
                  ea_buf + (buf ^ 1) * KC * ldw, nullptr, ids_buf + (buf ^ 1) * 2 * KC,
                  sc_buf + (buf ^ 1) * 4 * KC, hs_buf + (buf ^ 1) * heads * KC);
      const int rest = ns - (ch + 2) * KC;
      pv = (rest > 0 && lane < min(KC, rest)) ? __ldg(perm + sb + (size_t)(ch + 2) * KC + lane) : 0;
    }
    round_scalars(sc_buf + buf * 4 * KC, 4, hh, H);  // msk, dir0..2
    if (has_w)
      filter_tile(1, ea_buf + buf * KC * ldw, w_s, nullptr, nullptr, nullptr, ldw, rbfp, F, pre_s, ldp,
                  warp, nw, lane);
    group_sync(g, H);  // the filter tile, the chunk's ids and its rounded scalars are complete
    Recv cur = load_recv(p, ct_x, ct_vec, eid_s[KC], hh);
    for (int kc = 0; kc < kn; ++kc) {
      Recv nxt = cur;
      if (kc + 1 < kn) nxt = load_recv(p, ct_x, ct_vec, eid_s[KC + kc + 1], hh);
      if (slot == p.k) {  // the next source atom
        dk_out[(size_t)j * H + hh] = __float2bfloat16_rn(acc_k);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          dv_out[(size_t)j * 3 * H + c * H + hh] = __float2bfloat16_rn(acc_v[c]);
          dvecs[c][(size_t)j * H + hh] = __float2bfloat16_rn(acc_vec[c]);
          acc_v[c] = 0.0f;
          acc_vec[c] = 0.0f;
        }
        acc_k = 0.0f;
        own = load_src(p, ++j, hh);
        slot = 0;
      }
      ++slot;
      float pre[4], val[4];
      edge_filters(act, pre_s + kc * ldp + hh, H, bk, bv, pre, val);
      const float dk = has_dk ? val[0] : 1.0f;
      float dv[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) dv[c] = has_dv ? val[1 + c] : 1.0f;
      const float d_prod = __bfloat162float(hs_s[kc * 2 * heads + head]);
      const float attn = __bfloat162float(hs_s[kc * 2 * heads + heads + head]);
      const float m = sc_s[0 * KC + kc];
      // the receiver pass's rounding points: bf16(v * dv) is v where dv is absent
      float qk = d_prod * cur.q, d_xm = cur.ctx * attn;
      bfr2(qk, d_xm);
      float d_k = qk * dk, vm1 = bfr(own.v[1] * dv[1]) * m;
      bfr2(d_k, vm1);
      acc_k += has_dk ? d_k : qk;
      float d_vw1 = 0.0f, d_vw2 = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float u = cur.ctv[c] * own.vec[c], y = cur.ctv[c] * sc_s[(1 + c) * KC + kc];
        bfr2(u, y);
        float w = u * m;
        d_vw2 += y;
        bfr2(w, d_vw2);
        d_vw1 += w;
        float d_vec = cur.ctv[c] * vm1;
        bfr2(d_vw1, d_vec);
        acc_vec[c] += d_vec;
      }
      // bf16(d * dv) is d where dv is absent (d is a bf16 value)
      float d_v[3] = {d_xm * dv[0], d_vw1 * dv[1], bfr(d_vw2 * dv[2])};
      bfr2(d_v[0], d_v[1]);
#pragma unroll
      for (int c = 0; c < 3; ++c) acc_v[c] += d_v[c];
      cur = nxt;
    }
  }
  dk_out[(size_t)j * H + hh] = __float2bfloat16_rn(acc_k);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    dv_out[(size_t)j * 3 * H + c * H + hh] = __float2bfloat16_rn(acc_v[c]);
    dvecs[c][(size_t)j * H + hh] = __float2bfloat16_rn(acc_vec[c]);
  }
}

// The second order's receiver pass (#3): the VJP of the backward with respect
// to (inputs, ct) given the cotangents Z on its outputs (see the header).
// Per edge, with primes for tangents (the Z values; z_msk is ignored, msk's
// tangent is zero):
//   pre' = z_ea.W + ea.Z_W + z_b, dk' = act'(pre_k) pre_k', prod' = z_q k dk
//   + q z_k dk + q k dk', pa' = head sum of prod', attn' = attn_act'(pa) pa'
//   cutm + attn_act(pa) z_cutm, vdv' = z_v dv + v dv',
//   x'   += vdv'_0 attn + vdv_0 attn'
//   vec'_d += z_vec_d vdv_1 msk + vec_d vdv'_1 msk + vdv'_2 dir_d + vdv_2 z_dir_d
// g_ct = (x', vec') summed over the slots; g_inputs is the reverse pass of
// these lines seeded with ct on x' and vec'.  This pass computes the
// receiver's side (g q, g ea, the edge scalars' gradients, g_ct, the filter
// cotangents bpre and bpre' per edge for et_dw_kernel and the bias sums per
// group); per edge and head it writes attn, attn', and the head sums of the
// reverse seeds of prod' and prod (hs4, (E, 4, heads) f32) for the source
// pass.
template <int ACT, int ATT>
__global__ void __launch_bounds__(RECV2_MAX_THREADS, 2)
    et_bwd2_kernel(Params p, const float* __restrict__ ct_x, const float* __restrict__ ct_vec,
                   float* __restrict__ gq, bf16* __restrict__ gea, float* __restrict__ gcutm,
                   float* __restrict__ gmsk, float* __restrict__ gdir0, float* __restrict__ gdir1,
                   float* __restrict__ gdir2, float* __restrict__ gctx, float* __restrict__ gctvec,
                   float* __restrict__ hs4, bf16* __restrict__ bpre_out, bf16* __restrict__ bpret_out,
                   float* __restrict__ db_part) {
  extern __shared__ __align__(128) unsigned char smem[];
  // the activations: compile-time constants where the instantiation names them
  const int act = ACT >= 0 ? ACT : p.act, attn_act = ATT >= 0 ? ATT : p.attn_act;
  const int H = p.h, F = 4 * p.h, ldp = pre_ld(p.h);
  const int g = threadIdx.x / H, hh = threadIdx.x % H;
  const int nw = H / 32, warp = hh / 32, lane = hh % 32;
  const int ldw = w_ld(p.rbf), rbfp = rbf_pad(p.rbf);
  const int heads = H / p.hd, head = hh / p.hd;
  const GLayout L = pass_layout(H, heads, p.rbf, p.groups, RECV2);
  unsigned char* gs = smem + L.base + g * L.stride;
  bf16* ea_buf = reinterpret_cast<bf16*>(gs + L.ea);
  bf16* zea_buf = reinterpret_cast<bf16*>(gs + L.zea);
  bf16* pre_s = reinterpret_cast<bf16*>(gs + L.pre);    // pre, then its cotangent
  bf16* pret_s = reinterpret_cast<bf16*>(gs + L.pret);  // pre', then its cotangent
  int* ids_buf = reinterpret_cast<int*>(gs + L.ids);
  float* sc_buf = reinterpret_cast<float*>(gs + L.sc);
  float* red_s = reinterpret_cast<float*>(gs + L.red);
  const bool has_dk = p.wk != nullptr, has_dv = p.wv != nullptr, has_w = has_dk || has_dv;
  float* gdirs[3] = {gdir0, gdir1, gdir2};
  float db_acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int e = hh; e < 2 * KC * ldw; e += H) {
    ea_buf[e] = __float2bfloat16_rn(0.0f);
    zea_buf[e] = __float2bfloat16_rn(0.0f);
  }
  float bk = 0.0f, zbk = 0.0f, bv[3] = {0.0f, 0.0f, 0.0f}, zbv[3] = {0.0f, 0.0f, 0.0f};
  if (has_dk) {
    bk = ldb(p.bk + hh);
    zbk = ldb(p.zbk + hh);
  }
  if (has_dv) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      bv[c] = ldb(p.bv + c * H + hh);
      zbv[c] = ldb(p.zbv + c * H + hh);
    }
  }
  __syncthreads();  // zero padding in place before any copy lands

  const int r0 = ((int)blockIdx.x * p.groups + g) * p.iters;
  const int r1 = min(r0 + p.iters, p.n);
  if (r0 < r1) {
    const size_t eb = (size_t)r0 * p.k;
    const int ne = (r1 - r0) * p.k, nch = (ne + KC - 1) / KC;
    stage_edges(p, eb, min(KC, ne), hh, nw, 9, ea_buf, zea_buf, ids_buf, sc_buf);
    int i = r0, slot = 0;
    float qi = 0.0f, zqi = 0.0f, ctx = 0.0f, ctv[3];
    float gq_acc = 0.0f, gx_acc = 0.0f, gv_acc[3] = {0.0f, 0.0f, 0.0f};
    for (int ch = 0; ch < nch; ++ch) {
      const int buf = ch & 1;
      const size_t e0 = eb + (size_t)ch * KC;
      const int kn = min(KC, ne - ch * KC);
      const bf16* ea_s = ea_buf + buf * KC * ldw;
      const bf16* zea_s = zea_buf + buf * KC * ldw;
      const int* idx_s = ids_buf + buf * 2 * KC;
      const float* sc_s = sc_buf + buf * 9 * KC;
      __pipeline_wait_prior(0);
      group_sync(g, H);  // this chunk has landed; the last one is done with the other buffers
      if (ch + 1 < nch)
        stage_edges(p, e0 + KC, min(KC, ne - (ch + 1) * KC), hh, nw, 9,
                    ea_buf + (buf ^ 1) * KC * ldw, zea_buf + (buf ^ 1) * KC * ldw,
                    ids_buf + (buf ^ 1) * 2 * KC, sc_buf + (buf ^ 1) * 9 * KC);
      round_scalars(sc_buf + buf * 9 * KC, 5, hh, H);  // cutm, msk, dir0..2 (not their Z)
      if (has_w) {
        filter_tile(1, ea_s, nullptr, p.w_all, nullptr, nullptr, ldw, rbfp, F, pre_s, ldp, warp, nw, lane);
        filter_tile(2, zea_s, nullptr, p.w_all, ea_s, p.zw_all, ldw, rbfp, F, pret_s, ldp, warp, nw, lane);
      }
      group_sync(g, H);  // the filter tiles and the rounded scalars are complete
      for (int kc = 0; kc < kn; ++kc) {
        if (slot == 0 || slot == p.k) {  // a new receiver row
          if (slot == p.k) {
            gq[(size_t)i * H + hh] = gq_acc;
            gctx[(size_t)i * H + hh] = gx_acc;
#pragma unroll
            for (int d = 0; d < 3; ++d) gctvec[(size_t)i * 3 * H + d * H + hh] = gv_acc[d];
            gq_acc = gx_acc = 0.0f;
#pragma unroll
            for (int d = 0; d < 3; ++d) gv_acc[d] = 0.0f;
            ++i;
          }
          qi = ldb(p.q + (size_t)i * H + hh);
          zqi = ldb(p.zq + (size_t)i * H + hh);
          ctx = bfr(ct_x[(size_t)i * H + hh]);
#pragma unroll
          for (int c = 0; c < 3; ++c) ctv[c] = bfr(ct_vec[(size_t)i * 3 * H + c * H + hh]);
          slot = 0;
        }
        ++slot;
        const int j = idx_s[kc];
        const Src x = load_src(p, j, hh);
        const ZSrc z = load_zsrc(p, j, hh);
        const size_t e = e0 + kc;
        const float cm = sc_s[0 * KC + kc], m = sc_s[1 * KC + kc];
        const float zcm = sc_s[5 * KC + kc];
        float dir[3], zdir[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          dir[d] = sc_s[(2 + d) * KC + kc];
          zdir[d] = sc_s[(6 + d) * KC + kc];
        }
        // ---- the dual forward of the edge
        bf16* a = pre_s + kc * ldp + hh;
        bf16* at = pret_s + kc * ldp + hh;
        float f[4], f1[4], f2[4], pt[4];
        dual_filters(act, a, at, H, bk, zbk, bv, zbv, has_dk, has_dv, f, f1, f2, pt);
        const float dk = f[0], dk1 = f1[0], dk2 = f2[0], pkt = pt[0], dkt = dk1 * pkt;
        float dv[3], dv1[3], dv2[3], pvt[3], dvt[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          dv[c] = f[1 + c];
          dv1[c] = f1[1 + c];
          dv2[c] = f2[1 + c];
          pvt[c] = pt[1 + c];
          dvt[c] = dv1[c] * pvt[c];
        }
        const float qk = bfr(qi * x.k);
        const float prod = has_dk ? bfr(qk * dk) : qk;
        const float prodt = (zqi * x.k + qi * z.k) * dk + qi * x.k * dkt;
        float pa = prod, pat = prodt;  // their head sums, two at once
        group_sum2(pa, pat, p.hd, lane);
        pa = bfr(pa);
        float aa, a1, a2;
        act3(attn_act, pa, &aa, &a1, &a2);
        aa = bfr(aa);
        const float attn = bfr(aa * cm);
        const float attnt = a1 * pat * cm + aa * zcm;
        float vdv[3], vdvt[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          vdv[c] = has_dv ? bfr(x.v[c] * dv[c]) : x.v[c];
          vdvt[c] = z.v[c] * dv[c] + x.v[c] * dvt[c];
        }
        gx_acc += vdvt[0] * attn + vdv[0] * attnt;
        float cv = 0.0f, czv = 0.0f, cd = 0.0f, czd = 0.0f;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          gv_acc[d] += (z.vec[d] * vdv[1] + x.vec[d] * vdvt[1]) * m + vdvt[2] * dir[d] + vdv[2] * zdir[d];
          cv += ctv[d] * x.vec[d];
          czv += ctv[d] * z.vec[d];
          cd += ctv[d] * dir[d];
          czd += ctv[d] * zdir[d];
        }
        // ---- its reverse, seeded with ct on the tangent outputs
        const float b_vdvt[3] = {ctx * attn, m * cv, cd};
        const float b_vdv[3] = {ctx * attnt, m * czv, czd};
        const float b_attnt = ctx * vdv[0];
        const float b_attn = ctx * vdvt[0];
        // the warp's partials of g cutm, g msk, g dir0..2: four at once
        // (lanes 0, 8, 16, 24), the fifth alone
        const float r4 = warp_sum4(b_attnt * a1 * pat + b_attn * aa, czv * vdv[1] + cv * vdvt[1],
                                   ctv[0] * vdvt[2], ctv[1] * vdvt[2], lane);
        if ((lane & 7) == 0) red_s[(kc * 5 + (lane >> 3)) * nw + warp] = r4;
        const float r_dir2 = group_sum(ctv[2] * vdvt[2], 32);
        if (lane == 0) red_s[(kc * 5 + 4) * nw + warp] = r_dir2;
        const float b_pat = b_attnt * a1 * cm;
        const float b_pa = b_attnt * (a2 * pat * cm + a1 * zcm) + b_attn * a1 * cm;
        float b_prodt = b_pat, b_prod = b_pa;  // their head sums, two at once
        group_sum2(b_prodt, b_prod, p.hd, lane);
        if (hh % p.hd == 0) {  // the source pass's per-edge head scalars
          float* hrow = hs4 + e * 4 * heads + head;
          hrow[0] = attn;
          hrow[heads] = attnt;
          hrow[2 * heads] = b_prodt;
          hrow[3 * heads] = b_prod;
        }
        float bpre[4] = {0.0f, 0.0f, 0.0f, 0.0f}, bpret[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (has_dv) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float b_dv = b_vdvt[c] * z.v[c] + b_vdv[c] * x.v[c];
            const float b_dvt = b_vdvt[c] * x.v[c];
            bpret[1 + c] = b_dvt * dv1[c];
            bpre[1 + c] = b_dvt * dv2[c] * pvt[c] + b_dv * dv1[c];
          }
        }
        gq_acc += b_prodt * (z.k * dk + x.k * dkt) + b_prod * x.k * dk;
        if (has_dk) {
          const float b_dk = b_prodt * (zqi * x.k + qi * z.k) + b_prod * qi * x.k;
          const float b_dkt = b_prodt * qi * x.k;
          bpret[0] = b_dkt * dk1;
          bpre[0] = b_dkt * dk2 * pkt + b_dk * dk1;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // this thread read a[c * H] and at[c * H] above: overwrite them
          bfr2(bpre[c], bpret[c]);
          a[c * H] = bf16_exact(bpre[c]);
          at[c * H] = bf16_exact(bpret[c]);
          db_acc[c] += bpre[c];
        }
      }
      group_sync(g, H);
      // per-edge scalar gradients: fixed-order sums of the warp partials
      for (int s = hh; s < kn * 5; s += H) {
        const int kc = s / 5, which = s % 5;
        float sum = 0.0f;
        for (int w = 0; w < nw; ++w) sum += red_s[(kc * 5 + which) * nw + w];
        float* out = which == 0 ? gcutm : (which == 1 ? gmsk : gdirs[which - 2]);
        out[e0 + kc] = sum;
      }
      if (has_w) {
        // g ea (KC, RBFP) = pre-bar . W + pre'-bar . Z_W on the tensor cores
        dea_tile(2, pre_s, nullptr, p.w_all, pret_s, p.zw_all, F, ldp, ldw, p.rbf, rbfp, gea, e0, kn,
                 warp, nw, lane);
        store_tile(pre_s, ldp, F, bpre_out, e0, kn, hh, H);
        store_tile(pret_s, ldp, F, bpret_out, e0, kn, hh, H);
      } else {
        for (int x = hh; x < kn * p.rbf; x += H) gea[e0 * p.rbf + x] = __float2bfloat16_rn(0.0f);
      }
    }
    gq[(size_t)i * H + hh] = gq_acc;
    gctx[(size_t)i * H + hh] = gx_acc;
#pragma unroll
    for (int d = 0; d < 3; ++d) gctvec[(size_t)i * 3 * H + d * H + hh] = gv_acc[d];
  }
  if (has_w) {
#pragma unroll
    for (int c = 0; c < 4; ++c) db_part[((size_t)blockIdx.x * p.groups + g) * F + c * H + hh] = db_acc[c];
  }
}

// The second order's source pass (#3): per atom j, the gradients of k_j,
// v_j and vec_j summed over the K slots of perm from the edge's recomputed
// filters and filter tangents, the receiver's q, z_q and ct, the edge's
// msk, dir and z_dir, and hs4's attn, attn' and reverse seeds.  f32 sums in
// slot order, rounded once to bf16.
template <int ACT, int ATT>
__global__ void __launch_bounds__(SRC2_MAX_THREADS, 1)
    et_bwd2_src_kernel(Params p, const int32_t* __restrict__ perm, const float* __restrict__ ct_x,
                       const float* __restrict__ ct_vec, const float* __restrict__ hs4,
                       bf16* __restrict__ gk_out, bf16* __restrict__ gv_out,
                       bf16* __restrict__ gvec0, bf16* __restrict__ gvec1, bf16* __restrict__ gvec2) {
  extern __shared__ __align__(128) unsigned char smem[];
  // the activations: compile-time constants where the instantiation names them
  const int act = ACT >= 0 ? ACT : p.act, attn_act = ATT >= 0 ? ATT : p.attn_act;
  const int H = p.h, F = 4 * H, ldp = pre_ld(H), ldw = w_ld(p.rbf), rbfp = rbf_pad(p.rbf);
  const int g = threadIdx.x / H, hh = threadIdx.x % H;
  const int nw = H / 32, warp = hh / 32, lane = hh % 32;
  const int heads = H / p.hd, head = hh / p.hd;
  const GLayout L = pass_layout(H, heads, p.rbf, p.groups, SRC2);
  unsigned char* gs = smem + L.base + g * L.stride;
  bf16* ea_buf = reinterpret_cast<bf16*>(gs + L.ea);
  bf16* zea_buf = reinterpret_cast<bf16*>(gs + L.zea);
  bf16* pre_s = reinterpret_cast<bf16*>(gs + L.pre);
  bf16* pret_s = reinterpret_cast<bf16*>(gs + L.pret);
  int* ids_buf = reinterpret_cast<int*>(gs + L.ids);
  float* sc_buf = reinterpret_cast<float*>(gs + L.sc);
  float* hs_buf = reinterpret_cast<float*>(gs + L.hs);
  const bool has_dk = p.wk != nullptr, has_dv = p.wv != nullptr, has_w = has_dk || has_dv;
  bf16* gvecs[3] = {gvec0, gvec1, gvec2};
  const int hsw = 4 * heads;

  for (int e = hh; e < 2 * KC * ldw; e += H) {
    ea_buf[e] = __float2bfloat16_rn(0.0f);
    zea_buf[e] = __float2bfloat16_rn(0.0f);
  }
  float bk = 0.0f, zbk = 0.0f, bv[3] = {0.0f, 0.0f, 0.0f}, zbv[3] = {0.0f, 0.0f, 0.0f};
  if (has_dk) {
    bk = ldb(p.bk + hh);
    zbk = ldb(p.zbk + hh);
  }
  if (has_dv) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      bv[c] = ldb(p.bv + c * H + hh);
      zbv[c] = ldb(p.zbv + c * H + hh);
    }
  }
  __syncthreads();

  const int a0 = ((int)blockIdx.x * p.groups + g) * p.iters;
  const int a1 = min(a0 + p.iters, p.n);
  if (a0 >= a1) return;
  const size_t sb = (size_t)a0 * p.k;
  const int ns = (a1 - a0) * p.k, nch = (ns + KC - 1) / KC;
  int pv = lane < min(KC, ns) ? __ldg(perm + sb + lane) : 0;
  stage_slots(p, pv, min(KC, ns), hh, nw, 7, hsw, hs4, ea_buf, zea_buf, ids_buf, sc_buf, hs_buf);
  pv = (nch > 1 && lane < min(KC, ns - KC)) ? __ldg(perm + sb + KC + lane) : 0;
  int j = a0, slot = 0;
  Src x = load_src(p, j, hh);
  ZSrc z = load_zsrc(p, j, hh);
  float acc_k = 0.0f, acc_v[3] = {0.0f, 0.0f, 0.0f}, acc_vec[3] = {0.0f, 0.0f, 0.0f};
  for (int ch = 0; ch < nch; ++ch) {
    const int buf = ch & 1;
    const int kn = min(KC, ns - ch * KC);
    const int* eid_s = ids_buf + buf * 2 * KC;
    const float* sc_s = sc_buf + buf * 7 * KC;
    const float* hs_s = hs_buf + buf * hsw * KC;
    const bf16* ea_s = ea_buf + buf * KC * ldw;
    __pipeline_wait_prior(0);
    group_sync(g, H);
    if (ch + 1 < nch) {
      stage_slots(p, pv, min(KC, ns - (ch + 1) * KC), hh, nw, 7, hsw, hs4,
                  ea_buf + (buf ^ 1) * KC * ldw, zea_buf + (buf ^ 1) * KC * ldw,
                  ids_buf + (buf ^ 1) * 2 * KC, sc_buf + (buf ^ 1) * 7 * KC, hs_buf + (buf ^ 1) * hsw * KC);
      const int rest = ns - (ch + 2) * KC;
      pv = (rest > 0 && lane < min(KC, rest)) ? __ldg(perm + sb + (size_t)(ch + 2) * KC + lane) : 0;
    }
    round_scalars(sc_buf + buf * 7 * KC, 4, hh, H);  // msk, dir0..2 (not z_dir)
    if (has_w) {
      filter_tile(1, ea_s, nullptr, p.w_all, nullptr, nullptr, ldw, rbfp, F, pre_s, ldp, warp, nw, lane);
      filter_tile(2, zea_buf + buf * KC * ldw, nullptr, p.w_all, ea_s, p.zw_all, ldw, rbfp, F, pret_s,
                  ldp, warp, nw, lane);
    }
    group_sync(g, H);
    for (int kc = 0; kc < kn; ++kc) {
      if (slot == p.k) {  // the next source atom
        gk_out[(size_t)j * H + hh] = __float2bfloat16_rn(acc_k);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          gv_out[(size_t)j * 3 * H + c * H + hh] = __float2bfloat16_rn(acc_v[c]);
          gvecs[c][(size_t)j * H + hh] = __float2bfloat16_rn(acc_vec[c]);
          acc_v[c] = 0.0f;
          acc_vec[c] = 0.0f;
        }
        acc_k = 0.0f;
        ++j;
        x = load_src(p, j, hh);
        z = load_zsrc(p, j, hh);
        slot = 0;
      }
      ++slot;
      const int i = eid_s[KC + kc];
      const float qi = ldb(p.q + (size_t)i * H + hh);
      const float zqi = ldb(p.zq + (size_t)i * H + hh);
      float ctx = ct_x[(size_t)i * H + hh], ctv[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) ctv[c] = ct_vec[(size_t)i * 3 * H + c * H + hh];
      bfr2(ctx, ctv[0]);
      bfr2(ctv[1], ctv[2]);
      const float m = sc_s[0 * KC + kc];
      float dir[3], zdir[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        dir[d] = sc_s[(1 + d) * KC + kc];
        zdir[d] = sc_s[(4 + d) * KC + kc];
      }
      const float attn = hs_s[kc * hsw + head];
      const float attnt = hs_s[kc * hsw + heads + head];
      const float b_prodt = hs_s[kc * hsw + 2 * heads + head];
      const float b_prod = hs_s[kc * hsw + 3 * heads + head];
      const bf16* a = pre_s + kc * ldp + hh;
      const bf16* at = pret_s + kc * ldp + hh;
      float f[4], f1[4], f2[4], pt[4];
      dual_filters(act, a, at, H, bk, zbk, bv, zbv, has_dk, has_dv, f, f1, f2, pt);
      const float dk = f[0], dkt = f1[0] * pt[0];
      float dv[3], dvt[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        dv[c] = f[1 + c];
        dvt[c] = f1[1 + c] * pt[1 + c];
      }
      const float vdvt1 = z.v[1] * dv[1] + x.v[1] * dvt[1];
      float cv = 0.0f, czv = 0.0f, cd = 0.0f, czd = 0.0f;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        acc_vec[d] += ctv[d] * vdvt1 * m;
        cv += ctv[d] * x.vec[d];
        czv += ctv[d] * z.vec[d];
        cd += ctv[d] * dir[d];
        czd += ctv[d] * zdir[d];
      }
      const float b_vdvt[3] = {ctx * attn, m * cv, cd};
      const float b_vdv[3] = {ctx * attnt, m * czv, czd};
#pragma unroll
      for (int c = 0; c < 3; ++c) acc_v[c] += b_vdvt[c] * dvt[c] + b_vdv[c] * dv[c];
      acc_k += b_prodt * (zqi * dk + qi * dkt) + b_prod * qi * dk;
    }
  }
  gk_out[(size_t)j * H + hh] = __float2bfloat16_rn(acc_k);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    gv_out[(size_t)j * 3 * H + c * H + hh] = __float2bfloat16_rn(acc_v[c]);
    gvecs[c][(size_t)j * H + hh] = __float2bfloat16_rn(acc_vec[c]);
  }
}

// The weight-gradient reduction: part[s] (RBFP, F) f32 = sum over the edges
// of split s of sum over npairs of A_p^T . B_p, A_p (E, RBF) bf16 edge rows
// (ea, z_ea), B_p (E, F) bf16 filter cotangents.  A block takes DW_COLS
// columns and DW_ROWS rows of RBF (grid z) of one split (grid y) and walks
// its edges in tiles of DW_EDGES, staged by cp.async into a ring of two
// (edges past the split's end are zero-filled); each warp keeps its
// (DW_ROWS, 32) f32 accumulators in registers for the whole range and
// writes them once.  The caller sums the splits.
constexpr int DW_COLS = 128, DW_ROWS = 64, DW_EDGES = 64, DW_THREADS = 128;
constexpr int DW_LDA = DW_ROWS + 8, DW_LDB = DW_COLS + 8;  // row strides: no bank conflicts
constexpr size_t DW_SMEM = (size_t)2 * DW_EDGES * (DW_LDA + DW_LDB) * sizeof(bf16);

__global__ void __launch_bounds__(DW_THREADS)
    et_dw_kernel(const bf16* __restrict__ a0, const bf16* __restrict__ b0,
                 const bf16* __restrict__ a1, const bf16* __restrict__ b1, int npairs, int ne,
                 int rbf, int rbfp, int f, int per_split, float* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);      // 2 x (DW_EDGES, DW_LDA)
  bf16* b_s = a_s + 2 * DW_EDGES * DW_LDA;        // 2 x (DW_EDGES, DW_LDB)
  const int n0 = blockIdx.x * DW_COLS, split = blockIdx.y, m0 = blockIdx.z * DW_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int e_begin = split * per_split, e_end = min(ne, e_begin + per_split);
  const int words = min(DW_ROWS, rbf - m0) / 2;  // A's columns in this block, as bf16 pairs
  const int mrows = min(DW_ROWS, rbfp - m0);     // output rows (a multiple of 16)
  const int ntiles = e_end > e_begin ? (e_end - e_begin + DW_EDGES - 1) / DW_EDGES : 0;
  const int steps = npairs * ntiles;
  for (int x = threadIdx.x; x < 2 * DW_EDGES * DW_LDA; x += DW_THREADS) a_s[x] = __float2bfloat16_rn(0.0f);
  __syncthreads();  // A's padding columns stay zero: no copy writes them

  auto stage = [&](int st, int buf) {
    const int pr = st / ntiles, e0 = e_begin + (st % ntiles) * DW_EDGES;
    const bf16* a = pr ? a1 : a0;
    const bf16* b = pr ? b1 : b0;
    bf16* as = a_s + buf * DW_EDGES * DW_LDA;
    bf16* bs = b_s + buf * DW_EDGES * DW_LDB;
    for (int x = threadIdx.x; x < DW_EDGES * words; x += DW_THREADS) {
      const int r = x / words, w = x % words;
      const bool ok = e0 + r < e_end;
      __pipeline_memcpy_async(as + r * DW_LDA + 2 * w, ok ? a + (size_t)(e0 + r) * rbf + m0 + 2 * w : a,
                              4, ok ? 0 : 4);
    }
    for (int x = threadIdx.x; x < DW_EDGES * (DW_COLS / 8); x += DW_THREADS) {
      const int r = x / (DW_COLS / 8), c8 = x % (DW_COLS / 8);
      const bool ok = e0 + r < e_end && n0 + c8 * 8 < f;  // past F: zero columns
      __pipeline_memcpy_async(bs + r * DW_LDB + c8 * 8, ok ? b + (size_t)(e0 + r) * f + n0 + c8 * 8 : b,
                              16, ok ? 0 : 16);
    }
    __pipeline_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int x = 0; x < 16; ++x) acc[mt][x / 4][x % 4] = 0.0f;
  if (steps > 0) stage(0, 0);
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) {
      stage(st + 1, (st + 1) & 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // tile st has landed for every thread
    const bf16* as = a_s + (st & 1) * DW_EDGES * DW_LDA;
    const bf16* bs = b_s + (st & 1) * DW_EDGES * DW_LDB;
#pragma unroll
    for (int kk = 0; kk < DW_EDGES; kk += 16) {
      unsigned bfr2[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
        ldsm_x4_t(bs + (kk + (lane & 7) + (((lane >> 3) & 1) << 3)) * DW_LDB + warp * 32 + q * 16 +
                      ((lane >> 4) << 3),
                  bfr2[q]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt * 16 >= mrows) continue;
        unsigned af[4];
        ldsm_x4_t(as + (kk + (lane & 7) + ((lane >> 4) << 3)) * DW_LDA + mt * 16 + (((lane >> 3) & 1) << 3), af);
        mma_bf16(acc[mt][0], af, bfr2[0][0], bfr2[0][1]);
        mma_bf16(acc[mt][1], af, bfr2[0][2], bfr2[0][3]);
        mma_bf16(acc[mt][2], af, bfr2[1][0], bfr2[1][1]);
        mma_bf16(acc[mt][3], af, bfr2[1][2], bfr2[1][3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    if (mt * 16 >= mrows) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + warp * 32 + nt * 8 + 2 * t;
      if (col >= f) continue;  // a partial last block of columns
      float* row = part + ((size_t)split * rbfp + m0 + mt * 16 + g) * f + col;
      *reinterpret_cast<float2*>(row) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(row + (size_t)8 * f) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

bool valid_shape(int n, int k, int h, int heads, int rbf) {
  if (n <= 0 || k <= 0 || rbf <= 0 || rbf % 2 != 0 || heads <= 0 || h % 32 != 0 || h > 1024 ||
      h % heads != 0)
    return false;
  if (rbf_pad(rbf) > 4 * h) return false;
  const int hd = h / heads;
  return hd <= 32 && (hd & (hd - 1)) == 0;
}

cudaError_t device_limits(int* sms, int* smem_max) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}

// The forward: row groups per block (the most that fit in threads and
// shared memory) and rows per group, so that the grid is about one block
// per SM.
cudaError_t plan_grid(Params* p, size_t* smem, int* blocks) {
  int sms = 0, smem_max = 0;
  cudaError_t err = device_limits(&sms, &smem_max);
  if (err != cudaSuccess) return err;
  int groups = 0;
  for (int gcount = 4; gcount >= 1; gcount /= 2) {
    if (gcount * p->h <= FWD_MAX_THREADS && smem_layout(p->h, p->rbf, gcount).total <= (size_t)smem_max) {
      groups = gcount;
      break;
    }
  }
  if (groups == 0) return cudaErrorInvalidValue;  // too wide for one block
  p->groups = groups;
  p->iters = (p->n + groups * sms - 1) / (groups * sms);
  *blocks = (p->n + groups * p->iters - 1) / (groups * p->iters);
  *smem = smem_layout(p->h, p->rbf, groups).total;
  return cudaSuccess;
}

// A backward or second-order pass: the most row groups that fit in a
// block's threads and shared memory, and contiguous rows (atoms) per group
// so that the grid fills every SM's resident blocks about once.
cudaError_t plan_pass(Params* p, int pass, size_t* smem, int* blocks) {
  int sms = 0, smem_max = 0;
  cudaError_t err = device_limits(&sms, &smem_max);
  if (err != cudaSuccess) return err;
  const int max_threads = pass == RECV ? RECV_MAX_THREADS
                          : pass == SRC ? SRC_MAX_THREADS
                          : pass == RECV2 ? RECV2_MAX_THREADS
                                          : SRC2_MAX_THREADS;
  const int per_sm = pass == RECV2 ? 2 : 1;  // the kernels' __launch_bounds__
  const int heads = p->h / p->hd;
  int groups = 0;
  for (int gcount = min(MAX_GROUPS, max_threads / p->h); gcount >= 1; --gcount) {
    if (pass_layout(p->h, heads, p->rbf, gcount, pass).total <= (size_t)smem_max / per_sm) {
      groups = gcount;
      break;
    }
  }
  if (groups == 0) return cudaErrorInvalidValue;  // too wide for one block
  p->groups = groups;
  const int slots = groups * sms * per_sm;
  p->iters = (p->n + slots - 1) / slots;
  *blocks = (p->n + groups * p->iters - 1) / (groups * p->iters);
  *smem = pass_layout(p->h, heads, p->rbf, groups, pass).total;
  return cudaSuccess;
}

Params make_params(const void* idx, int n, int k, int h, int heads, int rbf, const void* q,
                   const void* kx, const void* v, const void* vec0, const void* vec1,
                   const void* vec2, const void* ea, const void* cutm, const void* msk,
                   const void* dir0, const void* dir1, const void* dir2, const void* wk,
                   const void* bk, const void* wv, const void* bv, int act, int attn_act) {
  Params p;
  p.idx = static_cast<const int32_t*>(idx);
  p.n = n;
  p.k = k;
  p.h = h;
  p.hd = h / heads;
  p.rbf = rbf;
  p.q = static_cast<const bf16*>(q);
  p.kx = static_cast<const bf16*>(kx);
  p.v = static_cast<const bf16*>(v);
  p.vec0 = static_cast<const bf16*>(vec0);
  p.vec1 = static_cast<const bf16*>(vec1);
  p.vec2 = static_cast<const bf16*>(vec2);
  p.ea = static_cast<const bf16*>(ea);
  p.cutm = static_cast<const float*>(cutm);
  p.msk = static_cast<const float*>(msk);
  p.dir0 = static_cast<const float*>(dir0);
  p.dir1 = static_cast<const float*>(dir1);
  p.dir2 = static_cast<const float*>(dir2);
  p.wk = static_cast<const bf16*>(wk);
  p.bk = static_cast<const bf16*>(bk);
  p.wv = static_cast<const bf16*>(wv);
  p.bv = static_cast<const bf16*>(bv);
  p.act = act;
  p.attn_act = attn_act;
  p.zq = p.zk = p.zv = p.zvec0 = p.zvec1 = p.zvec2 = p.zea = nullptr;
  p.zcutm = p.zdir0 = p.zdir1 = p.zdir2 = nullptr;
  p.w_all = p.zw_all = p.zbk = p.zbv = nullptr;
  p.groups = p.iters = 0;
  return p;
}

// the Z operands of the second order's passes
void set_z(Params* p, const void* zq, const void* zk, const void* zv, const void* zvec0,
           const void* zvec1, const void* zvec2, const void* zea, const void* zcutm,
           const void* zdir0, const void* zdir1, const void* zdir2, const void* w_all,
           const void* zw_all, const void* zbk, const void* zbv) {
  p->zq = static_cast<const bf16*>(zq);
  p->zk = static_cast<const bf16*>(zk);
  p->zv = static_cast<const bf16*>(zv);
  p->zvec0 = static_cast<const bf16*>(zvec0);
  p->zvec1 = static_cast<const bf16*>(zvec1);
  p->zvec2 = static_cast<const bf16*>(zvec2);
  p->zea = static_cast<const bf16*>(zea);
  p->zcutm = static_cast<const float*>(zcutm);
  p->zdir0 = static_cast<const float*>(zdir0);
  p->zdir1 = static_cast<const float*>(zdir1);
  p->zdir2 = static_cast<const float*>(zdir2);
  p->w_all = static_cast<const bf16*>(w_all);
  p->zw_all = static_cast<const bf16*>(zw_all);
  p->zbk = static_cast<const bf16*>(zbk);
  p->zbv = static_cast<const bf16*>(zbv);
}

// The passes are compiled twice: for silu in both activations (the
// configurations' choice), with the activations' arithmetic folded into the
// per-edge chain, and for any activations read at run time (A = -1).
template <int A>
const void* pass_kernel_as(int pass) {
  switch (pass) {
    case RECV: return reinterpret_cast<const void*>(et_bwd_kernel<A, A>);
    case RECV2: return reinterpret_cast<const void*>(et_bwd2_kernel<A, A>);
    case SRC: return reinterpret_cast<const void*>(et_bwd_src_kernel<A, A>);
    default: return reinterpret_cast<const void*>(et_bwd2_src_kernel<A, A>);
  }
}

bool silu_pair(const Params& p) { return p.act == ACT_SILU && p.attn_act == ACT_SILU; }

const void* pass_kernel(int pass, const Params& p) {
  return silu_pair(p) ? pass_kernel_as<ACT_SILU>(pass) : pass_kernel_as<-1>(pass);
}

#define LAUNCH_PASS(kernel, blocks, threads, smem, stream, ...)                       \
  do {                                                                               \
    if (silu_pair(p))                                                                \
      kernel<ACT_SILU, ACT_SILU><<<blocks, threads, smem, stream>>>(__VA_ARGS__);    \
    else                                                                             \
      kernel<-1, -1><<<blocks, threads, smem, stream>>>(__VA_ARGS__);                \
  } while (0)

#define ET_OPERANDS                                                                               \
  const void *idx, int n, int k, int h, int heads, int rbf, const void *q, const void *kx,        \
      const void *v, const void *vec0, const void *vec1, const void *vec2, const void *ea,        \
      const void *cutm, const void *msk, const void *dir0, const void *dir1, const void *dir2,    \
      const void *wk, const void *bk, const void *wv, const void *bv, int act, int attn_act
#define ET_PARAMS                                                                                 \
  make_params(idx, n, k, h, heads, rbf, q, kx, v, vec0, vec1, vec2, ea, cutm, msk, dir0, dir1,    \
              dir2, wk, bk, wv, bv, act, attn_act)

// plan a pass and allow its shared memory
cudaError_t prepare_pass(Params* p, int pass, size_t* smem, int* blocks) {
  cudaError_t err = plan_pass(p, pass, smem, blocks);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(pass_kernel(pass, *p), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

}  // namespace

extern "C" {

const char* et_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// Returns a cudaError_t (0 on success).  Pointers to absent filters (wk/bk,
// wv/bv) are null.  Launches on `stream` and does not synchronise.
int et_fwd(ET_OPERANDS, void* x_out, void* vec_out, void* stream) {
  if (!valid_shape(n, k, h, heads, rbf)) return (int)cudaErrorInvalidValue;
  Params p = ET_PARAMS;
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = plan_grid(&p, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(et_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  et_fwd_kernel<<<blocks, p.groups * h, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<float*>(x_out), static_cast<float*>(vec_out));
  return (int)cudaGetLastError();
}

// The grid of a receiver pass (kind 1 the backward's, 2 the second
// order's): its block count and row groups per block, which size the
// per-group bias-gradient partials (blocks * groups, 4H).
int et_plan(int kind, int n, int k, int h, int heads, int rbf, int* blocks, int* groups) {
  if (!valid_shape(n, k, h, heads, rbf) || (kind != 1 && kind != 2)) return (int)cudaErrorInvalidValue;
  Params p = make_params(nullptr, n, k, h, heads, rbf, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, nullptr, 0, 0);
  size_t smem = 0;
  cudaError_t err = plan_pass(&p, kind == 1 ? RECV : RECV2, &smem, blocks);
  *groups = p.groups;
  return (int)err;
}

// The backward's receiver pass.  Outputs: dq (N, H) f32, dea (N, K, RBF)
// bf16, dcutm, ddir0..2 (N, K) f32, hs (N*K, 2, heads) bf16 for the source
// pass; dpre (N*K, 4H) bf16 and db_part (blocks * groups, 4H) f32 (et_plan's
// grid) when the weights want a gradient, else both null.
int et_bwd(ET_OPERANDS, const void* ct_x, const void* ct_vec, void* dq, void* dea, void* dcutm,
           void* ddir0, void* ddir1, void* ddir2, void* hs, void* dpre, void* db_part, void* stream) {
  if (!valid_shape(n, k, h, heads, rbf)) return (int)cudaErrorInvalidValue;
  Params p = ET_PARAMS;
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = prepare_pass(&p, RECV, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  LAUNCH_PASS(et_bwd_kernel, blocks, p.groups * h, smem, static_cast<cudaStream_t>(stream),
      p, static_cast<const float*>(ct_x), static_cast<const float*>(ct_vec),
      static_cast<float*>(dq), static_cast<bf16*>(dea), static_cast<float*>(dcutm),
      static_cast<float*>(ddir0), static_cast<float*>(ddir1), static_cast<float*>(ddir2),
      static_cast<bf16*>(hs), static_cast<bf16*>(dpre), static_cast<float*>(db_part));
  return (int)cudaGetLastError();
}

// The backward's source pass: dk (N, H), dv (N, 3H), dvec0..2 (N, H) bf16
// from et_bwd's hs and the transpose permutation perm (N*K) int32.
int et_bwd_src(ET_OPERANDS, const void* perm, const void* ct_x, const void* ct_vec, const void* hs,
               void* dk, void* dv, void* dvec0, void* dvec1, void* dvec2, void* stream) {
  if (!valid_shape(n, k, h, heads, rbf)) return (int)cudaErrorInvalidValue;
  Params p = ET_PARAMS;
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = prepare_pass(&p, SRC, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  LAUNCH_PASS(et_bwd_src_kernel, blocks, p.groups * h, smem, static_cast<cudaStream_t>(stream),
      p, static_cast<const int32_t*>(perm), static_cast<const float*>(ct_x),
      static_cast<const float*>(ct_vec), static_cast<const bf16*>(hs), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<bf16*>(dvec0), static_cast<bf16*>(dvec1),
      static_cast<bf16*>(dvec2));
  return (int)cudaGetLastError();
}

// The second order's receiver pass.  z_* are the cotangents on et_bwd's
// outputs (all non-null: absent ones are zeros), w_all/zw_all the filters
// and their Z as (4H, RBFP) bf16 with zero rows for absent filters and zero
// padding columns.  Outputs: gq (N, H), gea (N, K, RBF) bf16, gcutm, gmsk,
// gdir0..2 (N, K), gctx (N, H), gctvec (N, 3H), hs4 (N*K, 4, heads) for
// the source pass; with filters, bpre and bpret (N*K, 4H) bf16 and db_part
// as for et_bwd (null without filters).  All f32 unless noted.
int et_bwd2(ET_OPERANDS, const void* ct_x, const void* ct_vec, const void* zq, const void* zk,
            const void* zv, const void* zvec0, const void* zvec1, const void* zvec2, const void* zea,
            const void* zcutm, const void* zdir0, const void* zdir1, const void* zdir2,
            const void* w_all, const void* zw_all, const void* zbk, const void* zbv, void* gq,
            void* gea, void* gcutm, void* gmsk, void* gdir0, void* gdir1, void* gdir2, void* gctx,
            void* gctvec, void* hs4, void* bpre, void* bpret, void* db_part, void* stream) {
  if (!valid_shape(n, k, h, heads, rbf) || h > RECV2_MAX_THREADS) return (int)cudaErrorInvalidValue;
  Params p = ET_PARAMS;
  set_z(&p, zq, zk, zv, zvec0, zvec1, zvec2, zea, zcutm, zdir0, zdir1, zdir2, w_all, zw_all, zbk, zbv);
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = prepare_pass(&p, RECV2, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  LAUNCH_PASS(et_bwd2_kernel, blocks, p.groups * h, smem, static_cast<cudaStream_t>(stream),
      p, static_cast<const float*>(ct_x), static_cast<const float*>(ct_vec),
      static_cast<float*>(gq), static_cast<bf16*>(gea), static_cast<float*>(gcutm),
      static_cast<float*>(gmsk), static_cast<float*>(gdir0), static_cast<float*>(gdir1),
      static_cast<float*>(gdir2), static_cast<float*>(gctx), static_cast<float*>(gctvec),
      static_cast<float*>(hs4), static_cast<bf16*>(bpre), static_cast<bf16*>(bpret),
      static_cast<float*>(db_part));
  return (int)cudaGetLastError();
}

// The second order's source pass: gk (N, H), gv (N, 3H), gvec0..2 (N, H)
// bf16 from et_bwd2's hs4 and perm; operands as for et_bwd2.
int et_bwd2_src(ET_OPERANDS, const void* perm, const void* ct_x, const void* ct_vec,
                const void* zq, const void* zk, const void* zv, const void* zvec0,
                const void* zvec1, const void* zvec2, const void* zea, const void* zdir0,
                const void* zdir1, const void* zdir2, const void* w_all, const void* zw_all,
                const void* zbk, const void* zbv, const void* hs4, void* gk, void* gv, void* gvec0,
                void* gvec1, void* gvec2, void* stream) {
  if (!valid_shape(n, k, h, heads, rbf) || h > SRC2_MAX_THREADS) return (int)cudaErrorInvalidValue;
  Params p = ET_PARAMS;
  set_z(&p, zq, zk, zv, zvec0, zvec1, zvec2, zea, nullptr, zdir0, zdir1, zdir2, w_all, zw_all, zbk, zbv);
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = prepare_pass(&p, SRC2, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  LAUNCH_PASS(et_bwd2_src_kernel, blocks, p.groups * h, smem, static_cast<cudaStream_t>(stream),
      p, static_cast<const int32_t*>(perm), static_cast<const float*>(ct_x),
      static_cast<const float*>(ct_vec), static_cast<const float*>(hs4), static_cast<bf16*>(gk),
      static_cast<bf16*>(gv), static_cast<bf16*>(gvec0), static_cast<bf16*>(gvec1),
      static_cast<bf16*>(gvec2));
  return (int)cudaGetLastError();
}

// part (splits, RBFP, F) f32 = per split of per_split edges (a multiple of
// 64), sum of a0^T . b0 (+ a1^T . b1 when npairs is 2): a (ne, RBF) bf16,
// b (ne, F) bf16, F a multiple of 8 (the last block of 128 columns may be
// partial: the Transformer's F = 2H at H = 32 or 96).
int et_dw(const void* a0, const void* b0, const void* a1, const void* b1, int npairs, int ne,
          int rbf, int f, int per_split, void* part, void* stream) {
  if (ne <= 0 || rbf <= 0 || rbf % 2 != 0 || f <= 0 || f % 8 != 0 || per_split <= 0 ||
      per_split % DW_EDGES != 0 || npairs < 1 || npairs > 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(et_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DW_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int rbfp = rbf_pad(rbf);
  const dim3 grid((f + DW_COLS - 1) / DW_COLS, (ne + per_split - 1) / per_split, (rbfp + DW_ROWS - 1) / DW_ROWS);
  et_dw_kernel<<<grid, DW_THREADS, DW_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a0), static_cast<const bf16*>(b0), static_cast<const bf16*>(a1),
      static_cast<const bf16*>(b1), npairs, ne, rbf, rbfp, f, per_split, static_cast<float*>(part));
  return (int)cudaGetLastError();
}

// A kernel's resources at a shape (kind 1 the backward's receiver pass, 2
// the second order's, 3 the backward's source pass, 4 the second order's,
// 5 et_dw_kernel): out = registers a thread, local (spill) bytes a thread,
// threads a block, dynamic shared memory a block, resident blocks an SM.
int et_resources(int kind, int n, int k, int h, int heads, int rbf, int* out) {
  if (!valid_shape(n, k, h, heads, rbf) || kind < 1 || kind > 5) return (int)cudaErrorInvalidValue;
  const void* fn = reinterpret_cast<const void*>(et_dw_kernel);
  size_t smem = DW_SMEM;
  int threads = DW_THREADS;
  cudaError_t err = cudaSuccess;
  if (kind < 5) {
    const int pass = kind == 1 ? RECV : (kind == 2 ? RECV2 : (kind == 3 ? SRC : SRC2));
    Params p = make_params(nullptr, n, k, h, heads, rbf, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, nullptr, 0, 0);
    int blocks = 0;
    p.act = p.attn_act = ACT_SILU;  // the instantiation the configurations run
    err = plan_pass(&p, pass, &smem, &blocks);
    fn = pass_kernel(pass, p);
    threads = p.groups * h;
  }
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
