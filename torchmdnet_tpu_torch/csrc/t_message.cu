// Fused Transformer (TorchMD_T) attention edge phase for Hopper (sm_90a):
// forward, backward and second order.
//
// Replaces the Pallas TPU kernels of torchmdnet_tpu/ops/pallas/t_message.py:
//   t_fwd_kernel  <- _fwd_kernel (:66, launched by _run_fwd at :267)
//   t_bwd_kernel + t_bwd_src_kernel <- _bwd_kernel (:113, launched by
//                    _run_bwd at :304) with its dxw partials and
//                    _table_scatter, the sum of the per-edge source-row
//                    cotangents onto the atoms
//   t_bwd2_kernel + t_bwd2_src_kernel <- _t_bwd2_kernel (:519, launched by
//                    _t_bwd2_op at :668)
// The weight cotangents of both come from et_dw_kernel (et_message.cu), the
// tensor-core reduction of the per-edge filter cotangents over the edges.
// The device helpers are common.cuh's.
//
// What one layer computes, per receiver atom i and neighbor slot k (j = idx[i, k]):
//   dk = act(ea[i,k] . Wdk + bdk)            (H)   distance filters, RBF -> H
//   dv = act(ea[i,k] . Wdv + bdv)            (H)
//   attn = attn_act(per-head sum of q_i * k_j * dk) * cutm[i,k]
//   out[i] = sum_k v_j * dv * attn
// with the JAX kernel's precision: bf16 operands, every elementwise product
// rounded to bf16, the filter pre-activation rounded to bf16 before the bias
// (t_message.py:81-85) and the f32 activation, f32 accumulation of every sum,
// f32 output.  It is the ET edge phase (csrc/et_message.cu) without the
// vector features: two source rows (k, v) instead of five, one filter pair of
// width H each (F = 2H filter columns instead of 4H), one per-edge scalar
// (cutm) instead of five.
//
// What bounds it on an H100 at the DHFR shapes (N = 2496, K = 81, H = 128,
// 8 heads, RBF = 50): the bytes are small (~22 MB forward: ea is 20 MB, the
// source rows 1.3 MB, cutm and idx 1.6 MB), 6.6 us at 3.35 TB/s.  The
// operations are the two filter products, 2 * RBF * 2H flops per edge = 5.2
// GFLOP per forward (5.2 us on the bf16 tensor cores), and ~20 H flops of
// elementwise work per edge (0.5 GFLOP, 7.7 us on the f32 CUDA cores).  So
// the kernel is bound by operations, and in practice by the latency of its
// row gathers and of the per-edge elementwise chain.
//
// The forward (#11) takes the design of ET's forward (#1, et_message.cu's
// header has the measurements behind each point).  What bounded its first
// port on this card (0.42 ms at DHFR, 3 % of its bound) and what this design
// does about each:
//   * no (N, K, F) tensor in device memory, as before: a group of H threads
//     owns receiver rows, one channel per thread, gathers k_j and v_j
//     directly by index and keeps its f32 sum in a register; the per-head
//     sum is a butterfly over the head's lanes of one warp (H/heads a power
//     of two <= 32), no ones-block product;
//   * chunks padded per row: a chunk was KC = 16 slots of one row, so K = 33
//     (training) filled 48 chunk rows and K = 81 (DHFR) 96.  Now a group owns
//     a contiguous range of rows and cuts its flattened slots into chunks of
//     16 that run across rows; each row's sum stays sequential in one
//     thread, in slot order;
//   * block-wide barriers (two __syncthreads a chunk across all of a block's
//     row groups, which ran in lockstep): now a named barrier per group;
//   * an f32 round trip for the filters (wmma -> f32 scratch tile -> one
//     scalar conversion per element): now filter_tile, mma.sync + ldmatrix
//     straight to the bf16 tile, in the k order of the old wmma products, so
//     the filters are bitwise the same;
//   * one edge's chain at a time: now two edges' chains interleave, their
//     head sums paired (group_sum2, the pairs of group_sum, so the same
//     bits), with the next two edges' k/v rows in flight; two values a
//     packed conversion where two are ready; each chunk's cutm rounded once
//     for the group in shared memory;
//   * activations read at run time and 512 threads (4 row groups at H =
//     128, 2 at H = 256): now a silu/silu build beside the run-time one, and
//     up to 768 threads at ptxas's 80 registers: 3 row groups at H = 256,
//     and at H = 128 the count that gives an SM the fewest rows (5 at DHFR,
//     where 6 would leave a fifth of the SMs without a block);
//   * the next chunk's ea rows, ids and cutm are still staged with cp.async
//     while the current chunk computes.
// Every rounding point and every sum's order is the first port's, so the
// output is bitwise its output (tools/time_bwd.py --compare on the card).
//
// The backward (#12) and the second order (#13) take the design of ET's #2
// and #3 (et_message.cu's header has the measurements behind each point):
//   * two passes in gather form, no per-edge (N, K, 2H) source-row buffer.
//     The receiver pass (the row owner) recomputes each edge and writes dq,
//     d ea, d cutm, and per edge and head only what the source side needs:
//     the head-summed d_prod and attn (bf16; the second order: attn, its
//     tangent and the two head-summed reverse seeds, f32).  The source pass
//     owns atom j and walks the K slots of the transpose permutation
//     (perm[j*K + s] = the edge (i, k') with idx[i, k'] = j, in ascending
//     i), gathers that edge's ea row and the receiver's q and ct, recomputes
//     the edge's filters on the tensor cores in the receiver pass's k order,
//     and sums the per-edge k_j and v_j values in f32 in slot order, rounded
//     once: the old buffer's values in its transpose-sum's order, so the
//     backward's dk and dv are bitwise the buffer form's.  Padding and self
//     slots add exact zeros, as in the buffer form;
//   * no weight-gradient partial in device memory: when the weights want a
//     gradient the receiver pass writes each edge's filter cotangents d_pre
//     (2H bf16, the values the old per-chunk partial summed) and sums the
//     bias cotangents per row group; et_dw_kernel reduces ea^T . d_pre;
//   * a named barrier per row group (bar.sync g+1) instead of block-wide
//     barriers, so one group's tensor-core phase overlaps another's per-edge
//     work; mma.sync m16n8k16 with ldmatrix loads, straight to the bf16
//     filter tile (no f32 scratch tile); a group owns a contiguous range of
//     rows (or atoms) and cuts its flattened edges (slots) into chunks of 16
//     that run across rows, the per-row sums kept sequential in one thread
//     (no float atomics: every result is bitwise the same from run to run);
//     the per-edge chain rounds two values at a time with the packed
//     conversion; the passes are compiled for silu in both activations
//     beside a build that reads them at run time; block sizes from ptxas's
//     register counts (RECV_MAX_THREADS etc. below);
//   * the backward's receiver pass takes two edges at a time: their chains
//     interleave, and their head and warp sums share shuffles (group_sum2,
//     the butterfly's pairs, so the same bits), 8-15 % faster than one at
//     a time in the same 96 registers; prefetching the next edge's rows in
//     the second order's passes did not pay (measured);
//   * the second order is the VJP of the backward with respect to (inputs,
//     ct) given cotangents Z on its outputs, written as a dual-number
//     forward (g_ct = J_f(a) . Z) plus its hand-written reverse seeded with
//     ct (g_inputs), as for ET's; its filter products read W from shared
//     memory and Z_W from device memory (L2): both do not fit in shared
//     memory beside two row groups at H = 256.
#include "common.cuh"

namespace {

// Threads a block of each pass (one block an SM), from ptxas's register
// counts: the forward fits 80 registers a thread at 768 threads (3 row
// groups at H = 256, faster than 2 at the training shapes); the backward's
// passes fit 96 registers at 640 threads (5 row groups at H = 128, 2 at H =
// 256); the second order's passes hold about twice the per-edge state: 512
// threads at 128 registers (2 row groups at H = 256).
constexpr int FWD_MAX_THREADS = 768;
constexpr int RECV_MAX_THREADS = 640;
constexpr int SRC_MAX_THREADS = 640;
constexpr int RECV2_MAX_THREADS = 512;
constexpr int SRC2_MAX_THREADS = 512;

// row stride (bf16 elements) of the per-edge filter tile (KC, 2H): 2H + 8,
// so the rows of a tensor-core load start on different banks
__host__ __device__ inline int pre_ld(int h) { return 2 * h + 8; }

struct Params {
  const int32_t* idx;
  int n, k, h, hd, rbf;
  const bf16 *q, *kx, *v, *ea;
  const float* cutm;
  const bf16 *wk, *bk, *wv, *bv;  // wk, wv (H, RBF); null: no filter
  int act, attn_act;
  // second order only: the Z cotangents (tangents of the dual forward)
  const bf16 *zq, *zk, *zv, *zea;
  const float* zcutm;
  const bf16* zw_all;  // Z_W as (2H, RBFP) bf16, zero rows for absent filters
  const bf16 *zbk, *zbv;
  // row groups per block, contiguous rows (atoms) per group
  int groups, iters;
};

// Filter weights into shared memory as (2H, ldw) bf16, one row per filter
// column: rows [0, H) dk, [H, 2H) dv.  Absent filters and the RBF padding
// are zeros.
__device__ void load_weights(const Params& p, bf16* w_s) {
  const int ldw = w_ld(p.rbf);
  const int total = 2 * p.h * ldw;
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

// the source-row values (or their Z tangents) one thread reads for one edge
struct Src {
  float k, v;
};

__device__ __forceinline__ Src load_src(const bf16* kx, const bf16* v, int j, int h, int hh) {
  const size_t row = (size_t)j * h + hh;
  return Src{ldb(kx + row), ldb(v + row)};
}

// ---------------------------------------------------------------------------
// The forward (#11), and the backward (#12) and second order (#13):
// receiver passes and source passes (the weight-gradient reduction is
// et_message.cu's et_dw_kernel).

enum Pass { RECV = 0, RECV2 = 1, SRC = 2, SRC2 = 3, FWD = 4 };

// One pass's shared memory: the filter weights W, then one slice per row
// group: two staging buffers of ea rows (and z_ea), the
// (KC, 2H) bf16 filter tile (and the tangent tile), two buffers of edge ids
// (and the source pass's receiver rows), of cutm (and z_cutm) and of the
// source pass's per-edge head scalars, and the receiver passes' warp
// partials of the cutm cotangent.
struct GLayout {
  size_t base, stride, total;
  size_t ea, zea, pre, pret, ids, sc, hs, red;
  int nsc, hsw;  // edge scalars staged; 4-byte words a staged head-scalar row
};

__host__ __device__ inline GLayout pass_layout(int h, int heads, int rbf, int groups, int pass) {
  GLayout s;
  const bool dual = pass == RECV2 || pass == SRC2;
  const size_t ea_bytes = (size_t)2 * KC * w_ld(rbf) * sizeof(bf16);
  const size_t tile_bytes = (size_t)KC * pre_ld(h) * sizeof(bf16);
  s.base = align32((size_t)2 * h * w_ld(rbf) * sizeof(bf16));
  s.nsc = pass == RECV || pass == FWD ? 1 : (pass == RECV2 ? 2 : 0);  // cutm, then z_cutm
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
  if (pass == RECV || pass == RECV2) o = align32(o + (size_t)KC * (h / 32) * sizeof(float));
  s.stride = o;
  s.total = s.base + (size_t)groups * o;
  return s;
}

// Forward and receiver pass: start copying the kn edges e0.. (contiguous:
// ea rows and z_ea, neighbor ids, cutm and z_cutm) into a staging buffer.
// Called by all H threads of a group.
__device__ void stage_edges(const Params& p, size_t e0, int kn, int hh, int nw, int nsc, bf16* ea_s,
                            bf16* zea_s, int* ids_s, float* sc_s) {
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
    __pipeline_memcpy_async(sc_s + hh, p.cutm + e, 4);
    if (nsc > 1) __pipeline_memcpy_async(sc_s + KC + hh, p.zcutm + e, 4);
  }
  __pipeline_commit();
}

// Source pass: start copying the kn slots whose edges are pv (lane s of
// every warp holds perm of slot s): the edges' ea rows (and z_ea) and their
// hsw-word rows of per-edge head scalars; the edge ids and receiver rows go
// to ids_s.  Called by all H threads of a group.
__device__ void stage_slots(const Params& p, int pv, int kn, int hh, int nw, int hsw, const float* hs,
                            bf16* ea_s, bf16* zea_s, int* ids_s, float* hs_s) {
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
  }
  __pipeline_commit();
}

// The two filters of an edge for this thread's channel, from the tile's
// bf16 accumulators a[0] (dk) and a[H] (dv): pre-activations bf16(acc + b)
// and values bf16(act(pre)) (the first port's arithmetic, rounded two at a
// time).  Absent filters give values the caller ignores.
__device__ __forceinline__ void edge_filters(int act, const bf16* a, int H, float bk, float bv, float pre[2],
                                             float val[2]) {
  pre[0] = ldb(a) + bk;
  pre[1] = ldb(a + H) + bv;
  bfr2(pre[0], pre[1]);
  val[0] = act_fn(act, pre[0]);
  val[1] = act_fn(act, pre[1]);
  bfr2(val[0], val[1]);
}

// The forward (#11): per receiver row i, out[i] (see the header), the
// group's rows walked in chunks of KC slots that run across rows, each row's
// sum sequential in its thread.
template <int ACT, int ATT>
__global__ void __launch_bounds__(FWD_MAX_THREADS, 1)
    t_fwd_kernel(Params p, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  // the activations: compile-time constants where the instantiation names them
  const int act = ACT >= 0 ? ACT : p.act, attn_act = ATT >= 0 ? ATT : p.attn_act;
  const int H = p.h, F = 2 * H, ldp = pre_ld(H), ldw = w_ld(p.rbf), rbfp = rbf_pad(p.rbf);
  const int g = threadIdx.x / H, hh = threadIdx.x % H;
  const int nw = H / 32, warp = hh / 32, lane = hh % 32;
  const GLayout L = pass_layout(H, H / p.hd, p.rbf, p.groups, FWD);
  const bf16* w_s = reinterpret_cast<const bf16*>(smem);
  unsigned char* gs = smem + L.base + g * L.stride;
  bf16* ea_buf = reinterpret_cast<bf16*>(gs + L.ea);
  bf16* pre_s = reinterpret_cast<bf16*>(gs + L.pre);
  int* ids_buf = reinterpret_cast<int*>(gs + L.ids);
  float* sc_buf = reinterpret_cast<float*>(gs + L.sc);
  const bool has_dk = p.wk != nullptr, has_dv = p.wv != nullptr, has_w = has_dk || has_dv;

  for (int e = hh; e < 2 * KC * ldw; e += H) ea_buf[e] = __float2bfloat16_rn(0.0f);
  load_weights(p, reinterpret_cast<bf16*>(smem));
  const float bk = has_dk ? ldb(p.bk + hh) : 0.0f;
  const float bv = has_dv ? ldb(p.bv + hh) : 0.0f;
  __syncthreads();  // weights and zero padding in place before any copy lands

  const int r0 = ((int)blockIdx.x * p.groups + g) * p.iters;
  const int r1 = min(r0 + p.iters, p.n);
  if (r0 >= r1) return;  // the same for the whole group
  const size_t eb = (size_t)r0 * p.k;
  const int ne = (r1 - r0) * p.k, nch = (ne + KC - 1) / KC;
  stage_edges(p, eb, min(KC, ne), hh, nw, 1, ea_buf, nullptr, ids_buf, sc_buf);
  int i = r0, slot = 0;
  float qi = ldb(p.q + (size_t)i * H + hh);
  float acc = 0.0f;
  for (int ch = 0; ch < nch; ++ch) {
    const int buf = ch & 1;
    const int kn = min(KC, ne - ch * KC);
    const int* idx_s = ids_buf + buf * 2 * KC;
    const float* sc_s = sc_buf + buf * KC;
    __pipeline_wait_prior(0);
    group_sync(g, H);  // this chunk has landed; the last one is done with the other buffers
    if (ch + 1 < nch)
      stage_edges(p, eb + (size_t)(ch + 1) * KC, min(KC, ne - (ch + 1) * KC), hh, nw, 1,
                  ea_buf + (buf ^ 1) * KC * ldw, nullptr, ids_buf + (buf ^ 1) * 2 * KC, sc_buf + (buf ^ 1) * KC);
    round_scalars(sc_buf + buf * KC, 1, hh, H);  // cutm
    if (has_w)
      filter_tile(1, ea_buf + buf * KC * ldw, w_s, nullptr, nullptr, nullptr, ldw, rbfp, F, pre_s, ldp, warp, nw,
                  lane);
    group_sync(g, H);  // the filter tile and the rounded cutm are complete
    // two edges at a time (a = kc, b = kc + 1): their chains interleave and
    // their head sums pair (group_sum2, group_sum's pairs, so the same bits);
    // the next two edges' source rows are in flight meanwhile
    Src cur[2] = {load_src(p.kx, p.v, idx_s[0], H, hh), load_src(p.kx, p.v, idx_s[min(1, kn - 1)], H, hh)};
    for (int kc = 0; kc < kn; kc += 2) {
      const bool two = kc + 1 < kn;  // the same for the whole group
      Src nxt[2] = {cur[0], cur[1]};
      if (kc + 2 < kn) nxt[0] = load_src(p.kx, p.v, idx_s[kc + 2], H, hh);
      if (kc + 3 < kn) nxt[1] = load_src(p.kx, p.v, idx_s[kc + 3], H, hh);
      // the receiver rows: edge a opens row i + 1 when row i is full, edge b
      // the row after a's
      const bool new_a = slot == p.k, new_b = two && (new_a ? 1 : slot + 1) == p.k;
      const float qa = new_a ? ldb(p.q + (size_t)(i + 1) * H + hh) : qi;
      const float qb = new_b ? ldb(p.q + (size_t)(i + 1 + new_a) * H + hh) : qa;
      float vdv[2], prod[2], dk[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        float pre[2], val[2];
        edge_filters(act, pre_s + (kc + x) * ldp + hh, H, bk, bv, pre, val);
        dk[x] = has_dk ? val[0] : 1.0f;
        // bf16(v * dv) is v where dv is absent (1)
        vdv[x] = cur[x].v * (has_dv ? val[1] : 1.0f);
        prod[x] = (x ? qb : qa) * cur[x].k;
      }
      bfr2(vdv[0], vdv[1]);
      bfr2(prod[0], prod[1]);
      if (has_dk) {
        prod[0] *= dk[0];
        prod[1] *= dk[1];
        bfr2(prod[0], prod[1]);
      }
      group_sum2(prod[0], prod[1], p.hd, lane);
      bfr2(prod[0], prod[1]);  // the attention pre-activations
      float a_act[2] = {act_fn(attn_act, prod[0]), act_fn(attn_act, prod[1])};
      bfr2(a_act[0], a_act[1]);
      float attn[2] = {a_act[0] * sc_s[kc], a_act[1] * sc_s[kc + 1]};
      bfr2(attn[0], attn[1]);
      float msg[2] = {vdv[0] * attn[0], vdv[1] * attn[1]};
      bfr2(msg[0], msg[1]);
      // the sums, in slot order
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        if (x == 1 && !two) break;
        if (x ? new_b : new_a) {  // the next receiver row
          out[(size_t)i * H + hh] = acc;
          acc = 0.0f;
          ++i;
          slot = 0;
        }
        ++slot;
        acc += msg[x];
      }
      qi = two ? qb : qa;
      cur[0] = nxt[0];
      cur[1] = nxt[1];
    }
  }
  out[(size_t)i * H + hh] = acc;
}

// The second order's dual filters of an edge for this thread's channel,
// from the filter tile a and the tangent tile at: f = bf16(act(pre)), its
// first and second derivatives f1, f2 at pre = bf16(acc + b), and the
// tangent pre-activation pt = bf16(acc' + z_b).  Absent filters give f = 1
// and zeros.
__device__ __forceinline__ void dual_filters(int act, const bf16* a, const bf16* at, int H, float bk,
                                             float zbk, float bv, float zbv, bool has_dk, bool has_dv,
                                             float f[2], float f1[2], float f2[2], float pt[2]) {
  float x[2] = {ldb(a) + bk, ldb(a + H) + bv};
  pt[0] = ldb(at) + zbk;
  pt[1] = ldb(at + H) + zbv;
  bfr2(x[0], x[1]);
  bfr2(pt[0], pt[1]);
#pragma unroll
  for (int c = 0; c < 2; ++c) act3(act, x[c], &f[c], &f1[c], &f2[c]);
  bfr2(f[0], f[1]);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (c == 0 ? has_dk : has_dv) continue;
    f[c] = 1.0f;
    f1[c] = f2[c] = pt[c] = 0.0f;
  }
}

// the receiver row values the source passes read: q and ct (rounded to bf16)
struct Recv {
  float q, ct;
};

__device__ __forceinline__ Recv load_recv(const Params& p, const float* ct, int i, int hh) {
  const size_t row = (size_t)i * p.h + hh;
  return Recv{ldb(p.q + row), bfr(ct[row])};
}

// The backward's receiver pass (#12): per edge the forward recomputed and
// its reverse on the receiver's side: dq, d ea, d cutm, the filter
// cotangents d_pre (written per edge when dpre is not null, for
// et_dw_kernel; the bias cotangents summed per group into db_part), and per
// edge and head the bf16 d_prod and attn (hs, (E, 2, heads)) that the source
// pass needs.
template <int ACT, int ATT>
__global__ void __launch_bounds__(RECV_MAX_THREADS, 1)
    t_bwd_kernel(Params p, const float* __restrict__ ct, float* __restrict__ dq, bf16* __restrict__ dea,
                 float* __restrict__ dcutm, bf16* __restrict__ hs, bf16* __restrict__ dpre,
                 float* __restrict__ db_part) {
  extern __shared__ __align__(128) unsigned char smem[];
  // the activations: compile-time constants where the instantiation names them
  const int act = ACT >= 0 ? ACT : p.act, attn_act = ATT >= 0 ? ATT : p.attn_act;
  const int H = p.h, F = 2 * H, ldp = pre_ld(H), ldw = w_ld(p.rbf), rbfp = rbf_pad(p.rbf);
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
  float db_acc[2] = {0.0f, 0.0f};  // this thread's filter columns

  for (int e = hh; e < 2 * KC * ldw; e += H) ea_buf[e] = __float2bfloat16_rn(0.0f);
  load_weights(p, reinterpret_cast<bf16*>(smem));
  const float bk = has_dk ? ldb(p.bk + hh) : 0.0f;
  const float bv = has_dv ? ldb(p.bv + hh) : 0.0f;
  __syncthreads();  // weights and zero padding in place before any copy lands

  const int r0 = ((int)blockIdx.x * p.groups + g) * p.iters;
  const int r1 = min(r0 + p.iters, p.n);
  if (r0 < r1) {  // the same for the whole group
    const size_t eb = (size_t)r0 * p.k;
    const int ne = (r1 - r0) * p.k, nch = (ne + KC - 1) / KC;
    stage_edges(p, eb, min(KC, ne), hh, nw, 1, ea_buf, nullptr, ids_buf, sc_buf);
    int i = r0, slot = 0;
    Recv rc = load_recv(p, ct, i, hh);
    float dq_acc = 0.0f;
    for (int ch = 0; ch < nch; ++ch) {
      const int buf = ch & 1;
      const size_t e0 = eb + (size_t)ch * KC;
      const int kn = min(KC, ne - ch * KC);
      const bf16* ea_s = ea_buf + buf * KC * ldw;
      const int* idx_s = ids_buf + buf * 2 * KC;
      const float* sc_s = sc_buf + buf * KC;
      __pipeline_wait_prior(0);
      group_sync(g, H);  // this chunk has landed; the last one is done with the other buffers
      if (ch + 1 < nch)
        stage_edges(p, e0 + KC, min(KC, ne - (ch + 1) * KC), hh, nw, 1, ea_buf + (buf ^ 1) * KC * ldw,
                    nullptr, ids_buf + (buf ^ 1) * 2 * KC, sc_buf + (buf ^ 1) * KC);
      round_scalars(sc_buf + buf * KC, 1, hh, H);  // cutm
      if (has_w) filter_tile(1, ea_s, w_s, nullptr, nullptr, nullptr, ldw, rbfp, F, pre_s, ldp, warp, nw, lane);
      group_sync(g, H);  // the filter tile and the rounded cutm are complete
      // two edges at a time (a = kc, b = kc + 1): their chains interleave,
      // and their head and warp sums share shuffles (group_sum2, the same
      // pairs as one sum at a time, so the same bits)
      Src s0 = load_src(p.kx, p.v, idx_s[0], H, hh);
      Src s1 = kn > 1 ? load_src(p.kx, p.v, idx_s[1], H, hh) : s0;
      for (int kc = 0; kc < kn; kc += 2) {
        const bool two = kc + 1 < kn;
        Src n0 = s0, n1 = s1;  // the next pair's source rows, in flight while this pair computes
        if (kc + 2 < kn) n0 = load_src(p.kx, p.v, idx_s[kc + 2], H, hh);
        if (kc + 3 < kn) n1 = load_src(p.kx, p.v, idx_s[kc + 3], H, hh);
        if (slot == p.k) {  // edge a starts the next receiver row
          dq[(size_t)i * H + hh] = dq_acc;
          dq_acc = 0.0f;
          rc = load_recv(p, ct, ++i, hh);
          slot = 0;
        }
        ++slot;
        const bool b_row = two && slot == p.k;  // edge b starts the next receiver row
        const Recv r[2] = {rc, b_row ? load_recv(p, ct, i + 1, hh) : rc};
        const Src x[2] = {s0, s1};
        // ---- recompute the forward edges (the first port's rounding points,
        // two roundings per conversion where two values are ready)
        bf16* a[2] = {pre_s + kc * ldp + hh, pre_s + (kc + 1) * ldp + hh};
        float pre[2][2], dk[2], dv[2], vdv[2], prod[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float val[2];
          edge_filters(act, a[u], H, bk, bv, pre[u], val);
          dk[u] = has_dk ? val[0] : 1.0f;
          dv[u] = has_dv ? val[1] : 1.0f;
          // bf16(v * dv) is v where dv is absent (1), bf16(bf16(q k) * dk) is bf16(q k)
          float qk = r[u].q * x[u].k;
          vdv[u] = x[u].v * dv[u];
          bfr2(vdv[u], qk);
          prod[u] = qk * dk[u];
        }
        bfr2(prod[0], prod[1]);
        float pre_a[2] = {prod[0], prod[1]};
        group_sum2(pre_a[0], pre_a[1], p.hd, lane);
        bfr2(pre_a[0], pre_a[1]);
        float a_act[2], attn[2], d_vdv[2], r_arg[2], d_prea[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float da = dact_fn(attn_act, pre_a[u]);
          a_act[u] = act_fn(attn_act, pre_a[u]);
          bfr2(a_act[u], da);
          const float cm = sc_s[kc + u];
          attn[u] = bfr(a_act[u] * cm);
          // ---- backward through the edge (the receiver's side)
          float d_attn = r[u].ct * vdv[u];
          d_vdv[u] = r[u].ct * attn[u];
          bfr2(d_attn, d_vdv[u]);
          float t_cm = da * cm;
          r_arg[u] = a_act[u] * d_attn;
          bfr2(t_cm, r_arg[u]);
          d_prea[u] = t_cm * d_attn;
        }
        bfr2(d_prea[0], d_prea[1]);
        group_sum2(r_arg[0], r_arg[1], 32, lane);  // the warp's partials of d cutm
        group_sum2(d_prea[0], d_prea[1], p.hd, lane);
        bfr2(d_prea[0], d_prea[1]);  // d_prod of each edge
        if (lane == 0) {
          red_s[kc * nw + warp] = r_arg[0];
          if (two) red_s[(kc + 1) * nw + warp] = r_arg[1];
        }
        float t[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float d_prod = d_prea[u];
          float dqk = d_prod * r[u].q, pk = d_prod * x[u].k;
          bfr2(dqk, pk);
          float d_dk = dqk * x[u].k;
          t[u] = pk * dk[u];  // bf16(pk * 1) is pk where dk is absent
          bfr2(d_dk, t[u]);
          if (u == 0 || two) {
            const size_t e = e0 + kc + u;
            if (hh % p.hd == 0) {  // the source pass's per-edge head scalars
              hs[e * 2 * heads + head] = bf16_exact(d_prod);
              hs[e * 2 * heads + heads + head] = bf16_exact(attn[u]);
            }
          }
          // the filter cotangents d_pre = bf16(bf16(act'(pre)) * bf16(d_filter))
          float dd[2] = {dact_fn(act, pre[u][0]), dact_fn(act, pre[u][1])};
          bfr2(dd[0], dd[1]);
          const float dvv = bfr(d_vdv[u] * x[u].v);
          float d_pre[2] = {dd[0] * d_dk, dd[1] * dvv};
          bfr2(d_pre[0], d_pre[1]);
          if (!has_dk) d_pre[0] = 0.0f;
          if (!has_dv) d_pre[1] = 0.0f;
          if (u == 0 || two) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              // this thread read a[u][c * H] above: overwrite it with d_pre
              a[u][c * H] = bf16_exact(d_pre[c]);
              db_acc[c] += d_pre[c];
            }
          }
        }
        dq_acc += t[0];
        if (two) {
          if (b_row) {
            dq[(size_t)i * H + hh] = dq_acc;
            dq_acc = 0.0f;
            rc = r[1];
            ++i;
            slot = 0;
          }
          ++slot;
          dq_acc += t[1];
        }
        s0 = n0;
        s1 = n1;
      }
      group_sync(g, H);  // d_pre and the warp partials are complete
      // the cutm cotangent: a fixed-order sum of the warp partials
      for (int s = hh; s < kn; s += H) {
        float sum = 0.0f;
        for (int w = 0; w < nw; ++w) sum += red_s[s * nw + w];
        dcutm[e0 + s] = sum;
      }
      if (has_w) {
        dea_tile(1, pre_s, w_s, nullptr, nullptr, nullptr, F, ldp, ldw, p.rbf, rbfp, dea, e0, kn, warp, nw, lane);
        if (dpre) store_tile(pre_s, ldp, F, dpre, e0, kn, hh, H);
      } else {
        for (int x = hh; x < kn * p.rbf; x += H) dea[e0 * p.rbf + x] = __float2bfloat16_rn(0.0f);
      }
    }
    dq[(size_t)i * H + hh] = dq_acc;
  }
  if (dpre) {
#pragma unroll
    for (int c = 0; c < 2; ++c) db_part[((size_t)blockIdx.x * p.groups + g) * F + c * H + hh] = db_acc[c];
  }
}

// The backward's source pass (#12): per atom j, the source-row cotangents
// d k_j = sum of bf16(bf16(d_prod q_i) dk) and d v_j = sum of bf16(bf16(ct_i
// attn) dv) over the K slots s of perm (the edges (i, k') with idx[i, k'] =
// j), from the edge's recomputed filters, the receiver's q and ct, and hs's
// d_prod and attn.  f32 sums in slot order, rounded once.
template <int ACT, int ATT>
__global__ void __launch_bounds__(SRC_MAX_THREADS, 1)
    t_bwd_src_kernel(Params p, const int32_t* __restrict__ perm, const float* __restrict__ ct,
                     const bf16* __restrict__ hs, bf16* __restrict__ dk_out, bf16* __restrict__ dv_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int act = ACT >= 0 ? ACT : p.act;
  const int H = p.h, F = 2 * H, ldp = pre_ld(H), ldw = w_ld(p.rbf), rbfp = rbf_pad(p.rbf);
  const int g = threadIdx.x / H, hh = threadIdx.x % H;
  const int nw = H / 32, warp = hh / 32, lane = hh % 32;
  const int heads = H / p.hd, head = hh / p.hd;
  const GLayout L = pass_layout(H, heads, p.rbf, p.groups, SRC);
  const bf16* w_s = reinterpret_cast<const bf16*>(smem);
  unsigned char* gs = smem + L.base + g * L.stride;
  bf16* ea_buf = reinterpret_cast<bf16*>(gs + L.ea);
  bf16* pre_s = reinterpret_cast<bf16*>(gs + L.pre);
  int* ids_buf = reinterpret_cast<int*>(gs + L.ids);
  float* hs_buf = reinterpret_cast<float*>(gs + L.hs);
  const bool has_dk = p.wk != nullptr, has_dv = p.wv != nullptr, has_w = has_dk || has_dv;
  const float* hs_words = reinterpret_cast<const float*>(hs);  // (E, heads) words of two bf16

  for (int e = hh; e < 2 * KC * ldw; e += H) ea_buf[e] = __float2bfloat16_rn(0.0f);
  load_weights(p, reinterpret_cast<bf16*>(smem));
  const float bk = has_dk ? ldb(p.bk + hh) : 0.0f;
  const float bv = has_dv ? ldb(p.bv + hh) : 0.0f;
  __syncthreads();

  const int a0 = ((int)blockIdx.x * p.groups + g) * p.iters;
  const int a1 = min(a0 + p.iters, p.n);
  if (a0 >= a1) return;  // the same for the whole group
  const size_t sb = (size_t)a0 * p.k;
  const int ns = (a1 - a0) * p.k, nch = (ns + KC - 1) / KC;
  // perm of the next chunks, lane s holding slot s: one chunk ahead of its staging
  int pv = lane < min(KC, ns) ? __ldg(perm + sb + lane) : 0;
  stage_slots(p, pv, min(KC, ns), hh, nw, heads, hs_words, ea_buf, nullptr, ids_buf, hs_buf);
  pv = (nch > 1 && lane < min(KC, ns - KC)) ? __ldg(perm + sb + KC + lane) : 0;
  int j = a0, slot = 0;
  float acc_k = 0.0f, acc_v = 0.0f;
  for (int ch = 0; ch < nch; ++ch) {
    const int buf = ch & 1;
    const int kn = min(KC, ns - ch * KC);
    const int* eid_s = ids_buf + buf * 2 * KC;
    const bf16* hs_s = reinterpret_cast<const bf16*>(hs_buf + buf * heads * KC);
    __pipeline_wait_prior(0);
    group_sync(g, H);  // this chunk has landed; the last one is done with the other buffers
    if (ch + 1 < nch) {
      stage_slots(p, pv, min(KC, ns - (ch + 1) * KC), hh, nw, heads, hs_words, ea_buf + (buf ^ 1) * KC * ldw,
                  nullptr, ids_buf + (buf ^ 1) * 2 * KC, hs_buf + (buf ^ 1) * heads * KC);
      const int rest = ns - (ch + 2) * KC;
      pv = (rest > 0 && lane < min(KC, rest)) ? __ldg(perm + sb + (size_t)(ch + 2) * KC + lane) : 0;
    }
    if (has_w)
      filter_tile(1, ea_buf + buf * KC * ldw, w_s, nullptr, nullptr, nullptr, ldw, rbfp, F, pre_s, ldp, warp,
                  nw, lane);
    group_sync(g, H);  // the filter tile and the chunk's ids are complete
    Recv cur = load_recv(p, ct, eid_s[KC], hh);
    for (int kc = 0; kc < kn; ++kc) {
      Recv nxt = cur;
      if (kc + 1 < kn) nxt = load_recv(p, ct, eid_s[KC + kc + 1], hh);
      if (slot == p.k) {  // the next source atom
        dk_out[(size_t)j * H + hh] = __float2bfloat16_rn(acc_k);
        dv_out[(size_t)j * H + hh] = __float2bfloat16_rn(acc_v);
        acc_k = acc_v = 0.0f;
        ++j;
        slot = 0;
      }
      ++slot;
      float pre[2], val[2];
      edge_filters(act, pre_s + kc * ldp + hh, H, bk, bv, pre, val);
      const float dk = has_dk ? val[0] : 1.0f, dv = has_dv ? val[1] : 1.0f;
      const float d_prod = __bfloat162float(hs_s[kc * 2 * heads + head]);
      const float attn = __bfloat162float(hs_s[kc * 2 * heads + heads + head]);
      // the receiver pass's rounding points: bf16(x * 1) is x where a filter is absent
      float qk = d_prod * cur.q, d_vdv = cur.ct * attn;
      bfr2(qk, d_vdv);
      float d_k = qk * dk, d_v = d_vdv * dv;
      bfr2(d_k, d_v);
      acc_k += d_k;
      acc_v += d_v;
      cur = nxt;
    }
  }
  dk_out[(size_t)j * H + hh] = __float2bfloat16_rn(acc_k);
  dv_out[(size_t)j * H + hh] = __float2bfloat16_rn(acc_v);
}

// The second order's receiver pass (#13): the VJP of the backward with
// respect to (inputs, ct) given the cotangents Z on its outputs (see the
// header).  Per edge, with primes for tangents (the Z values):
//   pre' = z_ea.W + ea.Z_W + z_b, dk' = act'(pre_k) pre_k', prod' = z_q k dk
//   + q z_k dk + q k dk', pa' = head sum of prod', attn' = attn_act'(pa) pa'
//   cutm + attn_act(pa) z_cutm, vdv' = z_v dv + v dv',
//   out' += vdv' attn + vdv attn'
// g_ct = out' summed over the slots; g_inputs is the reverse pass of these
// lines seeded with ct on out'.  This pass computes the receiver's side (g
// q, g ea, g cutm, g_ct, the filter cotangents bpre and bpre' per edge for
// et_dw_kernel and the bias sums per group); per edge and head it writes
// attn, attn', and the head sums of the reverse seeds of prod' and prod
// (hs4, (E, 4, heads) f32) for the source pass.
template <int ACT, int ATT>
__global__ void __launch_bounds__(RECV2_MAX_THREADS, 1)
    t_bwd2_kernel(Params p, const float* __restrict__ ct, float* __restrict__ gq, bf16* __restrict__ gea,
                  float* __restrict__ gcutm, float* __restrict__ gct, float* __restrict__ hs4,
                  bf16* __restrict__ bpre_out, bf16* __restrict__ bpret_out, float* __restrict__ db_part) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int act = ACT >= 0 ? ACT : p.act, attn_act = ATT >= 0 ? ATT : p.attn_act;
  const int H = p.h, F = 2 * H, ldp = pre_ld(H), ldw = w_ld(p.rbf), rbfp = rbf_pad(p.rbf);
  const int g = threadIdx.x / H, hh = threadIdx.x % H;
  const int nw = H / 32, warp = hh / 32, lane = hh % 32;
  const int heads = H / p.hd, head = hh / p.hd;
  const GLayout L = pass_layout(H, heads, p.rbf, p.groups, RECV2);
  const bf16* w_s = reinterpret_cast<const bf16*>(smem);
  unsigned char* gs = smem + L.base + g * L.stride;
  bf16* ea_buf = reinterpret_cast<bf16*>(gs + L.ea);
  bf16* zea_buf = reinterpret_cast<bf16*>(gs + L.zea);
  bf16* pre_s = reinterpret_cast<bf16*>(gs + L.pre);    // pre, then its cotangent
  bf16* pret_s = reinterpret_cast<bf16*>(gs + L.pret);  // pre', then its cotangent
  int* ids_buf = reinterpret_cast<int*>(gs + L.ids);
  float* sc_buf = reinterpret_cast<float*>(gs + L.sc);
  float* red_s = reinterpret_cast<float*>(gs + L.red);
  const bool has_dk = p.wk != nullptr, has_dv = p.wv != nullptr, has_w = has_dk || has_dv;
  float db_acc[2] = {0.0f, 0.0f};

  for (int e = hh; e < 2 * KC * ldw; e += H) {
    ea_buf[e] = __float2bfloat16_rn(0.0f);
    zea_buf[e] = __float2bfloat16_rn(0.0f);
  }
  load_weights(p, reinterpret_cast<bf16*>(smem));
  float bk = 0.0f, zbk = 0.0f, bv = 0.0f, zbv = 0.0f;
  if (has_dk) {
    bk = ldb(p.bk + hh);
    zbk = ldb(p.zbk + hh);
  }
  if (has_dv) {
    bv = ldb(p.bv + hh);
    zbv = ldb(p.zbv + hh);
  }
  __syncthreads();  // zero padding in place before any copy lands

  const int r0 = ((int)blockIdx.x * p.groups + g) * p.iters;
  const int r1 = min(r0 + p.iters, p.n);
  if (r0 < r1) {
    const size_t eb = (size_t)r0 * p.k;
    const int ne = (r1 - r0) * p.k, nch = (ne + KC - 1) / KC;
    stage_edges(p, eb, min(KC, ne), hh, nw, 2, ea_buf, zea_buf, ids_buf, sc_buf);
    int i = r0, slot = 0;
    float qi = 0.0f, zqi = 0.0f, cti = 0.0f;
    float gq_acc = 0.0f, gct_acc = 0.0f;
    for (int ch = 0; ch < nch; ++ch) {
      const int buf = ch & 1;
      const size_t e0 = eb + (size_t)ch * KC;
      const int kn = min(KC, ne - ch * KC);
      const bf16* ea_s = ea_buf + buf * KC * ldw;
      const bf16* zea_s = zea_buf + buf * KC * ldw;
      const int* idx_s = ids_buf + buf * 2 * KC;
      const float* sc_s = sc_buf + buf * 2 * KC;
      __pipeline_wait_prior(0);
      group_sync(g, H);  // this chunk has landed; the last one is done with the other buffers
      if (ch + 1 < nch)
        stage_edges(p, e0 + KC, min(KC, ne - (ch + 1) * KC), hh, nw, 2, ea_buf + (buf ^ 1) * KC * ldw,
                    zea_buf + (buf ^ 1) * KC * ldw, ids_buf + (buf ^ 1) * 2 * KC, sc_buf + (buf ^ 1) * 2 * KC);
      round_scalars(sc_buf + buf * 2 * KC, 1, hh, H);  // cutm (not z_cutm)
      if (has_w) {
        filter_tile(1, ea_s, w_s, nullptr, nullptr, nullptr, ldw, rbfp, F, pre_s, ldp, warp, nw, lane);
        filter_tile(2, zea_s, w_s, nullptr, ea_s, p.zw_all, ldw, rbfp, F, pret_s, ldp, warp, nw, lane);
      }
      group_sync(g, H);  // the filter tiles and the rounded cutm are complete
      for (int kc = 0; kc < kn; ++kc) {
        if (slot == 0 || slot == p.k) {  // a new receiver row
          if (slot == p.k) {
            gq[(size_t)i * H + hh] = gq_acc;
            gct[(size_t)i * H + hh] = gct_acc;
            gq_acc = gct_acc = 0.0f;
            ++i;
          }
          qi = ldb(p.q + (size_t)i * H + hh);
          zqi = ldb(p.zq + (size_t)i * H + hh);
          cti = bfr(ct[(size_t)i * H + hh]);
          slot = 0;
        }
        ++slot;
        const int j = idx_s[kc];
        const Src x = load_src(p.kx, p.v, j, H, hh);
        const Src z = load_src(p.zk, p.zv, j, H, hh);
        const size_t e = e0 + kc;
        const float cm = sc_s[kc], zcm = sc_s[KC + kc];
        // ---- the dual forward of the edge
        bf16* a = pre_s + kc * ldp + hh;
        bf16* at = pret_s + kc * ldp + hh;
        float f[2], f1[2], f2[2], pt[2];
        dual_filters(act, a, at, H, bk, zbk, bv, zbv, has_dk, has_dv, f, f1, f2, pt);
        const float dk = f[0], dk1 = f1[0], dk2 = f2[0], pkt = pt[0], dkt = dk1 * pkt;
        const float dv = f[1], dv1 = f1[1], dv2 = f2[1], pvt = pt[1], dvt = dv1 * pvt;
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
        const float vdv = has_dv ? bfr(x.v * dv) : x.v;
        const float vdvt = z.v * dv + x.v * dvt;
        gct_acc += vdvt * attn + vdv * attnt;
        // ---- its reverse, seeded with ct on the tangent output
        const float b_vdvt = cti * attn, b_vdv = cti * attnt;
        const float b_attnt = cti * vdv, b_attn = cti * vdvt;
        const float r_cm = group_sum(b_attnt * a1 * pat + b_attn * aa, 32);
        if (lane == 0) red_s[kc * nw + warp] = r_cm;
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
        float bpre[2] = {0.0f, 0.0f}, bpret[2] = {0.0f, 0.0f};
        if (has_dv) {
          const float b_dv = b_vdvt * z.v + b_vdv * x.v;
          const float b_dvt = b_vdvt * x.v;
          bpret[1] = b_dvt * dv1;
          bpre[1] = b_dvt * dv2 * pvt + b_dv * dv1;
        }
        gq_acc += b_prodt * (z.k * dk + x.k * dkt) + b_prod * x.k * dk;
        if (has_dk) {
          const float b_dk = b_prodt * (zqi * x.k + qi * z.k) + b_prod * qi * x.k;
          const float b_dkt = b_prodt * qi * x.k;
          bpret[0] = b_dkt * dk1;
          bpre[0] = b_dkt * dk2 * pkt + b_dk * dk1;
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          // this thread read a[c * H] and at[c * H] above: overwrite them
          bfr2(bpre[c], bpret[c]);
          a[c * H] = bf16_exact(bpre[c]);
          at[c * H] = bf16_exact(bpret[c]);
          db_acc[c] += bpre[c];
        }
      }
      group_sync(g, H);
      // the cutm gradient: a fixed-order sum of the warp partials
      for (int s = hh; s < kn; s += H) {
        float sum = 0.0f;
        for (int w = 0; w < nw; ++w) sum += red_s[s * nw + w];
        gcutm[e0 + s] = sum;
      }
      if (has_w) {
        // g ea (KC, RBFP) = pre-bar . W + pre'-bar . Z_W on the tensor cores
        dea_tile(2, pre_s, w_s, nullptr, pret_s, p.zw_all, F, ldp, ldw, p.rbf, rbfp, gea, e0, kn, warp, nw,
                 lane);
        store_tile(pre_s, ldp, F, bpre_out, e0, kn, hh, H);
        store_tile(pret_s, ldp, F, bpret_out, e0, kn, hh, H);
      } else {
        for (int x = hh; x < kn * p.rbf; x += H) gea[e0 * p.rbf + x] = __float2bfloat16_rn(0.0f);
      }
    }
    gq[(size_t)i * H + hh] = gq_acc;
    gct[(size_t)i * H + hh] = gct_acc;
  }
  if (has_w) {
#pragma unroll
    for (int c = 0; c < 2; ++c) db_part[((size_t)blockIdx.x * p.groups + g) * F + c * H + hh] = db_acc[c];
  }
}

// The second order's source pass (#13): per atom j, the gradients of k_j
// and v_j summed over the K slots of perm from the edge's recomputed
// filters and filter tangents, the receiver's q, z_q and ct, and hs4's
// attn, attn' and reverse seeds.  f32 sums in slot order, rounded once to
// bf16.
template <int ACT, int ATT>
__global__ void __launch_bounds__(SRC2_MAX_THREADS, 1)
    t_bwd2_src_kernel(Params p, const int32_t* __restrict__ perm, const float* __restrict__ ct,
                      const float* __restrict__ hs4, bf16* __restrict__ gk_out, bf16* __restrict__ gv_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int act = ACT >= 0 ? ACT : p.act;
  const int H = p.h, F = 2 * H, ldp = pre_ld(H), ldw = w_ld(p.rbf), rbfp = rbf_pad(p.rbf);
  const int g = threadIdx.x / H, hh = threadIdx.x % H;
  const int nw = H / 32, warp = hh / 32, lane = hh % 32;
  const int heads = H / p.hd, head = hh / p.hd;
  const GLayout L = pass_layout(H, heads, p.rbf, p.groups, SRC2);
  const bf16* w_s = reinterpret_cast<const bf16*>(smem);
  unsigned char* gs = smem + L.base + g * L.stride;
  bf16* ea_buf = reinterpret_cast<bf16*>(gs + L.ea);
  bf16* zea_buf = reinterpret_cast<bf16*>(gs + L.zea);
  bf16* pre_s = reinterpret_cast<bf16*>(gs + L.pre);
  bf16* pret_s = reinterpret_cast<bf16*>(gs + L.pret);
  int* ids_buf = reinterpret_cast<int*>(gs + L.ids);
  float* hs_buf = reinterpret_cast<float*>(gs + L.hs);
  const bool has_dk = p.wk != nullptr, has_dv = p.wv != nullptr, has_w = has_dk || has_dv;
  const int hsw = 4 * heads;

  for (int e = hh; e < 2 * KC * ldw; e += H) {
    ea_buf[e] = __float2bfloat16_rn(0.0f);
    zea_buf[e] = __float2bfloat16_rn(0.0f);
  }
  load_weights(p, reinterpret_cast<bf16*>(smem));
  float bk = 0.0f, zbk = 0.0f, bv = 0.0f, zbv = 0.0f;
  if (has_dk) {
    bk = ldb(p.bk + hh);
    zbk = ldb(p.zbk + hh);
  }
  if (has_dv) {
    bv = ldb(p.bv + hh);
    zbv = ldb(p.zbv + hh);
  }
  __syncthreads();

  const int a0 = ((int)blockIdx.x * p.groups + g) * p.iters;
  const int a1 = min(a0 + p.iters, p.n);
  if (a0 >= a1) return;
  const size_t sb = (size_t)a0 * p.k;
  const int ns = (a1 - a0) * p.k, nch = (ns + KC - 1) / KC;
  int pv = lane < min(KC, ns) ? __ldg(perm + sb + lane) : 0;
  stage_slots(p, pv, min(KC, ns), hh, nw, hsw, hs4, ea_buf, zea_buf, ids_buf, hs_buf);
  pv = (nch > 1 && lane < min(KC, ns - KC)) ? __ldg(perm + sb + KC + lane) : 0;
  int j = a0, slot = 0;
  float acc_k = 0.0f, acc_v = 0.0f;
  for (int ch = 0; ch < nch; ++ch) {
    const int buf = ch & 1;
    const int kn = min(KC, ns - ch * KC);
    const int* eid_s = ids_buf + buf * 2 * KC;
    const float* hs_s = hs_buf + buf * hsw * KC;
    const bf16* ea_s = ea_buf + buf * KC * ldw;
    __pipeline_wait_prior(0);
    group_sync(g, H);
    if (ch + 1 < nch) {
      stage_slots(p, pv, min(KC, ns - (ch + 1) * KC), hh, nw, hsw, hs4, ea_buf + (buf ^ 1) * KC * ldw,
                  zea_buf + (buf ^ 1) * KC * ldw, ids_buf + (buf ^ 1) * 2 * KC, hs_buf + (buf ^ 1) * hsw * KC);
      const int rest = ns - (ch + 2) * KC;
      pv = (rest > 0 && lane < min(KC, rest)) ? __ldg(perm + sb + (size_t)(ch + 2) * KC + lane) : 0;
    }
    if (has_w) {
      filter_tile(1, ea_s, w_s, nullptr, nullptr, nullptr, ldw, rbfp, F, pre_s, ldp, warp, nw, lane);
      filter_tile(2, zea_buf + buf * KC * ldw, w_s, nullptr, ea_s, p.zw_all, ldw, rbfp, F, pret_s, ldp, warp,
                  nw, lane);
    }
    group_sync(g, H);
    for (int kc = 0; kc < kn; ++kc) {
      if (slot == p.k) {  // the next source atom
        gk_out[(size_t)j * H + hh] = __float2bfloat16_rn(acc_k);
        gv_out[(size_t)j * H + hh] = __float2bfloat16_rn(acc_v);
        acc_k = acc_v = 0.0f;
        ++j;
        slot = 0;
      }
      ++slot;
      const int i = eid_s[KC + kc];
      const float qi = ldb(p.q + (size_t)i * H + hh);
      const float zqi = ldb(p.zq + (size_t)i * H + hh);
      const float cti = bfr(ct[(size_t)i * H + hh]);
      const float attn = hs_s[kc * hsw + head];
      const float attnt = hs_s[kc * hsw + heads + head];
      const float b_prodt = hs_s[kc * hsw + 2 * heads + head];
      const float b_prod = hs_s[kc * hsw + 3 * heads + head];
      float f[2], f1[2], f2[2], pt[2];
      dual_filters(act, pre_s + kc * ldp + hh, pret_s + kc * ldp + hh, H, bk, zbk, bv, zbv, has_dk, has_dv, f,
                   f1, f2, pt);
      const float dk = f[0], dkt = f1[0] * pt[0], dv = f[1], dvt = f1[1] * pt[1];
      const float b_vdvt = cti * attn, b_vdv = cti * attnt;
      acc_k += b_prodt * (zqi * dk + qi * dkt) + b_prod * qi * dk;
      acc_v += b_vdvt * dvt + b_vdv * dv;
    }
  }
  gk_out[(size_t)j * H + hh] = __float2bfloat16_rn(acc_k);
  gv_out[(size_t)j * H + hh] = __float2bfloat16_rn(acc_v);
}

bool valid_shape(int n, int k, int h, int heads, int rbf) {
  if (n <= 0 || k <= 0 || rbf <= 0 || rbf % 2 != 0 || heads <= 0 || h % 32 != 0 || h > 1024 ||
      h % heads != 0)
    return false;
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

// A pass: the most row groups that fit in a block's threads and shared
// memory, and contiguous rows (atoms) per group so that the grid fills
// every SM about once (one block an SM).
cudaError_t plan_pass(Params* p, int pass, size_t* smem, int* blocks) {
  int sms = 0, smem_max = 0;
  cudaError_t err = device_limits(&sms, &smem_max);
  if (err != cudaSuccess) return err;
  const int max_threads = pass == FWD    ? FWD_MAX_THREADS
                          : pass == RECV ? RECV_MAX_THREADS
                          : pass == SRC  ? SRC_MAX_THREADS
                          : pass == RECV2 ? RECV2_MAX_THREADS
                                          : SRC2_MAX_THREADS;
  const int heads = p->h / p->hd;
  int groups = 0;
  for (int gcount = min(MAX_GROUPS, max_threads / p->h); gcount >= 1; --gcount) {
    if (pass_layout(p->h, heads, p->rbf, gcount, pass).total <= (size_t)smem_max) {
      groups = gcount;
      break;
    }
  }
  if (groups == 0) return cudaErrorInvalidValue;  // too wide for one block
  if (pass == FWD) {
    // the forward is paced by its issue rate: of the counts that keep at
    // least half the most row groups in flight, the one that gives an SM the
    // fewest rows (groups x rows a group), then the most groups
    auto rows_an_sm = [&](int g) { return g * ((p->n + g * sms - 1) / (g * sms)); };
    int best = groups;
    for (int gcount = groups - 1; 2 * gcount >= groups; --gcount)
      if (rows_an_sm(gcount) < rows_an_sm(best)) best = gcount;
    groups = best;
  }
  p->groups = groups;
  const int slots = groups * sms;
  p->iters = (p->n + slots - 1) / slots;
  *blocks = (p->n + groups * p->iters - 1) / (groups * p->iters);
  *smem = pass_layout(p->h, heads, p->rbf, groups, pass).total;
  return cudaSuccess;
}

Params make_params(const void* idx, int n, int k, int h, int heads, int rbf, const void* q,
                   const void* kx, const void* v, const void* ea, const void* cutm, const void* wk,
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
  p.ea = static_cast<const bf16*>(ea);
  p.cutm = static_cast<const float*>(cutm);
  p.wk = static_cast<const bf16*>(wk);
  p.bk = static_cast<const bf16*>(bk);
  p.wv = static_cast<const bf16*>(wv);
  p.bv = static_cast<const bf16*>(bv);
  p.act = act;
  p.attn_act = attn_act;
  p.zq = p.zk = p.zv = p.zea = nullptr;
  p.zcutm = nullptr;
  p.zw_all = p.zbk = p.zbv = nullptr;
  p.groups = p.iters = 0;
  return p;
}

// the Z operands of the second order's passes
void set_z(Params* p, const void* zq, const void* zk, const void* zv, const void* zea, const void* zcutm,
           const void* zw_all, const void* zbk, const void* zbv) {
  p->zq = static_cast<const bf16*>(zq);
  p->zk = static_cast<const bf16*>(zk);
  p->zv = static_cast<const bf16*>(zv);
  p->zea = static_cast<const bf16*>(zea);
  p->zcutm = static_cast<const float*>(zcutm);
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
    case RECV: return reinterpret_cast<const void*>(t_bwd_kernel<A, A>);
    case RECV2: return reinterpret_cast<const void*>(t_bwd2_kernel<A, A>);
    case SRC: return reinterpret_cast<const void*>(t_bwd_src_kernel<A, A>);
    case SRC2: return reinterpret_cast<const void*>(t_bwd2_src_kernel<A, A>);
    default: return reinterpret_cast<const void*>(t_fwd_kernel<A, A>);
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

#define T_OPERANDS                                                                               \
  const void *idx, int n, int k, int h, int heads, int rbf, const void *q, const void *kx,       \
      const void *v, const void *ea, const void *cutm, const void *wk, const void *bk,           \
      const void *wv, const void *bv, int act, int attn_act
#define T_PARAMS make_params(idx, n, k, h, heads, rbf, q, kx, v, ea, cutm, wk, bk, wv, bv, act, attn_act)

// plan a pass and allow its shared memory
cudaError_t prepare_pass(Params* p, int pass, size_t* smem, int* blocks) {
  cudaError_t err = plan_pass(p, pass, smem, blocks);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(pass_kernel(pass, *p), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

}  // namespace

extern "C" {

const char* t_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// Returns a cudaError_t (0 on success).  Pointers to absent filters (wk/bk,
// wv/bv) are null.  Launches on `stream` and does not synchronise.
int t_fwd(T_OPERANDS, void* out, void* stream) {
  if (!valid_shape(n, k, h, heads, rbf)) return (int)cudaErrorInvalidValue;
  Params p = T_PARAMS;
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = prepare_pass(&p, FWD, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  LAUNCH_PASS(t_fwd_kernel, blocks, p.groups * h, smem, static_cast<cudaStream_t>(stream), p,
              static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// The grid of a receiver pass (kind 1 the backward's, 2 the second
// order's): its block count and row groups per block, which size the
// per-group bias-gradient partials (blocks * groups, 2H).
int t_plan(int kind, int n, int k, int h, int heads, int rbf, int* blocks, int* groups) {
  if (!valid_shape(n, k, h, heads, rbf) || (kind != 1 && kind != 2)) return (int)cudaErrorInvalidValue;
  Params p = make_params(nullptr, n, k, h, heads, rbf, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, 0, 0);
  size_t smem = 0;
  cudaError_t err = plan_pass(&p, kind == 1 ? RECV : RECV2, &smem, blocks);
  *groups = p.groups;
  return (int)err;
}

// The backward's receiver pass.  Outputs: dq (N, H) f32, dea (N, K, RBF)
// bf16, dcutm (N, K) f32, hs (N*K, 2, heads) bf16 for the source pass; dpre
// (N*K, 2H) bf16 and db_part (blocks * groups, 2H) f32 (t_plan's grid) when
// the weights want a gradient, else both null.
int t_bwd(T_OPERANDS, const void* ct, void* dq, void* dea, void* dcutm, void* hs, void* dpre, void* db_part,
          void* stream) {
  if (!valid_shape(n, k, h, heads, rbf)) return (int)cudaErrorInvalidValue;
  Params p = T_PARAMS;
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = prepare_pass(&p, RECV, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  LAUNCH_PASS(t_bwd_kernel, blocks, p.groups * h, smem, static_cast<cudaStream_t>(stream),
      p, static_cast<const float*>(ct), static_cast<float*>(dq), static_cast<bf16*>(dea),
      static_cast<float*>(dcutm), static_cast<bf16*>(hs), static_cast<bf16*>(dpre), static_cast<float*>(db_part));
  return (int)cudaGetLastError();
}

// The backward's source pass: dk, dv (N, H) bf16 from t_bwd's hs and the
// transpose permutation perm (N*K) int32.
int t_bwd_src(T_OPERANDS, const void* perm, const void* ct, const void* hs, void* dk, void* dv, void* stream) {
  if (!valid_shape(n, k, h, heads, rbf)) return (int)cudaErrorInvalidValue;
  Params p = T_PARAMS;
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = prepare_pass(&p, SRC, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  LAUNCH_PASS(t_bwd_src_kernel, blocks, p.groups * h, smem, static_cast<cudaStream_t>(stream),
      p, static_cast<const int32_t*>(perm), static_cast<const float*>(ct), static_cast<const bf16*>(hs),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv));
  return (int)cudaGetLastError();
}

// The second order's receiver pass.  z_* are the cotangents on t_bwd's
// outputs (all non-null: absent ones are zeros), zw_all the filters' Z as
// (2H, RBFP) bf16 with zero rows for absent filters and zero padding
// columns.  Outputs: gq (N, H), gea (N, K, RBF) bf16, gcutm (N, K),
// gct (N, H), hs4 (N*K, 4, heads) for the source pass; with filters, bpre
// and bpret (N*K, 2H) bf16 and db_part as for t_bwd (null without
// filters).  All f32 unless noted.
int t_bwd2(T_OPERANDS, const void* ct, const void* zq, const void* zk, const void* zv, const void* zea,
           const void* zcutm, const void* zw_all, const void* zbk, const void* zbv, void* gq,
           void* gea, void* gcutm, void* gct, void* hs4, void* bpre, void* bpret, void* db_part, void* stream) {
  if (!valid_shape(n, k, h, heads, rbf) || h > RECV2_MAX_THREADS) return (int)cudaErrorInvalidValue;
  Params p = T_PARAMS;
  set_z(&p, zq, zk, zv, zea, zcutm, zw_all, zbk, zbv);
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = prepare_pass(&p, RECV2, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  LAUNCH_PASS(t_bwd2_kernel, blocks, p.groups * h, smem, static_cast<cudaStream_t>(stream),
      p, static_cast<const float*>(ct), static_cast<float*>(gq), static_cast<bf16*>(gea),
      static_cast<float*>(gcutm), static_cast<float*>(gct), static_cast<float*>(hs4), static_cast<bf16*>(bpre),
      static_cast<bf16*>(bpret), static_cast<float*>(db_part));
  return (int)cudaGetLastError();
}

// The second order's source pass: gk, gv (N, H) bf16 from t_bwd2's hs4 and
// perm; operands as for t_bwd2 (z_k, z_v and z_cutm are not read).
int t_bwd2_src(T_OPERANDS, const void* perm, const void* ct, const void* zq, const void* zea, const void* zw_all,
               const void* zbk, const void* zbv, const void* hs4, void* gk, void* gv, void* stream) {
  if (!valid_shape(n, k, h, heads, rbf) || h > SRC2_MAX_THREADS) return (int)cudaErrorInvalidValue;
  Params p = T_PARAMS;
  set_z(&p, zq, nullptr, nullptr, zea, nullptr, zw_all, zbk, zbv);
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = prepare_pass(&p, SRC2, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  LAUNCH_PASS(t_bwd2_src_kernel, blocks, p.groups * h, smem, static_cast<cudaStream_t>(stream),
      p, static_cast<const int32_t*>(perm), static_cast<const float*>(ct), static_cast<const float*>(hs4),
      static_cast<bf16*>(gk), static_cast<bf16*>(gv));
  return (int)cudaGetLastError();
}

// A pass's resources at a shape (kind 1 the backward's receiver pass, 2 the
// second order's, 3 the backward's source pass, 4 the second order's, 5 the
// forward): out
// = registers a thread, local (spill) bytes a thread, threads a block,
// dynamic shared memory a block, resident blocks an SM.
int t_resources(int kind, int n, int k, int h, int heads, int rbf, int* out) {
  if (!valid_shape(n, k, h, heads, rbf) || kind < 1 || kind > 5) return (int)cudaErrorInvalidValue;
  const int pass = kind == 1 ? RECV : (kind == 2 ? RECV2 : (kind == 3 ? SRC : (kind == 4 ? SRC2 : FWD)));
  Params p = make_params(nullptr, n, k, h, heads, rbf, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, ACT_SILU, ACT_SILU);  // the instantiation the configurations run
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = plan_pass(&p, pass, &smem, &blocks);
  const void* fn = pass_kernel(pass, p);
  const int threads = p.groups * h;
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
