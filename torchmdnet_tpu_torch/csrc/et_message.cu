// Fused ET attention edge phase for Hopper (sm_90a): forward, backward and
// second order.
//
// Replaces the Pallas TPU kernels of torchmdnet_tpu/ops/pallas/et_message.py:
//   et_fwd_kernel  <- _fwd_kernel (:227, launched by _run_fwd at :509)
//   et_bwd_kernel  <- _bwd_kernel (:296, launched by _run_bwd at :563)
//   et_bwd2_kernel <- _bwd2_kernel (:685, launched by _run_bwd2 at :895)
//   ell_transpose_sum_kernel <- _inverse_scatter (:603), the reduction of the
//                    per-edge source-row cotangents back onto the atoms.
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
// What the design does about it:
//   * no (N, K, F) tensor in device memory in the forward: a group of H
//     threads owns one receiver row, one channel per thread, gathers the
//     source rows k/v/vec directly by index (no block plan, no one-hot
//     product: those were TPU layout workarounds) and keeps its f32
//     accumulators in registers; each thread loads the next edge's source
//     values before it computes the current edge, so gathers overlap work;
//   * the filter products run on the tensor cores (wmma bf16 16x16x16, f32
//     accumulation) for KC = 16 edges at a time, against the filter weights
//     (4H x RBF bf16, 72 KB at DHFR) loaded into shared memory once per
//     block and shared by the block's row groups (4 at H = 128); the next
//     chunk's ea rows, neighbor ids and edge scalars are copied into a
//     second buffer asynchronously while the current chunk computes;
//   * the per-head sum is a butterfly over the head's lanes of one warp
//     (H/heads must be a power of two <= 32), no ones-block product;
//   * the backward recomputes each chunk from the same inputs, as the TPU
//     kernel does; d ea = d_pre . W^T runs on the tensor cores too.  It
//     writes per-edge source cotangents (N, K, 7H) in bf16 (the values are
//     bf16 already, so this loses nothing), and a second kernel sums them
//     onto the atoms through the ELL list's transpose permutation: no float
//     atomics, so the cotangents (and forces) are bitwise the same on every
//     run.  Weight cotangents, when wanted, are accumulated in the kernel:
//     after each chunk the block's warps add ea^T . d_pre over all its row
//     groups into the block's own f32 partial (RBFP x 4H, in device memory
//     and L2: too large for registers or shared memory at H = 256; each
//     warp keeps two or four tiles' loads in flight), and the caller sums the
//     per-block partials once, as the JAX kernel does;
//   * the second-order kernel (force-loss training's outer pass) is the
//     VJP of the backward with respect to (inputs, ct), given cotangents Z
//     on the backward's outputs.  It uses the identity of the JAX kernel's
//     docstring: S = <vjp_f(a)(ct), Z> = <ct, J_f(a) . Z>, so g_ct = J_f(a).Z
//     is a forward-mode pass (each per-edge value carries a tangent, the
//     Z on the source rows gathered by idx) and g_inputs is the reverse pass
//     of that dual-number forward, seeded with ct on the tangent outputs.
//     The formulas are written out per edge (second derivatives of the four
//     activations included); the three filter products of the dual forward
//     (ea.W, z_ea.W + ea.Z_W), the two of d ea and the two of the weight
//     gradient run on the tensor cores.  W and Z_W are read from device
//     memory (L2): both would not fit in shared memory next to the chunk
//     state at H = 256.  Source-row gradients go out per edge in f32 and
//     are summed through the transpose permutation and rounded once.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
using namespace nvcuda;

namespace {

constexpr int KC = 16;  // edges per chunk: the M of one wmma tile
constexpr int FWD_MAX_THREADS = 512;
constexpr int BWD_MAX_THREADS = 512;
// the second-order kernel holds about three times the backward's per-edge
// state: at most 256 threads, so that each may use up to 255 registers
constexpr int BWD2_MAX_THREADS = 256;
constexpr float kLog2 = 0.69314718055994530942f;

enum { ACT_SILU = 0, ACT_SSP = 1, ACT_TANH = 2, ACT_SIGMOID = 3 };

__device__ __forceinline__ float bfr(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

enum Kind { FWD = 0, BWD = 1, BWD2 = 2 };

// Shared memory: the filter weights (forward and backward), then one slice
// per row group.  The second-order kernel keeps no weights here; it stages
// z_ea beside ea, the filter tangents beside the filters, and nine edge
// scalars (cutm, msk, dir0..2, z_cutm, z_dir0..2) instead of five.
struct Smem {
  size_t groups_base, group_stride, total;
  size_t ea, zea, pre, pret, scratch, idx, sc, red;
  int nsc, nred;
};

// row stride (bf16 elements) of the per-edge filter tile: 4H + 8, so the
// rows of a wmma load start on different banks
__host__ __device__ inline int pre_ld(int h) { return 4 * h + 8; }

__host__ __device__ inline Smem smem_layout(int h, int rbf, int groups, int kind) {
  Smem s;
  s.groups_base = kind == BWD2 ? 0 : align32((size_t)4 * h * w_ld(rbf) * sizeof(bf16));
  s.nsc = kind == BWD2 ? 9 : 5;
  s.nred = kind == BWD2 ? 5 : (kind == BWD ? 4 : 0);
  size_t o = 0;
  s.ea = o;  // two (KC, ldw) buffers: one is filled while the other is used
  o = align32(o + (size_t)2 * KC * w_ld(rbf) * sizeof(bf16));
  s.zea = o;
  if (kind == BWD2) o = align32(o + (size_t)2 * KC * w_ld(rbf) * sizeof(bf16));
  // (KC, 4H) bf16 filter accumulators (the kernels only ever use them
  // rounded to bf16); the backward overwrites them in place with the
  // filter cotangents
  s.pre = o;
  o = align32(o + (size_t)KC * pre_ld(h) * sizeof(bf16));
  s.pret = o;  // second order: the filter tangents, then their cotangents
  if (kind == BWD2) o = align32(o + (size_t)KC * pre_ld(h) * sizeof(bf16));
  s.scratch = o;  // one 16x16 f32 tile per warp: the wmma epilogue
  o = align32(o + (size_t)(h / 32) * 256 * sizeof(float));
  s.idx = o;  // two buffers of KC neighbor ids
  o = align32(o + 2 * KC * sizeof(int));
  s.sc = o;  // two (nsc, KC) f32 buffers of edge scalars
  o = align32(o + (size_t)2 * s.nsc * KC * sizeof(float));
  s.red = o;  // (KC, nred, H/32) f32 warp partials of the per-edge scalars
  o = align32(o + (size_t)KC * s.nred * (h / 32) * sizeof(float));
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
  int groups, iters;  // row groups per block; rows per group
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
                            float* sc_s, bf16* zea_s = nullptr) {
  const int ldw = w_ld(p.rbf), words = p.rbf / 2, nw = p.h / 32;
  const int kn = min(KC, p.k - c0);
  const int warp = hh / 32, lane = hh % 32;
  const size_t off = ((size_t)i * p.k + c0) * p.rbf;
  for (int kc = warp; kc < kn; kc += nw)
    for (int w = lane; w < words; w += 32) {
      __pipeline_memcpy_async(ea_s + kc * ldw + 2 * w, p.ea + off + (size_t)kc * p.rbf + 2 * w, 4);
      if (zea_s)
        __pipeline_memcpy_async(zea_s + kc * ldw + 2 * w, p.zea + off + (size_t)kc * p.rbf + 2 * w, 4);
    }
  if (hh < kn) {
    const size_t e = (size_t)i * p.k + c0 + hh;
    __pipeline_memcpy_async(idx_s + hh, p.idx + e, 4);
    const float* scalars[9] = {p.cutm, p.msk, p.dir0, p.dir1, p.dir2,
                               p.zcutm, p.zdir0, p.zdir1, p.zdir2};
    const int nsc = zea_s ? 9 : 5;
    for (int c = 0; c < nsc; ++c) __pipeline_memcpy_async(sc_s + c * KC + hh, scalars[c] + e, 4);
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

// The block's weight-gradient partial (RBFP, 4H) f32 in device memory,
// += A_g^T . B_g over the first `nact` row groups of the block and over one
// or two (A, B) operand pairs: A the chunk's (KC, ldw) edge rows (ea, or
// z_ea), B its (KC, 4H) filter cotangents (rows past the chunk's end are
// zero).  Every warp of the block takes whole 16x16 tiles, TILES at a time
// so that their loads from L2 overlap (4 in the second-order kernel; 2 in
// the backward, whose 128-register budget spills at 4); `first` starts the
// partial from zero.  Called by all threads of the block.
template <int TILES>
__device__ void accumulate_dw(const Smem& L, unsigned char* smem, int buf, int h, int rbf,
                              int nact, bool two, bool first, float* part) {
  const int F = 4 * h, ldw = w_ld(rbf), ldp = pre_ld(h), rbfp = rbf_pad(rbf);
  const int ftiles = F / 16, tiles = (rbfp / 16) * ftiles;
  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  for (int t0 = warp; t0 < tiles; t0 += TILES * nwarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[TILES];
#pragma unroll
    for (int q = 0; q < TILES; ++q) {
      const int t = t0 + q * nwarps;
      if (t >= tiles) continue;
      if (first)
        wmma::fill_fragment(c[q], 0.0f);
      else
        wmma::load_matrix_sync(c[q], part + (size_t)(t / ftiles) * 16 * F + (t % ftiles) * 16, F,
                               wmma::mem_row_major);
    }
    for (int g = 0; g < nact; ++g) {
      unsigned char* gs = smem + L.groups_base + g * L.group_stride;
      for (int pr = 0; pr < (two ? 2 : 1); ++pr) {
        const bf16* a0 = reinterpret_cast<const bf16*>(gs + (pr ? L.zea : L.ea)) + buf * KC * ldw;
        const bf16* b0 = reinterpret_cast<const bf16*>(gs + (pr ? L.pret : L.pre));
#pragma unroll
        for (int q = 0; q < TILES; ++q) {
          const int t = t0 + q * nwarps;
          if (t >= tiles) continue;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, a0 + (t / ftiles) * 16, ldw);
          wmma::load_matrix_sync(fb, b0 + (t % ftiles) * 16, ldp);
          wmma::mma_sync(c[q], fa, fb, c[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < TILES; ++q) {
      const int t = t0 + q * nwarps;
      if (t < tiles)
        wmma::store_matrix_sync(part + (size_t)(t / ftiles) * 16 * F + (t % ftiles) * 16, c[q], F,
                                wmma::mem_row_major);
    }
    __syncwarp();
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
  const Smem L = smem_layout(H, p.rbf, p.groups, FWD);
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

__global__ void __launch_bounds__(BWD_MAX_THREADS, 1)
    et_bwd_kernel(Params p, const float* __restrict__ ct_x, const float* __restrict__ ct_vec,
                  float* __restrict__ dq, bf16* __restrict__ dea, float* __restrict__ dcutm,
                  float* __restrict__ ddir0, float* __restrict__ ddir1,
                  float* __restrict__ ddir2, bf16* __restrict__ dsrc,
                  float* __restrict__ dw_part, float* __restrict__ db_part) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = p.h, F = 4 * p.h, ldp = pre_ld(p.h);
  const int g = threadIdx.x / H, hh = threadIdx.x % H;
  const int nw = H / 32, warp = hh / 32, lane = hh % 32;
  const int ldw = w_ld(p.rbf), rbfp = rbf_pad(p.rbf);
  const Smem L = smem_layout(H, p.rbf, p.groups, BWD);
  bf16* w_s = reinterpret_cast<bf16*>(smem);
  unsigned char* gs = smem + L.groups_base + g * L.group_stride;
  bf16* ea_buf = reinterpret_cast<bf16*>(gs + L.ea);
  bf16* pre_s = reinterpret_cast<bf16*>(gs + L.pre);  // then d_pre, in place
  float* scratch = reinterpret_cast<float*>(gs + L.scratch) + warp * 256;
  int* idx_buf = reinterpret_cast<int*>(gs + L.idx);
  float* sc_buf = reinterpret_cast<float*>(gs + L.sc);
  float* red_s = reinterpret_cast<float*>(gs + L.red);
  const bool has_dk = p.wk != nullptr, has_dv = p.wv != nullptr;
  float* ddirs[3] = {ddir0, ddir1, ddir2};
  const bool want_dw = dw_part != nullptr && (has_dk || has_dv);
  float db_acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // this thread's filter columns

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
    const bool active = i < p.n;
    float qi = 0.0f, ctx = 0.0f, ctv[3] = {0.0f, 0.0f, 0.0f};
    if (active) {
      qi = ldb(p.q + (size_t)i * H + hh);
      ctx = bfr(ct_x[(size_t)i * H + hh]);
#pragma unroll
      for (int c = 0; c < 3; ++c) ctv[c] = bfr(ct_vec[(size_t)i * 3 * H + c * H + hh]);
    }
    float dq_acc = 0.0f;
    for (int c0 = 0; c0 < p.k; c0 += KC) {
      const int kn = min(KC, p.k - c0);
      const int cur_buf = buf;
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
      if (active) {
        Src cur = load_src(p, idx_s[0], hh);
        for (int kc = 0; kc < kn; ++kc) {
          Src nxt = cur;
          if (kc + 1 < kn) nxt = load_src(p, idx_s[kc + 1], hh);
          const size_t e = (size_t)i * p.k + c0 + kc;
          // ---- recompute the forward edge
          bf16* a = pre_s + kc * ldp + hh;
          float pre_k = 0.0f, dk = 1.0f, pre_v[3] = {0.0f, 0.0f, 0.0f}, dv[3] = {1.0f, 1.0f, 1.0f};
          if (has_dk) dk = filter_val(p.act, a[0], bk, &pre_k);
          if (has_dv) {
#pragma unroll
            for (int c = 0; c < 3; ++c) dv[c] = filter_val(p.act, a[(1 + c) * H], bv[c], &pre_v[c]);
          }
          float vdv[3], dir[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            vdv[c] = has_dv ? bfr(cur.v[c] * dv[c]) : cur.v[c];
            dir[c] = bfr(sc_s[(2 + c) * KC + kc]);
          }
          float prod = bfr(qi * cur.k);
          if (has_dk) prod = bfr(prod * dk);
          const float pre_a = bfr(group_sum(prod, p.hd));
          const float a_act = bfr(act_fn(p.attn_act, pre_a));
          const float cm = bfr(sc_s[0 * KC + kc]);
          const float attn = bfr(a_act * cm);
          const float m = bfr(sc_s[1 * KC + kc]);
          const float vm1 = bfr(vdv[1] * m);
          const float vw2 = vdv[2];
          // ---- backward through the edge
          const float d_attn = bfr(ctx * vdv[0]);
          const float d_xm = bfr(ctx * attn);
          const float d_prea = bfr(bfr(bfr(dact_fn(p.attn_act, pre_a)) * cm) * d_attn);
          const float r0 = group_sum(bfr(a_act * d_attn), 32);
          if (lane == 0) red_s[(kc * 4) * nw + warp] = r0;
          const float d_prod = bfr(group_sum(d_prea, p.hd));
          const float qk = bfr(d_prod * qi);
          float d_kj, d_dk = 0.0f;
          if (has_dk) {
            d_kj = bfr(qk * dk);
            d_dk = bfr(qk * cur.k);
            dq_acc += bfr(bfr(d_prod * cur.k) * dk);
          } else {
            d_kj = qk;
            dq_acc += bfr(d_prod * cur.k);
          }
          float d_vw1 = 0.0f, d_vw2 = 0.0f, d_vec[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            d_vw1 = bfr(d_vw1 + bfr(bfr(ctv[c] * cur.vec[c]) * m));
            d_vw2 = bfr(d_vw2 + bfr(ctv[c] * dir[c]));
            d_vec[c] = bfr(ctv[c] * vm1);
            const float rc = group_sum(bfr(ctv[c] * vw2), 32);
            if (lane == 0) red_s[(kc * 4 + 1 + c) * nw + warp] = rc;
          }
          const float d_vdv[3] = {d_xm, d_vw1, d_vw2};
          bf16* ds = dsrc + e * 7 * H;
          ds[hh] = __float2bfloat16_rn(d_kj);
          float d_pre[4];
          d_pre[0] = has_dk ? bfr(bfr(dact_fn(p.act, pre_k)) * d_dk) : 0.0f;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            ds[H + c * H + hh] = __float2bfloat16_rn(has_dv ? bfr(d_vdv[c] * dv[c]) : d_vdv[c]);
            ds[4 * H + c * H + hh] = __float2bfloat16_rn(d_vec[c]);
            d_pre[1 + c] =
                has_dv ? bfr(bfr(dact_fn(p.act, pre_v[c])) * bfr(d_vdv[c] * cur.v[c])) : 0.0f;
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            // this thread read a[c * H] above: overwrite it with d_pre
            const bf16 d = __float2bfloat16_rn(d_pre[c]);
            a[c * H] = d;
            db_acc[c] += __bfloat162float(d);
          }
          cur = nxt;
        }
        // rows past the chunk's end take no part in the weight gradient
        for (int kc = kn; kc < KC; ++kc)
          for (int c = 0; c < 4; ++c) pre_s[kc * ldp + c * H + hh] = __float2bfloat16_rn(0.0f);
      }
      __syncthreads();
      if (active) {
        // per-edge scalar cotangents: fixed-order sums of the warp partials
        for (int s = hh; s < kn * 4; s += H) {
          const int kc = s / 4, which = s % 4;
          float sum = 0.0f;
          for (int w = 0; w < nw; ++w) sum += red_s[(kc * 4 + which) * nw + w];
          float* out = which == 0 ? dcutm : ddirs[which - 1];
          out[(size_t)i * p.k + c0 + kc] = sum;
        }
        // d ea (KC, RBFP) = d_pre (KC, 4H) . W (4H, RBFP) on the tensor cores,
        // one 16-column tile per warp, written out from the warp's scratch
        for (int tile = warp; tile < rbfp / 16; tile += nw) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
          wmma::fill_fragment(c, 0.0f);
          if (has_dk || has_dv) {
            for (int k0 = 0; k0 < F; k0 += 16) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
              wmma::load_matrix_sync(a, pre_s + k0, ldp);
              wmma::load_matrix_sync(b, w_s + (size_t)k0 * ldw + tile * 16, ldw);
              wmma::mma_sync(c, a, b, c);
            }
          }
          wmma::store_matrix_sync(scratch, c, 16, wmma::mem_row_major);
          __syncwarp();
          for (int s = lane; s < 256; s += 32) {
            const int kc = s / 16, r = tile * 16 + s % 16;
            if (kc < kn && r < p.rbf)
              dea[((size_t)i * p.k + c0 + kc) * p.rbf + r] = __float2bfloat16_rn(scratch[s]);
          }
          __syncwarp();
        }
      }
      if (want_dw) {
        // signed: past the last row the count is negative (an unsigned
        // blockIdx.x would wrap it to p.groups and re-add stale rows)
        const int nact = min(p.groups, p.n - ((int)blockIdx.x * p.iters + t) * p.groups);
        accumulate_dw<2>(L, smem, cur_buf, H, p.rbf, nact, false, t == 0 && c0 == 0,
                      dw_part + (size_t)blockIdx.x * rbfp * F);
      }
    }
    if (active) dq[(size_t)i * H + hh] = dq_acc;
  }
  if (want_dw) {
#pragma unroll
    for (int c = 0; c < 4; ++c) db_part[((size_t)blockIdx.x * p.groups + g) * F + c * H + hh] = db_acc[c];
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

// out (KC, 4H) bf16 = sum over the pairs of A (KC, RBFP; shared, ld ldw) .
// B^T, B (4H, RBFP) bf16 in device memory; the group's warps split the 4H/16
// column tiles.
__device__ void dual_filter_mma(const Params& p, int npairs, const bf16* a0, const bf16* b0,
                                const bf16* a1, const bf16* b1, bf16* out, float* scratch,
                                int warp, int lane) {
  const int ldw = w_ld(p.rbf), rbfp = rbf_pad(p.rbf), ldp = pre_ld(p.h);
  const int tiles = 4 * p.h / 16, nw = p.h / 32;
  for (int t = warp; t < tiles; t += nw) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::fill_fragment(c, 0.0f);
    for (int pr = 0; pr < npairs; ++pr) {
      const bf16* a = pr ? a1 : a0;
      const bf16* b = (pr ? b1 : b0) + (size_t)t * 16 * rbfp;
      for (int k0 = 0; k0 < rbfp; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, a + k0, ldw);
        wmma::load_matrix_sync(fb, b + k0, rbfp);
        wmma::mma_sync(c, fa, fb, c);
      }
    }
    wmma::store_matrix_sync(scratch, c, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32)
      out[(e / 16) * ldp + t * 16 + e % 16] = __float2bfloat16_rn(scratch[e]);
    __syncwarp();
  }
}

// Second order: the VJP of et_bwd with respect to (inputs, ct), given the
// cotangents Z on its outputs (see the header).  Per edge, with primes for
// tangents (the Z values; z_msk is ignored, msk's tangent is zero):
//   pre' = z_ea.W + ea.Z_W + z_b, dk' = act'(pre_k) pre_k', prod' = z_q k dk
//   + q z_k dk + q k dk', pa' = head sum of prod', attn' = attn_act'(pa) pa'
//   cutm + attn_act(pa) z_cutm, vdv' = z_v dv + v dv',
//   x'   += vdv'_0 attn + vdv_0 attn'
//   vec'_d += z_vec_d vdv_1 msk + vec_d vdv'_1 msk + vdv'_2 dir_d + vdv_2 z_dir_d
// g_ct = (x', vec') summed over the slots; g_inputs is the reverse pass of
// these lines seeded with ct on x' and vec'.
__global__ void __launch_bounds__(BWD2_MAX_THREADS, 1)
    et_bwd2_kernel(Params p, const float* __restrict__ ct_x, const float* __restrict__ ct_vec,
                   float* __restrict__ gq, bf16* __restrict__ gea, float* __restrict__ gcutm,
                   float* __restrict__ gmsk, float* __restrict__ gdir0, float* __restrict__ gdir1,
                   float* __restrict__ gdir2, float* __restrict__ gsrc, float* __restrict__ gctx,
                   float* __restrict__ gctvec, float* __restrict__ dw_part,
                   float* __restrict__ db_part) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = p.h, F = 4 * p.h, ldp = pre_ld(p.h);
  const int g = threadIdx.x / H, hh = threadIdx.x % H;
  const int nw = H / 32, warp = hh / 32, lane = hh % 32;
  const int ldw = w_ld(p.rbf), rbfp = rbf_pad(p.rbf);
  const Smem L = smem_layout(H, p.rbf, p.groups, BWD2);
  unsigned char* gs = smem + L.groups_base + g * L.group_stride;
  bf16* ea_buf = reinterpret_cast<bf16*>(gs + L.ea);
  bf16* zea_buf = reinterpret_cast<bf16*>(gs + L.zea);
  bf16* pre_s = reinterpret_cast<bf16*>(gs + L.pre);    // pre, then its cotangent
  bf16* pret_s = reinterpret_cast<bf16*>(gs + L.pret);  // pre', then its cotangent
  float* scratch = reinterpret_cast<float*>(gs + L.scratch) + warp * 256;
  int* idx_buf = reinterpret_cast<int*>(gs + L.idx);
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
  const int first = blockIdx.x * p.iters * p.groups + g;
  if (first < p.n) stage_async(p, first, 0, hh, ea_buf, idx_buf, sc_buf, zea_buf);
  int buf = 0;

  for (int t = 0; t < p.iters; ++t) {
    const int i = (blockIdx.x * p.iters + t) * p.groups + g;
    const bool active = i < p.n;
    float qi = 0.0f, zqi = 0.0f, ctx = 0.0f, ctv[3] = {0.0f, 0.0f, 0.0f};
    if (active) {
      qi = ldb(p.q + (size_t)i * H + hh);
      zqi = ldb(p.zq + (size_t)i * H + hh);
      ctx = bfr(ct_x[(size_t)i * H + hh]);
#pragma unroll
      for (int c = 0; c < 3; ++c) ctv[c] = bfr(ct_vec[(size_t)i * 3 * H + c * H + hh]);
    }
    float gq_acc = 0.0f, gx_acc = 0.0f, gv_acc[3] = {0.0f, 0.0f, 0.0f};
    for (int c0 = 0; c0 < p.k; c0 += KC) {
      const int kn = min(KC, p.k - c0);
      const int cur_buf = buf;
      const bf16* ea_s = ea_buf + buf * KC * ldw;
      const bf16* zea_s = zea_buf + buf * KC * ldw;
      const int* idx_s = idx_buf + buf * KC;
      const float* sc_s = sc_buf + buf * 9 * KC;
      __pipeline_wait_prior(0);
      __syncthreads();  // this chunk has landed; the last one is done with the other buffer
      if (active && has_w) {
        dual_filter_mma(p, 1, ea_s, p.w_all, nullptr, nullptr, pre_s, scratch, warp, lane);
        dual_filter_mma(p, 2, zea_s, p.w_all, ea_s, p.zw_all, pret_s, scratch, warp, lane);
      }
      int i2, c2;
      next_chunk(p, t, i, c0, &i2, &c2);
      buf ^= 1;
      if (i2 < p.n)
        stage_async(p, i2, c2, hh, ea_buf + buf * KC * ldw, idx_buf + buf * KC,
                    sc_buf + buf * 9 * KC, zea_buf + buf * KC * ldw);
      __syncthreads();  // the filter tiles are complete
      if (active) {
        for (int kc = 0; kc < kn; ++kc) {
          const int j = idx_s[kc];
          const Src x = load_src(p, j, hh);
          const ZSrc z = load_zsrc(p, j, hh);
          const size_t e = (size_t)i * p.k + c0 + kc;
          const float cm = bfr(sc_s[0 * KC + kc]), m = bfr(sc_s[1 * KC + kc]);
          const float zcm = sc_s[5 * KC + kc];
          float dir[3], zdir[3];
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            dir[d] = bfr(sc_s[(2 + d) * KC + kc]);
            zdir[d] = sc_s[(6 + d) * KC + kc];
          }
          // ---- the dual forward of the edge
          bf16* a = pre_s + kc * ldp + hh;
          bf16* at = pret_s + kc * ldp + hh;
          float dk = 1.0f, dk1 = 0.0f, dk2 = 0.0f, pkt = 0.0f, dkt = 0.0f;
          if (has_dk) {
            const float pk = bfr(ldb(a) + bk);
            act3(p.act, pk, &dk, &dk1, &dk2);
            dk = bfr(dk);
            pkt = bfr(ldb(at) + zbk);
            dkt = dk1 * pkt;
          }
          float dv[3] = {1.0f, 1.0f, 1.0f}, dv1[3] = {0.0f, 0.0f, 0.0f};
          float dv2[3] = {0.0f, 0.0f, 0.0f}, pvt[3] = {0.0f, 0.0f, 0.0f}, dvt[3] = {0.0f, 0.0f, 0.0f};
          if (has_dv) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float pv = bfr(ldb(a + (1 + c) * H) + bv[c]);
              act3(p.act, pv, &dv[c], &dv1[c], &dv2[c]);
              dv[c] = bfr(dv[c]);
              pvt[c] = bfr(ldb(at + (1 + c) * H) + zbv[c]);
              dvt[c] = dv1[c] * pvt[c];
            }
          }
          const float qk = bfr(qi * x.k);
          const float prod = has_dk ? bfr(qk * dk) : qk;
          const float prodt = (zqi * x.k + qi * z.k) * dk + qi * x.k * dkt;
          const float pa = bfr(group_sum(prod, p.hd));
          const float pat = group_sum(prodt, p.hd);
          float aa, a1, a2;
          act3(p.attn_act, pa, &aa, &a1, &a2);
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
          float* gs_e = gsrc + e * 7 * H;
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            gs_e[4 * H + d * H + hh] = ctv[d] * vdvt[1] * m;  // vec_j
            const float r = group_sum(ctv[d] * vdvt[2], 32);  // dir_d
            if (lane == 0) red_s[(kc * 5 + 2 + d) * nw + warp] = r;
          }
          const float r_m = group_sum(czv * vdv[1] + cv * vdvt[1], 32);
          const float r_cm = group_sum(b_attnt * a1 * pat + b_attn * aa, 32);
          if (lane == 0) {
            red_s[(kc * 5 + 0) * nw + warp] = r_cm;
            red_s[(kc * 5 + 1) * nw + warp] = r_m;
          }
          const float b_pat = b_attnt * a1 * cm;
          const float b_pa = b_attnt * (a2 * pat * cm + a1 * zcm) + b_attn * a1 * cm;
          const float b_prodt = group_sum(b_pat, p.hd);
          const float b_prod = group_sum(b_pa, p.hd);
          float bpre[4] = {0.0f, 0.0f, 0.0f, 0.0f}, bpret[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            gs_e[H + c * H + hh] = b_vdvt[c] * dvt[c] + b_vdv[c] * dv[c];  // v_j
            if (has_dv) {
              const float b_dv = b_vdvt[c] * z.v[c] + b_vdv[c] * x.v[c];
              const float b_dvt = b_vdvt[c] * x.v[c];
              bpret[1 + c] = b_dvt * dv1[c];
              bpre[1 + c] = b_dvt * dv2[c] * pvt[c] + b_dv * dv1[c];
            }
          }
          gs_e[hh] = b_prodt * (zqi * dk + qi * dkt) + b_prod * qi * dk;  // k_j
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
            const bf16 d = __float2bfloat16_rn(bpre[c]);
            a[c * H] = d;
            at[c * H] = __float2bfloat16_rn(bpret[c]);
            db_acc[c] += __bfloat162float(d);
          }
        }
        for (int kc = kn; kc < KC; ++kc)
          for (int c = 0; c < 4; ++c) {
            pre_s[kc * ldp + c * H + hh] = __float2bfloat16_rn(0.0f);
            pret_s[kc * ldp + c * H + hh] = __float2bfloat16_rn(0.0f);
          }
      }
      __syncthreads();
      if (active) {
        // per-edge scalar gradients: fixed-order sums of the warp partials
        for (int s = hh; s < kn * 5; s += H) {
          const int kc = s / 5, which = s % 5;
          float sum = 0.0f;
          for (int w = 0; w < nw; ++w) sum += red_s[(kc * 5 + which) * nw + w];
          float* out = which == 0 ? gcutm : (which == 1 ? gmsk : gdirs[which - 2]);
          out[(size_t)i * p.k + c0 + kc] = sum;
        }
        // g ea (KC, RBFP) = pre-bar . W + pre'-bar . Z_W on the tensor cores
        for (int tile = warp; tile < rbfp / 16; tile += nw) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
          wmma::fill_fragment(c, 0.0f);
          if (has_w) {
            for (int pr = 0; pr < 2; ++pr) {
              const bf16* a = pr ? pret_s : pre_s;
              const bf16* b = (pr ? p.zw_all : p.w_all) + tile * 16;
              for (int k0 = 0; k0 < F; k0 += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
                wmma::load_matrix_sync(fa, a + k0, ldp);
                wmma::load_matrix_sync(fb, b + (size_t)k0 * rbfp, rbfp);
                wmma::mma_sync(c, fa, fb, c);
              }
            }
          }
          wmma::store_matrix_sync(scratch, c, 16, wmma::mem_row_major);
          __syncwarp();
          for (int s = lane; s < 256; s += 32) {
            const int kc = s / 16, r = tile * 16 + s % 16;
            if (kc < kn && r < p.rbf)
              gea[((size_t)i * p.k + c0 + kc) * p.rbf + r] = __float2bfloat16_rn(scratch[s]);
          }
          __syncwarp();
        }
      }
      if (has_w) {
        // signed: past the last row the count is negative (an unsigned
        // blockIdx.x would wrap it to p.groups and re-add stale rows)
        const int nact = min(p.groups, p.n - ((int)blockIdx.x * p.iters + t) * p.groups);
        accumulate_dw<4>(L, smem, cur_buf, H, p.rbf, nact, true, t == 0 && c0 == 0,
                      dw_part + (size_t)blockIdx.x * rbfp * F);
      }
    }
    if (active) {
      gq[(size_t)i * H + hh] = gq_acc;
      gctx[(size_t)i * H + hh] = gx_acc;
#pragma unroll
      for (int d = 0; d < 3; ++d) gctvec[(size_t)i * 3 * H + d * H + hh] = gv_acc[d];
    }
  }
  if (has_w) {
#pragma unroll
    for (int c = 0; c < 4; ++c) db_part[((size_t)blockIdx.x * p.groups + g) * F + c * H + hh] = db_acc[c];
  }
}

// out[j, :] = sum over the K slots s of g[perm[j * K + s], :], in slot order,
// two columns per thread.
__device__ __forceinline__ float2 load_pair(const bf16* g, size_t i) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(g)[i]);
}
__device__ __forceinline__ float2 load_pair(const float* g, size_t i) {
  return reinterpret_cast<const float2*>(g)[i];
}

template <typename T>
__global__ void ell_transpose_sum_kernel(const T* __restrict__ g, const int32_t* __restrict__ perm,
                                         int k, int f, bf16* __restrict__ out) {
  extern __shared__ int32_t slots[];
  const int j = blockIdx.x;
  for (int s = threadIdx.x; s < k; s += blockDim.x) slots[s] = perm[(size_t)j * k + s];
  __syncthreads();
  const int f2 = f / 2;
  for (int c = threadIdx.x; c < f2; c += blockDim.x) {
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 8
    for (int s = 0; s < k; ++s) {
      const float2 v = load_pair(g, (size_t)slots[s] * f2 + c);
      a0 += v.x;
      a1 += v.y;
    }
    reinterpret_cast<__nv_bfloat162*>(out)[(size_t)j * f2 + c] = __floats2bfloat162_rn(a0, a1);
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

// Row groups per block (the most that fit in threads and shared memory) and
// rows per group, so that the grid is about one block per SM.
cudaError_t plan_grid(Params* p, int kind, size_t* smem, int* blocks) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int max_threads =
      kind == BWD2 ? BWD2_MAX_THREADS : (kind == BWD ? BWD_MAX_THREADS : FWD_MAX_THREADS);
  int groups = 0;
  for (int gcount = 4; gcount >= 1; gcount /= 2) {
    if (gcount * p->h <= max_threads &&
        smem_layout(p->h, p->rbf, gcount, kind).total <= (size_t)smem_max) {
      groups = gcount;
      break;
    }
  }
  if (groups == 0) return cudaErrorInvalidValue;  // too wide for one block
  p->groups = groups;
  p->iters = (p->n + groups * sms - 1) / (groups * sms);
  *blocks = (p->n + groups * p->iters - 1) / (groups * p->iters);
  *smem = smem_layout(p->h, p->rbf, groups, kind).total;
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

}  // namespace

extern "C" {

const char* et_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// Returns a cudaError_t (0 on success).  Pointers to absent filters (wk/bk,
// wv/bv) are null.  Launches on `stream` and does not synchronise.
int et_fwd(const void* idx, int n, int k, int h, int heads, int rbf, const void* q,
           const void* kx, const void* v, const void* vec0, const void* vec1, const void* vec2,
           const void* ea, const void* cutm, const void* msk, const void* dir0,
           const void* dir1, const void* dir2, const void* wk, const void* bk, const void* wv,
           const void* bv, int act, int attn_act, void* x_out, void* vec_out, void* stream) {
  if (!valid_shape(n, k, h, heads, rbf)) return (int)cudaErrorInvalidValue;
  Params p = make_params(idx, n, k, h, heads, rbf, q, kx, v, vec0, vec1, vec2, ea, cutm, msk,
                         dir0, dir1, dir2, wk, bk, wv, bv, act, attn_act);
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = plan_grid(&p, FWD, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(et_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  et_fwd_kernel<<<blocks, p.groups * h, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<float*>(x_out), static_cast<float*>(vec_out));
  return (int)cudaGetLastError();
}

// The grid a kernel would launch (kind 0 forward, 1 backward, 2 second
// order): its block count and row groups per block, which size the
// per-block weight-gradient partials.
int et_plan(int kind, int n, int k, int h, int heads, int rbf, int* blocks, int* groups) {
  if (!valid_shape(n, k, h, heads, rbf)) return (int)cudaErrorInvalidValue;
  Params p = make_params(nullptr, n, k, h, heads, rbf, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, nullptr, 0, 0);
  size_t smem = 0;
  cudaError_t err = plan_grid(&p, kind, &smem, blocks);
  *groups = p.groups;
  return (int)err;
}

// dsrc is (N, K, 7H) bf16.  dw_part (blocks, RBFP, 4H) and db_part
// (blocks * groups, 4H) f32 (et_plan's grid) receive the per-block weight
// cotangent partials; both null when the weights need no gradient.
int et_bwd(const void* idx, int n, int k, int h, int heads, int rbf, const void* q,
           const void* kx, const void* v, const void* vec0, const void* vec1, const void* vec2,
           const void* ea, const void* cutm, const void* msk, const void* dir0,
           const void* dir1, const void* dir2, const void* wk, const void* bk, const void* wv,
           const void* bv, int act, int attn_act, const void* ct_x, const void* ct_vec,
           void* dq, void* dea, void* dcutm, void* ddir0, void* ddir1, void* ddir2, void* dsrc,
           void* dw_part, void* db_part, void* stream) {
  if (!valid_shape(n, k, h, heads, rbf)) return (int)cudaErrorInvalidValue;
  Params p = make_params(idx, n, k, h, heads, rbf, q, kx, v, vec0, vec1, vec2, ea, cutm, msk,
                         dir0, dir1, dir2, wk, bk, wv, bv, act, attn_act);
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = plan_grid(&p, BWD, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(et_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  et_bwd_kernel<<<blocks, p.groups * h, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const float*>(ct_x), static_cast<const float*>(ct_vec),
      static_cast<float*>(dq), static_cast<bf16*>(dea), static_cast<float*>(dcutm),
      static_cast<float*>(ddir0), static_cast<float*>(ddir1), static_cast<float*>(ddir2),
      static_cast<bf16*>(dsrc), static_cast<float*>(dw_part), static_cast<float*>(db_part));
  return (int)cudaGetLastError();
}

// The second-order kernel.  z_* are the cotangents on et_bwd's outputs (all
// non-null: absent ones are zeros), w_all/zw_all the filters and their Z as
// (4H, RBFP) bf16 with zero rows for absent filters and zero padding
// columns.  Outputs: gq (N, H), gea (N, K, RBF) bf16, gcutm, gmsk, gdir0..2
// (N, K), gsrc (N, K, 7H) per-edge source-row gradients, gctx (N, H),
// gctvec (N, 3H), and the weight partials as for et_bwd (null without
// filters).  All f32 unless noted.
int et_bwd2(const void* idx, int n, int k, int h, int heads, int rbf, const void* q,
            const void* kx, const void* v, const void* vec0, const void* vec1, const void* vec2,
            const void* ea, const void* cutm, const void* msk, const void* dir0,
            const void* dir1, const void* dir2, const void* wk, const void* bk, const void* wv,
            const void* bv, int act, int attn_act, const void* ct_x, const void* ct_vec,
            const void* zq, const void* zk, const void* zv, const void* zvec0, const void* zvec1,
            const void* zvec2, const void* zea, const void* zcutm, const void* zdir0,
            const void* zdir1, const void* zdir2, const void* w_all, const void* zw_all,
            const void* zbk, const void* zbv, void* gq, void* gea, void* gcutm, void* gmsk,
            void* gdir0, void* gdir1, void* gdir2, void* gsrc, void* gctx, void* gctvec,
            void* dw_part, void* db_part, void* stream) {
  if (!valid_shape(n, k, h, heads, rbf) || h > BWD2_MAX_THREADS) return (int)cudaErrorInvalidValue;
  Params p = make_params(idx, n, k, h, heads, rbf, q, kx, v, vec0, vec1, vec2, ea, cutm, msk,
                         dir0, dir1, dir2, wk, bk, wv, bv, act, attn_act);
  p.zq = static_cast<const bf16*>(zq);
  p.zk = static_cast<const bf16*>(zk);
  p.zv = static_cast<const bf16*>(zv);
  p.zvec0 = static_cast<const bf16*>(zvec0);
  p.zvec1 = static_cast<const bf16*>(zvec1);
  p.zvec2 = static_cast<const bf16*>(zvec2);
  p.zea = static_cast<const bf16*>(zea);
  p.zcutm = static_cast<const float*>(zcutm);
  p.zdir0 = static_cast<const float*>(zdir0);
  p.zdir1 = static_cast<const float*>(zdir1);
  p.zdir2 = static_cast<const float*>(zdir2);
  p.w_all = static_cast<const bf16*>(w_all);
  p.zw_all = static_cast<const bf16*>(zw_all);
  p.zbk = static_cast<const bf16*>(zbk);
  p.zbv = static_cast<const bf16*>(zbv);
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = plan_grid(&p, BWD2, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(et_bwd2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  et_bwd2_kernel<<<blocks, p.groups * h, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const float*>(ct_x), static_cast<const float*>(ct_vec),
      static_cast<float*>(gq), static_cast<bf16*>(gea), static_cast<float*>(gcutm),
      static_cast<float*>(gmsk), static_cast<float*>(gdir0), static_cast<float*>(gdir1),
      static_cast<float*>(gdir2), static_cast<float*>(gsrc), static_cast<float*>(gctx),
      static_cast<float*>(gctvec), static_cast<float*>(dw_part), static_cast<float*>(db_part));
  return (int)cudaGetLastError();
}

// out (N, F) bf16 = transpose-sum of g (N*K, F) through perm (N*K) int32,
// summed in f32 and rounded once; g is bf16 (f32_in 0) or f32 (f32_in 1).
// F must be even.
int ell_transpose_sum(const void* g, int f32_in, const void* perm, int n, int k, int f, void* out,
                      void* stream) {
  if (n <= 0 || k <= 0 || f <= 0 || f % 2 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)k * sizeof(int32_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int pairs = f / 2;
  const int threads = pairs < 256 ? ((pairs + 31) / 32) * 32 : 256;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32_in)
    ell_transpose_sum_kernel<float><<<n, threads, smem, st>>>(
        static_cast<const float*>(g), static_cast<const int32_t*>(perm), k, f, static_cast<bf16*>(out));
  else
    ell_transpose_sum_kernel<bf16><<<n, threads, smem, st>>>(
        static_cast<const bf16*>(g), static_cast<const int32_t*>(perm), k, f, static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
