// Fused ET attention edge phase for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernels of torchmdnet_tpu/ops/pallas/et_message.py:
//   et_fwd_kernel  <- _fwd_kernel (:227, launched by _run_fwd at :509)
//   et_bwd_kernel  <- _bwd_kernel (:296, launched by _run_bwd at :563)
//   ell_transpose_sum_kernel <- _inverse_scatter (:603), the reduction of the
//                    backward's source-row cotangents back onto the atoms.
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
//     run.  For weight cotangents it writes the per-edge filter cotangents
//     d_pre (N*K, 4H) bf16; the caller reduces them with one matrix product.

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

// Shared memory: the filter weights, then one slice per row group.
struct Smem {
  size_t groups_base, group_stride, total;
  size_t ea, pre, scratch, idx, sc, red;
};

// row stride (bf16 elements) of the per-edge filter tile: 4H + 8, so the
// rows of a wmma load start on different banks
__host__ __device__ inline int pre_ld(int h) { return 4 * h + 8; }

__host__ __device__ inline Smem smem_layout(int h, int rbf, int groups, bool bwd) {
  Smem s;
  s.groups_base = align32((size_t)4 * h * w_ld(rbf) * sizeof(bf16));
  size_t o = 0;
  s.ea = o;  // two (KC, ldw) buffers: one is filled while the other is used
  o = align32(o + (size_t)2 * KC * w_ld(rbf) * sizeof(bf16));
  // (KC, 4H) bf16 filter accumulators (the kernels only ever use them
  // rounded to bf16); the backward overwrites them in place with the
  // filter cotangents
  s.pre = o;
  o = align32(o + (size_t)KC * pre_ld(h) * sizeof(bf16));
  s.scratch = o;  // one 16x16 f32 tile per warp: the wmma epilogue
  o = align32(o + (size_t)(h / 32) * 256 * sizeof(float));
  s.idx = o;  // two buffers of KC neighbor ids
  o = align32(o + 2 * KC * sizeof(int));
  s.sc = o;  // two (5, KC) f32 buffers: cutm, msk, dir0, dir1, dir2
  o = align32(o + 2 * 5 * KC * sizeof(float));
  s.red = 0;
  if (bwd) {
    s.red = o;  // (KC, 4, H/32) f32 warp partials of the per-edge scalars
    o = align32(o + (size_t)KC * 4 * (h / 32) * sizeof(float));
  }
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
                            float* sc_s) {
  const int ldw = w_ld(p.rbf), words = p.rbf / 2, nw = p.h / 32;
  const int kn = min(KC, p.k - c0);
  const int warp = hh / 32, lane = hh % 32;
  const bf16* src = p.ea + ((size_t)i * p.k + c0) * p.rbf;
  for (int kc = warp; kc < kn; kc += nw)
    for (int w = lane; w < words; w += 32)
      __pipeline_memcpy_async(ea_s + kc * ldw + 2 * w, src + (size_t)kc * p.rbf + 2 * w, 4);
  if (hh < kn) {
    const size_t e = (size_t)i * p.k + c0 + hh;
    __pipeline_memcpy_async(idx_s + hh, p.idx + e, 4);
    const float* scalars[5] = {p.cutm, p.msk, p.dir0, p.dir1, p.dir2};
#pragma unroll
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
  const Smem L = smem_layout(H, p.rbf, p.groups, false);
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
                  bf16* __restrict__ dpre_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = p.h, F = 4 * p.h, ldp = pre_ld(p.h);
  const int g = threadIdx.x / H, hh = threadIdx.x % H;
  const int nw = H / 32, warp = hh / 32, lane = hh % 32;
  const int ldw = w_ld(p.rbf), rbfp = rbf_pad(p.rbf);
  const Smem L = smem_layout(H, p.rbf, p.groups, true);
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
            if (dpre_out) dpre_out[e * F + c * H + hh] = d;
          }
          cur = nxt;
        }
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
    }
    if (active) dq[(size_t)i * H + hh] = dq_acc;
  }
}

// out[j, :] = sum over the K slots s of g[perm[j * K + s], :], in slot order,
// two columns per thread.
__global__ void ell_transpose_sum_kernel(const bf16* __restrict__ g, const int32_t* __restrict__ perm,
                                         int k, int f, bf16* __restrict__ out) {
  extern __shared__ int32_t slots[];
  const int j = blockIdx.x;
  for (int s = threadIdx.x; s < k; s += blockDim.x) slots[s] = perm[(size_t)j * k + s];
  __syncthreads();
  const int f2 = f / 2;
  const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(g);
  for (int c = threadIdx.x; c < f2; c += blockDim.x) {
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 8
    for (int s = 0; s < k; ++s) {
      const float2 v = __bfloat1622float2(g2[(size_t)slots[s] * f2 + c]);
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
cudaError_t plan_grid(Params* p, bool bwd, size_t* smem, int* blocks) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int max_threads = bwd ? BWD_MAX_THREADS : FWD_MAX_THREADS;
  int groups = 0;
  for (int gcount = 4; gcount >= 1; gcount /= 2) {
    if (gcount * p->h <= max_threads &&
        smem_layout(p->h, p->rbf, gcount, bwd).total <= (size_t)smem_max) {
      groups = gcount;
      break;
    }
  }
  if (groups == 0) return cudaErrorInvalidValue;  // too wide for one block
  p->groups = groups;
  p->iters = (p->n + groups * sms - 1) / (groups * sms);
  *blocks = (p->n + groups * p->iters - 1) / (groups * p->iters);
  *smem = smem_layout(p->h, p->rbf, groups, bwd).total;
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
  cudaError_t err = plan_grid(&p, false, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(et_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  et_fwd_kernel<<<blocks, p.groups * h, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<float*>(x_out), static_cast<float*>(vec_out));
  return (int)cudaGetLastError();
}

// dsrc is (N, K, 7H) bf16.  dpre_out (N, K, 4H) bf16 may be null: the
// per-edge filter cotangents, wanted only for weight cotangents.
int et_bwd(const void* idx, int n, int k, int h, int heads, int rbf, const void* q,
           const void* kx, const void* v, const void* vec0, const void* vec1, const void* vec2,
           const void* ea, const void* cutm, const void* msk, const void* dir0,
           const void* dir1, const void* dir2, const void* wk, const void* bk, const void* wv,
           const void* bv, int act, int attn_act, const void* ct_x, const void* ct_vec,
           void* dq, void* dea, void* dcutm, void* ddir0, void* ddir1, void* ddir2, void* dsrc,
           void* dpre_out, void* stream) {
  if (!valid_shape(n, k, h, heads, rbf)) return (int)cudaErrorInvalidValue;
  Params p = make_params(idx, n, k, h, heads, rbf, q, kx, v, vec0, vec1, vec2, ea, cutm, msk,
                         dir0, dir1, dir2, wk, bk, wv, bv, act, attn_act);
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = plan_grid(&p, true, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(et_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  et_bwd_kernel<<<blocks, p.groups * h, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const float*>(ct_x), static_cast<const float*>(ct_vec),
      static_cast<float*>(dq), static_cast<bf16*>(dea), static_cast<float*>(dcutm),
      static_cast<float*>(ddir0), static_cast<float*>(ddir1), static_cast<float*>(ddir2),
      static_cast<bf16*>(dsrc), static_cast<bf16*>(dpre_out));
  return (int)cudaGetLastError();
}

// out (N, F) bf16 = transpose-sum of g (N*K, F) bf16 through perm (N*K) int32;
// F must be even.
int ell_transpose_sum_bf16(const void* g, const void* perm, int n, int k, int f, void* out,
                           void* stream) {
  if (n <= 0 || k <= 0 || f <= 0 || f % 2 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)k * sizeof(int32_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int pairs = f / 2;
  const int threads = pairs < 256 ? ((pairs + 31) / 32) * 32 : 256;
  ell_transpose_sum_kernel<<<n, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(g), static_cast<const int32_t*>(perm), k, f,
      static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
