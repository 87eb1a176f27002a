// Fused Transformer (TorchMD_T) attention edge phase for Hopper (sm_90a):
// forward, backward and second order.
//
// Replaces the Pallas TPU kernels of torchmdnet_tpu/ops/pallas/t_message.py:
//   t_fwd_kernel  <- _fwd_kernel (:66, launched by _run_fwd at :267)
//   t_bwd_kernel  <- _bwd_kernel (:113, launched by _run_bwd at :304)
//   t_bwd2_kernel <- _t_bwd2_kernel (:519, launched by _t_bwd2_op at :668)
// The per-edge source-row cotangents the backward and second-order kernels
// write are summed onto the atoms by ell_transpose_sum (csrc/et_message.cu),
// the counterpart of the JAX kernels' dxw partials and _table_scatter.
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
// What the design does about it (the ET kernels' design, see et_message.cu):
//   * no (N, K, F) tensor in device memory in the forward: a group of H
//     threads owns one receiver row, one channel per thread, gathers k_j and
//     v_j directly by index (no block plan, no one-hot product: TPU layout
//     workarounds) and keeps its f32 accumulator in a register; the next
//     edge's source values load while the current edge computes;
//   * the filter products run on the tensor cores (wmma bf16 16x16x16, f32
//     accumulation) for KC = 16 edges at a time against the filter weights
//     (2H x RBF bf16) in shared memory, loaded once per block and shared by
//     its row groups; the next chunk's ea rows, ids and cutm are copied
//     asynchronously into a second buffer while the current chunk computes;
//   * the per-head sum is a warp butterfly over the head's lanes (H/heads a
//     power of two <= 32), no ones-block product;
//   * the backward recomputes each chunk, as the TPU kernel does; d ea =
//     d_pre . W runs on the tensor cores.  It writes per-edge source
//     cotangents (N, K, 2H) bf16, summed onto the atoms through the list's
//     transpose permutation (no float atomics: forces are bitwise
//     repeatable).  Weight cotangents, when wanted, go into per-block f32
//     partials (RBFP x 2H) that the caller sums once;
//   * the second order is the VJP of the backward with respect to (inputs,
//     ct) given cotangents Z on its outputs, written as a dual-number
//     forward (g_ct = J_f(a) . Z) plus its hand-written reverse seeded with
//     ct (g_inputs), as for ET's second-order kernel; its three filter
//     products, two for g ea and two for g W run on the tensor cores, with W
//     and Z_W read from device memory (L2).
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
// the second-order kernel keeps about three times the backward's per-edge
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
// row stride of the per-edge filter tile (KC, 2H): 2H + 8, for the same reason
__host__ __device__ inline int pre_ld(int h) { return 2 * h + 8; }
__host__ __device__ inline size_t align32(size_t x) { return (x + 31) & ~size_t(31); }

enum Kind { FWD = 0, BWD = 1, BWD2 = 2 };

// Shared memory: the filter weights (forward and backward), then one slice
// per row group.  The second-order kernel keeps no weights here; it stages
// z_ea beside ea, the filter tangents beside the filters, and two edge
// scalars (cutm, z_cutm) instead of one.
struct Smem {
  size_t groups_base, group_stride, total;
  size_t ea, zea, pre, pret, scratch, idx, sc, red;
  int nsc;
};

__host__ __device__ inline Smem smem_layout(int h, int rbf, int groups, int kind) {
  Smem s;
  s.groups_base = kind == BWD2 ? 0 : align32((size_t)2 * h * w_ld(rbf) * sizeof(bf16));
  s.nsc = kind == BWD2 ? 2 : 1;
  size_t o = 0;
  s.ea = o;  // two (KC, ldw) buffers: one is filled while the other is used
  o = align32(o + (size_t)2 * KC * w_ld(rbf) * sizeof(bf16));
  s.zea = o;
  if (kind == BWD2) o = align32(o + (size_t)2 * KC * w_ld(rbf) * sizeof(bf16));
  // (KC, 2H) bf16 filter accumulators; the backward overwrites them in
  // place with the filter cotangents
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
  s.red = o;  // (KC, H/32) f32 warp partials of the cutm cotangent
  if (kind != FWD) o = align32(o + (size_t)KC * (h / 32) * sizeof(float));
  s.group_stride = o;
  s.total = s.groups_base + (size_t)groups * o;
  return s;
}

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
  const bf16 *w_all, *zw_all;  // (2H, RBFP) bf16, zero rows for absent filters
  const bf16 *zbk, *zbv;
  int groups, iters;  // row groups per block; rows per group
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
    __pipeline_memcpy_async(sc_s + hh, p.cutm + e, 4);
    if (zea_s) __pipeline_memcpy_async(sc_s + KC + hh, p.zcutm + e, 4);
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

// pre_s (KC, 2H) = bf16(ea_s (KC, RBFP) . W^T) on the tensor cores; the
// group's H/32 warps split the 2H/16 column tiles, four each.
__device__ void filter_mma(const Params& p, const bf16* w_s, const bf16* ea_s, bf16* pre_s,
                           float* scratch, int warp, int lane) {
  const int ldw = w_ld(p.rbf), rbfp = rbf_pad(p.rbf), ldp = pre_ld(p.h);
  const int tiles = 2 * p.h / 16, nw = p.h / 32;
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

// The block's weight-gradient partial (RBFP, 2H) f32 in device memory,
// += A_g^T . B_g over the first `nact` row groups of the block and over one
// or two (A, B) operand pairs: A the chunk's (KC, ldw) edge rows (ea, or
// z_ea), B its (KC, 2H) filter cotangents (rows past the chunk's end are
// zero).  Every warp of the block takes whole 16x16 tiles, TILES at a time
// so that their loads from L2 overlap; `first` starts the partial from zero.
// Called by all threads of the block.
template <int TILES>
__device__ void accumulate_dw(const Smem& L, unsigned char* smem, int buf, int h, int rbf,
                              int nact, bool two, bool first, float* part) {
  const int F = 2 * h, ldw = w_ld(rbf), ldp = pre_ld(h), rbfp = rbf_pad(rbf);
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

// the source-row values (or their Z tangents) one thread reads for one edge
struct Src {
  float k, v;
};

__device__ __forceinline__ Src load_src(const bf16* kx, const bf16* v, int j, int h, int hh) {
  const size_t row = (size_t)j * h + hh;
  return Src{ldb(kx + row), ldb(v + row)};
}

__global__ void __launch_bounds__(FWD_MAX_THREADS, 1)
    t_fwd_kernel(Params p, float* __restrict__ out) {
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
  const float bv = has_dv ? ldb(p.bv + hh) : 0.0f;
  __syncthreads();  // zero padding in place before any copy lands
  const int first = blockIdx.x * p.iters * p.groups + g;
  if (first < p.n) stage_async(p, first, 0, hh, ea_buf, idx_buf, sc_buf);
  int buf = 0;

  for (int t = 0; t < p.iters; ++t) {
    const int i = (blockIdx.x * p.iters + t) * p.groups + g;
    const bool active = i < p.n;  // the same for the whole group (whole warps)
    const float qi = active ? ldb(p.q + (size_t)i * H + hh) : 0.0f;
    float acc = 0.0f;
    for (int c0 = 0; c0 < p.k; c0 += KC) {
      const int kn = min(KC, p.k - c0);
      const bf16* ea_s = ea_buf + buf * KC * ldw;
      const int* idx_s = idx_buf + buf * KC;
      const float* sc_s = sc_buf + buf * KC;
      __pipeline_wait_prior(0);
      __syncthreads();  // this chunk has landed; the last one is done with the other buffer
      if (active && (has_dk || has_dv)) filter_mma(p, w_s, ea_s, pre_s, scratch, warp, lane);
      int i2, c2;
      next_chunk(p, t, i, c0, &i2, &c2);
      buf ^= 1;
      if (i2 < p.n) stage_async(p, i2, c2, hh, ea_buf + buf * KC * ldw, idx_buf + buf * KC, sc_buf + buf * KC);
      __syncthreads();  // the filter tile is complete
      if (!active) continue;
      Src cur = load_src(p.kx, p.v, idx_s[0], H, hh);
      for (int kc = 0; kc < kn; ++kc) {
        Src nxt = cur;
        if (kc + 1 < kn) nxt = load_src(p.kx, p.v, idx_s[kc + 1], H, hh);  // in flight while this edge computes
        const bf16* a = pre_s + kc * ldp + hh;
        float pre, dk = 1.0f, dv = 1.0f;
        if (has_dk) dk = filter_val(p.act, a[0], bk, &pre);
        if (has_dv) dv = filter_val(p.act, a[H], bv, &pre);
        const float vdv = has_dv ? bfr(cur.v * dv) : cur.v;
        float prod = bfr(qi * cur.k);
        if (has_dk) prod = bfr(prod * dk);
        const float pre_a = bfr(group_sum(prod, p.hd));
        const float cm = bfr(sc_s[kc]);
        const float attn = bfr(bfr(act_fn(p.attn_act, pre_a)) * cm);
        acc += bfr(vdv * attn);
        cur = nxt;
      }
    }
    if (active) out[(size_t)i * H + hh] = acc;
  }
}

__global__ void __launch_bounds__(BWD_MAX_THREADS, 1)
    t_bwd_kernel(Params p, const float* __restrict__ ct, float* __restrict__ dq,
                 bf16* __restrict__ dea, float* __restrict__ dcutm, bf16* __restrict__ dsrc,
                 float* __restrict__ dw_part, float* __restrict__ db_part) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = p.h, F = 2 * p.h, ldp = pre_ld(p.h);
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
  const bool want_dw = dw_part != nullptr && (has_dk || has_dv);
  float db_acc[2] = {0.0f, 0.0f};  // this thread's filter columns

  for (int e = hh; e < 2 * KC * ldw; e += H) ea_buf[e] = __float2bfloat16_rn(0.0f);
  load_weights(p, w_s);
  const float bk = has_dk ? ldb(p.bk + hh) : 0.0f;
  const float bv = has_dv ? ldb(p.bv + hh) : 0.0f;
  __syncthreads();  // zero padding in place before any copy lands
  const int first = blockIdx.x * p.iters * p.groups + g;
  if (first < p.n) stage_async(p, first, 0, hh, ea_buf, idx_buf, sc_buf);
  int buf = 0;

  for (int t = 0; t < p.iters; ++t) {
    const int i = (blockIdx.x * p.iters + t) * p.groups + g;
    const bool active = i < p.n;
    float qi = 0.0f, cti = 0.0f;
    if (active) {
      qi = ldb(p.q + (size_t)i * H + hh);
      cti = bfr(ct[(size_t)i * H + hh]);
    }
    float dq_acc = 0.0f;
    for (int c0 = 0; c0 < p.k; c0 += KC) {
      const int kn = min(KC, p.k - c0);
      const int cur_buf = buf;
      const bf16* ea_s = ea_buf + buf * KC * ldw;
      const int* idx_s = idx_buf + buf * KC;
      const float* sc_s = sc_buf + buf * KC;
      __pipeline_wait_prior(0);
      __syncthreads();  // this chunk has landed; the last one is done with the other buffer
      if (active && (has_dk || has_dv)) filter_mma(p, w_s, ea_s, pre_s, scratch, warp, lane);
      int i2, c2;
      next_chunk(p, t, i, c0, &i2, &c2);
      buf ^= 1;
      if (i2 < p.n) stage_async(p, i2, c2, hh, ea_buf + buf * KC * ldw, idx_buf + buf * KC, sc_buf + buf * KC);
      __syncthreads();  // the filter tile is complete
      if (active) {
        Src cur = load_src(p.kx, p.v, idx_s[0], H, hh);
        for (int kc = 0; kc < kn; ++kc) {
          Src nxt = cur;
          if (kc + 1 < kn) nxt = load_src(p.kx, p.v, idx_s[kc + 1], H, hh);
          const size_t e = (size_t)i * p.k + c0 + kc;
          // ---- recompute the forward edge
          bf16* a = pre_s + kc * ldp + hh;
          float pre_k = 0.0f, dk = 1.0f, pre_v = 0.0f, dv = 1.0f;
          if (has_dk) dk = filter_val(p.act, a[0], bk, &pre_k);
          if (has_dv) dv = filter_val(p.act, a[H], bv, &pre_v);
          const float vdv = has_dv ? bfr(cur.v * dv) : cur.v;
          float prod = bfr(qi * cur.k);
          if (has_dk) prod = bfr(prod * dk);
          const float pre_a = bfr(group_sum(prod, p.hd));
          const float a_act = bfr(act_fn(p.attn_act, pre_a));
          const float cm = bfr(sc_s[kc]);
          const float attn = bfr(a_act * cm);
          // ---- backward through the edge (t_message.py:165-228)
          const float d_attn = bfr(cti * vdv);
          const float d_vdv = bfr(cti * attn);
          const float d_prea = bfr(bfr(bfr(dact_fn(p.attn_act, pre_a)) * cm) * d_attn);
          const float r0 = group_sum(bfr(a_act * d_attn), 32);
          if (lane == 0) red_s[kc * nw + warp] = r0;
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
          bf16* ds = dsrc + e * 2 * H;
          ds[hh] = __float2bfloat16_rn(d_kj);
          ds[H + hh] = __float2bfloat16_rn(has_dv ? bfr(d_vdv * dv) : d_vdv);
          float d_pre[2];
          d_pre[0] = has_dk ? bfr(bfr(dact_fn(p.act, pre_k)) * d_dk) : 0.0f;
          d_pre[1] = has_dv ? bfr(bfr(dact_fn(p.act, pre_v)) * bfr(d_vdv * cur.v)) : 0.0f;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            // this thread read a[c * H] above: overwrite it with d_pre
            const bf16 d = __float2bfloat16_rn(d_pre[c]);
            a[c * H] = d;
            db_acc[c] += __bfloat162float(d);
          }
          cur = nxt;
        }
        // rows past the chunk's end take no part in the weight gradient
        for (int kc = kn; kc < KC; ++kc)
          for (int c = 0; c < 2; ++c) pre_s[kc * ldp + c * H + hh] = __float2bfloat16_rn(0.0f);
      }
      __syncthreads();
      if (active) {
        // the cutm cotangent: a fixed-order sum of the warp partials
        for (int s = hh; s < kn; s += H) {
          float sum = 0.0f;
          for (int w = 0; w < nw; ++w) sum += red_s[s * nw + w];
          dcutm[(size_t)i * p.k + c0 + s] = sum;
        }
        // d ea (KC, RBFP) = d_pre (KC, 2H) . W (2H, RBFP) on the tensor cores,
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
    for (int c = 0; c < 2; ++c) db_part[((size_t)blockIdx.x * p.groups + g) * F + c * H + hh] = db_acc[c];
  }
}

// out (KC, 2H) bf16 = sum over the pairs of A (KC, RBFP; shared, ld ldw) .
// B^T, B (2H, RBFP) bf16 in device memory; the group's warps split the 2H/16
// column tiles.
__device__ void dual_filter_mma(const Params& p, int npairs, const bf16* a0, const bf16* b0,
                                const bf16* a1, const bf16* b1, bf16* out, float* scratch,
                                int warp, int lane) {
  const int ldw = w_ld(p.rbf), rbfp = rbf_pad(p.rbf), ldp = pre_ld(p.h);
  const int tiles = 2 * p.h / 16, nw = p.h / 32;
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

// Second order: the VJP of t_bwd with respect to (inputs, ct), given the
// cotangents Z on its outputs (see the header).  Per edge, with primes for
// tangents (the Z values):
//   pre' = z_ea.W + ea.Z_W + z_b, dk' = act'(pre_k) pre_k', prod' = z_q k dk
//   + q z_k dk + q k dk', pa' = head sum of prod', attn' = attn_act'(pa) pa'
//   cutm + attn_act(pa) z_cutm, vdv' = z_v dv + v dv',
//   out' += vdv' attn + vdv attn'
// g_ct = out' summed over the slots; g_inputs is the reverse pass of these
// lines seeded with ct on out'.
__global__ void __launch_bounds__(BWD2_MAX_THREADS, 1)
    t_bwd2_kernel(Params p, const float* __restrict__ ct, float* __restrict__ gq,
                  bf16* __restrict__ gea, float* __restrict__ gcutm, float* __restrict__ gsrc,
                  float* __restrict__ gct, float* __restrict__ dw_part,
                  float* __restrict__ db_part) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = p.h, F = 2 * p.h, ldp = pre_ld(p.h);
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
  float db_acc[2] = {0.0f, 0.0f};

  for (int e = hh; e < 2 * KC * ldw; e += H) {
    ea_buf[e] = __float2bfloat16_rn(0.0f);
    zea_buf[e] = __float2bfloat16_rn(0.0f);
  }
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
  const int first = blockIdx.x * p.iters * p.groups + g;
  if (first < p.n) stage_async(p, first, 0, hh, ea_buf, idx_buf, sc_buf, zea_buf);
  int buf = 0;

  for (int t = 0; t < p.iters; ++t) {
    const int i = (blockIdx.x * p.iters + t) * p.groups + g;
    const bool active = i < p.n;
    float qi = 0.0f, zqi = 0.0f, cti = 0.0f;
    if (active) {
      qi = ldb(p.q + (size_t)i * H + hh);
      zqi = ldb(p.zq + (size_t)i * H + hh);
      cti = bfr(ct[(size_t)i * H + hh]);
    }
    float gq_acc = 0.0f, gct_acc = 0.0f;
    for (int c0 = 0; c0 < p.k; c0 += KC) {
      const int kn = min(KC, p.k - c0);
      const int cur_buf = buf;
      const bf16* ea_s = ea_buf + buf * KC * ldw;
      const bf16* zea_s = zea_buf + buf * KC * ldw;
      const int* idx_s = idx_buf + buf * KC;
      const float* sc_s = sc_buf + buf * 2 * KC;
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
                    sc_buf + buf * 2 * KC, zea_buf + buf * KC * ldw);
      __syncthreads();  // the filter tiles are complete
      if (active) {
        for (int kc = 0; kc < kn; ++kc) {
          const int j = idx_s[kc];
          const Src x = load_src(p.kx, p.v, j, H, hh);
          const Src z = load_src(p.zk, p.zv, j, H, hh);
          const size_t e = (size_t)i * p.k + c0 + kc;
          const float cm = bfr(sc_s[kc]);
          const float zcm = sc_s[KC + kc];
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
          float dv = 1.0f, dv1 = 0.0f, dv2 = 0.0f, pvt = 0.0f, dvt = 0.0f;
          if (has_dv) {
            const float pv = bfr(ldb(a + H) + bv);
            act3(p.act, pv, &dv, &dv1, &dv2);
            dv = bfr(dv);
            pvt = bfr(ldb(at + H) + zbv);
            dvt = dv1 * pvt;
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
          const float b_prodt = group_sum(b_pat, p.hd);
          const float b_prod = group_sum(b_pa, p.hd);
          float bpre[2] = {0.0f, 0.0f}, bpret[2] = {0.0f, 0.0f};
          float* gs_e = gsrc + e * 2 * H;
          gs_e[H + hh] = b_vdvt * dvt + b_vdv * dv;  // v_j
          if (has_dv) {
            const float b_dv = b_vdvt * z.v + b_vdv * x.v;
            const float b_dvt = b_vdvt * x.v;
            bpret[1] = b_dvt * dv1;
            bpre[1] = b_dvt * dv2 * pvt + b_dv * dv1;
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
          for (int c = 0; c < 2; ++c) {
            // this thread read a[c * H] and at[c * H] above: overwrite them
            const bf16 d = __float2bfloat16_rn(bpre[c]);
            a[c * H] = d;
            at[c * H] = __float2bfloat16_rn(bpret[c]);
            db_acc[c] += __bfloat162float(d);
          }
        }
        for (int kc = kn; kc < KC; ++kc)
          for (int c = 0; c < 2; ++c) {
            pre_s[kc * ldp + c * H + hh] = __float2bfloat16_rn(0.0f);
            pret_s[kc * ldp + c * H + hh] = __float2bfloat16_rn(0.0f);
          }
      }
      __syncthreads();
      if (active) {
        // the cutm gradient: a fixed-order sum of the warp partials
        for (int s = hh; s < kn; s += H) {
          float sum = 0.0f;
          for (int w = 0; w < nw; ++w) sum += red_s[s * nw + w];
          gcutm[(size_t)i * p.k + c0 + s] = sum;
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
      gct[(size_t)i * H + hh] = gct_acc;
    }
  }
  if (has_w) {
#pragma unroll
    for (int c = 0; c < 2; ++c) db_part[((size_t)blockIdx.x * p.groups + g) * F + c * H + hh] = db_acc[c];
  }
}

bool valid_shape(int n, int k, int h, int heads, int rbf) {
  if (n <= 0 || k <= 0 || rbf <= 0 || rbf % 2 != 0 || heads <= 0 || h % 32 != 0 || h > 1024 ||
      h % heads != 0)
    return false;
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
  p.w_all = p.zw_all = p.zbk = p.zbv = nullptr;
  p.groups = p.iters = 0;
  return p;
}

}  // namespace

extern "C" {

const char* t_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// Returns a cudaError_t (0 on success).  Pointers to absent filters (wk/bk,
// wv/bv) are null.  Launches on `stream` and does not synchronise.
int t_fwd(const void* idx, int n, int k, int h, int heads, int rbf, const void* q, const void* kx,
          const void* v, const void* ea, const void* cutm, const void* wk, const void* bk,
          const void* wv, const void* bv, int act, int attn_act, void* out, void* stream) {
  if (!valid_shape(n, k, h, heads, rbf)) return (int)cudaErrorInvalidValue;
  Params p = make_params(idx, n, k, h, heads, rbf, q, kx, v, ea, cutm, wk, bk, wv, bv, act, attn_act);
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = plan_grid(&p, FWD, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(t_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  t_fwd_kernel<<<blocks, p.groups * h, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// The grid a kernel would launch (kind 0 forward, 1 backward, 2 second
// order): its block count and row groups per block, which size the
// per-block weight-gradient partials.
int t_plan(int kind, int n, int k, int h, int heads, int rbf, int* blocks, int* groups) {
  if (!valid_shape(n, k, h, heads, rbf)) return (int)cudaErrorInvalidValue;
  Params p = make_params(nullptr, n, k, h, heads, rbf, nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, nullptr, nullptr, 0, 0);
  size_t smem = 0;
  cudaError_t err = plan_grid(&p, kind, &smem, blocks);
  *groups = p.groups;
  return (int)err;
}

// dsrc is (N, K, 2H) bf16: per edge, the cotangents of k_j then v_j.
// dw_part (blocks, RBFP, 2H) and db_part (blocks * groups, 2H) f32 (t_plan's
// grid) receive the per-block weight cotangent partials; both null when the
// weights need no gradient.
int t_bwd(const void* idx, int n, int k, int h, int heads, int rbf, const void* q, const void* kx,
          const void* v, const void* ea, const void* cutm, const void* wk, const void* bk,
          const void* wv, const void* bv, int act, int attn_act, const void* ct, void* dq,
          void* dea, void* dcutm, void* dsrc, void* dw_part, void* db_part, void* stream) {
  if (!valid_shape(n, k, h, heads, rbf)) return (int)cudaErrorInvalidValue;
  Params p = make_params(idx, n, k, h, heads, rbf, q, kx, v, ea, cutm, wk, bk, wv, bv, act, attn_act);
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = plan_grid(&p, BWD, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(t_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  t_bwd_kernel<<<blocks, p.groups * h, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const float*>(ct), static_cast<float*>(dq), static_cast<bf16*>(dea),
      static_cast<float*>(dcutm), static_cast<bf16*>(dsrc), static_cast<float*>(dw_part),
      static_cast<float*>(db_part));
  return (int)cudaGetLastError();
}

// The second-order kernel.  z_* are the cotangents on t_bwd's outputs (all
// non-null: absent ones are zeros), w_all/zw_all the filters and their Z as
// (2H, RBFP) bf16 with zero rows for absent filters and zero padding
// columns.  Outputs: gq (N, H), gea (N, K, RBF) bf16, gcutm (N, K), gsrc
// (N, K, 2H) per-edge source-row gradients, gct (N, H), and the weight
// partials as for t_bwd (null without filters).  All f32 unless noted.
int t_bwd2(const void* idx, int n, int k, int h, int heads, int rbf, const void* q,
           const void* kx, const void* v, const void* ea, const void* cutm, const void* wk,
           const void* bk, const void* wv, const void* bv, int act, int attn_act, const void* ct,
           const void* zq, const void* zk, const void* zv, const void* zea, const void* zcutm,
           const void* w_all, const void* zw_all, const void* zbk, const void* zbv, void* gq,
           void* gea, void* gcutm, void* gsrc, void* gct, void* dw_part, void* db_part,
           void* stream) {
  if (!valid_shape(n, k, h, heads, rbf) || h > BWD2_MAX_THREADS) return (int)cudaErrorInvalidValue;
  Params p = make_params(idx, n, k, h, heads, rbf, q, kx, v, ea, cutm, wk, bk, wv, bv, act, attn_act);
  p.zq = static_cast<const bf16*>(zq);
  p.zk = static_cast<const bf16*>(zk);
  p.zv = static_cast<const bf16*>(zv);
  p.zea = static_cast<const bf16*>(zea);
  p.zcutm = static_cast<const float*>(zcutm);
  p.w_all = static_cast<const bf16*>(w_all);
  p.zw_all = static_cast<const bf16*>(zw_all);
  p.zbk = static_cast<const bf16*>(zbk);
  p.zbv = static_cast<const bf16*>(zbv);
  size_t smem = 0;
  int blocks = 0;
  cudaError_t err = plan_grid(&p, BWD2, &smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(t_bwd2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  t_bwd2_kernel<<<blocks, p.groups * h, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const float*>(ct), static_cast<float*>(gq), static_cast<bf16*>(gea),
      static_cast<float*>(gcutm), static_cast<float*>(gsrc), static_cast<float*>(gct),
      static_cast<float*>(dw_part), static_cast<float*>(db_part));
  return (int)cudaGetLastError();
}

}  // extern "C"
