// The ELL row gather and its transpose for Hopper (sm_90a): the message
// gathers of the graph network (and of every other bf16 (N, F) row gather).
//
// Replaces the Pallas TPU kernels of torchmdnet_tpu/ops/pallas/onehot_gather.py:
//   gather_rows_kernel         <- _gather_kernel    (:178, launched by onehot_gather at :211)
//   transpose_sum_rows_kernel  <- _transpose_kernel (:227, launched by onehot_transpose_sum at :277)
//
// What they compute, for a symmetric ELL neighbor list idx (N, K) int32:
//   gather:        out[i, k, :] = x[idx[i, k], :]            x (n_src, F) bf16 -> out (N, K, F) bf16
//   transpose-sum: dh[j, :] = sum of g[i, k, :] over the slots (i, k) with idx[i, k] == j,
//                  g (N, K, F) bf16 -> dh (N, F) bf16, summed in f32 in ascending slot order
//                  (perm = the stable argsort of idx, `transpose_perm`: atom j's K slots
//                  are perm[j*K .. j*K + K)), rounded once to bf16.
// The gather is exact.  The transpose-sum adds no float atomics, so its result
// (and every force through it) is bitwise the same from run to run.
//
// What bounds them on an H100: neither does arithmetic worth counting (one f32
// add per input element for the transpose), so the bound is the bytes.  At
// GN's DHFR shapes (N = 2496, K = 80, F = 128) the gather reads N*F*2 bytes of
// rows (0.6 MB: once, the rest from L2) and N*K*4 of idx (0.8 MB) and writes
// N*K*F*2 (51 MB): 15.7 us at 3.35 TB/s.  The transpose reads the 51 MB of g
// and the 0.8 MB of perm and writes 0.6 MB.  What costs more than the bound is
// the latency of the random row reads: the transpose reads K rows of 2F bytes
// scattered over g for every output row.
//
// What the design does about it (a simple kernel that is right first):
//   * no one-hot matrix product and no block gather plan: those were TPU
//     layout workarounds (the MXU gathering for a VPU that cannot); here a
//     thread copies its 16 bytes by index;
//   * gather: a block owns a tile of output rows; it reads the tile's idx
//     once, coalesced, into shared memory, then each thread copies 16-byte
//     chunks (8 bf16) with ld.global.nc loads (the rows stay in L1/L2: every
//     source row is read about K times) and streaming stores (the output is
//     read by the next op, not by this one);
//   * transpose-sum: a block owns a few target atoms; it reads their K perm
//     entries into shared memory, then each thread adds its 8 channels of
//     the K slot rows in f32 registers in slot order, four rows' loads in
//     flight at a time, and stores 16 bytes of bf16;
//   * F % 8 != 0 or unaligned pointers take a scalar path (one bf16 per
//     thread), so any width runs: there is no width gate to fall back through;
//   * every offset is 64-bit: N*K*F exceeds 2^31 at STMV for TensorNet's
//     (N, K, 9H) rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGatherRows = 64;  // output rows per gather block

__device__ __forceinline__ int4 load_nc(const int4* p) {
  int4 v;
  asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// out (rows, f) <- x[idx[r]] for r in the block's tile; VEC: 16-byte chunks
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ idx,
                  long long rows, int f, __nv_bfloat16* __restrict__ out) {
  __shared__ int32_t src[kGatherRows];
  const long long r0 = (long long)blockIdx.x * kGatherRows;
  const int nrows = (int)min((long long)kGatherRows, rows - r0);
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) src[r] = __ldg(idx + r0 + r);
  __syncthreads();
  const int chunks = VEC ? f / 8 : f;  // per row
  const long long total = (long long)nrows * chunks;
  for (long long t = threadIdx.x; t < total; t += blockDim.x) {
    const int r = (int)(t / chunks);
    const int c = (int)(t - (long long)r * chunks);
    const long long s = src[r];
    const long long o = r0 + r;
    if (VEC) {
      const int4 v = load_nc(reinterpret_cast<const int4*>(x + s * f) + c);
      __stcs(reinterpret_cast<int4*>(out + o * f) + c, v);
    } else {
      out[o * f + c] = x[s * f + c];
    }
  }
}

__device__ __forceinline__ void add8(float* a, const int4& v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    a[2 * i] += p.x;
    a[2 * i + 1] += p.y;
  }
}

// dh[j] = sum over s < k of g[perm[j*k + s]] for the block's target atoms j;
// `per` threads per atom (a chunk of 8 channels, or one channel, each)
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
transpose_sum_rows_kernel(const __nv_bfloat16* __restrict__ g, const int32_t* __restrict__ perm,
                         int n, int k, int f, int per, __nv_bfloat16* __restrict__ out) {
  extern __shared__ int32_t slots[];  // (atoms per block, k)
  const int apb = blockDim.x / per;
  const long long j0 = (long long)blockIdx.x * apb;
  const int natoms = (int)min((long long)apb, (long long)n - j0);
  for (int t = threadIdx.x; t < natoms * k; t += blockDim.x) slots[t] = __ldg(perm + j0 * k + t);
  __syncthreads();
  const int a = threadIdx.x / per;
  if (a >= natoms) return;  // no barrier follows
  const int32_t* sl = slots + a * k;
  const long long j = j0 + a;
  const int chunks = VEC ? f / 8 : f;
  for (int c = threadIdx.x - a * per; c < chunks; c += per) {
    if (VEC) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      int s = 0;
      for (; s + 4 <= k; s += 4) {  // four rows in flight, added in slot order
        int4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = load_nc(reinterpret_cast<const int4*>(g + (long long)sl[s + u] * f) + c);
#pragma unroll
        for (int u = 0; u < 4; ++u) add8(acc, v[u]);
      }
      for (; s < k; ++s) add8(acc, load_nc(reinterpret_cast<const int4*>(g + (long long)sl[s] * f) + c));
      int4 o;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
      reinterpret_cast<int4*>(out + j * f)[c] = o;
    } else {
      float acc = 0.f;
      for (int s = 0; s < k; ++s) acc += __bfloat162float(g[(long long)sl[s] * f + c]);
      out[j * f + c] = __float2bfloat16_rn(acc);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

const char* ell_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (n_src, f) bf16, idx (rows,) int32 with entries in [0, n_src), out (rows, f)
// bf16; all contiguous.  Returns a cudaError_t (0 on success).  Launches on
// `stream` and does not synchronise.
int ell_gather_bf16(const void* x, const void* idx, long long rows, int f, void* out, void* stream) {
  if (rows <= 0 || f <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((rows + kGatherRows - 1) / kGatherRows));
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* ib = static_cast<const int32_t*>(idx);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (f % 8 == 0 && aligned16(x) && aligned16(out))
    gather_rows_kernel<true><<<grid, kThreads, 0, s>>>(xb, ib, rows, f, ob);
  else
    gather_rows_kernel<false><<<grid, kThreads, 0, s>>>(xb, ib, rows, f, ob);
  return (int)cudaGetLastError();
}

// g (n*k, f) bf16, perm (n*k,) int32 (the stable argsort of a symmetric
// list's idx), out (n, f) bf16; all contiguous.  Returns a cudaError_t.
int ell_transpose_sum_bf16(const void* g, const void* perm, int n, int k, int f, void* out,
                           void* stream) {
  if (n <= 0 || f <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = f % 8 == 0 && aligned16(g) && aligned16(out);
  const int chunks = vec ? f / 8 : f;
  const int per = chunks < kThreads ? chunks : kThreads;  // threads per atom
  // atoms per block: as many as fill the block, as far as their K slot ids
  // fit in the default 48 KB of shared memory
  const int fit = (48 * 1024) / (k * (int)sizeof(int32_t));
  if (fit < 1) return (int)cudaErrorInvalidValue;  // K > 12288
  const int apb = kThreads / per < fit ? kThreads / per : fit;
  const size_t smem = (size_t)apb * k * sizeof(int32_t);
  const dim3 grid((unsigned)((n + apb - 1) / apb));
  const dim3 block((unsigned)(apb * per));
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  const auto* pb = static_cast<const int32_t*>(perm);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (vec)
    transpose_sum_rows_kernel<true><<<grid, block, smem, s>>>(gb, pb, n, k, f, per, ob);
  else
    transpose_sum_rows_kernel<false><<<grid, block, smem, s>>>(gb, pb, n, k, f, per, ob);
  return (int)cudaGetLastError();
}

}  // extern "C"
