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
// and the 0.8 MB of perm and writes 0.6 MB.  Each output needs two dependent
// trips to memory (the index, then the row), so at small N the latency of
// those trips, and not the bytes, sets the time.
//
// What bounded the first port:
//   * transpose-sum: a block of 256 threads held 16 atoms (16 threads of 8
//     channels each at F = 128) with their K slot ids in shared memory behind
//     a barrier; each thread walked its K rows in rounds of four 16-byte
//     loads, and the next four waited for the adds.  GN-aspirin training (N =
//     168, K = 32) launched 11 blocks on 132 SMs, each thread 8 dependent
//     rounds after the perm load (0.014 ms on the card alone); at DHFR 156
//     blocks (about 9.5 warps an SM, at most four loads in flight each) took
//     20 rounds for K = 80 and reached 36 % of the byte bound (88 % at STMV,
//     where 1896 blocks fill the card);
//   * gather: a block of 256 threads a tile of 64 rows read the tile's idx
//     into shared memory, waited at a barrier, then each thread ran about
//     four iterations of a load and the store that waited on it.  It wrote
//     at about 80 % of the byte bound at DHFR and 87 % at STMV: the stores
//     bound it, not the chain.
//
// What the design does about it:
//   * transpose-sum: a warp owns one atom's span of 64 channels (2 a lane, 4
//     bytes; two warps an atom at F = 128).  The atom's slot ids are read 32
//     at a time, coalesced, one a lane, and pass by __shfl_sync: no shared
//     memory and no barrier.  Each lane keeps a register ring of 16 slot
//     rows: each ring entry's refill (the row 16 slots on) is issued right
//     after its add, so 16 rows stay in flight while the adds walk the slots
//     in ascending order, and the next 32 slot ids arrive a chunk ahead.  A
//     refill past the last slot re-reads the last row: unconditional,
//     because a predicated refill makes the compiler load into a temporary
//     and move it into the ring, the move waiting on the load.  Blocks take 8
//     warps, fewer where that leaves SMs idle: 168 two-warp blocks at N =
//     168.  Tried on the card and dropped: 8 bytes a lane (one warp an atom)
//     with 32 rows in flight, whose compiled code held two rings (225
//     registers, 8 warps an SM: 14 % slower at DHFR, 3 % at STMV); 16 rows
//     at 8 bytes (122 registers: 8 % slower at DHFR, within 1 % at STMV);
//     32 rows at 4 bytes, or all K rows in flight at once (no gain); loads
//     that skip L1 (L1::no_allocate, or .cs: 10 % faster at DHFR, 1.5 %
//     slower at STMV, where MD launches it 78 times to DHFR's 30); rows
//     read in storage order instead of the list's, a cut (3 % faster at
//     DHFR: the DHFR system's random atom order costs little);
//   * gather: a block copies a tile of rpb * U rows.  Thread (ry, cx) copies
//     chunk cx (16 bytes) of U rows: its U source rows first, then all U
//     loads in flight before its first store.  U = 4, or 1 where four rows a
//     thread would leave SMs without a tile (GN-aspirin training: 336 blocks
//     of 16 rows).  Tried on the card and dropped: a persistent grid of the
//     SMs times the resident blocks walking the tiles with the next tile's
//     idx in flight (4 % slower at STMV), with U = 1 or 2 too; rows through
//     a shared-memory stage by cp.async.bulk with an mbarrier and the tile
//     written back by one bulk store (12 % slower at DHFR, 14 % at STMV);
//   * rows of a width that is not a multiple of the chunk, or at an
//     unaligned address, take narrower chunks (down to one bf16), so any
//     width runs: there is no width gate to fall back through;
//   * every offset is 64-bit: N*K*F exceeds 2^31 at STMV for TensorNet's
//     (N, K, 9H) rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kGatherThreads = 256;  // most threads a gather block
constexpr int kGatherUnroll = 4;     // rows a gather thread has in flight on a large grid
constexpr int kRing = 16;            // transpose-sum: slot rows in flight a lane (divides 32)
constexpr int kSumWarps = 8;         // transpose-sum: most warps (atom spans) a block

// V bf16 channels moved as one load
template <int V> struct Chunk;
template <> struct Chunk<8> { using T = int4; };
template <> struct Chunk<2> { using T = unsigned int; };
template <> struct Chunk<1> { using T = unsigned short; };

// out (rows, f) <- x[idx[r]]: block b copies the tile of rows b * rpb * U
// onwards; thread (ry, cx) copies chunks cx, cx + cw, ... of its U rows
// r0 + u * rpb, every load in flight before the first store
template <int V, int U>
__global__ void __launch_bounds__(kGatherThreads)
gather_rows_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ idx, int rows, int f,
                   int cw, __nv_bfloat16* __restrict__ out) {
  using T = typename Chunk<V>::T;
  const int fv = f / V;  // chunks a row
  const int rpb = blockDim.x / cw;
  const int cx = threadIdx.x % cw, ry = threadIdx.x / cw;
  const long long r0 = (long long)blockIdx.x * rpb * U + ry;
  const T* xv = reinterpret_cast<const T*>(x);
  T* ov = reinterpret_cast<T*>(out);
  int src[U];  // a row past the end reads the last row's source and stores nothing
#pragma unroll
  for (int u = 0; u < U; ++u) src[u] = __ldg(idx + min(r0 + u * rpb, (long long)rows - 1));
  for (int c = cx; c < fv; c += cw) {
    T v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = __ldg(xv + (long long)src[u] * fv + c);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r0 + u * rpb < rows) __stcs(ov + (r0 + u * rpb) * fv + c, v[u]);
  }
}

template <int V>
__device__ __forceinline__ void add_chunk(float (&acc)[V], const typename Chunk<V>::T& v) {
  if constexpr (V == 1) {
    acc[0] += __bfloat162float(__ushort_as_bfloat16(v));
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      acc[2 * i] += p.x;
      acc[2 * i + 1] += p.y;
    }
  }
}

template <int V>
__device__ __forceinline__ typename Chunk<V>::T round_chunk(const float (&acc)[V]) {
  typename Chunk<V>::T o;
  if constexpr (V == 1) {
    o = __bfloat16_as_ushort(__float2bfloat16_rn(acc[0]));
  } else {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
  }
  return o;
}

// dh[j] = sum over s < k of g[perm[j*k + s]]: warp w of the grid owns span
// w % spans (32 V channels, V a lane) of atom w / spans
template <int V>
__global__ void __launch_bounds__(kSumWarps * kWarp)
transpose_sum_rows_kernel(const __nv_bfloat16* __restrict__ g, const int32_t* __restrict__ perm, int n, int k,
                          int f, int spans, __nv_bfloat16* __restrict__ out) {
  using T = typename Chunk<V>::T;
  const int lane = threadIdx.x % kWarp;
  const int task = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (task >= n * spans) return;  // the whole warp: no shuffle waits on it
  const int j = task / spans;
  const int c = ((task - j * spans) * kWarp + lane) * V;  // the lane's first channel
  const int fv = f / V;
  // a lane past the width reads column 0 (its shuffles are needed) and stores nothing
  const T* col = reinterpret_cast<const T*>(g) + (c < f ? c / V : 0);
  const int32_t* slots = perm + (long long)j * k;
  const int last = k - 1;
  // slot ids 32 at a time, one a lane: the 32 the refills take now, and the next 32
  int cur = __ldg(slots + min(lane, last));
  int nxt = __ldg(slots + min(kWarp + lane, last));
  T ring[kRing];
#pragma unroll
  for (int u = 0; u < kRing; ++u) ring[u] = __ldg(col + (long long)__shfl_sync(~0u, cur, u) * fv);
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  int base = 0;
  for (; base + kRing < k; base += kRing) {  // every ring entry is a real slot; refill the next kRing
    const int from = base + kRing;           // the first slot refilled
    if (from % kWarp == 0) {
      cur = nxt;
      nxt = __ldg(slots + min(from + kWarp + lane, last));
    }
#pragma unroll
    for (int u = 0; u < kRing; ++u) {
      add_chunk<V>(acc, ring[u]);  // slot base + u
      ring[u] = __ldg(col + (long long)__shfl_sync(~0u, cur, from % kWarp + u) * fv);
    }
  }
#pragma unroll
  for (int u = 0; u < kRing; ++u)
    if (base + u < k) add_chunk<V>(acc, ring[u]);
  if (c < f) *reinterpret_cast<T*>(out + (long long)j * f + c) = round_chunk<V>(acc);
}

// the largest power of two (at most 16) that divides the address
int alignment(const void* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p) & 15u;
  return a == 0 ? 16 : (int)(a & (~a + 1));
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  static int cached[64] = {0};  // per device; a race writes the same value
  if (dev < 64 && cached[dev]) return cached[dev];
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) cached[dev] = sms;
  return sms;
}

struct Plan {
  const void* fn;
  int threads;
  int cw;     // gather: threads across a row
  int spans;  // transpose-sum: warps an atom
  long long blocks;
};

// #4 over `rows` rows of width f: 16-byte chunks where the rows and both
// pointers allow, else one bf16; U = 4 rows a thread unless that leaves SMs
// without a tile; one tile of rpb * U rows a block
cudaError_t gather_plan(long long rows, int f, int align, Plan* p) {
  const bool vec = f % 8 == 0 && align % 16 == 0;
  const int fv = vec ? f / 8 : f;
  p->cw = fv < kGatherThreads ? fv : kGatherThreads;
  const int rpb = kGatherThreads / p->cw;
  p->threads = p->cw * rpb;
  const long long most = (long long)rpb * kGatherUnroll;  // rows a tile at U = 4
  const int unroll = (rows + most - 1) / most >= sm_count() ? kGatherUnroll : 1;
  p->blocks = (rows + (long long)rpb * unroll - 1) / ((long long)rpb * unroll);
  p->spans = 0;
  if (vec)
    p->fn = unroll == 1 ? (const void*)gather_rows_kernel<8, 1> : (const void*)gather_rows_kernel<8, kGatherUnroll>;
  else
    p->fn = unroll == 1 ? (const void*)gather_rows_kernel<1, 1> : (const void*)gather_rows_kernel<1, kGatherUnroll>;
  return p->blocks > 0x7fffffffLL ? cudaErrorInvalidValue : cudaSuccess;
}

// #5 over n atoms of width f: V = 2 channels a lane (4 bytes) where the width
// and both pointers allow, else 1; 8 warps a block, halved while the grid
// would have fewer blocks than SMs
cudaError_t sum_plan(int n, int f, int align, Plan* p) {
  const int sms = sm_count();
  const int v = f % 2 == 0 && align % 4 == 0 ? 2 : 1;
  p->spans = (f + kWarp * v - 1) / (kWarp * v);
  const long long tasks = (long long)n * p->spans;
  int warps = kSumWarps;
  while (warps > 1 && (tasks + warps - 1) / warps < sms) warps /= 2;
  p->threads = warps * kWarp;
  p->blocks = (tasks + warps - 1) / warps;
  p->cw = 0;
  p->fn = v == 2 ? (const void*)transpose_sum_rows_kernel<2> : (const void*)transpose_sum_rows_kernel<1>;
  return tasks > 0x7fffffffLL ? cudaErrorInvalidValue : cudaSuccess;
}

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
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int align = alignment(x) < alignment(out) ? alignment(x) : alignment(out);
  Plan p;
  cudaError_t err = gather_plan(rows, f, align, &p);
  if (err != cudaSuccess) return (int)err;
  int r = (int)rows;
  void* args[] = {&x, &idx, &r, &f, &p.cw, &out};
  err = cudaLaunchKernel(p.fn, dim3((unsigned)p.blocks), dim3(p.threads), args, 0, static_cast<cudaStream_t>(stream));
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// g (n*k, f) bf16, perm (n*k,) int32 (the stable argsort of a symmetric
// list's idx), out (n, f) bf16; all contiguous.  Returns a cudaError_t.
int ell_transpose_sum_bf16(const void* g, const void* perm, int n, int k, int f, void* out, void* stream) {
  if (n <= 0 || f <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 0) return (int)cudaMemsetAsync(out, 0, (size_t)n * f * sizeof(__nv_bfloat16), s);  // no slots
  const int align = alignment(g) < alignment(out) ? alignment(g) : alignment(out);
  Plan p;
  cudaError_t err = sum_plan(n, f, align, &p);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&g, &perm, &n, &k, &f, &p.spans, &out};
  err = cudaLaunchKernel(p.fn, dim3((unsigned)p.blocks), dim3(p.threads), args, 0, s);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The resources of the kernel each plan takes at a shape with aligned
// pointers (kind 0: the gather of n*k rows; 1: the transpose-sum of n atoms
// of k slots), width f: out = registers a thread, local memory (spills) a
// thread, threads a block, shared memory a block, blocks an SM (occupancy
// calculator), blocks of the grid.  Returns a cudaError_t.
int ell_gather_resources(int kind, int n, int k, int f, int* out) {
  Plan p;
  cudaError_t err = kind == 0 ? gather_plan((long long)n * k, f, 16, &p) : sum_plan(n, f, 16, &p);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, p.fn);
  int per_sm = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p.fn, p.threads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = p.threads;
  out[3] = (int)attr.sharedSizeBytes;
  out[4] = per_sm;
  out[5] = (int)p.blocks;
  return 0;
}

}  // extern "C"
