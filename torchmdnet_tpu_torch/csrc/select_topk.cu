// Per-row k-smallest selection for Hopper (sm_90a): the neighbor-list
// compaction of the cell strategy.
//
// Replaces the Pallas TPU kernel of torchmdnet_tpu/ops/pallas/select_topk.py:
//   select_topk_kernel <- _kernel (:32, launched by select_topk at :69)
//
// What it computes: for each row of keys (N, W) int32, the row's k smallest
// entries in ascending order, written to out (N, k) int32, with the slots
// past the row's real keys set to `sentinel`.  Preconditions (the cell list
// meets them): real keys of a row are unique (an atom id sits in exactly one
// cell) and below `sentinel`; every other entry equals `sentinel`.  The result
// is then bitwise what sorting the row and keeping its first k columns gives.
// Nothing relies on the cells' runs being ascending.
//
// What bounds it on an H100 at the STMV skin shapes (N = 30,336, W = 27 *
// cell capacity ~ 1026, k = 112): the bytes it must move are N*W*4 in
// (124.5 MB) and N*k*4 out (13.6 MB), 0.041 ms at 3.35 TB/s; the function
// needs about one integer operation per key, a few microseconds, so its
// bound is the bytes.
//
// The first port extracted the minimum k times: one compare/select and one
// min per key per pass, a pass per output slot (3.85e9 int32 operations at
// the STMV skin shape, 0.23 ms at the int32 peak, 5.6x the byte bound), and
// it ran at 8.5 % of the byte bound (0.49 ms), bound by the issue rate of
// those instructions.  This design looks at each key a bounded number of
// times, whatever k:
//   * one warp per row, the row in registers (KPL keys per lane, lane l
//     holding columns l, l + 32, ...: one coalesced read of the row); rows
//     wider than the register budget (W > 64 * 32) take the KPL = 0
//     variant, which re-reads the row from L1/L2;
//   * the threshold: the k-th smallest key.  Keys become unsigned offsets
//     from the row's minimum (any int32 keys keep their order).  One count
//     of the real keys (per-lane compares and one warp sum, redux.sync)
//     settles a row with fewer than k of them: its threshold is the
//     sentinel, and every real key is kept (at the cell list's shapes, k is
//     above the true neighbor count, so nearly every row).  Other rows
//     search on value, one count a bit over 32 - clz(sentinel - min) bits
//     (15 at STMV);
//   * the keys at or below the threshold that are real (exactly k, or every
//     real key when the row has fewer) are compacted in row order into
//     shared memory with ballot/popc prefixes;
//   * each compacted key's rank is the count of smaller compacted keys
//     (unique keys: the ranks are distinct); it is written to its slot of a
//     second shared buffer, and the row's k slots are stored coalesced, the
//     sentinel past the real keys.
// About KPL compare/adds a lane for the count (bits x KPL more where a row
// has k real keys or more), KPL for the compaction and (m/32) x m compares
// for the ranks of its m <= k kept keys, against the first port's passes x
// (2 KPL + 5).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarpsPerBlock = 8;
constexpr int kDefaultSmem = 48 * 1024;

// the shared buffers' stride (ints) of one warp: compacted keys, then ranked
// keys, each k rounded up to 4 (the rank loop reads four at a time)
__host__ __device__ inline int warp_ints(int k) { return 2 * ((k + 3) & ~3); }

// offset of key x from the row minimum lo, as unsigned (order preserved)
__device__ __forceinline__ unsigned off(int x, int lo) { return (unsigned)x - (unsigned)lo; }

template <int KPL>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
select_topk_kernel(const int* __restrict__ keys, int n, int w, int k, int sentinel,
                   int* __restrict__ out) {
  extern __shared__ int smem[];
  constexpr int R = KPL > 0 ? KPL : 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= n) return;  // whole warps leave together: no block barrier follows
  const int* krow = keys + row * w;
  int* orow = out + row * k;
  int* sel = smem + warp * warp_ints(k);
  int* ord = sel + warp_ints(k) / 2;
  // the register rungs hold KPL keys a lane; this row needs kpl of them
  const int kpl = (w + 31) >> 5;

  // 1. the row, its minimum and the unsigned offsets (padding UINT_MAX: never counted)
  int lo = INT_MAX;
  unsigned u[R];
  if (KPL > 0) {
    int v[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < w ? __ldg(krow + c) : INT_MAX;
      lo = min(lo, v[i]);
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
#pragma unroll
    for (int i = 0; i < R; ++i) u[i] = lane + 32 * i < w ? off(v[i], lo) : UINT_MAX;
  } else {
    for (int c = lane; c < w; c += 32) lo = min(lo, __ldg(krow + c));
    lo = __reduce_min_sync(0xffffffffu, lo);
  }
  const unsigned top = off(sentinel, lo);

  // 2. the threshold t: the largest offset with fewer than k keys below it,
  // i.e. the k-th smallest key's offset.  A row with fewer than k real keys
  // (keys below the sentinel) has the sentinel's: one count finds it.
  auto count_below = [&](unsigned cand) {
    unsigned cnt = 0;
    if (KPL > 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (i >= KPL - 8 && i >= kpl) break;  // the rung's unused registers (warp-uniform)
        cnt += u[i] < cand;
      }
    } else {
      for (int c = lane; c < w; c += 32) cnt += off(__ldg(krow + c), lo) < cand;
    }
    return __reduce_add_sync(0xffffffffu, cnt);
  };
  unsigned t = top;
  if (count_below(top) >= (unsigned)k) {
    t = 0;
    for (int b = 31 - __clz((int)top); b >= 0; --b) {  // 32 - clz(top) bits
      const unsigned cand = t | (1u << b);
      if (count_below(cand) < (unsigned)k) t = cand;
    }
  }

  // 3. the real keys at or below the threshold (at most k), compacted in row order
  const unsigned below = (1u << lane) - 1u;
  int m = 0;
  auto take = [&](unsigned d) {
    const bool p = d <= t && d != top;
    const unsigned bal = __ballot_sync(0xffffffffu, p);
    const int at = m + __popc(bal & below);
    if (p && at < k) sel[at] = (int)(d + (unsigned)lo);
    m += __popc(bal);
  };
  if (KPL > 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i >= KPL - 8 && i >= kpl) break;
      take(u[i]);
    }
  } else {
    for (int c0 = 0; c0 < w; c0 += 32) take(c0 + lane < w ? off(__ldg(krow + c0 + lane), lo) : UINT_MAX);
  }
  m = min(m, k);
  if (lane < 4 && m + lane < ((m + 3) & ~3)) sel[m + lane] = INT_MAX;  // pad to four: never below a key
  __syncwarp();

  // 4. ranks: each lane ranks up to four compacted keys at a time against all of them
  for (int j0 = 0; j0 < m; j0 += 128) {
    int x[4], r[4] = {0, 0, 0, 0};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + 32 * q + lane;
      x[q] = j < m ? sel[j] : INT_MAX;
    }
    for (int i = 0; i < m; i += 4) {
      const int4 y = *reinterpret_cast<const int4*>(sel + i);
#pragma unroll
      for (int q = 0; q < 4; ++q) r[q] += (y.x < x[q]) + (y.y < x[q]) + (y.z < x[q]) + (y.w < x[q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (j0 + 32 * q + lane < m) ord[r[q]] = x[q];
  }
  __syncwarp();

  // 5. the row's k slots, coalesced
  for (int j = lane; j < k; j += 32) orow[j] = j < m ? ord[j] : sentinel;
}

// warps a block and dynamic shared memory a block for a given k
void plan(int k, int* warps, size_t* smem) {
  const size_t per_warp = (size_t)warp_ints(k) * sizeof(int);
  int wpb = kMaxWarpsPerBlock;
  while (wpb > 1 && wpb * per_warp > (size_t)kDefaultSmem) wpb /= 2;
  *warps = wpb;
  *smem = wpb * per_warp;
}

const void* kernel_for(int w) {
  // keys per lane; the rungs are multiples of 8 up to 64 (the cell list's
  // widths: 27 x the probed cell capacity), then re-reading
  const int kpl = (w + 31) / 32;
  if (kpl <= 8) return reinterpret_cast<const void*>(select_topk_kernel<8>);
  if (kpl <= 16) return reinterpret_cast<const void*>(select_topk_kernel<16>);
  if (kpl <= 24) return reinterpret_cast<const void*>(select_topk_kernel<24>);
  if (kpl <= 32) return reinterpret_cast<const void*>(select_topk_kernel<32>);
  if (kpl <= 40) return reinterpret_cast<const void*>(select_topk_kernel<40>);
  if (kpl <= 48) return reinterpret_cast<const void*>(select_topk_kernel<48>);
  if (kpl <= 56) return reinterpret_cast<const void*>(select_topk_kernel<56>);
  if (kpl <= 64) return reinterpret_cast<const void*>(select_topk_kernel<64>);
  return reinterpret_cast<const void*>(select_topk_kernel<0>);
}

// the kernel for width w with its shared memory allowed: (fn, warps, smem)
cudaError_t prepare(int w, int k, const void** fn, int* warps, size_t* smem) {
  plan(k, warps, smem);
  *fn = kernel_for(w);
  if (*smem > (size_t)kDefaultSmem)
    return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* select_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// keys (n, w) and out (n, k) int32, contiguous, 1 <= k <= w.  Returns a
// cudaError_t (0 on success).  Launches on `stream` and does not synchronise.
int select_topk(const int* keys, int n, int w, int k, int sentinel, int* out, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > w) return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  int warps = 0;
  size_t smem = 0;
  cudaError_t err = prepare(w, k, &fn, &warps, &smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&keys, &n, &w, &k, &sentinel, &out};
  const dim3 grid((unsigned)((n + warps - 1) / warps)), block(warps * 32);
  return (int)cudaLaunchKernel(fn, grid, block, args, smem, static_cast<cudaStream_t>(stream));
}

// The kernel's resources at a width and k: out = registers a thread, local
// (spill) bytes a thread, threads a block, dynamic shared memory a block,
// resident blocks an SM.
int select_topk_resources(int w, int k, int* out) {
  if (k < 1 || k > w) return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  int warps = 0;
  size_t smem = 0;
  cudaError_t err = prepare(w, k, &fn, &warps, &smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  int per_sm = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, warps * 32, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = warps * 32;
  out[3] = (int)smem;
  out[4] = per_sm;
  return 0;
}

}  // extern "C"
