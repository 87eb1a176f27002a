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
//
// What bounds it on an H100 at the STMV skin shapes (N = 30,336, W = 27 *
// cell capacity ~ 1026, k = 112): the bytes it must move are N*W*4 in
// (124.5 MB) and N*k*4 out (13.6 MB), 0.041 ms at 3.35 TB/s.  The function
// itself needs about one integer operation per key (a radix select, or a
// 27-way merge of the cells' already-ascending runs, looks at each key a
// bounded number of times): 3.1e7, a few microseconds on the integer units,
// so its bound is the bytes.  This design costs more: its min-extraction
// passes do one compare/select and one min per key per pass, about k*W per
// row (3.5e9 at most, fewer because a row stops once its real keys are used
// up), and it is bound by the issue rate of those instructions, well above
// the byte bound (PERF.md holds its times).
//
// What the design does about it (a simple kernel that is right first):
//   * one warp per row, eight rows per block; the row lives in registers,
//     KPL keys per lane, lane l holding columns l, l + 32, ...: every warp
//     load reads 128 contiguous bytes, so the only read of device memory is
//     one coalesced pass (rows are W*4 bytes apart, 8-byte aligned at W = 1026,
//     so 16-byte vector loads would need a realignment step; not worth it
//     here because the kernel is bound by instructions, not bytes);
//   * each pass takes, per lane, the smallest key above the previous pass's
//     minimum, then a 5-step __shfl_xor_sync butterfly minimum over the warp.
//     Nothing is retired by writing: "smallest above the last one" is the
//     same as the TPU kernel's retire-and-take-the-minimum for unique keys,
//     and leaves the registers read-only (no dynamic register indexing);
//   * a row stops at its first sentinel minimum and fills the rest with the
//     sentinel: the passes this data needs, not k;
//   * outputs are collected one per lane and stored 32 at a time
//     (coalesced), not one scalar store per pass;
//   * rows wider than the register budget (W > 64 * 32) take the KPL = 0
//     variant, which re-reads the row from L1/L2 on every pass.
// The TPU kernel's k-pass VPU loop over (256, W) VMEM tiles is not carried
// over: blocks here run in parallel with no tile to keep resident.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// This lane's smallest key (kFirst) or smallest key above `prev`; INT_MAX if none.
template <int KPL, int R, bool kFirst>
__device__ __forceinline__ int lane_min(const int (&v)[R], const int* __restrict__ krow, int w,
                                        int lane, int prev) {
  int m = INT_MAX;
  if (KPL > 0) {
#pragma unroll
    for (int i = 0; i < KPL; ++i) m = min(m, (kFirst || v[i] > prev) ? v[i] : INT_MAX);
  } else {
    for (int c = lane; c < w; c += 32) {
      const int x = __ldg(krow + c);
      m = min(m, (kFirst || x > prev) ? x : INT_MAX);
    }
  }
  return m;
}

template <int KPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
select_topk_kernel(const int* __restrict__ keys, int n, int w, int k, int sentinel,
                   int* __restrict__ out) {
  constexpr int R = KPL > 0 ? KPL : 1;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warps leave together: no block barrier follows
  const int* krow = keys + row * w;
  int* orow = out + row * k;

  int v[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = lane + 32 * i;
    v[i] = (KPL > 0 && c < w) ? __ldg(krow + c) : INT_MAX;
  }

  int m = warp_min(lane_min<KPL, R, true>(v, krow, w, lane, 0));
  int mine = sentinel;  // output slot j lives in lane j % 32 until its chunk of 32 is stored
  int j = 0;
  for (; j < k; ++j) {
    if (m >= sentinel) break;  // warp-uniform: the real keys are used up
    if ((j & 31) == lane) mine = m;
    if ((j & 31) == 31) {
      orow[j - 31 + lane] = mine;
      mine = sentinel;
    }
    if (j + 1 < k) m = warp_min(lane_min<KPL, R, false>(v, krow, w, lane, m));
  }
  // the open chunk (slots before j hold keys, the rest the sentinel), then
  // sentinel-only chunks up to k
  const int base = j & ~31;
  for (int c = base + lane; c < k; c += 32) orow[c] = c < base + 32 ? mine : sentinel;
}

template <int KPL>
void launch(const int* keys, int n, int w, int k, int sentinel, int* out, cudaStream_t s) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock));
  select_topk_kernel<KPL><<<grid, block, 0, s>>>(keys, n, w, k, sentinel, out);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // keys per lane; the rungs are the widths the cell list gives: small tests
  // (8), the default capacity 32 (W = 864: 27 per lane), the STMV skin probe
  // (capacity 38, W = 1026: 33), capacities up to 75 (64), then re-reading
  const int kpl = (w + 31) / 32;
  if (kpl <= 8) launch<8>(keys, n, w, k, sentinel, out, s);
  else if (kpl <= 32) launch<32>(keys, n, w, k, sentinel, out, s);
  else if (kpl <= 40) launch<40>(keys, n, w, k, sentinel, out, s);
  else if (kpl <= 64) launch<64>(keys, n, w, k, sentinel, out, s);
  else launch<0>(keys, n, w, k, sentinel, out, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
