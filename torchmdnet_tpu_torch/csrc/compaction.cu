// Fused brute-force neighbor search with ordered stream compaction for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of torchmdnet_tpu/ops/pallas/compaction.py:
//   compact_kernel <- _kernel (:31, launched by compact_neighbors_pallas at :159)
//
// What it computes, for atoms i, j of positions pos (N, 3) f32, molecule ids
// batch (N,) and a validity mask (N,):
//   valid(i, j) = d2 < cutoff_upper^2 and d2 >= cutoff_lower^2 and
//                 batch[i] == batch[j] and both atoms real and j != i,
//   d2 = dx*dx + dy*dy + dz*dz, dx = x_i - x_j (each product and sum rounded
//   once in f32, no fused multiply-add: the arithmetic of the JAX kernel,
//   compaction.py:68-71, and of the plain PyTorch version, so the lists are
//   bitwise equal);
//   idx[i, :] = the first K valid j in ascending order, then i itself; mask
//   True on the filled slots; n_neighbors[i] = the count of every valid j
//   (past K too, for overflow checks).
// The list differs from the port's strategy="brute" list (Gram form
// |xi|^2 + |xj|^2 - 2 xi.xj on centred coordinates) only for pairs whose d2
// is within float rounding of a cutoff.
//
// What bounds it on an H100: N^2 pair tests of about 9 f32 operations (three
// subtractions, three products, two sums, the comparisons) against the
// output's bytes.  At DHFR (N = 2496, K = 80): 56 MFLOP, 0.8 us at 67
// TFLOP/s; 1 MB of output, 0.3 us at 3.35 TB/s.  Operations bound it.
//
// What the design does about it:
//   * one warp per receiver row; it sweeps the columns in tiles of 32 in
//     ascending j, each lane testing one pair;
//   * the slot of a valid pair is the row's running count plus the popcount
//     of the warp's ballot below the lane: no atomics, ascending order, and
//     the same list on every run (the TPU kernel's prefix-sum matmul with a
//     triangular ones matrix and its one-hot insert were MXU workarounds);
//   * the rows of a block share the column positions, staged into shared
//     memory one 256-column tile at a time;
//   * offsets into the (N, K) outputs are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // receiver rows per block
constexpr int kTile = kWarps * 32;   // columns staged per pass
constexpr int kInvalid = -1;         // batch id of a masked column (real ids are >= 0)

__global__ void __launch_bounds__(kTile)
    compact_kernel(const float* __restrict__ pos, const int32_t* __restrict__ batch,
                   const uint8_t* __restrict__ atom_mask, int n, int k, float cl2, float cu2,
                   int32_t* __restrict__ idx, uint8_t* __restrict__ mask,
                   int32_t* __restrict__ count) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  __shared__ int32_t sb[kTile];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarps + warp;
  const bool row_ok = i < n;
  float xi = 0.0f, yi = 0.0f, zi = 0.0f;
  int32_t bi = kInvalid;
  if (row_ok) {
    xi = pos[(size_t)i * 3];
    yi = pos[(size_t)i * 3 + 1];
    zi = pos[(size_t)i * 3 + 2];
    if (atom_mask[i]) bi = batch[i];
  }
  const bool live = bi != kInvalid;  // the same for the whole warp
  int cnt = 0;
  for (int c0 = 0; c0 < n; c0 += kTile) {
    __syncthreads();  // the last tile is done with
    const int j = c0 + threadIdx.x;
    if (j < n) {
      sx[threadIdx.x] = pos[(size_t)j * 3];
      sy[threadIdx.x] = pos[(size_t)j * 3 + 1];
      sz[threadIdx.x] = pos[(size_t)j * 3 + 2];
      sb[threadIdx.x] = atom_mask[j] ? batch[j] : kInvalid;
    }
    __syncthreads();
    if (!live) continue;
    const int tn = min(kTile, n - c0);
    for (int s = 0; s < tn; s += 32) {
      const int t = s + lane;
      bool valid = false;
      if (t < tn) {
        const float dx = __fsub_rn(xi, sx[t]);
        const float dy = __fsub_rn(yi, sy[t]);
        const float dz = __fsub_rn(zi, sz[t]);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        valid = d2 < cu2 && d2 >= cl2 && sb[t] == bi && c0 + t != i;
      }
      const unsigned ball = __ballot_sync(0xffffffffu, valid);
      if (valid) {
        const int slot = cnt + __popc(ball & ((1u << lane) - 1u));
        if (slot < k) {
          idx[(size_t)i * k + slot] = c0 + t;
          mask[(size_t)i * k + slot] = 1;
        }
      }
      cnt += __popc(ball);
    }
  }
  if (!row_ok) return;
  for (int s = min(cnt, k) + lane; s < k; s += 32) {
    idx[(size_t)i * k + s] = i;
    mask[(size_t)i * k + s] = 0;
  }
  if (lane == 0) count[i] = cnt;
}

}  // namespace

extern "C" {

const char* compaction_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// pos (N, 3) f32, batch (N,) int32 (>= 0), atom_mask (N,) uint8 (0/1);
// outputs idx (N, K) int32, mask (N, K) uint8, count (N,) int32.  cl2/cu2 are
// the squared cutoffs in f32.  Returns a cudaError_t (0 on success).
// Launches on `stream` and does not synchronise.
int compact_neighbors(const void* pos, const void* batch, const void* atom_mask, int n, int k,
                      float cl2, float cu2, void* idx, void* mask, void* count, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kWarps - 1) / kWarps;
  compact_kernel<<<blocks, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const int32_t*>(batch),
      static_cast<const uint8_t*>(atom_mask), n, k, cl2, cu2, static_cast<int32_t*>(idx),
      static_cast<uint8_t*>(mask), static_cast<int32_t*>(count));
  return (int)cudaGetLastError();
}

}  // extern "C"
