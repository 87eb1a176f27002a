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
//   row i of (idx, mask), K' = K + loop slots: with the loop, slot 0 holds i
//   itself (mask = the atom's validity); then the first K valid j in
//   ascending order (mask True), then i itself (mask False);
//   n_neighbors[i] = the count of every valid j (past K too, for overflow
//   checks).
// The list differs from the port's strategy="brute" list (Gram form
// |xi|^2 + |xj|^2 - 2 xi.xj on centred coordinates) only for pairs whose d2
// is within float rounding of a cutoff.
//
// What bounds it on an H100: N^2 pair tests of about 9 f32 operations (three
// subtractions, three products, two sums, the comparisons) against the
// output's bytes.  At DHFR (N = 2496, K = 80): 56 MFLOP, 0.8 us at 67
// TFLOP/s; 1 MB of output, 0.3 us at 3.35 TB/s.  The difference form cannot
// use fused multiply-adds, and each 32 pair tests also take a shared load, a
// ballot and its store, so the instructions a pair issues, not the FLOP
// rate, set the floor: about 3 us at DHFR across 528 schedulers (an
// estimate from counting instructions), with the launch and a round trip
// to memory for the rows and the stage on top.
//
// What bounded the first port (one warp a row, 8 rows a block, 312 blocks,
// the columns staged 256 at a time behind two barriers, the slots stored in
// the sweep behind a branch on each ballot), measured at N 2496 on an H100
// (PERF.md, section 6): 0.021-0.023 ms of device time alone at the
// DHFR and MD build shapes, and a build of five launches (the wrapper's
// int64 -> int32 conversion of the molecule ids, the kernel, and an arange
// and two concatenations for the self column).  Timed variants showed the
// sweep serialised by its per-step stores (each step's loads and arithmetic
// waited for the last step's branch), a fixed cost of dependent global
// loads (the id behind the mask's load) and a grid whose blocks fell
// unevenly on the SMs.
//
// What the design does about it:
//   * one launch a build: the kernel reads the molecule ids as they come
//     (int64 or int32) and the mask as bytes, and writes the self column
//     itself when asked;
//   * the column set is staged once a block: each column one 16-byte entry
//     (x, y, z, molecule id or a marker for a masked atom) in dynamic shared
//     memory, up to kMaxStage columns a stage (64 KB; stages walked in
//     ascending column order past that), every load of a stage issued in one
//     round before its one barrier, the id not behind the mask's load;
//   * the sweep stores nothing but each step's ballot word (into shared
//     memory) and has no branch, so the compiler interleaves the steps, each
//     step's entry loaded a step ahead;
//   * the compaction after each stage: lane l takes words l, l + 32, ...; a
//     warp scan of their popcounts gives each word's first slot, so the
//     slots fill in ascending column order with no atomics and the same list
//     on every run (the TPU kernel's prefix-sum matmul with a triangular
//     ones matrix and its one-hot insert were MXU workarounds); the self
//     pair (d2 = 0) is cleared from its word there, not tested in the sweep;
//   * one block an SM: ceil(N / SMs) rows a block as R = 1, 2 or 4 rows a
//     warp (each lane's entry tested against R rows), so no SM holds more
//     rows than another (at DHFR 132 blocks of 19 warps of one row; past
//     20 warps a block, R = 4 and 8 warps a block in several waves);
//   * offsets into the (N, K') outputs are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxStage = 4096;    // columns staged a pass: 64 KB of shared memory
constexpr int kMaxWarps = 20;      // warps a block
constexpr int kInvalidCol = -1;    // molecule id of a masked or padding column (real ids are >= 0)
constexpr int kInvalidRow = -2;    // of a masked or missing row: equal to no column's
constexpr int kStageUnroll = 8;    // columns a thread loads before it stores them: a stage in one round

struct Params {
  const float* pos;
  const void* batch;
  const uint8_t* atom_mask;
  int32_t* idx;
  uint8_t* mask;
  int32_t* count;
  int n, k, loop, stage;
  float cl2, cu2;
};

template <bool I64>
__device__ __forceinline__ int mol_id(const void* batch, int j) {
  if (I64) return (int)static_cast<const long long*>(batch)[j];
  return static_cast<const int*>(batch)[j];
}

template <int R, bool I64>
__global__ void __launch_bounds__(kMaxWarps * 32)
    compact_kernel(const Params p) {
  extern __shared__ float4 cols[];  // the stage's entries, then each row's ballot words
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = ((int)blockIdx.x * (int)(blockDim.x >> 5) + warp) * R;
  const int stage_pad = (p.stage + 31) & ~31;
  const int wmax = stage_pad >> 5;  // ballot words a row a stage
  unsigned* const words = reinterpret_cast<unsigned*>(cols + stage_pad) + warp * R * wmax;
  float xi[R], yi[R], zi[R];
  int bi[R], cnt[R];
  bool live = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
    xi[r] = yi[r] = zi[r] = 0.0f;
    bi[r] = kInvalidRow;
    cnt[r] = 0;
    if (i < p.n) {
      xi[r] = p.pos[(size_t)i * 3];
      yi[r] = p.pos[(size_t)i * 3 + 1];
      zi[r] = p.pos[(size_t)i * 3 + 2];
      const int id = mol_id<I64>(p.batch, i);  // not behind the mask's load: one round trip
      if (p.atom_mask[i]) bi[r] = id;
    }
    live |= bi[r] != kInvalidRow;
  }
  const size_t kk = (size_t)(p.k + p.loop);
  for (int c0 = 0; c0 < p.n; c0 += p.stage) {
    const int cn = min(p.stage, p.n - c0);
    const int cpad = (cn + 31) & ~31;  // padded with entries that match no row
    if (c0 > 0) __syncthreads();       // the last stage is done with
    for (int t0 = threadIdx.x; t0 < cpad; t0 += kStageUnroll * blockDim.x) {
      float4 e[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int t = t0 + u * blockDim.x;
        e[u] = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(kInvalidCol));
        if (t < cn) {
          const int j = c0 + t;
          e[u].x = p.pos[(size_t)j * 3];
          e[u].y = p.pos[(size_t)j * 3 + 1];
          e[u].z = p.pos[(size_t)j * 3 + 2];
          const int id = mol_id<I64>(p.batch, j);
          e[u].w = __int_as_float(p.atom_mask[j] ? id : kInvalidCol);
        }
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int t = t0 + u * blockDim.x;
        if (t < cpad) cols[t] = e[u];
      }
    }
    __syncthreads();
    if (!live) continue;
    // the sweep: no branch and no store but the ballot word, so the
    // compiler interleaves the steps' loads and arithmetic; the self pair
    // is valid here (d2 = 0) and cleared from its word below
    float4 next = cols[lane];  // each step's entry loaded a step ahead
#pragma unroll 4
    for (int s = 0; s < cpad; s += 32) {
      const float4 c = next;
      next = cols[min(s + 32, cpad - 32) + lane];
      const int cid = __float_as_int(c.w);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dx = __fsub_rn(xi[r], c.x);
        const float dy = __fsub_rn(yi[r], c.y);
        const float dz = __fsub_rn(zi[r], c.z);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        const bool valid = d2 < p.cu2 && d2 >= p.cl2 && cid == bi[r];
        const unsigned ball = __ballot_sync(0xffffffffu, valid);
        if (lane == 0) words[r * wmax + (s >> 5)] = ball;
      }
    }
    __syncwarp();
    // the compaction: lane l holds words l, l + 32, ...; a warp scan of
    // their popcounts gives each word's first slot, in ascending column order
    const int nw = cpad >> 5;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int self = row0 + r - c0;  // the row's own column in this stage, if 0 <= self < cn
      const size_t o = (size_t)(row0 + r) * kk + p.loop;
      int base = cnt[r];
      for (int w0 = 0; w0 < nw; w0 += 32) {
        const int w = w0 + lane;
        unsigned bits = w < nw ? words[r * wmax + w] : 0u;
        if (self >= 0 && w == (self >> 5)) bits &= ~(1u << (self & 31));
        const int c = __popc(bits);
        int inc = c;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int t = __shfl_up_sync(0xffffffffu, inc, d);
          if (lane >= d) inc += t;
        }
        for (int slot = base + inc - c; bits != 0u && slot < p.k; ++slot) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1u;
          p.idx[o + slot] = c0 + (w << 5) + b;
          p.mask[o + slot] = 1;
        }
        base += __shfl_sync(0xffffffffu, inc, 31);
      }
      cnt[r] = base;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {  // no break: a loop left rolled would put cnt in local memory
    const int i = row0 + r;
    if (i < p.n) {
      const size_t o = (size_t)i * kk + p.loop;
      for (int s = min(cnt[r], p.k) + lane; s < p.k; s += 32) {
        p.idx[o + s] = i;
        p.mask[o + s] = 0;
      }
      if (lane == 0) {
        p.count[i] = cnt[r];
        if (p.loop) {
          p.idx[o - 1] = i;
          p.mask[o - 1] = p.atom_mask[i];
        }
      }
    }
  }
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
  int rows;    // R, receiver rows a warp
  int warps;   // a block
  int stage;   // columns a stage
  int blocks;
  size_t smem;  // dynamic, a block
};

template <int R>
const void* kernel_for(bool i64) {
  return i64 ? reinterpret_cast<const void*>(compact_kernel<R, true>)
             : reinterpret_cast<const void*>(compact_kernel<R, false>);
}

// The launch plan: one block an SM, each with ceil(N / SMs) rows, as R = 1,
// 2 or 4 rows a warp (the fewest that fit kMaxWarps warps); past that, R =
// 4 and 8 warps a block in several waves.  The whole column set in one stage
// up to kMaxStage columns.
cudaError_t make_plan(int n, bool i64, Plan* p) {
  const int sms = sm_count();
  const int need = (n + sms - 1) / sms;
  int rows = 4, warps = 8;
  for (int r = 1; r <= 4; r *= 2) {
    if ((need + r - 1) / r <= kMaxWarps) {
      rows = r;
      warps = (need + r - 1) / r;
      break;
    }
  }
  const int stage = std::min(kMaxStage, n);
  p->rows = rows;
  p->warps = warps;
  p->stage = stage;
  p->blocks = (n + rows * warps - 1) / (rows * warps);
  const size_t stage_pad = (size_t)((stage + 31) & ~31);
  p->smem = stage_pad * sizeof(float4) + (size_t)warps * rows * (stage_pad / 32) * sizeof(unsigned);
  p->fn = rows == 4 ? kernel_for<4>(i64) : rows == 2 ? kernel_for<2>(i64) : kernel_for<1>(i64);
  if (p->smem > 48 * 1024)
    return cudaFuncSetAttribute(p->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->smem);
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* compaction_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// pos (N, 3) f32, batch (N,) int64 (batch_i64 != 0) or int32, ids >= 0,
// atom_mask (N,) uint8 (0/1); outputs idx (N, K + loop) int32, mask (N, K +
// loop) uint8, count (N,) int32.  cl2/cu2 are the squared cutoffs in f32.
// Returns a cudaError_t (0 on success).  Launches on `stream` and does not synchronise.
int compact_neighbors(const void* pos, const void* batch, int batch_i64, const void* atom_mask, int n, int k,
                      int loop, float cl2, float cu2, void* idx, void* mask, void* count, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  Plan plan;
  cudaError_t err = make_plan(n, batch_i64 != 0, &plan);
  if (err != cudaSuccess) return (int)err;
  Params p{static_cast<const float*>(pos), batch, static_cast<const uint8_t*>(atom_mask),
           static_cast<int32_t*>(idx), static_cast<uint8_t*>(mask), static_cast<int32_t*>(count),
           n, k, loop ? 1 : 0, plan.stage, cl2, cu2};
  void* args[] = {&p};
  return (int)cudaLaunchKernel(plan.fn, dim3((unsigned)plan.blocks), dim3((unsigned)plan.warps * 32), args,
                               plan.smem, static_cast<cudaStream_t>(stream));
}

// The launch plan and the kernel's resources at N atoms (int64 ids): out =
// registers a thread, local (spill) bytes a thread, threads a block, shared memory a block (static +
// dynamic), resident blocks an SM, blocks launched, rows a warp, columns a
// stage.
int compaction_resources(int n, int* out) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  Plan plan;
  cudaError_t err = make_plan(n, true, &plan);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, plan.fn);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, plan.fn, plan.warps * 32, plan.smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = plan.warps * 32;
  out[3] = (int)(attr.sharedSizeBytes + plan.smem);
  out[4] = per_sm;
  out[5] = plan.blocks;
  out[6] = plan.rows;
  out[7] = plan.stage;
  return 0;
}

}  // extern "C"
