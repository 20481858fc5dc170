// Shared helpers of the segment-reduction kernels (K1-K4).
//
// Every kernel takes a leading site-batch dimension (blockIdx.z = site), so
// one launch covers a whole site batch. Pixels ride blockIdx.y chunks and
// threadIdx.x; consecutive threads of a warp read consecutive pixels of a
// raster row, which in a label image usually belong to the same object.
// The accumulators exploit that: when every active lane of a warp carries
// the same label, the warp reduces its values with shuffles and one lane
// issues a single shared-memory atomic instead of 32 serialised ones.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SAG_FULL_MASK 0xffffffffu
#define SAG_THREADS 256

// K2's sentinel rule (segment_pallas._take_fn / onehot_reduce._bf16_split3):
// a table entry that is non-finite or at least 3.38e38 in magnitude (the
// +-3.4e38 empty-label sentinel of segment min/max) reads as 0.
__device__ __forceinline__ float sag_clean(float v) {
  return (isfinite(v) && fabsf(v) < 3.38e38f) ? v : 0.0f;
}

__device__ __forceinline__ float sag_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(SAG_FULL_MASK, v, o);
  return v;
}

// Per-warp accumulator into a shared (lanes x max_cells) block of float
// sums, restricted to the lane group [g0, g1) this block owns. All 32 lanes
// of a warp must call add() with the same lane index sequence: `uniform`
// and the shuffles inside are warp-collective.
struct SagAcc {
  float* sh;     // shared accumulator, (g1 - g0) rows of mc floats
  int mc;        // label slots
  int g0, g1;    // lane group owned by this block
  int lab;       // this thread's label slot (valid only when act)
  int lab0;      // the warp's common label when uniform
  bool act;      // this thread contributes
  bool uniform;  // every active lane of the warp shares lab0

  __device__ __forceinline__ void add(int idx, float v) {
    if (idx < g0 || idx >= g1) return;  // warp-uniform branch
    float* row = sh + (size_t)(idx - g0) * mc;
    if (uniform) {
      float r = sag_warp_sum(act ? v : 0.0f);
      if ((threadIdx.x & 31) == 0 && r != 0.0f) atomicAdd(row + lab0, r);
    } else if (act && v != 0.0f) {
      atomicAdd(row + lab, v);
    }
  }
};

// Fills the warp-level fields of `acc` for one pixel step; returns false
// when no lane of the warp is active (the whole warp may skip the step).
__device__ __forceinline__ bool sag_warp_setup(SagAcc& acc, bool act, int lab) {
  unsigned amask = __ballot_sync(SAG_FULL_MASK, act);
  if (amask == 0u) return false;
  int first = __ffs(amask) - 1;
  int lab0 = __shfl_sync(SAG_FULL_MASK, lab, first);
  acc.act = act;
  acc.lab = lab;
  acc.lab0 = lab0;
  acc.uniform = __all_sync(SAG_FULL_MASK, (!act) || lab == lab0);
  return true;
}

// Adds a block's shared sums into the global (B, mc, n_lanes) output,
// skipping slots the block never touched.
__device__ __forceinline__ void sag_flush(const float* sh, float* out_site,
                                         int mc, int n_lanes, int g0, int g1) {
  int n = (g1 - g0) * mc;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float v = sh[j];
    if (v != 0.0f) {
      int lane = g0 + j / mc;
      int lab = j % mc;
      atomicAdd(out_site + (size_t)lab * n_lanes + lane, v);
    }
  }
}

// Splits n_lanes into equal groups whose (group x mc) float accumulator fits
// `budget` bytes of shared memory. Returns the group width, or 0 when even
// one lane's accumulator does not fit.
static inline int sag_group_width(int n_lanes, int mc, int budget) {
  int per_lane = mc * (int)sizeof(float);
  if (per_lane > budget) return 0;
  int g = budget / per_lane;
  if (g >= n_lanes) return n_lanes;
  int n_groups = (n_lanes + g - 1) / g;
  return (n_lanes + n_groups - 1) / n_groups;
}

// Pixel chunks per site: enough blocks in all to keep every SM busy
// (132 SMs, a few resident blocks each), but at least ~2k pixels a block.
static inline int sag_chunks(long long n, int blocks_per_chunk) {
  long long by_size = (n + 2047) / 2048;
  long long target = (528 + blocks_per_chunk - 1) / blocks_per_chunk;
  long long c = by_size < target ? by_size : target;
  return c < 1 ? 1 : (int)c;
}

static inline int sag_status() { return (int)cudaGetLastError(); }
