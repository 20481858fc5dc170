// Shared helpers of the port's kernels (K1-K7).
//
// Every kernel takes a leading batch dimension, so one launch covers a
// whole site or image batch.
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

// Pixel chunks per site: enough blocks in all to keep every SM busy
// (132 SMs, a few resident blocks each), but at least ~2k pixels a block.
static inline int sag_chunks(long long n, int blocks_per_chunk) {
  long long by_size = (n + 2047) / 2048;
  long long target = (528 + blocks_per_chunk - 1) / blocks_per_chunk;
  long long c = by_size < target ? by_size : target;
  return c < 1 ? 1 : (int)c;
}

static inline int sag_status() { return (int)cudaGetLastError(); }

// A failed runtime call's code, with the thread's last error cleared so
// that the next launch's sag_status() does not report it again.
static inline int sag_clear(cudaError_t e) {
  cudaGetLastError();
  return (int)e;
}
