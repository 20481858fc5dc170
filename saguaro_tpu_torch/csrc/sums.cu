// K3: per-label sums of real-valued lanes.
//
// Replaces saguaro_tpu/kernels/segment_pallas.py::seg_sums_pallas
// (kernel _sums_fn: bf16 hi/lo split of the values contracted against a
// VMEM label one-hot on the MXU).
//
// out[b, lab, k] = sum of vals[b, i, k] over pixels i with labels[b, i] ==
// lab, for 0 <= lab < mc (other labels are dropped).
//
// Bound on the H100: bytes (4 + 4K bytes per pixel read once, one add per
// value). The TPU split each value into bf16 halves to use the MXU; here
// the sums are plain f32. Each block keeps (group x mc) partial sums in
// shared memory, a warp whose active lanes share one label reduces with
// shuffles and issues one atomic per value column, zero values are skipped
// (the main path's Euler stream is mostly zeros), and the block merges its
// non-zero partials into the global sums with one atomic each. Column groups
// split K when (K x mc) floats exceed the shared budget. Float atomics make
// the summation order, and so the last bits of a sum, vary between runs;
// sums of small integers (the Euler contributions) stay exact.
#include "common.cuh"

#define SAG_SUMS_SMEM (96 * 1024)

__global__ void __launch_bounds__(SAG_THREADS)
sag_sums_kernel(const int* __restrict__ labels, const float* __restrict__ vals,
                float* __restrict__ out, long long n, int k_cols, int mc, int group) {
  extern __shared__ float acc_sh[];
  const int b = blockIdx.z;
  const int g0 = blockIdx.x * group;
  const int g1 = min(g0 + group, k_cols);
  for (int j = threadIdx.x; j < (g1 - g0) * mc; j += blockDim.x) acc_sh[j] = 0.0f;
  __syncthreads();

  SagAcc acc;
  acc.sh = acc_sh;
  acc.mc = mc;
  acc.g0 = g0;
  acc.g1 = g1;
  const int* lab_site = labels + (size_t)b * n;
  const float* val_site = vals + (size_t)b * n * k_cols;
  const long long stride = (long long)gridDim.y * blockDim.x;
  for (long long start = (long long)blockIdx.y * blockDim.x; start < n; start += stride) {
    long long i = start + threadIdx.x;
    int lab = i < n ? lab_site[i] : -1;
    bool act = lab >= 0 && lab < mc;
    if (!sag_warp_setup(acc, act, lab)) continue;
    for (int k = g0; k < g1; ++k) {
      acc.add(k, act ? val_site[(size_t)i * k_cols + k] : 0.0f);
    }
  }
  __syncthreads();
  sag_flush(acc_sh, out + (size_t)b * mc * k_cols, mc, k_cols, g0, g1);
}

// labels (B, n) int32; vals (B, n, K) f32; out (B, mc, K) f32 zero-filled.
extern "C" int sag_sums(const int* labels, const float* vals, float* out, int batch,
                        long long n, int k_cols, int mc, void* stream) {
  int group = sag_group_width(k_cols, mc, SAG_SUMS_SMEM);
  if (group == 0) return (int)cudaErrorInvalidValue;
  int n_groups = (k_cols + group - 1) / group;
  size_t smem = (size_t)group * mc * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sag_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(n_groups, sag_chunks(n, batch * n_groups), batch);
  sag_sums_kernel<<<grid, SAG_THREADS, smem, (cudaStream_t)stream>>>(labels, vals, out, n,
                                                                     k_cols, mc, group);
  return sag_status();
}
