// K1: fused per-label histograms (exact integer counts).
//
// Replaces saguaro_tpu/kernels/segment_pallas.py::seg_counts_pallas
// (kernel _counts_fn, s8 one-hot MXU contraction per pixel tile).
//
// out[b, lab, off_q + code] += 1 for every pixel i of site b and code plane
// q with 0 <= lab < mc and 0 <= code < n_q (code -1 marks an invalid pixel).
//
// Bound on the H100: bytes. Each pixel is read once (a 4-byte label and one
// 4-byte code per plane) and costs one integer increment; the histogram is
// tiny. The TPU needed the one-hot matmul because its scatters serialise;
// here the design keeps the increments on-chip instead: each block holds a
// private (mc x total) int histogram in shared memory, lanes of a warp that
// hit the same bin merge first (__match_any_sync + one atomic of the peer
// count), and the block adds its non-zero bins to the global histogram with
// integer atomics. Integer sums are exact and order-free, so the result is
// deterministic. A histogram too large for shared memory counts straight
// into global memory with the same warp merge (the measurement's GLCM,
// neighbour, value-count and Costes joint tables take this path). The plan
// of column offsets and sizes is read from global memory (it stays in L1),
// so a call takes any number of code planes.
#include "common.cuh"

#define SAG_COUNTS_SMEM (200 * 1024)

__global__ void __launch_bounds__(SAG_THREADS)
sag_counts_kernel(const int* __restrict__ labels, const int* __restrict__ codes,
                  const int* __restrict__ plan, int* __restrict__ out,
                  long long n, int q_planes, int mc, int total, int shared_hist) {
  extern __shared__ int hist_sh[];
  const int b = blockIdx.z;
  int* out_site = out + (size_t)b * mc * total;
  int* h = shared_hist ? hist_sh : out_site;
  if (shared_hist) {
    for (int j = threadIdx.x; j < mc * total; j += blockDim.x) hist_sh[j] = 0;
  }
  __syncthreads();

  const int* lab_site = labels + (size_t)b * n;
  const int* code_site = codes + (size_t)b * q_planes * n;
  const long long stride = (long long)gridDim.y * blockDim.x;
  for (long long start = (long long)blockIdx.y * blockDim.x; start < n; start += stride) {
    long long i = start + threadIdx.x;
    bool in = i < n;
    int lab = in ? lab_site[i] : -1;
    bool lab_ok = in && lab >= 0 && lab < mc;
    for (int q = 0; q < q_planes; ++q) {
      int code = in ? code_site[(size_t)q * n + i] : -1;
      const int size_q = __ldg(plan + q_planes + q);
      int key = (lab_ok && code >= 0 && code < size_q) ? lab * total + __ldg(plan + q) + code : -1;
      unsigned peers = __match_any_sync(SAG_FULL_MASK, key);
      int leader = __ffs(peers) - 1;
      if (key >= 0 && (int)(threadIdx.x & 31) == leader) atomicAdd(h + key, __popc(peers));
    }
  }
  if (!shared_hist) return;
  __syncthreads();
  for (int j = threadIdx.x; j < mc * total; j += blockDim.x) {
    int v = hist_sh[j];
    if (v != 0) atomicAdd(out_site + j, v);
  }
}

// labels (B, n) int32; codes (B, q_planes, n) int32; plan (2 * q_planes)
// int32 device array holding the column offset then the size of each plane;
// out (B, mc, total) int32, zero-filled by the caller.
extern "C" int sag_counts(const int* labels, const int* codes, const int* plan,
                          int* out, int batch, long long n, int q_planes, int mc,
                          int total, void* stream) {
  if (q_planes < 1) return (int)cudaErrorInvalidValue;
  size_t hist_bytes = (size_t)mc * total * sizeof(int);
  int shared_hist = hist_bytes <= SAG_COUNTS_SMEM;
  size_t smem = shared_hist ? hist_bytes : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sag_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(1, sag_chunks(n, batch), batch);
  sag_counts_kernel<<<grid, SAG_THREADS, smem, (cudaStream_t)stream>>>(
      labels, codes, plan, out, n, q_planes, mc, total, shared_hist);
  return sag_status();
}
