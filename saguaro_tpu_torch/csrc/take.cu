// K2: per-pixel gather of a per-label table, transposed.
//
// Replaces saguaro_tpu/kernels/segment_pallas.py::seg_take_t_pallas
// (kernel _take_fn: 3-term bf16 split of the table contracted against a
// VMEM label one-hot on the MXU).
//
// out[b, k, i] = clean(table[b, seg[b, i], k]) with clean() zeroing
// non-finite entries and entries of magnitude >= 3.38e38 (the empty-label
// sentinel), and 0 for a label outside [0, mc).
//
// Bound on the H100: bytes. Per output element one 4-byte store, per pixel
// one 4-byte label load; the table (mc x K floats, ~14 KB at the main
// path's 512 x 7) stays in L1/L2. The one-hot contraction was the TPU's way
// around slow gathers and only approximated the table to ~1 ulp; on the
// H100 a gather is cheap, so this is a plain exact gather: one thread per
// pixel loads its label once and writes the pixel's K columns; for each
// column, consecutive threads store consecutive addresses (coalesced).
#include "common.cuh"

__global__ void __launch_bounds__(SAG_THREADS)
sag_take_t_kernel(const float* __restrict__ table, const int* __restrict__ seg,
                  float* __restrict__ out, long long n, int mc, int k_cols) {
  const int b = blockIdx.z;
  const float* tab = table + (size_t)b * mc * k_cols;
  const int* seg_site = seg + (size_t)b * n;
  float* out_site = out + (size_t)b * k_cols * n;
  const long long stride = (long long)gridDim.y * blockDim.x;
  for (long long i = (long long)blockIdx.y * blockDim.x + threadIdx.x; i < n; i += stride) {
    int lab = __ldg(seg_site + i);
    bool ok = lab >= 0 && lab < mc;
    const float* row = tab + (size_t)(ok ? lab : 0) * k_cols;
    for (int k = 0; k < k_cols; ++k) {
      out_site[(size_t)k * n + i] = ok ? sag_clean(__ldg(row + k)) : 0.0f;
    }
  }
}

// table (B, mc, K) f32; seg (B, n) int32; out (B, K, n) f32.
extern "C" int sag_take_t(const float* table, const int* seg, float* out, int batch,
                          long long n, int mc, int k_cols, void* stream) {
  long long blocks = (n + SAG_THREADS - 1) / SAG_THREADS;
  long long cap = (2048 + batch - 1) / batch;
  dim3 grid(1, (unsigned)(blocks < cap ? (blocks < 1 ? 1 : blocks) : cap), batch);
  sag_take_t_kernel<<<grid, SAG_THREADS, 0, (cudaStream_t)stream>>>(table, seg, out, n, mc,
                                                                    k_cols);
  return sag_status();
}
