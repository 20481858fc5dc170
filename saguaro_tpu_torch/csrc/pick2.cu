// K6: per-pixel two-level table pick (colocalization dense ranks).
//
// Replaces saguaro_tpu/kernels/segment_pallas.py::pick2_pallas (kernel
// _pick2_fn: hi-byte one-hot s8 MXU dot over byte planes of the tables,
// lo-byte masked reduction).
//
// out[b, i, c, k] = tables[b, c, hi[b, i, c], lo[b, i, c], k]
//
// Bound on the H100: bytes. A pixel reads its C hi and C lo codes (8C B)
// and writes C*K floats (4CK B: 100 B per pixel at 5 channels and 3 object
// sets); the tables (C x 256 x 256 x K floats, 3.9 MB per site at the main
// path's shapes) stay in the 50 MB L2. The TPU needed the byte-plane split
// and the one-hot dot because its gathers are slow; the H100 gathers
// directly, so this is a plain exact gather at hi*256 + lo: one thread per
// (pixel, channel) reads its two codes and writes its K values. Codes
// outside [0, 256) give 0.
#include "common.cuh"

__global__ void __launch_bounds__(SAG_THREADS)
sag_pick2_kernel(const int* __restrict__ hi, const int* __restrict__ lo,
                 const float* __restrict__ tables, float* __restrict__ out, long long n_items,
                 int n_ch, int k_tab) {
  const int b = blockIdx.z;
  const int* hi_site = hi + (size_t)b * n_items;
  const int* lo_site = lo + (size_t)b * n_items;
  const float* tab_site = tables + (size_t)b * n_ch * 65536 * k_tab;
  float* out_site = out + (size_t)b * n_items * k_tab;
  const long long stride = (long long)gridDim.y * blockDim.x;
  for (long long j = (long long)blockIdx.y * blockDim.x + threadIdx.x; j < n_items; j += stride) {
    // j = pixel * n_ch + channel
    const int c = (int)(j % n_ch);
    const int h = __ldg(hi_site + j), l = __ldg(lo_site + j);
    const bool ok = h >= 0 && h < 256 && l >= 0 && l < 256;
    const float* row = tab_site + ((size_t)c * 65536 + (ok ? h * 256 + l : 0)) * k_tab;
    for (int k = 0; k < k_tab; ++k) out_site[(size_t)j * k_tab + k] = ok ? __ldg(row + k) : 0.0f;
  }
}

// hi, lo (B, n, C) int32; tables (B, C, 256, 256, K) f32; out (B, n, C, K) f32.
extern "C" int sag_pick2(const int* hi, const int* lo, const float* tables, float* out,
                         int batch, long long n, int n_ch, int k_tab, void* stream) {
  if (n_ch < 1 || k_tab < 1) return (int)cudaErrorInvalidValue;
  const long long items = n * n_ch;
  long long blocks = (items + SAG_THREADS - 1) / SAG_THREADS;
  long long cap = (4096 + batch - 1) / batch;
  dim3 grid(1, (unsigned)(blocks < cap ? (blocks < 1 ? 1 : blocks) : cap), batch);
  sag_pick2_kernel<<<grid, SAG_THREADS, 0, (cudaStream_t)stream>>>(hi, lo, tables, out, items,
                                                                   n_ch, k_tab);
  return sag_status();
}
