// K5: bounded horizontal sweep of the exact label-aware EDT.
//
// Replaces saguaro_tpu/kernels/segment_pallas.py::edt_sweep_pallas
// (kernel _edt_sweep_fn: 32-row VMEM blocks, 2R+1 shifted min-adds).
//
// out[b, y, x] = min(d2[b, y, x], min over 1 <= dx <= R of
//                    min(v2[b, y, x - dx], v2[b, y, x + dx]) + dx*dx)
// with candidates outside the row read as +inf.
//
// Bound on the H100: bytes. Each pixel reads v2 and d2 once and writes one
// float (12 B); the 2R candidates per pixel are ~3 operations each, about a
// tenth of the byte time at R = 64. The TPU kernel kept a row block and its
// shifts in VMEM to avoid 2R+1 full-image passes; here one block takes one
// row: its threads stage the row with its +-R halo in shared memory (+inf
// outside the row), then each thread takes the min over its 2R candidates
// from shared memory. The values are integer-valued f32 (squared pixel
// distances) and every step is a min or one rounded add, as in the plain
// form, so the result is bit-exact.
#include "common.cuh"

__global__ void __launch_bounds__(SAG_THREADS)
sag_edt_sweep_kernel(const float* __restrict__ v2, const float* __restrict__ d2,
                     float* __restrict__ out, int h, int w, int radius) {
  extern __shared__ float row_sh[];  // w + 2 * radius floats
  const int y = blockIdx.x;
  const int b = blockIdx.y;
  const size_t base = ((size_t)b * h + y) * w;
  const int wp = w + 2 * radius;
  for (int j = threadIdx.x; j < wp; j += blockDim.x) {
    const int x = j - radius;
    row_sh[j] = (x >= 0 && x < w) ? __ldg(v2 + base + x) : __int_as_float(0x7f800000);  // +inf
  }
  __syncthreads();
  for (int x = threadIdx.x; x < w; x += blockDim.x) {
    float best = __ldg(d2 + base + x);
    const float* c = row_sh + radius + x;
    for (int dx = 1; dx <= radius; ++dx) {
      const float cand = fminf(c[-dx], c[dx]) + (float)(dx * dx);
      best = fminf(best, cand);
    }
    out[base + x] = best;
  }
}

// v2, d2, out (B, h, w) f32.
extern "C" int sag_edt_sweep(const float* v2, const float* d2, float* out, int batch, int h,
                             int w, int radius, void* stream) {
  if (radius < 0 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)(w + 2 * radius) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(sag_edt_sweep_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(h, batch);
  sag_edt_sweep_kernel<<<grid, SAG_THREADS, smem, (cudaStream_t)stream>>>(v2, d2, out, h, w,
                                                                          radius);
  return sag_status();
}
