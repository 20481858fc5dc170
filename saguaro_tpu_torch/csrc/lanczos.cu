// K7: separable Lanczos-3 re-binning with PIL-parity weights.
//
// Replaces saguaro_tpu/kernels/resample_pallas.py::lanczos_resize_pallas and
// lanczos_resize_batch_pallas (kernel _kernel: per 128 x 128 output tile, a
// DMA'd input window and two banded MXU matmuls RyBand @ window @ RxBand).
//
// out[b, i, j] = sum_y sum_x Ry[i, y] * img[b, y, x] * Rx[j, x], where each
// output's taps lie in one window per axis: y in [y0[i], y0[i] + ny[i]) and
// x in [x0[j], x0[j] + nx[j]). The host builds these PIL coefficient tables
// (start, count, weights) from the same f32 matrices the plain form
// multiplies, border windows clipped and renormalised, so the kernel needs
// no padding and multiplies no zeros outside a window.
//
// Bound on the H100: bytes. At 2160^2 uint16 -> 1080^2 each output takes
// about 12 taps per axis, about 50 flops per output pixel in all, against
// 2 B read per input pixel and 4 B written per output pixel. The TPU kernel
// padded its windows to the (8, 128) DMA tiling and fed the MXU bands that
// are mostly zeros; here a block owns a 32 x 32 output tile, stages its
// input window in shared memory in chunks of at most 80 rows x 96 columns
// (the whole window at scale 2), converts the input to f32 as it stages
// it, runs the vertical pass into a shared (32 x chunk-width) intermediate
// and then the horizontal pass into registers, four outputs a thread. The
// chunking keeps shared memory fixed for any ratio: downsampling at any
// scale (support 3 * scale), upsampling (support 3), odd and non-square
// sizes. Sums are f32 FMAs over the taps in increasing input order.
#include <climits>

#include "common.cuh"

#define LZ_TILE 32  // outputs per block along each axis
#define LZ_ROWS 80  // input rows staged per chunk
#define LZ_COLS 96  // input columns staged per chunk
#define LZ_PER_THREAD (LZ_TILE * LZ_TILE / SAG_THREADS)

static_assert(LZ_TILE * LZ_TILE == LZ_PER_THREAD * SAG_THREADS, "tile must split evenly");

template <typename T>
__global__ void __launch_bounds__(SAG_THREADS)
sag_lanczos_kernel(const T* __restrict__ img, float* __restrict__ out,
                   const int* __restrict__ y0, const int* __restrict__ ny,
                   const float* __restrict__ wy, int ky,
                   const int* __restrict__ x0, const int* __restrict__ nx,
                   const float* __restrict__ wxt, int in_h, int in_w, int out_h, int out_w) {
  __shared__ float win[LZ_ROWS][LZ_COLS];  // staged input chunk, f32
  __shared__ float tmp[LZ_TILE][LZ_COLS];  // vertical pass of the column chunk
  __shared__ int span[4];                  // the tile's input rows [0, 1), columns [2, 3)
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * LZ_TILE;
  const int j0 = blockIdx.x * LZ_TILE;
  const int ti = min(LZ_TILE, out_h - i0);
  const int tj = min(LZ_TILE, out_w - j0);
  const T* src = img + (size_t)b * in_h * in_w;
  const int t = threadIdx.x;

  // the union of the tile's output windows along each axis
  if (t == 0) {
    span[0] = INT_MAX;
    span[1] = INT_MIN;
    span[2] = INT_MAX;
    span[3] = INT_MIN;
  }
  __syncthreads();
  if (t < ti && ny[i0 + t] > 0) {
    atomicMin(&span[0], y0[i0 + t]);
    atomicMax(&span[1], y0[i0 + t] + ny[i0 + t]);
  } else if (t >= LZ_TILE && t - LZ_TILE < tj && nx[j0 + t - LZ_TILE] > 0) {
    atomicMin(&span[2], x0[j0 + t - LZ_TILE]);
    atomicMax(&span[3], x0[j0 + t - LZ_TILE] + nx[j0 + t - LZ_TILE]);
  }
  __syncthreads();
  const int y_lo = span[0], y_hi = span[1], x_lo = span[2], x_hi = span[3];

  float acc[LZ_PER_THREAD];
#pragma unroll
  for (int m = 0; m < LZ_PER_THREAD; ++m) acc[m] = 0.0f;

  for (int cx = x_lo; cx < x_hi; cx += LZ_COLS) {
    const int cw = min(LZ_COLS, x_hi - cx);
    for (int e = t; e < LZ_TILE * LZ_COLS; e += SAG_THREADS) (&tmp[0][0])[e] = 0.0f;
    for (int ry = y_lo; ry < y_hi; ry += LZ_ROWS) {
      const int rh = min(LZ_ROWS, y_hi - ry);
      for (int e = t; e < rh * cw; e += SAG_THREADS) {
        const int r = e / cw, c = e - r * cw;
        win[r][c] = (float)src[(size_t)(ry + r) * in_w + cx + c];
      }
      __syncthreads();
      // vertical pass: tmp[r][c] += sum over this chunk's rows of row r's window
      for (int e = t; e < ti * cw; e += SAG_THREADS) {
        const int r = e / cw, c = e - r * cw;
        const int i = i0 + r;
        const int ya = y0[i];
        const int lo = max(ya, ry), hi = min(ya + ny[i], ry + rh);
        const float* w = wy + (size_t)i * ky;
        float s = tmp[r][c];
        for (int y = lo; y < hi; ++y) s = fmaf(__ldg(w + (y - ya)), win[y - ry][c], s);
        tmp[r][c] = s;
      }
      __syncthreads();
    }
    // horizontal pass over this column chunk, into each thread's outputs
#pragma unroll
    for (int m = 0; m < LZ_PER_THREAD; ++m) {
      const int e = t + m * SAG_THREADS;
      const int r = e / LZ_TILE, q = e - r * LZ_TILE;
      if (r < ti && q < tj) {
        const int j = j0 + q;
        const int xa = x0[j];
        const int lo = max(xa, cx), hi = min(xa + nx[j], cx + cw);
        float s = acc[m];
        for (int x = lo; x < hi; ++x)
          s = fmaf(__ldg(wxt + (size_t)(x - xa) * out_w + j), tmp[r][x - cx], s);
        acc[m] = s;
      }
    }
    __syncthreads();
  }

  float* dst = out + (size_t)b * out_h * out_w;
#pragma unroll
  for (int m = 0; m < LZ_PER_THREAD; ++m) {
    const int e = t + m * SAG_THREADS;
    const int r = e / LZ_TILE, q = e - r * LZ_TILE;
    if (r < ti && q < tj) dst[(size_t)(i0 + r) * out_w + j0 + q] = acc[m];
  }
}

// img (B, in_h, in_w) of dtype 0 = uint8, 1 = uint16, 2 = f32; out (B, out_h,
// out_w) f32. y axis: y0, ny (out_h,) int32, wy (out_h, ky) f32; x axis: x0,
// nx (out_w,) int32, wxt (kx, out_w) f32, the weights transposed.
extern "C" int sag_lanczos(const void* img, int dtype, float* out, const int* y0, const int* ny,
                           const float* wy, int ky, const int* x0, const int* nx,
                           const float* wxt, int batch, int in_h, int in_w, int out_h, int out_w,
                           void* stream) {
  if (batch < 1 || in_h < 1 || in_w < 1 || out_h < 1 || out_w < 1 || ky < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((out_w + LZ_TILE - 1) / LZ_TILE, (out_h + LZ_TILE - 1) / LZ_TILE, batch);
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      sag_lanczos_kernel<uint8_t><<<grid, SAG_THREADS, 0, s>>>(
          (const uint8_t*)img, out, y0, ny, wy, ky, x0, nx, wxt, in_h, in_w, out_h, out_w);
      break;
    case 1:
      sag_lanczos_kernel<uint16_t><<<grid, SAG_THREADS, 0, s>>>(
          (const uint16_t*)img, out, y0, ny, wy, ky, x0, nx, wxt, in_h, in_w, out_h, out_w);
      break;
    case 2:
      sag_lanczos_kernel<float><<<grid, SAG_THREADS, 0, s>>>(
          (const float*)img, out, y0, ny, wy, ky, x0, nx, wxt, in_h, in_w, out_h, out_w);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return sag_status();
}
