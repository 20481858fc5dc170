// K7: separable Lanczos-3 re-binning with PIL-parity weights.
//
// Replaces saguaro_tpu/kernels/resample_pallas.py::lanczos_resize_pallas and
// lanczos_resize_batch_pallas (kernel _kernel: per 128 x 128 output tile, a
// DMA'd input window and two banded MXU matmuls RyBand @ window @ RxBand).
//
// out[b, i, j] = sum_y sum_x Ry[i, y] * img[b, y, x] * Rx[j, x]. The host
// (resample.axis_bands) cuts each axis' PIL coefficient table
// (resample.axis_windows) into bands of 4 neighbouring outputs: a band's
// first input `base`, its `span` (the union of its 4 tap windows) and its
// dense (span x 4) weights, zero where an input lies outside an output's
// window. Border windows are the table's own clipped, renormalised rows,
// so nothing is padded and nothing outside the image is read.
//
// Bound on the H100: bytes, if the arithmetic stays under about 3
// instructions an FMA (2 B read per uint16 input pixel, 4 B written per
// output; at 2160^2 -> 1080^2 about 12 taps per axis and output). Design:
// - one persistent CTA per resident slot walks output tiles of 64 rows x
//   4 * ngx columns (ngx from the plan, 14 at scale 2: the staged window
//   then spans at most 128 columns; the halo is about 1.2x);
// - each tile's input window is staged in shared memory in the input's
//   own type by one TMA box (a tensor map over the (B * in_h, in_w) input,
//   completion on an mbarrier), into a two-stage ring: the next window's
//   copy is in flight while this one is computed. Rows whose pitch is not
//   a multiple of 16 bytes, which TMA cannot address, are copied element
//   by element instead. A window larger than the ring's buffers
//   (downsampling by large factors) is walked in chunks of rows and
//   columns, partial sums kept;
// - vertical pass: a thread owns 8 input columns and one band of 4 output
//   rows, and walks down the band's inputs: each step reads 8 staged
//   values (one 16-byte load for uint16) and the band's 4 weights, and
//   does 32 FMAs into registers. The sums go to a shared (columns x 64)
//   f32 intermediate whose 16-byte row blocks are XOR-swizzled by column,
//   so neither pass's 16-byte accesses collide on the banks;
// - horizontal pass: a thread owns 4 output rows and one band of 4 output
//   columns, reads 4 intermediate rows and 4 weights an input column, does
//   16 FMAs, and writes 4 x 16 bytes at the end of the tile.
// Taps are f32 FMAs (no tensor cores, no TF32).
#include <cuda.h>

#include "common.cuh"

#define LZ_THREADS 256
#define LZ_ROWS 64  // output rows a tile: 16 bands of 4
#define LZ_BANDS (LZ_ROWS / 4)

struct LzStage {
  int tile;           // b * (tiles_y * tiles_x) + ty * tiles_x + tx; >= n_tiles when done
  int wr0, wr1;       // the tile's input window: rows [wr0, wr1)
  int wc0, wc1;       // columns [wc0, wc1)
  int cy0, cx0;       // this chunk's first row and column
};

struct LzArgs {
  const void* img;
  float* out;
  const int2* ymeta;   // (gy, 2): base, span of each band of 4 output rows
  const float* yw;     // (gy, spy, 4)
  const int2* xmeta;   // (gx, 2)
  const float* xw;     // (gx, spx, 4)
  const int2* ywin;    // (tiles_y, 2): the input rows [lo, hi) a tile row needs
  const int2* xwin;    // (tiles_x, 2): the input columns a tile column needs
  int gy, spy, gx, spx;
  int in_h, in_w, out_h, out_w;
  int ngx;             // bands of 4 output columns a tile
  int rows, cols;      // a ring buffer: staged rows (at most 256), and its pitch in elements
                       // (a multiple of 16, at most 128)
  int tiles_y, tiles_x, n_tiles;
  int tma;             // the input's rows are 16-byte aligned: windows are staged by TMA
};

__device__ __forceinline__ void lz_tile(const LzArgs& a, LzStage& s) {
  if (s.tile >= a.n_tiles) return;
  const int per_img = a.tiles_y * a.tiles_x;
  const int r = s.tile % per_img;
  const int2 wy = __ldg(a.ywin + r / a.tiles_x), wx = __ldg(a.xwin + r % a.tiles_x);
  s.wr0 = wy.x;
  s.wr1 = wy.y;
  s.wc0 = wx.x;
  s.wc1 = wx.y;
  s.cy0 = s.wr0;
  s.cx0 = s.wc0;
}

template <typename T>
__device__ __forceinline__ int lz_col_start(int cx0) {
  constexpr int E = 16 / (int)sizeof(T);
  return cx0 & ~(E - 1);
}

template <typename T>
__device__ __forceinline__ int lz_col_end(const LzArgs& a, const LzStage& s) {
  return min(s.wc1, lz_col_start<T>(s.cx0) + a.cols);
}

template <typename T>
__device__ __forceinline__ void lz_next(const LzArgs& a, LzStage& s) {
  s.cy0 += a.rows;
  if (s.cy0 < s.wr1) return;
  s.cy0 = s.wr0;
  s.cx0 = lz_col_end<T>(a, s);
  if (s.cx0 < s.wc1) return;
  s.tile += gridDim.x;
  lz_tile(a, s);
}

__device__ __forceinline__ unsigned lz_smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Stage the chunk of `s` into `buf`: rows [cy0, min(cy0 + rows, wr1)),
// columns [cs, cx1) from the aligned column cs, in the input's type. With
// TMA, thread 0 asks for one (rows x cols) box of the (B * in_h, in_w)
// input, which arrives on `bar` (rows past the chunk are copied and never
// read; columns past the image are filled with zeros); otherwise every
// thread copies elements.
template <typename T>
__device__ __forceinline__ void lz_stage(const LzArgs& a, const CUtensorMap& tmap,
                                         const LzStage& s, T* buf, uint64_t* bar) {
  if (s.tile >= a.n_tiles) return;
  const int b = s.tile / (a.tiles_y * a.tiles_x);
  const int cs = lz_col_start<T>(s.cx0);
  if (a.tma) {
    if (threadIdx.x == 0) {
      const unsigned mb = lz_smem_addr(bar);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mb),
                   "r"((unsigned)(a.rows * a.cols * sizeof(T)))
                   : "memory");
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(lz_smem_addr(buf)),
          "l"(reinterpret_cast<uint64_t>(&tmap)), "r"(cs), "r"(b * a.in_h + s.cy0), "r"(mb)
          : "memory");
    }
    return;
  }
  const int nrows = min(a.rows, s.wr1 - s.cy0), ncols = lz_col_end<T>(a, s) - cs;
  const T* src = static_cast<const T*>(a.img) + ((size_t)b * a.in_h + s.cy0) * a.in_w;
  for (int r = threadIdx.x / 32; r < nrows; r += LZ_THREADS / 32)
    for (int c = threadIdx.x & 31; c < ncols; c += 32)
      buf[r * a.cols + c] = src[(size_t)r * a.in_w + cs + c];
}

// Waits for the phase `parity` of `bar` to complete (the TMA box it
// counts has landed). A wait of more than about 10 s traps, so that a
// fault shows as an error instead of a hung card.
__device__ __forceinline__ void lz_wait(uint64_t* bar, unsigned parity) {
  const unsigned mb = lz_smem_addr(bar);
  const long long t0 = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mb), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// 8 staged values from p (16-byte aligned for uint16 and f32, 8 for uint8)
// as f32. Integers convert exactly through the float whose mantissa holds
// them: 0x4B000000 | u is 2^23 + u.
__device__ __forceinline__ float lz_u(unsigned bits) {
  return __uint_as_float(bits) - 8388608.0f;
}

__device__ __forceinline__ void lz_load8(const uint16_t* p, float (&d)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    d[2 * k] = lz_u(__byte_perm(w[k], 0x4B000000u, 0x7610));
    d[2 * k + 1] = lz_u(__byte_perm(w[k], 0x4B000000u, 0x7632));
  }
}

__device__ __forceinline__ void lz_load8(const uint8_t* p, float (&d)[8]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const unsigned w[2] = {v.x, v.y};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    d[4 * k] = lz_u(__byte_perm(w[k], 0x4B000000u, 0x7660));
    d[4 * k + 1] = lz_u(__byte_perm(w[k], 0x4B000000u, 0x7661));
    d[4 * k + 2] = lz_u(__byte_perm(w[k], 0x4B000000u, 0x7662));
    d[4 * k + 3] = lz_u(__byte_perm(w[k], 0x4B000000u, 0x7663));
  }
}

__device__ __forceinline__ void lz_load8(const float* p, float (&d)[8]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  const float4 v = *reinterpret_cast<const float4*>(p + 4);
  d[0] = u.x; d[1] = u.y; d[2] = u.z; d[3] = u.w;
  d[4] = v.x; d[5] = v.y; d[6] = v.z; d[7] = v.w;
}

// the intermediate's 16-byte block of rows [4 * band, 4 * band + 4) at
// staged column x
__device__ __forceinline__ float4* lz_mid(float* mid, int x, int band) {
  return reinterpret_cast<float4*>(mid + x * LZ_ROWS + (((band ^ (x >> 3)) & (LZ_BANDS - 1)) << 2));
}

template <typename T>
__global__ void __launch_bounds__(LZ_THREADS)
sag_lanczos_kernel(const LzArgs a, const __grid_constant__ CUtensorMap tmap) {
  extern __shared__ __align__(128) unsigned char lz_smem[];
  const size_t buf_bytes = ((size_t)a.rows * a.cols * sizeof(T) + 127) & ~(size_t)127;
  T* const buf0 = reinterpret_cast<T*>(lz_smem);
  T* const buf1 = reinterpret_cast<T*>(lz_smem + buf_bytes);
  float* mid = reinterpret_cast<float*>(lz_smem + 2 * buf_bytes);  // (cols, LZ_ROWS), swizzled
  uint64_t* bars = reinterpret_cast<uint64_t*>(mid + a.cols * LZ_ROWS);  // one a ring buffer
  const int t = threadIdx.x;
  const int h_band = t & (LZ_BANDS - 1), h_xband = t / LZ_BANDS;  // this thread's horizontal micro tile
  if (a.tma && t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(lz_smem_addr(bars)) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(lz_smem_addr(bars + 1)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  LzStage cur;
  cur.tile = blockIdx.x;
  lz_tile(a, cur);
  lz_stage<T>(a, tmap, cur, buf0, bars);

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  for (int k = 0; cur.tile < a.n_tiles; ++k) {
    // the next chunk's copy goes out before this one is computed: its
    // buffer was last read in iteration k - 1, which ended in a barrier
    LzStage nxt = cur;
    lz_next<T>(a, nxt);
    lz_stage<T>(a, tmap, nxt, (k & 1) ? buf0 : buf1, bars + ((k + 1) & 1));
    if (a.tma) lz_wait(bars + (k & 1), (k >> 1) & 1);
    __syncthreads();

    const T* buf = (k & 1) ? buf1 : buf0;
    const int per_img = a.tiles_y * a.tiles_x;
    const int b = cur.tile / per_img;
    const int ty = (cur.tile % per_img) / a.tiles_x, tx = (cur.tile % per_img) % a.tiles_x;
    const int cs = lz_col_start<T>(cur.cx0), cx1 = lz_col_end<T>(a, cur);
    const int cy1 = min(cur.cy0 + a.rows, cur.wr1);
    const bool first_rows = cur.cy0 == cur.wr0;

    // vertical pass: (band, 8-column group) micro tiles, one a thread
    const int n_cg = (cx1 - cs + 7) / 8;
    if (t < LZ_BANDS * n_cg) {
      const int band = t / n_cg, cg = t - band * n_cg;
      const int g = ty * LZ_BANDS + band;
      float v[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) v[r][c] = 0.0f;
      if (g < a.gy) {
        const int2 m = __ldg(a.ymeta + g);
        const int lo = max(m.x, cur.cy0), hi = min(m.x + m.y, cy1);
        const float4* w = reinterpret_cast<const float4*>(a.yw) + (size_t)g * a.spy - m.x;
        const T* col = buf + (size_t)(lo - cur.cy0) * a.cols + cg * 8;
#pragma unroll 4
        for (int y = lo; y < hi; ++y, col += a.cols) {
          const float4 wy = __ldg(w + y);
          float d[8];
          lz_load8(col, d);
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            v[0][c] = fmaf(wy.x, d[c], v[0][c]);
            v[1][c] = fmaf(wy.y, d[c], v[1][c]);
            v[2][c] = fmaf(wy.z, d[c], v[2][c]);
            v[3][c] = fmaf(wy.w, d[c], v[3][c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float4* p = lz_mid(mid, cg * 8 + c, band);
        float4 s = make_float4(v[0][c], v[1][c], v[2][c], v[3][c]);
        if (!first_rows) {
          const float4 o = *p;
          s.x += o.x; s.y += o.y; s.z += o.z; s.w += o.w;
        }
        *p = s;
      }
    }

    const bool last_rows = cy1 >= cur.wr1;
    if (last_rows) {
      __syncthreads();
      // horizontal pass over this chunk's columns: 4 rows x 4 columns a thread
      const int gxb = tx * a.ngx + h_xband;
      if (h_xband < a.ngx && gxb < a.gx && ty * LZ_BANDS + h_band < a.gy) {
        const int2 m = __ldg(a.xmeta + gxb);
        const int lo = max(m.x, cur.cx0), hi = min(m.x + m.y, cx1);
        const float4* w = reinterpret_cast<const float4*>(a.xw) + (size_t)gxb * a.spx - m.x;
#pragma unroll 4
        for (int x = lo; x < hi; ++x) {
          const float4 wx = __ldg(w + x);
          const float4 s = *lz_mid(mid, x - cs, h_band);
          const float sr[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[r][0] = fmaf(sr[r], wx.x, acc[r][0]);
            acc[r][1] = fmaf(sr[r], wx.y, acc[r][1]);
            acc[r][2] = fmaf(sr[r], wx.z, acc[r][2]);
            acc[r][3] = fmaf(sr[r], wx.w, acc[r][3]);
          }
        }
      }
      if (cx1 >= cur.wc1) {  // the tile's last chunk: write its outputs
        const int i0 = ty * LZ_ROWS + 4 * h_band;
        const int j0 = (tx * a.ngx + h_xband) * 4;
        if (h_xband < a.ngx && j0 < a.out_w) {
          float* dst = a.out + ((size_t)b * a.out_h + i0) * a.out_w + j0;
          const bool vec_out = (a.out_w & 3) == 0;
#pragma unroll
          for (int r = 0; r < 4; ++r, dst += a.out_w) {
            if (i0 + r >= a.out_h) break;
            if (vec_out) {
              *reinterpret_cast<float4*>(dst) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c)
                if (j0 + c < a.out_w) dst[c] = acc[r][c];
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
      }
    }
    __syncthreads();
    cur = nxt;
  }
}

static const void* lz_kernel(int dtype) {
  switch (dtype) {
    case 0: return (const void*)sag_lanczos_kernel<uint8_t>;
    case 1: return (const void*)sag_lanczos_kernel<uint16_t>;
    case 2: return (const void*)sag_lanczos_kernel<float>;
    default: return nullptr;
  }
}

static const int lz_itemsize[3] = {1, 2, 4};

static size_t lz_smem_bytes(int dtype, int rows, int cols) {
  const size_t buf = ((size_t)rows * cols * lz_itemsize[dtype] + 127) & ~(size_t)127;
  return 2 * buf + (size_t)cols * LZ_ROWS * sizeof(float) + 2 * sizeof(uint64_t);
}

typedef CUresult (*LzEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime's entry
// point query (the library links the runtime only).
static LzEncodeTiled lz_encoder() {
  static LzEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<LzEncodeTiled>(p);
  }
  return fn;
}

// img (B, in_h, in_w) of dtype 0 = uint8, 1 = uint16, 2 = f32; out (B, out_h,
// out_w) f32. Each axis: meta (bands, 2) int32 (base, span) and weights
// (bands, span_max, 4) f32 of resample.axis_bands. The plan
// (resample_cuda.lanczos_plan): the input window [lo, hi) of each tile row
// (ywin) and tile column (xwin), ngx column bands a tile, ring buffers of
// rows x cols elements, ctas persistent CTAs.
extern "C" int sag_lanczos(const void* img, int dtype, float* out, const int* ymeta,
                           const float* yw, int gy, int spy, const int* xmeta, const float* xw,
                           int gx, int spx, const int* ywin, const int* xwin, int batch, int in_h,
                           int in_w, int out_h, int out_w, int ngx, int rows, int cols, int ctas,
                           void* stream) {
  const void* fn = lz_kernel(dtype);
  if (fn == nullptr || batch < 1 || in_h < 1 || in_w < 1 || out_h < 1 || out_w < 1 || ngx < 1 ||
      ngx > LZ_THREADS / LZ_BANDS || rows < 1 || rows > 256 || cols < 16 || cols > 128 ||
      cols % 16 != 0 ||
      ctas < 1 || gy != (out_h + 3) / 4 || gx != (out_w + 3) / 4)
    return (int)cudaErrorInvalidValue;
  LzArgs a;
  a.img = img;
  a.out = out;
  a.ymeta = reinterpret_cast<const int2*>(ymeta);
  a.yw = yw;
  a.xmeta = reinterpret_cast<const int2*>(xmeta);
  a.xw = xw;
  a.ywin = reinterpret_cast<const int2*>(ywin);
  a.xwin = reinterpret_cast<const int2*>(xwin);
  a.gy = gy;
  a.spy = spy;
  a.gx = gx;
  a.spx = spx;
  a.in_h = in_h;
  a.in_w = in_w;
  a.out_h = out_h;
  a.out_w = out_w;
  a.ngx = ngx;
  a.rows = rows;
  a.cols = cols;
  a.tiles_y = (out_h + LZ_ROWS - 1) / LZ_ROWS;
  a.tiles_x = (gx + ngx - 1) / ngx;
  const long long n_tiles = (long long)batch * a.tiles_y * a.tiles_x;
  if (n_tiles > 0x7fffffffLL - ctas) return (int)cudaErrorInvalidValue;
  a.n_tiles = (int)n_tiles;
  a.tma = (reinterpret_cast<size_t>(img) & 15) == 0 && ((size_t)in_w * lz_itemsize[dtype]) % 16 == 0;
  CUtensorMap tmap = {};
  if (a.tma) {
    const LzEncodeTiled encode = lz_encoder();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    static const CUtensorMapDataType types[3] = {CU_TENSOR_MAP_DATA_TYPE_UINT8,
                                                 CU_TENSOR_MAP_DATA_TYPE_UINT16,
                                                 CU_TENSOR_MAP_DATA_TYPE_FLOAT32};
    const cuuint64_t dims[2] = {(cuuint64_t)in_w, (cuuint64_t)batch * in_h};
    const cuuint64_t strides[1] = {(cuuint64_t)in_w * lz_itemsize[dtype]};
    const cuuint32_t box[2] = {(cuuint32_t)cols, (cuuint32_t)rows};
    const cuuint32_t unit[2] = {1, 1};
    if (encode(&tmap, types[dtype], 2, const_cast<void*>(img), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  const size_t smem = lz_smem_bytes(dtype, rows, cols);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return sag_clear(e);
  }
  void* args[] = {(void*)&a, (void*)&tmap};
  cudaLaunchKernel(fn, dim3((unsigned)ctas, 1, 1), dim3(LZ_THREADS, 1, 1), args, smem,
                       (cudaStream_t)stream);
  return sag_status();
}

// Resources of the kernel for `dtype` with ring buffers of rows x cols:
// info[0] registers a thread, info[1] local (spilled) bytes a thread,
// info[2] dynamic shared bytes, info[3] resident CTAs a SM.
extern "C" int sag_lanczos_info(int dtype, int rows, int cols, int* info) {
  const void* fn = lz_kernel(dtype);
  if (fn == nullptr || rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  const int smem = (int)lz_smem_bytes(dtype, rows, cols);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int fits = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fits, fn, LZ_THREADS, smem);
  if (e != cudaSuccess) return sag_clear(e);
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = smem;
  info[3] = fits;
  return 0;
}
