// K8: the granularity spectrum's reconstructions (CellProfiler 4.2.8
// MeasureGranularity, step 3 of morphology.granularity_spectrum_cp), every
// scale in one launch.
//
// Replaces no Pallas kernel: the reference reconstructs with an XLA
// while_loop of blocked unit dilations (reference kernels/morphology.py:283,
// _reconstruct_cross_unit), which the port's plain form runs as about a
// dozen launches a sweep and a host check every 32 sweeps. For k = 1..L:
//   ero_k = cross-erosion of ero_{k-1} (ero_0 = pixels, outside ignored);
//   rec_k = reconstruction by dilation of the seed ero_k under the ceiling
//           pixels: r(p) <- min(max(r(p), r of its 4 neighbours in the
//           plane), pixels(p)), to its fixpoint;
//   out[k] = mean(rec_{k-1} - rec_k) * 100 / max(mean(pixels), eps)
//           (rec_0 = pixels).
//
// Bound on the H100: bytes. The pixels read once and the spectrum written
// once, 11.7 MB for the main path's 40 planes of 270², about 3.5 us at 3.35
// TB/s; an iterative fixpoint cannot come near that (the plain form runs
// about 235 sweeps a scale). What the design does about it: every sweep
// stays on chip, and device memory (in practice the 50 MB L2, which holds
// the batch's buffers) carries only tiles and their halos between rounds.
// - The fixpoint is unique, the iteration from the seed stays below it,
//   and the updates only raise r, exactly (min and max of f32). So any
//   order of in-place updates reaches the same r, bit for bit, as the
//   plain form's Jacobi sweeps, in far fewer passes.
// - A persistent cooperative grid, sized by occupancy, one warp a 32 x 32
//   tile at a time: a plane's tiles are spread over the warps of all CTAs.
// - A grid round: each warp stages each of its tiles that needs work with
//   a 1-pixel halo (and its ceiling) in shared memory and scans it in
//   place, lane = row or column, left, right, down, up, until four scans
//   in a row raise nothing: the tile is then stable against the halo it
//   read. A scan carries a value along a whole line of the tile. A tile
//   that changed is written back; each side whose pixels rose marks the
//   neighbour across it for the next round. Then grid.sync().
// - Stopping: a round after which no tile is marked ends the scale. A tile
//   left unmarked was stable against its halo and no neighbour changed
//   since, so the whole state is the global fixpoint.
// - The rest of a scale in the same launch, between grid syncs: the cross
//   erosion into the scale's rec buffer (its seed), kept as ero in the
//   first round; each tile's sum of (prev_rec - rec), taken directly, as the
//   plain form does, into a buffer of partials, reduced per plane in a
//   fixed order at the end (no float atomics: a call is deterministic bit
//   for bit). rec and prev_rec swap between two buffers.
// - Memory: the wrapper allocates three plane-sized f32 buffers (ero and
//   the two recs), the partials and the flags; the kernel allocates
//   nothing.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define K8_T 32                  // tile side: a warp's tile, a lane a row or a column
#define K8_WARPS 4               // warps (tiles in flight) a CTA
#define K8_THREADS (32 * K8_WARPS)
#define K8_S (K8_T + 3)          // row stride of the staged tile: halo, 32, halo, pad

struct K8Args {
  const float* pix;  // (B, H, W): the ceiling, ero_0 and rec_0
  float* ero;        // (B, H, W): ero_k
  float* rec0;       // (B, H, W) x 2: rec_k in rec0 for even k, rec1 for odd
  float* rec1;
  double* part;      // (n_tiles, L + 1): a tile's sum of (prev - rec) at scale k, then of pix
  int* flags;        // marks of the two round parities (n_tiles each), then 3 round flags
  int* counters;     // [0] grid rounds, [1] in-tile scans, summed over scales
  float* out;        // (B, L)
  int h, w, len, tiles_y, tiles_x, n_tiles, n_out;
};

struct K8Warp {
  float r[K8_T + 2][K8_S];  // the tile with its 1-pixel halo (corners unused)
  float c[K8_T][K8_T + 1];  // the ceiling
};

// Stages the tile whose top-left pixel is (y0, x0) of the plane `src` into
// r with its halo, `fill` outside the plane.
__device__ __forceinline__ void k8_stage(float (*r)[K8_S], const float* src, int h, int w, int y0,
                                         int x0, int lane, float fill) {
  const int gx = x0 + lane;
#pragma unroll 8
  for (int i = -1; i <= K8_T; ++i) {
    const int gy = y0 + i;
    r[i + 1][lane + 1] = (gx < w && gy >= 0 && gy < h) ? __ldcg(src + (size_t)gy * w + gx) : fill;
  }
  const int gy = y0 + lane;
  r[lane + 1][0] = (gy < h && x0 > 0) ? __ldcg(src + (size_t)gy * w + x0 - 1) : fill;
  r[lane + 1][K8_T + 1] =
      (gy < h && x0 + K8_T < w) ? __ldcg(src + (size_t)gy * w + x0 + K8_T) : fill;
}

// One scan of the staged tile in place: dir 0 left to right along row
// `lane`, 1 right to left, 2 top to bottom along column `lane`, 3 bottom to
// top. Returns whether it raised a pixel of this lane's line.
__device__ __forceinline__ bool k8_scan(float (*__restrict__ r)[K8_S],
                                        float (*__restrict__ c)[K8_T + 1], int dir,
                                        int lane) {
  bool up = false;
  if (dir < 2) {
    float* row = r[lane + 1];
    const float* cr = c[lane];
    if (dir == 0) {
      float v = row[0];
#pragma unroll
      for (int x = 0; x < K8_T; ++x) {
        const float old = row[x + 1];
        v = fminf(fmaxf(old, v), cr[x]);
        up |= v > old;
        row[x + 1] = v;
      }
    } else {
      float v = row[K8_T + 1];
#pragma unroll
      for (int x = K8_T - 1; x >= 0; --x) {
        const float old = row[x + 1];
        v = fminf(fmaxf(old, v), cr[x]);
        up |= v > old;
        row[x + 1] = v;
      }
    }
  } else {
    const int x = lane + 1;
    if (dir == 2) {
      float v = r[0][x];
#pragma unroll
      for (int y = 0; y < K8_T; ++y) {
        const float old = r[y + 1][x];
        v = fminf(fmaxf(old, v), c[y][lane]);
        up |= v > old;
        r[y + 1][x] = v;
      }
    } else {
      float v = r[K8_T + 1][x];
#pragma unroll
      for (int y = K8_T - 1; y >= 0; --y) {
        const float old = r[y + 1][x];
        v = fminf(fmaxf(old, v), c[y][lane]);
        up |= v > old;
        r[y + 1][x] = v;
      }
    }
  }
  return up;
}

// The sum over a tile of a - b (b null: of a), each difference rounded to
// f32 as the plain form's, summed in f64 in a fixed order; every lane
// returns it.
__device__ __forceinline__ double k8_tile_sum(const float* a, const float* b, int h, int w, int y0,
                                              int x0, int lane) {
  const int gx = x0 + lane;
  double s = 0.0;
  if (gx < w) {
    const int y1 = min(y0 + K8_T, h);
    for (int gy = y0; gy < y1; ++gy) {
      const size_t o = (size_t)gy * w + gx;
      s += b == nullptr ? (double)__ldcg(a + o) : (double)(__ldcg(a + o) - __ldcg(b + o));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(SAG_FULL_MASK, s, o);
  return s;
}

__global__ void __launch_bounds__(K8_THREADS) sag_granularity_kernel(K8Args a) {
  __shared__ K8Warp smem[K8_WARPS];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  K8Warp& s = smem[threadIdx.x >> 5];
  const int gw = blockIdx.x * K8_WARPS + (threadIdx.x >> 5), nw = gridDim.x * K8_WARPS;
  const int gt = blockIdx.x * K8_THREADS + threadIdx.x, nt = gridDim.x * K8_THREADS;
  const int per_plane = a.tiles_y * a.tiles_x;
  const size_t plane = (size_t)a.h * a.w;
  const int stride = a.len + 1;
  int* marks = a.flags;                 // marks[(round & 1) * n_tiles + tile]
  int* any = a.flags + 2 * a.n_tiles;   // any[round % 3]: a tile was marked in round - 1
  const float inf = INFINITY;

  // the tile's plane, top-left pixel and offset of its plane
#define K8_TILE(t)                                              \
  const int p_ = (t) / per_plane, q_ = (t) - p_ * per_plane;    \
  const int ty_ = q_ / a.tiles_x, tx_ = q_ - ty_ * a.tiles_x;   \
  const int y0 = ty_ * K8_T, x0 = tx_ * K8_T;                   \
  const size_t off = p_ * plane;

  for (int i = gt; i < 2 * a.n_tiles + 3; i += nt) a.flags[i] = 0;
  if (gt == 0) a.counters[1] = 0;
  for (int t = gw; t < a.n_tiles; t += nw) {
    K8_TILE(t)
    const double sum = k8_tile_sum(a.pix + off, nullptr, a.h, a.w, y0, x0, lane);
    if (lane == 0) a.part[(size_t)t * stride + a.len] = sum;
  }
  grid.sync();

  int rounds = 0, cached = -1;
  unsigned scans = 0;
  for (int k = 0; k < a.len; ++k) {
    const float* esrc = k == 0 ? a.pix : a.ero;
    float* rec = (k & 1) ? a.rec1 : a.rec0;
    const float* prev = k == 0 ? a.pix : ((k & 1) ? a.rec0 : a.rec1);

    // the seed: the cross erosion of ero_{k-1}, outside ignored
    for (int t = gw; t < a.n_tiles; t += nw) {
      K8_TILE(t)
      k8_stage(s.r, esrc + off, a.h, a.w, y0, x0, lane, inf);
      __syncwarp();
      const int gx = x0 + lane;
      if (gx < a.w) {
        const int y1 = min(K8_T, a.h - y0);
        for (int i = 0; i < y1; ++i) {
          const float v = fminf(fminf(s.r[i + 1][lane + 1], s.r[i][lane + 1]),
                                fminf(s.r[i + 2][lane + 1], fminf(s.r[i + 1][lane], s.r[i + 1][lane + 2])));
          __stcg(rec + off + (size_t)(y0 + i) * a.w + gx, v);
        }
      }
      __syncwarp();
    }
    if (gt == 0) __stcg(any + 1, 0);
    grid.sync();

    for (int rd = 0;; ++rd) {
      if (rd > 0 && __ldcg(any + rd % 3) == 0) break;
      if (gt == 0) {
        __stcg(any + (rd + 2) % 3, 0);
        ++rounds;
      }
      int* mine = marks + (rd & 1) * a.n_tiles;
      int* next = marks + ((rd + 1) & 1) * a.n_tiles;
      for (int t = gw; t < a.n_tiles; t += nw) {
        if (rd > 0) {
          const int m = __shfl_sync(SAG_FULL_MASK, lane == 0 ? __ldcg(mine + t) : 0, 0);
          if (!m) continue;
          if (lane == 0) __stcg(mine + t, 0);
        }
        K8_TILE(t)
        const int gx = x0 + lane;
        const int y1 = min(K8_T, a.h - y0);
        k8_stage(s.r, rec + off, a.h, a.w, y0, x0, lane, -inf);
        if (t != cached) {
#pragma unroll 8
          for (int i = 0; i < K8_T; ++i)
            s.c[i][lane] = (gx < a.w && i < y1) ? __ldcg(a.pix + off + (size_t)(y0 + i) * a.w + gx)
                                                : -inf;
          cached = t;
        }
        __syncwarp();
        if (rd == 0 && gx < a.w)
          for (int i = 0; i < y1; ++i)
            __stcg(a.ero + off + (size_t)(y0 + i) * a.w + gx, s.r[i + 1][lane + 1]);
        const float top = s.r[1][lane + 1], bottom = s.r[K8_T][lane + 1];
        const float left = s.r[lane + 1][1], right = s.r[lane + 1][K8_T];
        __syncwarp();
        bool moved = false;
        for (int quiet = 0, dir = 0; quiet < 4; dir = (dir + 1) & 3) {
          const bool up = __any_sync(SAG_FULL_MASK, k8_scan(s.r, s.c, dir, lane));
          __syncwarp();
          ++scans;
          quiet = up ? 0 : quiet + 1;
          moved |= up;
        }
        if (moved) {
          if (gx < a.w)
            for (int i = 0; i < y1; ++i)
              __stcg(rec + off + (size_t)(y0 + i) * a.w + gx, s.r[i + 1][lane + 1]);
          const bool m_top = __any_sync(SAG_FULL_MASK, s.r[1][lane + 1] > top) && ty_ > 0;
          const bool m_bottom =
              __any_sync(SAG_FULL_MASK, s.r[K8_T][lane + 1] > bottom) && ty_ + 1 < a.tiles_y;
          const bool m_left = __any_sync(SAG_FULL_MASK, s.r[lane + 1][1] > left) && tx_ > 0;
          const bool m_right =
              __any_sync(SAG_FULL_MASK, s.r[lane + 1][K8_T] > right) && tx_ + 1 < a.tiles_x;
          if (lane == 0 && (m_top || m_bottom || m_left || m_right)) {
            if (m_top) __stcg(next + t - a.tiles_x, 1);
            if (m_bottom) __stcg(next + t + a.tiles_x, 1);
            if (m_left) __stcg(next + t - 1, 1);
            if (m_right) __stcg(next + t + 1, 1);
            __stcg(any + (rd + 1) % 3, 1);
          }
        }
        __syncwarp();
      }
      grid.sync();
    }

    // the scale's share of each tile: sum(prev_rec - rec)
    for (int t = gw; t < a.n_tiles; t += nw) {
      K8_TILE(t)
      const double sum = k8_tile_sum(prev + off, rec + off, a.h, a.w, y0, x0, lane);
      if (lane == 0) a.part[(size_t)t * stride + k] = sum;
    }
  }
#undef K8_TILE
  if (lane == 0) atomicAdd((unsigned*)a.counters + 1, scans);
  grid.sync();

  // per plane and scale, the tiles' partials in tile order
  const double n = (double)plane;
  for (int i = gt; i < a.n_out; i += nt) {
    const int p = i / a.len, k = i - p * a.len;
    double d = 0.0, m = 0.0;
    for (int t = p * per_plane; t < (p + 1) * per_plane; ++t) {
      d += a.part[(size_t)t * stride + k];
      m += a.part[(size_t)t * stride + a.len];
    }
    const float denom = fmaxf((float)(m / n), 2.220446049250313e-16f);
    a.out[i] = (float)(d / n) * 100.0f / denom;
  }
  if (gt == 0) a.counters[0] = rounds;
}

static int k8_grid(int n_tiles, int* per_sm, int* sms) {
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, sag_granularity_kernel, K8_THREADS, 0);
  if (e != cudaSuccess) return -sag_clear(e);
  if (!coop || *per_sm < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
  const long long want = ((long long)n_tiles + K8_WARPS - 1) / K8_WARPS;
  const long long fit = (long long)*per_sm * *sms;
  return (int)(want < fit ? want : fit);
}

// pix (B, H, W) f32 contiguous; scratch 3 * B * H * W f32; part n_tiles * (L
// + 1) f64; flags 2 * n_tiles + 3 int32; counters 2 int32; out (B, L) f32,
// with n_tiles = B * ceil(H / 32) * ceil(W / 32). No host synchronisation.
extern "C" int sag_granularity(const float* pix, float* scratch, double* part, int* flags,
                               int* counters, float* out, int batch, int h, int w, int len,
                               void* stream) {
  if (batch < 1 || h < 1 || w < 1 || len < 1) return (int)cudaErrorInvalidValue;
  const long long ty = (h + K8_T - 1) / K8_T, tx = (w + K8_T - 1) / K8_T;
  const long long n_tiles = batch * ty * tx;
  if (n_tiles >= (1LL << 29) || (long long)batch * len >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  const int grid = k8_grid((int)n_tiles, &per_sm, &sms);
  if (grid < 0) return -grid;
  const size_t plane = (size_t)batch * h * w;
  K8Args a{pix, scratch, scratch + plane, scratch + 2 * plane, part, flags, counters, out,
           h, w, len, (int)ty, (int)tx, (int)n_tiles, batch * len};
  void* args[] = {(void*)&a};
  const cudaError_t e =
      cudaLaunchCooperativeKernel((const void*)sag_granularity_kernel, dim3((unsigned)grid, 1, 1),
                                  dim3(K8_THREADS, 1, 1), args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return sag_clear(e);
  return sag_status();
}

// info[0] registers a thread, [1] local (spilled) bytes a thread, [2]
// shared bytes a CTA, [3] resident CTAs a SM, [4] SMs, [5] the grid's CTAs
// for (batch, h, w), [6] its tiles.
extern "C" int sag_granularity_info(int batch, int h, int w, int* info) {
  if (batch < 1 || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, sag_granularity_kernel);
  if (e != cudaSuccess) return sag_clear(e);
  const int n_tiles = batch * ((h + K8_T - 1) / K8_T) * ((w + K8_T - 1) / K8_T);
  int per_sm = 0, sms = 0;
  const int grid = k8_grid(n_tiles, &per_sm, &sms);
  if (grid < 0) return -grid;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)attr.sharedSizeBytes;
  info[3] = per_sm;
  info[4] = sms;
  info[5] = grid;
  info[6] = n_tiles;
  return 0;
}
