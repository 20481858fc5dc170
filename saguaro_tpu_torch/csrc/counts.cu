// K1: fused per-label histograms (exact integer counts).
//
// Replaces saguaro_tpu/kernels/segment_pallas.py::seg_counts_pallas
// (kernel _counts_fn, s8 one-hot MXU contraction per pixel tile).
//
// out[b, lab, off_q + code] += 1 for every pixel i of site b and code plane
// q with 0 <= lab < mc and 0 <= code < n_q (code -1 marks an invalid pixel).
//
// Bound on the H100: bytes. Each pixel is read once (a 4-byte label and one
// 2-byte code per plane) and costs one integer increment a plane. The TPU
// needed the one-hot matmul because its scatters serialise; here every
// increment is an atomic into a table held on-chip, at every shape the
// measurement gives (up to 512 x 2720 int32, 5.6 MB). A plan fixed before
// the launch (segment_cuda.counts_plan) cuts the (mc x total) table into
// slices of at most SAG_COUNTS_SLICE bytes, each in one CTA's shared memory:
// - one slice: the whole table in one CTA (in per-warp copies when it is a
//   few KB, so a background full of equal keys does not serialise one bin);
// - tiles: row ranges of the table, one CTA each; the CTAs of one pixel
//   chunk (adjacent blockIdx.x, so their reads meet in L2) each read the
//   chunk's labels and count only the keys of their own rows, loading a
//   plane's codes only for 8 pixels that hold one of their labels;
// - a cluster: the row ranges over the CTAs of a thread-block cluster of at
//   most 8 (the portable limit); a CTA counts its own pixels and adds each
//   key into the shared memory of the CTA that owns its row through
//   distributed shared memory
//   (map_shared_rank + atomicAdd);
// and a table wider than a slice's row also splits into column groups
// (blockIdx.y), each reading the labels and only the planes that meet its
// columns. Then:
// - a thread loads 8 pixels at a time, 16 bytes a load (4 labels, 8 int16
//   codes of a plane), skips a plane whose 8 codes are all invalid, and
//   merges equal consecutive keys of its 8 pixels into one atomic of their
//   count (labels and codes are mostly constant along a raster row); a
//   scalar tail takes the pixels past the last multiple of 8, and every
//   pixel where the arrays do not allow 16-byte loads;
// - a thread keeps 2 octets' labels and 8 planes' codes in flight;
// - a grid of a few waves of the card's resident CTAs: each zeroes its
//   slice, counts, and after a barrier (the cluster's, for a cluster) adds
//   the slice's non-zero bins to the global table with integer atomics.
// Integer sums are exact in any order, so the result is deterministic.
// Measured on an H100 SXM at 700 W with chip_smoke's inputs
// (tools/k1_variants.py; PERF.md §6): atomics into another CTA's shared
// memory are far slower than local ones (texture 1.8-2.2 ms in clusters of
// 8, 0.6 ms in row tiles), so the plan takes a cluster only where tiles
// would re-read the labels many times for few planes (neighbour pairs); a
// warp merge of equal keys (match + reduce) before each atomic cost more
// than it saved at every shape; and a tile owning a label most pixels
// carry (the background's slot 0) read every code plane of the site and
// held the launch back, until the callers masked such pixels to label -1
// (onehot_counts' label_valid).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define SAG_COUNTS_THREADS 512            // K1_THREADS in segment_cuda.py
#define SAG_COUNTS_SLICE (200 * 1024)     // K1_SLICE: table bytes a CTA
#define SAG_COUNTS_RUNS 1                 // merge equal consecutive keys of a thread
#define SAG_COUNTS_UNROLL 2               // octets a thread loads before counting them
#define SAG_COUNTS_AHEAD 8                // code planes of an octet loaded together
#define SAG_SMEM_MAX (227 * 1024)         // shared memory a block can use

// Adds cnt to slice key (row * cols + col). CLUSTER: the key's row belongs
// to cluster rank key / slice, at key % slice of that CTA's slice.
template <bool CLUSTER>
__device__ __forceinline__ void sag_count_add(int* hist, int key, int cnt, int slice) {
  if constexpr (CLUSTER) {
    const int r = key / slice;
    atomicAdd(cg::this_cluster().map_shared_rank(hist, r) + (key - r * slice), cnt);
  } else {
    atomicAdd(hist + key, cnt);
  }
}

// The keys of 8 pixels of one plane: base[k] = row * cols for a label this
// CTA counts, else -1; c[k] the codes. Consecutive equal keys go in one
// atomic of their count.
template <bool CLUSTER>
__device__ __forceinline__ void sag_count_octet(int* hist, const int (&base)[8], const int (&c)[8],
                                                int off, int size, int cols, int slice) {
  int run = -1, cnt = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int col = off + c[k];
    const bool ok = base[k] >= 0 && (unsigned)c[k] < (unsigned)size && (unsigned)col < (unsigned)cols;
    const int key = ok ? base[k] + col : -1;
    if (SAG_COUNTS_RUNS && key == run) {
      ++cnt;
    } else {
      if (run >= 0) sag_count_add<CLUSTER>(hist, run, cnt, slice);
      run = key;
      cnt = 1;
    }
  }
  if (run >= 0) sag_count_add<CLUSTER>(hist, run, cnt, slice);
}

// grid (units * ways, groups, batch) with ways = tiles (CLUSTER false) or
// the cluster size (CLUSTER true, cluster dims (ways, 1, 1)). plan: offsets
// (Q), sizes (Q), then (q0, q1, col0, col1) per group. Tiles: CTA x owns
// label rows [t * rows, (t + 1) * rows), t = x % tiles, of its group's
// columns, and reads pixel unit x / tiles; one tile may hold `copies`
// copies (one per warp group). Cluster: the CTA of rank r owns rows
// [r * rows, (r + 1) * rows) and every CTA reads its own pixels.
template <bool CLUSTER>
__global__ void __launch_bounds__(SAG_COUNTS_THREADS)
sag_counts_kernel(const int* __restrict__ labels, const short* __restrict__ codes,
                  const int* __restrict__ plan, int* __restrict__ out, long long n, int q_planes,
                  int mc, int total, int rows, int tiles, int copies, int vec) {
  extern __shared__ __align__(16) int sag_counts_sh[];
  const int b = blockIdx.z;
  const int* gp = plan + 2 * q_planes + 4 * blockIdx.y;
  const int q0 = __ldg(gp), q1 = __ldg(gp + 1), col0 = __ldg(gp + 2);
  const int cols = __ldg(gp + 3) - col0;
  const int slice = rows * cols;
  int* off_sh = sag_counts_sh + copies * slice;  // plane offsets within the group's columns
  int* size_sh = off_sh + (q1 - q0);
  for (int j = threadIdx.x; j < copies * slice; j += blockDim.x) sag_counts_sh[j] = 0;
  for (int k = threadIdx.x; k < q1 - q0; k += blockDim.x) {
    off_sh[k] = __ldg(plan + q0 + k) - col0;
    size_sh[k] = __ldg(plan + q_planes + q0 + k);
  }
  int row0 = 0;         // the first label row this CTA holds
  int lo = 0, hi = mc;  // the labels this CTA counts
  long long unit = blockIdx.x, units = gridDim.x;
  if constexpr (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    row0 = (int)cluster.block_rank() * rows;
    cluster.sync();  // every slice is zero before any CTA adds into it
  } else {
    row0 = (int)(blockIdx.x % tiles) * rows;
    lo = row0;
    hi = min(row0 + rows, mc);
    unit = blockIdx.x / tiles;
    units = gridDim.x / tiles;
    __syncthreads();
  }
  const int warp_copy = (int)(threadIdx.x / 32) % copies;
  int* hist = sag_counts_sh + warp_copy * slice;

  const int* lab_site = labels + (size_t)b * n;
  const short* code_site = codes + (size_t)b * q_planes * n;
  const long long tid = unit * blockDim.x + threadIdx.x;
  const long long stride = units * blockDim.x;
  const long long n8 = vec ? n / 8 : 0;
  const int4* lab4 = reinterpret_cast<const int4*>(lab_site);
  const int4 none4 = make_int4(-1, -1, -1, -1);
  for (long long o0 = tid; o0 < n8; o0 += SAG_COUNTS_UNROLL * stride) {
    int4 la[SAG_COUNTS_UNROLL], lb[SAG_COUNTS_UNROLL];  // the labels of UNROLL octets in flight
#pragma unroll
    for (int u = 0; u < SAG_COUNTS_UNROLL; ++u) {
      const long long o = o0 + u * stride;
      la[u] = o < n8 ? __ldg(lab4 + 2 * o) : none4;
      lb[u] = o < n8 ? __ldg(lab4 + 2 * o + 1) : none4;
    }
#pragma unroll
    for (int u = 0; u < SAG_COUNTS_UNROLL; ++u) {
      const long long o = o0 + u * stride;
      const int lab[8] = {la[u].x, la[u].y, la[u].z, la[u].w, lb[u].x, lb[u].y, lb[u].z, lb[u].w};
      int base[8];
      bool any = false;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool mine = lab[k] >= lo && lab[k] < hi;
        base[k] = mine ? (lab[k] - (CLUSTER ? 0 : row0)) * cols : -1;
        any |= mine;
      }
      if (!any) continue;  // no label of this CTA's rows (or past the end): no code is read
      const int4* plane4 = reinterpret_cast<const int4*>(code_site) + o;
      for (int qa = q0; qa < q1; qa += SAG_COUNTS_AHEAD) {
        int4 cv[SAG_COUNTS_AHEAD];  // AHEAD planes' codes in flight
#pragma unroll
        for (int j = 0; j < SAG_COUNTS_AHEAD; ++j)
          cv[j] = qa + j < q1 ? __ldg(plane4 + (size_t)(qa + j) * (n / 8)) : none4;
#pragma unroll
        for (int j = 0; j < SAG_COUNTS_AHEAD; ++j) {
          if ((cv[j].x & cv[j].y & cv[j].z & cv[j].w) == -1) continue;  // 8 invalid codes
          const int c[8] = {(short)cv[j].x, cv[j].x >> 16, (short)cv[j].y, cv[j].y >> 16,
                            (short)cv[j].z, cv[j].z >> 16, (short)cv[j].w, cv[j].w >> 16};
          const int q = qa + j - q0;
          sag_count_octet<CLUSTER>(hist, base, c, off_sh[q], size_sh[q], cols, slice);
        }
      }
    }
  }
  for (long long i = n8 * 8 + tid; i < n; i += stride) {
    const int lab = lab_site[i];
    if (lab < lo || lab >= hi) continue;
    const int base = (lab - (CLUSTER ? 0 : row0)) * cols;
    for (int q = q0; q < q1; ++q) {
      const int c = code_site[(size_t)q * n + i];
      const int col = off_sh[q - q0] + c;
      if ((unsigned)c < (unsigned)size_sh[q - q0] && (unsigned)col < (unsigned)cols)
        sag_count_add<CLUSTER>(hist, base + col, 1, slice);
    }
  }

  if constexpr (CLUSTER) {
    cg::this_cluster().sync();  // every add into this CTA's slice has landed
  } else {
    __syncthreads();
  }
  int* out_site = out + (size_t)b * mc * total + col0;
  for (int j = threadIdx.x; j < slice; j += blockDim.x) {
    int v = 0;
    for (int k = 0; k < copies; ++k) v += sag_counts_sh[k * slice + j];
    if (v != 0) {
      const int row = row0 + j / cols;
      atomicAdd(out_site + (size_t)row * total + (j - (j / cols) * cols), v);
    }
  }
}

// labels (B, n) int32; codes (B, q_planes, n) int16; plan: a device array
// of the plane offsets, the plane sizes and n_groups (q0, q1, col0, col1)
// column groups; out (B, mc, total) int32, zero-filled by the caller. The
// launch plan (cluster, rows, tiles, copies, units, max_cols, smem) comes
// from segment_cuda.counts_plan; a plan that is inconsistent, or that the
// card cannot hold resident, is refused with cudaErrorInvalidConfiguration.
extern "C" int sag_counts(const int* labels, const short* codes, const int* plan, int* out,
                          int batch, long long n, int q_planes, int mc, int total, int n_groups,
                          int cluster, int rows, int tiles, int copies, int units, int max_cols,
                          int smem, void* stream) {
  const int ways = cluster > 1 ? cluster : tiles;
  const size_t need = (size_t)4 * rows * max_cols * copies + (size_t)8 * q_planes;
  const bool ok = q_planes >= 1 && mc >= 1 && n_groups >= 1 && n_groups <= 65535 &&
                  batch >= 1 && batch <= 65535 && cluster >= 1 && cluster <= 8 && rows >= 1 &&
                  tiles >= 1 && (cluster == 1 || tiles == 1) && (long long)rows * ways >= mc &&
                  (long long)rows * (ways - 1) < mc && copies >= 1 && (ways == 1 || copies == 1) &&
                  copies <= SAG_COUNTS_THREADS / 32 && units >= 1 && max_cols >= 1 &&
                  max_cols <= total && (size_t)4 * rows * max_cols <= SAG_COUNTS_SLICE &&
                  need <= (size_t)smem && smem <= SAG_SMEM_MAX &&
                  (long long)ways * units <= 0x7fffffffLL;
  if (!ok) return (int)cudaErrorInvalidConfiguration;
  if (n == 0) return 0;
  const uintptr_t bits = (uintptr_t)labels | (uintptr_t)codes;
  const int vec = n % 8 == 0 && bits % 16 == 0;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(ways * units), (unsigned)n_groups, (unsigned)batch);
  cfg.blockDim = dim3(SAG_COUNTS_THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  auto kernel = cluster > 1 ? sag_counts_kernel<true> : sag_counts_kernel<false>;
  int fits = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cluster > 1) {
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&fits, kernel, &cfg);
  } else if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fits, kernel, SAG_COUNTS_THREADS, smem);
  }
  if (e != cudaSuccess) return (int)e;
  if (fits < 1) return (int)cudaErrorInvalidConfiguration;
  e = cudaLaunchKernelEx(&cfg, kernel, labels, codes, plan, out, n, q_planes, mc, total, rows,
                         tiles, copies, vec);
  if (e != cudaSuccess) return (int)e;
  return sag_status();
}

// Resources of the K1 kernel (cluster <= 1: the one-CTA-a-slice form, else
// the cluster form at that size) with `smem` dynamic shared bytes: info =
// {registers a thread, local bytes a thread, resident CTAs a SM (one CTA a
// slice) or resident clusters on the card (cluster form)}.
extern "C" int sag_counts_info(int cluster, int smem, int* info) {
  const void* fn = cluster > 1 ? (const void*)sag_counts_kernel<true>
                               : (const void*)sag_counts_kernel<false>;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int fits = 0;
  if (e == cudaSuccess && cluster > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)cluster, 1, 1);
    cfg.blockDim = dim3(SAG_COUNTS_THREADS, 1, 1);
    cfg.dynamicSmemBytes = (size_t)smem;
    cudaLaunchAttribute attr_c[1];
    attr_c[0].id = cudaLaunchAttributeClusterDimension;
    attr_c[0].val.clusterDim.x = (unsigned)cluster;
    attr_c[0].val.clusterDim.y = 1;
    attr_c[0].val.clusterDim.z = 1;
    cfg.attrs = attr_c;
    cfg.numAttrs = 1;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&fits, fn, &cfg);
  } else if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fits, fn, SAG_COUNTS_THREADS, smem);
  }
  if (e != cudaSuccess) return (int)e;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = fits;
  return 0;
}
