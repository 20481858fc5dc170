// K4, radial lanes: per-(label, ring/wedge bin) pixel counts and channel
// sums of the radial-distribution family.
//
// Replaces the radial lanes of saguaro_tpu/kernels/segment_pallas.py::
// seg_lane_sums_pallas as fused_measure._make_lanes_c_fn_t builds them
// (4*(1+C) ring-masked lanes + 32*(1+C) ring-and-wedge-masked lanes, 216
// at 5 channels).
//
// out[b, lab, code, 0] += 1 and out[b, lab, code, 1 + c] += v_c for every
// pixel of site b with label > 0 and 0 <= code < n_codes, where lab is the
// label (labels >= mc fold into the ignored slot 0, as the lane scans do)
// and code = ring*8 + wedge is the pixel's packed bin (radial.cp_ring_wedge,
// or the centroid binning's code). The ring lanes are sums of their 8 wedge
// bins, so the caller derives them.
//
// Bound on the H100: bytes. A pixel reads its label, code and C channel
// values (28 B at 5 channels) and adds to 1+C sums. The TPU kernel added
// each pixel to every one of the 216 masked lanes because its one-hot
// contraction has no sparse form; here a pixel touches only its own bin.
// It is K3's reduction (csrc/sums.cu) with a composite key slot*n_codes +
// code and 1+C sums, and K3's design carries over:
// - the launch plan (segment_cuda.radial_plan) gives each site a few
//   contiguous ranges of 16-byte vectors, one a CTA, about one wave in
//   all; the ragged head and tail of a site go to its first CTA;
// - a thread reads 4 pixels at a time (an int4 of labels and one of
//   codes, K4R_UNROLL such vectors, and the next iteration's in flight
//   while this one's values load) and, only where one of the 4 is in a
//   bin, their C float4s of channel-last values: most of a site is
//   background, whose values no sum needs;
// - in registers, equal consecutive keys merge into runs, inactive pixels
//   are dropped before any warp instruction and the count is a register
//   sum: a warp whose pixels are all background spends one ballot a
//   vector;
// - a run that crosses into the next lane is handed to that lane's
//   neighbour, and the lanes' last runs go through K3's segmented warp
//   merge, so a run is flushed once a warp however many lanes it spans.
// What K3 cannot do here is keep the table in shared memory: 512 x 32 x 6
// floats is 393 KB a site. Each finished run goes to the zero-filled
// global output (resident in L2) as reductions, as 8-byte vector
// reductions (sm_90) when 1+C is even. Float atomics make the summation
// order vary between runs; the counts are exact.
#include "common.cuh"

#define SAG_RADIAL_MAX_CH 8
#define K4R_THREADS 256
#define K4R_UNROLL 2  // 16-byte label vectors a thread keeps in flight

// adds a run's sums s (count, then C channel sums) into row key of out:
// 8-byte vector reductions (sm_90) where the row's floats pair up
template <int NV>
__device__ __forceinline__ void k4r_flush(float* out, int key, const float (&s)[NV]) {
  float* dst = out + (size_t)key * NV;
  if (NV % 2 == 0) {
#pragma unroll
    for (int q = 0; q < NV / 2; ++q)
      atomicAdd(reinterpret_cast<float2*>(dst) + q, make_float2(s[2 * q], s[2 * q + 1]));
  } else {
#pragma unroll
    for (int k = 0; k < NV; ++k) atomicAdd(dst + k, s[k]);
  }
}

// One vector of 4 pixels: keys `key` (-1: inactive), values `v` (pixel p,
// channel c at v[p * C + c]). Warp-collective: every lane calls it.
template <int C>
__device__ __forceinline__ void k4r_vector(const int (&key)[4], const float (&v)[4 * C],
                                           float* out) {
  constexpr int NV = 1 + C;
  int fk = -1, lk = -1;  // the first run's key (when a later run closed it), the last run's
  float fs[NV], ls[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) fs[k] = ls[k] = 0.0f;
  int runs = 0;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    if (key[p] < 0) continue;
    if (key[p] != lk) {
      if (lk >= 0) {
        if (runs == 1) {
          fk = lk;
#pragma unroll
          for (int k = 0; k < NV; ++k) fs[k] = ls[k];
        } else {
          k4r_flush<NV>(out, lk, ls);
        }
      }
      lk = key[p];
      ++runs;
#pragma unroll
      for (int k = 0; k < NV; ++k) ls[k] = 0.0f;
    }
    ls[0] += 1.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) ls[1 + c] += v[p * C + c];
  }
  if (__ballot_sync(SAG_FULL_MASK, lk >= 0) == 0u) return;
  const int lane = threadIdx.x & 31;
  // a first run that continues the previous lane's last run goes to that lane
  const int prev = __shfl_up_sync(SAG_FULL_MASK, lk, 1);
  const int next_first = __shfl_down_sync(SAG_FULL_MASK, fk, 1);
  const bool take = lane < 31 && lk >= 0 && next_first == lk;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const float o = __shfl_down_sync(SAG_FULL_MASK, fs[k], 1);
    if (take) ls[k] += o;
  }
  if (fk >= 0 && !(lane > 0 && fk == prev)) k4r_flush<NV>(out, fk, fs);
  // segmented sum of the lanes' last runs over neighbouring lanes of equal
  // key; the last lane of each segment flushes the segment's total
  const unsigned heads = __ballot_sync(SAG_FULL_MASK, lane == 0 || prev != lk);
  const int first = 31 - __clz(heads & (SAG_FULL_MASK >> (31 - lane)));
  const int reach = __reduce_max_sync(SAG_FULL_MASK, (unsigned)(lane - first));
  for (int off = 1; off <= reach; off <<= 1) {  // warp-uniform
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const float o = __shfl_up_sync(SAG_FULL_MASK, ls[k], off);
      if (lane - off >= first) ls[k] += o;
    }
  }
  const bool last = lane == 31 || ((heads >> (lane + 1)) & 1u);
  if (last && lk >= 0) k4r_flush<NV>(out, lk, ls);
}

__device__ __forceinline__ int k4r_key(int raw, int code, int mc, int n_codes) {
  return (raw > 0 && (unsigned)code < (unsigned)n_codes) ? (raw < mc ? raw : 0) * n_codes + code
                                                         : -1;
}

// the labels and codes of the 16-byte vectors base + u * K4R_THREADS +
// threadIdx.x (background past v1)
__device__ __forceinline__ void k4r_load_lc(const int4* lab4, const int4* code4, long long base,
                                            long long v1, int4 (&lv)[K4R_UNROLL],
                                            int4 (&cv)[K4R_UNROLL]) {
#pragma unroll
  for (int u = 0; u < K4R_UNROLL; ++u) {
    const long long v = base + u * K4R_THREADS + threadIdx.x;
    lv[u] = v < v1 ? __ldg(lab4 + v) : make_int4(0, 0, 0, 0);
    cv[u] = v < v1 ? __ldg(code4 + v) : make_int4(-1, -1, -1, -1);
  }
}

template <int C>
__global__ void __launch_bounds__(K4R_THREADS)
sag_radial_kernel(const int* __restrict__ labels, const int* __restrict__ codes,
                  const float* __restrict__ image, float* __restrict__ out, long long n, int mc,
                  int n_codes, long long vecs_per_cta) {
  constexpr int NV = 1 + C;
  const int b = blockIdx.y;
  float* out_site = out + (size_t)b * mc * n_codes * NV;
  // the site's pixels [g_lo, g_hi) of the flat (B * n) stream: a ragged
  // head [g_lo, a_lo) and tail [a_hi, g_hi) of at most 3 pixels each around
  // the 16-byte vectors [a_lo / 4, a_hi / 4)
  const long long g_lo = (long long)b * n, g_hi = g_lo + n;
  const long long a_lo = min((g_lo + 3) & ~3LL, g_hi);
  const long long a_hi = max(g_hi & ~3LL, a_lo);
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const long long g = threadIdx.x < 4 ? g_lo + threadIdx.x : a_hi + (threadIdx.x - 4);
    if (g < (threadIdx.x < 4 ? a_lo : g_hi)) {
      const int key = k4r_key(labels[g], codes[g], mc, n_codes);
      if (key >= 0) {
        float s[NV];
        s[0] = 1.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) s[1 + c] = image[g * C + c];
        k4r_flush<NV>(out_site, key, s);
      }
    }
  }

  const int4* lab4 = reinterpret_cast<const int4*>(labels);
  const int4* code4 = reinterpret_cast<const int4*>(codes);
  const float4* val4 = reinterpret_cast<const float4*>(image);
  const long long v0 = a_lo / 4 + (long long)blockIdx.x * vecs_per_cta;
  const long long v1 = min(a_hi / 4, v0 + vecs_per_cta);
  const long long step = (long long)K4R_THREADS * K4R_UNROLL;
  int4 nl[K4R_UNROLL], nc[K4R_UNROLL];  // the next iteration's labels and codes
  k4r_load_lc(lab4, code4, v0, v1, nl, nc);
  // the trip count is the same for every thread of the block: the warp
  // instructions in k4r_vector see full warps
  for (long long base = v0; base < v1; base += step) {
    int4 lv[K4R_UNROLL], cv[K4R_UNROLL];
#pragma unroll
    for (int u = 0; u < K4R_UNROLL; ++u) {
      lv[u] = nl[u];
      cv[u] = nc[u];
    }
    // in flight while this iteration's values load and its runs are summed
    k4r_load_lc(lab4, code4, base + step, v1, nl, nc);
    int key[K4R_UNROLL][4];
    float4 vv[K4R_UNROLL][C];
#pragma unroll
    for (int u = 0; u < K4R_UNROLL; ++u) {
      key[u][0] = k4r_key(lv[u].x, cv[u].x, mc, n_codes);
      key[u][1] = k4r_key(lv[u].y, cv[u].y, mc, n_codes);
      key[u][2] = k4r_key(lv[u].z, cv[u].z, mc, n_codes);
      key[u][3] = k4r_key(lv[u].w, cv[u].w, mc, n_codes);
      const long long v = base + u * K4R_THREADS + threadIdx.x;
      const bool load = max(max(key[u][0], key[u][1]), max(key[u][2], key[u][3])) >= 0;
#pragma unroll
      for (int k = 0; k < C; ++k)
        vv[u][k] = load ? __ldg(val4 + v * C + k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < K4R_UNROLL; ++u) {
      float v[4 * C];
#pragma unroll
      for (int k = 0; k < C; ++k) {
        v[4 * k] = vv[u][k].x;
        v[4 * k + 1] = vv[u][k].y;
        v[4 * k + 2] = vv[u][k].z;
        v[4 * k + 3] = vv[u][k].w;
      }
      k4r_vector<C>(key[u], v, out_site);
    }
  }
}

template <int C>
static const void* k4r_fn() {
  return (const void*)sag_radial_kernel<C>;
}

static const void* k4r_kernel(int n_ch) {
  switch (n_ch) {
    case 1: return k4r_fn<1>();
    case 2: return k4r_fn<2>();
    case 3: return k4r_fn<3>();
    case 4: return k4r_fn<4>();
    case 5: return k4r_fn<5>();
    case 6: return k4r_fn<6>();
    case 7: return k4r_fn<7>();
    case 8: return k4r_fn<8>();
    default: return nullptr;
  }
}

// labels (B, n) int32 raw, codes (B, n) int32 and image (B, n, C) f32, all
// 16-byte aligned; out (B, mc, n_codes, 1 + C) f32 zero-filled. The plan:
// ctas CTAs a site, vecs_per_cta 16-byte vectors each
// (segment_cuda.radial_plan).
extern "C" int sag_radial_sums(const int* labels, const int* codes, const float* image,
                               float* out, int batch, long long n, int n_ch, int mc, int n_codes,
                               int ctas, long long vecs_per_cta, void* stream) {
  const void* fn = k4r_kernel(n_ch);
  if (fn == nullptr || n_codes < 1 || mc < 1 || batch < 1 || batch > 65535 || ctas < 1 || n < 0)
    return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&labels, (void*)&codes, (void*)&image, (void*)&out, (void*)&n,
                  (void*)&mc, (void*)&n_codes, (void*)&vecs_per_cta};
  cudaLaunchKernel(fn, dim3((unsigned)ctas, (unsigned)batch, 1), dim3(K4R_THREADS, 1, 1), args, 0,
                   (cudaStream_t)stream);
  return sag_status();
}

// Resources of the n_ch-channel kernel: info[0] registers a thread,
// info[1] local (spilled) bytes a thread, info[2] resident CTAs a SM.
extern "C" int sag_radial_info(int n_ch, int* info) {
  const void* fn = k4r_kernel(n_ch);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  int fits = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fits, fn, K4R_THREADS, 0);
  if (e != cudaSuccess) return sag_clear(e);
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = fits;
  return 0;
}
