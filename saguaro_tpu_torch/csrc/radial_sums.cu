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
// The (mc x n_codes x (1+C)) sums (393 KB at the main path's 512 x 32 x 6)
// exceed a block's shared memory, so they are added into global memory
// (zero-filled by the caller, resident in L2). Neighbouring pixels of a
// warp usually share label and bin: the warp reduces the pixels of each
// distinct key with shuffles and one lane issues 1+C atomics per key.
// Float atomics make the summation order vary between runs; the counts are
// exact.
#include "common.cuh"

#define SAG_RADIAL_MAX_CH 8

__global__ void __launch_bounds__(SAG_THREADS)
sag_radial_kernel(const int* __restrict__ labels, const int* __restrict__ codes,
                  const float* __restrict__ image, float* __restrict__ out, long long n,
                  int n_ch, int mc, int n_codes) {
  const int b = blockIdx.z;
  const int* lab_site = labels + (size_t)b * n;
  const int* code_site = codes + (size_t)b * n;
  const float* image_site = image + (size_t)b * n * n_ch;
  float* out_site = out + (size_t)b * mc * n_codes * (1 + n_ch);
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.y * blockDim.x;
  for (long long start = (long long)blockIdx.y * blockDim.x; start < n; start += stride) {
    const long long i = start + threadIdx.x;
    const int raw = i < n ? lab_site[i] : 0;
    const int code = i < n ? code_site[i] : -1;
    const bool act = raw > 0 && code >= 0 && code < n_codes;
    const int key = act ? (raw < mc ? raw : 0) * n_codes + code : -1;
    float v[SAG_RADIAL_MAX_CH];
#pragma unroll
    for (int c = 0; c < SAG_RADIAL_MAX_CH; ++c)
      v[c] = (act && c < n_ch) ? image_site[(size_t)i * n_ch + c] : 0.0f;
    unsigned todo = __ballot_sync(SAG_FULL_MASK, act);
    while (todo != 0u) {  // warp-uniform: one round per distinct key
      const int leader = __ffs(todo) - 1;
      const int k0 = __shfl_sync(SAG_FULL_MASK, key, leader);
      const bool mine = act && key == k0;
      const unsigned members = __ballot_sync(SAG_FULL_MASK, mine);
      todo &= ~members;
      float* dst = out_site + (size_t)k0 * (1 + n_ch);
      if (lane == leader) atomicAdd(dst, (float)__popc(members));
#pragma unroll
      for (int c = 0; c < SAG_RADIAL_MAX_CH; ++c) {
        if (c < n_ch) {
          const float s = sag_warp_sum(mine ? v[c] : 0.0f);
          if (lane == leader) atomicAdd(dst + 1 + c, s);
        }
      }
    }
  }
}

// labels (B, n) int32 raw; codes (B, n) int32; image (B, n, C) f32;
// out (B, mc, n_codes, 1 + C) f32 zero-filled.
extern "C" int sag_radial_sums(const int* labels, const int* codes, const float* image,
                               float* out, int batch, long long n, int n_ch, int mc,
                               int n_codes, void* stream) {
  if (n_ch < 1 || n_ch > SAG_RADIAL_MAX_CH || n_codes < 1) return (int)cudaErrorInvalidValue;
  dim3 grid(1, sag_chunks(n, batch), batch);
  sag_radial_kernel<<<grid, SAG_THREADS, 0, (cudaStream_t)stream>>>(labels, codes, image, out,
                                                                    n, n_ch, mc, n_codes);
  return sag_status();
}
