// K4: fused lane scan, per-label sums of payload lanes built in registers.
//
// Replaces saguaro_tpu/kernels/segment_pallas.py::seg_lane_sums_pallas
// (kernel _lane_sums_fn) with the lane functions of
// saguaro_tpu/kernels/fused_measure.py: pass A (_make_lanes_a_fn_t, the
// linear sums) and pass C (_make_lanes_c_fn_t, centred and bbox moment
// products, Zernike re/im, centred intensity quadratics, edge quadratics),
// and of saguaro_tpu/kernels/colocalization.py: pass E
// (_make_lanes_e_fn_t, the Manders / RWC / Costes thresholded sums).
//
// out[b, lab, l] = sum over pixels i of site b with slot(i) == lab of
// lane_l(i), where slot(i) = label if 0 < label < mc else 0 (overflow labels
// fold into the ignored slot 0, as features.py does) and lane_l is the
// pass's payload built from the pixel's coordinates, channel values,
// boundary flag, perimeter weight and, for pass C, the gathered per-label
// table row (centroid, bbox origin, rmax, channel means, edge means).
//
// Bound on the H100: bytes. A pixel is read once (label 4 B, C channel
// floats, perimeter weight 4 B, border flag 1 B: 29 B at 5 channels for
// pass A, 25 B for pass C) and yields 40 (A) or 110 (C) lanes at 5 channels,
// a few hundred flops: far below the card's ~20 flops/byte ridge for f32.
// The point of the TPU kernel was that the (pixels x lanes) payload never
// reaches memory, and that holds here: lanes live in registers, are summed
// into a shared (lane group x mc) accumulator, and the block adds its
// non-zero sums to global memory once. Every lane of both passes is a
// multiple of the pixel's inside flag (or of its border flag, which implies
// inside), so background pixels contribute nothing and whole background
// warps skip the step. A warp whose active lanes share one label (the usual
// case inside an object) reduces each lane with shuffles and issues one
// shared atomic. At 5 channels pass C's full accumulator (512 x 110 x 4 B =
// 225 KB) would fill a block's shared memory, so the lanes are split into
// groups of equal width (grid.x): each block rebuilds all lanes of its
// pixels and keeps only its group; the rebuild is cheap arithmetic, and
// neighbouring blocks of a pixel chunk read the same pixels through L2.
// Pass E (C + 8P lanes, 85 at 5 channels and 10 pairs) reads a pixel's
// label, channels and dense ranks (44 B at 5 channels) and a per-label
// Manders threshold row; its 512 x 85 accumulator (174 KB) fits one block,
// so it runs as one lane group with a larger shared budget.
// Float atomics make the summation order vary between runs.
#include "common.cuh"

#define SAG_MAX_CH 8
#define SAG_LANES_SMEM (96 * 1024)
#define SAG_LANES_E_SMEM (200 * 1024)

struct SagPixel {
  float y, x, in, bnd;
  float vr[SAG_MAX_CH];
};

__device__ __forceinline__ void sag_load_pixel(SagPixel& p, const float* image_site,
                                               const uint8_t* border_site, long long i,
                                               bool act, int n_ch, int w) {
  p.y = (float)(i / w);
  p.x = (float)(i - (i / w) * w);
  p.in = act ? 1.0f : 0.0f;
  p.bnd = act && border_site != nullptr && border_site[i] ? 1.0f : 0.0f;
#pragma unroll
  for (int c = 0; c < SAG_MAX_CH; ++c) {
    p.vr[c] = (act && c < n_ch) ? image_site[(size_t)i * n_ch + c] : 0.0f;
  }
}

// pass A: [in, y*in, x*in, b, pw, v(C), y*v(C), x*v(C), (vr*b)(C) if edge,
//          vr*v (C), vr_a*v_b for a < b]  with v = vr*in
template <bool WITH_EDGE>
__device__ __forceinline__ void sag_lanes_a(SagAcc& acc, const SagPixel& p, float pw,
                                            int n_ch) {
  float v[SAG_MAX_CH];
#pragma unroll
  for (int c = 0; c < SAG_MAX_CH; ++c) v[c] = p.vr[c] * p.in;
  int l = 0;
  acc.add(l++, p.in);
  acc.add(l++, p.y * p.in);
  acc.add(l++, p.x * p.in);
  acc.add(l++, p.bnd);
  acc.add(l++, pw);
#pragma unroll
  for (int c = 0; c < SAG_MAX_CH; ++c)
    if (c < n_ch) acc.add(l++, v[c]);
#pragma unroll
  for (int c = 0; c < SAG_MAX_CH; ++c)
    if (c < n_ch) acc.add(l++, p.y * v[c]);
#pragma unroll
  for (int c = 0; c < SAG_MAX_CH; ++c)
    if (c < n_ch) acc.add(l++, p.x * v[c]);
  if (WITH_EDGE) {
#pragma unroll
    for (int c = 0; c < SAG_MAX_CH; ++c)
      if (c < n_ch) acc.add(l++, p.vr[c] * p.bnd);
  }
#pragma unroll
  for (int c = 0; c < SAG_MAX_CH; ++c)
    if (c < n_ch) acc.add(l++, p.vr[c] * v[c]);
#pragma unroll
  for (int a = 0; a < SAG_MAX_CH; ++a)
#pragma unroll
    for (int bb = a + 1; bb < SAG_MAX_CH; ++bb)
      if (bb < n_ch) acc.add(l++, p.vr[a] * v[bb]);
}

// pass C: central (p,q) != (0,0) products [15], bbox-local products [15] if
// moments, Zernike re [30] and im [30] if zernike, vc^2 (C), vc_a*vc_b,
// ec^2 (C) if edge. Table row: cy, cx, [ymin, xmin], [rmax], mean (C),
// [edge mean (C)].
template <bool WITH_MOMENTS, bool WITH_ZERNIKE, bool WITH_EDGE>
__device__ __forceinline__ void sag_lanes_c(SagAcc& acc, const SagPixel& p,
                                            const float* __restrict__ row,
                                            const float* __restrict__ zcoef, int n_ch) {
  const int o_rmax = 2 + (WITH_MOMENTS ? 2 : 0);
  const int o_mean = o_rmax + (WITH_ZERNIKE ? 1 : 0);
  const float in = p.in;
  const float dy = p.y - sag_clean(__ldg(row + 0));
  const float dx = p.x - sag_clean(__ldg(row + 1));
  int l = 0;
  {
    const float yc = dy * in, xc = dx * in;
    const float y2 = yc * yc, x2 = xc * xc;
    const float ycp[4] = {in, yc, y2, y2 * yc};
    const float xcp[4] = {in, xc, x2, x2 * xc};
#pragma unroll
    for (int pp = 0; pp < 4; ++pp)
#pragma unroll
      for (int qq = 0; qq < 4; ++qq)
        if (pp != 0 || qq != 0) acc.add(l++, ycp[pp] * xcp[qq]);
  }
  if (WITH_MOMENTS) {
    const float yb = (p.y - sag_clean(__ldg(row + 2))) * in;
    const float xb = (p.x - sag_clean(__ldg(row + 3))) * in;
    const float y2 = yb * yb, x2 = xb * xb;
    const float ybp[4] = {in, yb, y2, y2 * yb};
    const float xbp[4] = {in, xb, x2, x2 * xb};
#pragma unroll
    for (int pp = 0; pp < 4; ++pp)
#pragma unroll
      for (int qq = 0; qq < 4; ++qq)
        if (pp != 0 || qq != 0) acc.add(l++, ybp[pp] * xbp[qq]);
  }
  if (WITH_ZERNIKE) {
    const float dist = sqrtf(dy * dy + dx * dx);
    const float inv_rmax = 1.0f / fmaxf(sag_clean(__ldg(row + o_rmax)), 1e-6f);
    const float rho = fminf(dist * inv_rmax, 1.0f);
    float rp[10];
    rp[0] = 1.0f;
#pragma unroll
    for (int k = 1; k < 10; ++k) rp[k] = rp[k - 1] * rho;
    // cos/sin(m*theta) by angle addition on (cos, sin) = (dx, dy) / dist;
    // both are 0 at dist == 0, where every m > 0 radial vanishes
    const float inv_d = dist > 0.0f ? 1.0f / fmaxf(dist, 1e-30f) : 0.0f;
    const float ct = dx * inv_d, st = dy * inv_d;
    float cm[10], sm[10];
    cm[0] = 1.0f;
    sm[0] = 0.0f;
#pragma unroll
    for (int m = 1; m < 10; ++m) {
      cm[m] = ct * cm[m - 1] - st * sm[m - 1];
      sm[m] = st * cm[m - 1] + ct * sm[m - 1];
    }
    // re lanes at l + j, im lanes at l + 30 + j, j over ZERNIKE_INDEXES
    int j = 0;
#pragma unroll
    for (int nn = 0; nn < 10; ++nn) {
#pragma unroll
      for (int m = nn % 2; m <= nn; m += 2) {
        float r = 0.0f;
#pragma unroll
        for (int k = 0; k < 10; ++k) r += __ldg(zcoef + j * 10 + k) * rp[k];
        acc.add(l + j, r * cm[m] * in);
        acc.add(l + 30 + j, r * sm[m] * in);
        ++j;
      }
    }
    l += 60;
  }
  float vc[SAG_MAX_CH];
#pragma unroll
  for (int c = 0; c < SAG_MAX_CH; ++c)
    vc[c] = c < n_ch ? (p.vr[c] - sag_clean(__ldg(row + o_mean + c))) * in : 0.0f;
#pragma unroll
  for (int c = 0; c < SAG_MAX_CH; ++c)
    if (c < n_ch) acc.add(l++, vc[c] * vc[c]);
#pragma unroll
  for (int a = 0; a < SAG_MAX_CH; ++a)
#pragma unroll
    for (int bb = a + 1; bb < SAG_MAX_CH; ++bb)
      if (bb < n_ch) acc.add(l++, vc[a] * vc[bb]);
  if (WITH_EDGE) {
#pragma unroll
    for (int c = 0; c < SAG_MAX_CH; ++c) {
      if (c < n_ch) {
        const float ec = (p.vr[c] - sag_clean(__ldg(row + o_mean + n_ch + c))) * p.bnd;
        acc.add(l++, ec * ec);
      }
    }
  }
}

// pass E: [vr*above (C), Manders vr_a*cmb, vr_b*cmb per pair, RWC
// vr_a*w*cmb, vr_b*w*cmb per pair, Costes vr_a*cc, vr_b*cc, vr_a*ca, vr_b*cb
// per pair] with above = vr > tff (the label's Manders threshold row),
// cmb = above_a*above_b, w = 1 - |rank_a - rank_b| * inv_r, ca = vr_a >
// thr_f, cb = vr_b > thr_s, cc = ca*cb; cst = (thr_f (P), thr_s (P),
// inv_r (P)) of the site.
__device__ __forceinline__ void sag_lanes_e(SagAcc& acc, const SagPixel& p,
                                            const float* __restrict__ row,
                                            const float* __restrict__ rk,
                                            const float* __restrict__ cst, int n_ch,
                                            int n_pairs) {
  float above[SAG_MAX_CH];
#pragma unroll
  for (int c = 0; c < SAG_MAX_CH; ++c)
    above[c] = (c < n_ch && p.vr[c] > sag_clean(__ldg(row + c))) ? p.in : 0.0f;
#pragma unroll
  for (int c = 0; c < SAG_MAX_CH; ++c)
    if (c < n_ch) acc.add(c, p.vr[c] * above[c]);
  const int o_mand = n_ch, o_rwc = n_ch + 2 * n_pairs, o_cot = n_ch + 4 * n_pairs;
  int q = 0;
#pragma unroll
  for (int a = 0; a < SAG_MAX_CH; ++a) {
#pragma unroll
    for (int bb = a + 1; bb < SAG_MAX_CH; ++bb) {
      if (bb < n_ch) {
        const float cmb = above[a] * above[bb];
        acc.add(o_mand + 2 * q, p.vr[a] * cmb);
        acc.add(o_mand + 2 * q + 1, p.vr[bb] * cmb);
        const float wr = 1.0f - fabsf(rk[a] - rk[bb]) * __ldg(cst + 2 * n_pairs + q);
        acc.add(o_rwc + 2 * q, p.vr[a] * wr * cmb);
        acc.add(o_rwc + 2 * q + 1, p.vr[bb] * wr * cmb);
        const float ca = p.vr[a] > __ldg(cst + q) ? p.in : 0.0f;
        const float cb = p.vr[bb] > __ldg(cst + n_pairs + q) ? p.in : 0.0f;
        const float cc = ca * cb;
        acc.add(o_cot + 4 * q, p.vr[a] * cc);
        acc.add(o_cot + 4 * q + 1, p.vr[bb] * cc);
        acc.add(o_cot + 4 * q + 2, p.vr[a] * ca);
        acc.add(o_cot + 4 * q + 3, p.vr[bb] * cb);
        ++q;
      }
    }
  }
}

// One kernel for the three passes: PASS 0 = A, 1 = C, 2 = E.
template <int PASS, bool WITH_MOMENTS, bool WITH_ZERNIKE, bool WITH_EDGE>
__global__ void __launch_bounds__(SAG_THREADS)
sag_lanes_kernel(const int* __restrict__ labels, const float* __restrict__ image,
                 const float* __restrict__ pweight, const uint8_t* __restrict__ border,
                 const float* __restrict__ table, int k_tab, const float* __restrict__ zcoef,
                 const float* __restrict__ ranks, const float* __restrict__ consts, int n_pairs,
                 float* __restrict__ out, long long n, int w, int n_ch, int mc, int n_lanes,
                 int group) {
  extern __shared__ float acc_sh[];
  const int b = blockIdx.z;
  const int g0 = blockIdx.x * group;
  const int g1 = min(g0 + group, n_lanes);
  for (int j = threadIdx.x; j < (g1 - g0) * mc; j += blockDim.x) acc_sh[j] = 0.0f;
  __syncthreads();

  SagAcc acc;
  acc.sh = acc_sh;
  acc.mc = mc;
  acc.g0 = g0;
  acc.g1 = g1;
  const int* lab_site = labels + (size_t)b * n;
  const float* image_site = image + (size_t)b * n * n_ch;
  const uint8_t* border_site = PASS == 2 ? nullptr : border + (size_t)b * n;
  const long long stride = (long long)gridDim.y * blockDim.x;
  for (long long start = (long long)blockIdx.y * blockDim.x; start < n; start += stride) {
    const long long i = start + threadIdx.x;
    const int raw = i < n ? lab_site[i] : 0;
    // every lane is a multiple of the inside flag: only labelled pixels count
    const bool act = raw > 0;
    const int lab = (act && raw < mc) ? raw : 0;
    if (!sag_warp_setup(acc, act, lab)) continue;
    SagPixel p;
    sag_load_pixel(p, image_site, border_site, act ? i : 0, act, n_ch, w);
    if (PASS == 0) {
      const float pw = act ? pweight[(size_t)b * n + i] : 0.0f;
      sag_lanes_a<WITH_EDGE>(acc, p, pw, n_ch);
    } else if (PASS == 1) {
      const float* row = table + ((size_t)b * mc + lab) * k_tab;
      sag_lanes_c<WITH_MOMENTS, WITH_ZERNIKE, WITH_EDGE>(acc, p, row, zcoef, n_ch);
    } else {
      const float* row = table + ((size_t)b * mc + lab) * k_tab;
      float rk[SAG_MAX_CH];
      const float* rk_px = ranks + ((size_t)b * n + (act ? i : 0)) * n_ch;
#pragma unroll
      for (int c = 0; c < SAG_MAX_CH; ++c) rk[c] = (act && c < n_ch) ? rk_px[c] : 0.0f;
      sag_lanes_e(acc, p, row, rk, consts + (size_t)b * 3 * n_pairs, n_ch, n_pairs);
    }
  }
  __syncthreads();
  sag_flush(acc_sh, out + (size_t)b * mc * n_lanes, mc, n_lanes, g0, g1);
}

template <int PASS, bool M, bool Z, bool E>
static int sag_launch_lanes(const int* labels, const float* image, const float* pweight,
                            const uint8_t* border, const float* table, int k_tab,
                            const float* zcoef, const float* ranks, const float* consts,
                            int n_pairs, float* out, int batch, long long n, int w, int n_ch,
                            int mc, int n_lanes, int budget, cudaStream_t stream) {
  int group = sag_group_width(n_lanes, mc, budget);
  if (group == 0) return (int)cudaErrorInvalidValue;
  int n_groups = (n_lanes + group - 1) / group;
  size_t smem = (size_t)group * mc * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(sag_lanes_kernel<PASS, M, Z, E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(n_groups, sag_chunks(n, batch * n_groups), batch);
  sag_lanes_kernel<PASS, M, Z, E><<<grid, SAG_THREADS, smem, stream>>>(
      labels, image, pweight, border, table, k_tab, zcoef, ranks, consts, n_pairs, out, n, w,
      n_ch, mc, n_lanes, group);
  return sag_status();
}

// Pass A. labels (B, h*w) int32 raw; image (B, h*w, C) f32; pweight (B, h*w)
// f32; border (B, h*w) uint8; out (B, mc, n_lanes) f32 zero-filled.
extern "C" int sag_lanes_a(const int* labels, const float* image, const float* pweight,
                           const uint8_t* border, float* out, int batch, int h, int w,
                           int n_ch, int mc, int with_edge, int n_lanes, void* stream) {
  if (n_ch < 1 || n_ch > SAG_MAX_CH) return (int)cudaErrorInvalidValue;
  long long n = (long long)h * w;
  cudaStream_t s = (cudaStream_t)stream;
  if (with_edge)
    return sag_launch_lanes<0, false, false, true>(labels, image, pweight, border, nullptr,
                                                   0, nullptr, nullptr, nullptr, 0, out, batch,
                                                   n, w, n_ch, mc, n_lanes, SAG_LANES_SMEM, s);
  return sag_launch_lanes<0, false, false, false>(labels, image, pweight, border, nullptr, 0,
                                                  nullptr, nullptr, nullptr, 0, out, batch, n,
                                                  w, n_ch, mc, n_lanes, SAG_LANES_SMEM, s);
}

// Pass C. table (B, mc, k_tab) f32; zcoef (30, 10) f32 radial coefficients.
extern "C" int sag_lanes_c(const int* labels, const float* image, const uint8_t* border,
                           const float* table, int k_tab, const float* zcoef, float* out,
                           int batch, int h, int w, int n_ch, int mc, int with_moments,
                           int with_zernike, int with_edge, int n_lanes, void* stream) {
  if (n_ch < 1 || n_ch > SAG_MAX_CH) return (int)cudaErrorInvalidValue;
  long long n = (long long)h * w;
  cudaStream_t s = (cudaStream_t)stream;
  const int flags = (with_moments ? 4 : 0) | (with_zernike ? 2 : 0) | (with_edge ? 1 : 0);
#define SAG_C_CASE(F, M, Z, E)                                                          \
  case F:                                                                               \
    return sag_launch_lanes<1, M, Z, E>(labels, image, nullptr, border, table, k_tab,   \
                                        zcoef, nullptr, nullptr, 0, out, batch, n, w, n_ch, \
                                        mc, n_lanes, SAG_LANES_SMEM, s);
  switch (flags) {
    SAG_C_CASE(0, false, false, false)
    SAG_C_CASE(1, false, false, true)
    SAG_C_CASE(2, false, true, false)
    SAG_C_CASE(3, false, true, true)
    SAG_C_CASE(4, true, false, false)
    SAG_C_CASE(5, true, false, true)
    SAG_C_CASE(6, true, true, false)
    SAG_C_CASE(7, true, true, true)
  }
#undef SAG_C_CASE
  return (int)cudaErrorInvalidValue;
}

// Pass E. labels (B, h*w) int32 raw; image (B, h*w, C) f32; ranks (B, h*w, C)
// f32 dense ranks of this object set; tff (B, mc, C) f32 per-label Manders
// thresholds; consts (B, 3, n_pairs) f32 = (Costes thr_f, thr_s, 1/R) in raw
// units per site; out (B, mc, C + 8 * n_pairs) f32 zero-filled.
extern "C" int sag_lanes_e(const int* labels, const float* image, const float* ranks,
                           const float* tff, const float* consts, float* out, int batch,
                           long long n, int n_ch, int mc, int n_pairs, void* stream) {
  if (n_ch < 2 || n_ch > SAG_MAX_CH || n_pairs != n_ch * (n_ch - 1) / 2)
    return (int)cudaErrorInvalidValue;
  return sag_launch_lanes<2, false, false, false>(
      labels, image, nullptr, nullptr, tff, n_ch, nullptr, ranks, consts, n_pairs, out, batch,
      n, 1, n_ch, mc, n_ch + 8 * n_pairs, SAG_LANES_E_SMEM, (cudaStream_t)stream);
}
