// K4: fused lane scans, per-label sums of payload lanes built in registers.
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
// boundary flag, perimeter weight, dense ranks and the gathered per-label
// table row. Every lane is a multiple of the pixel's inside flag (label >
// 0), so background pixels contribute nothing.
//
// Bound on the H100: bytes. Pass A reads 29 B a pixel at 5 channels (label,
// channels, perimeter weight, border byte) and builds 40 lanes, pass C 25 B
// (label, channels, border byte) and 110 lanes, pass E 44 B (label,
// channels, ranks) and 85 lanes: a few hundred flops a labelled pixel, far
// below the card's ~20 flops/byte ridge for f32. The first port of A, C
// and E was bound by neither: every lane of every 32-pixel warp step went
// through a 5-step shuffle reduction and a shared atomic, each block
// rebuilt all lanes and kept a share, and the shared accumulators (96 KB
// for A, 174 KB for E) left few blocks a SM (1.04, 7.15 and 3.16 ms at
// chip_smoke's 8 x 1080^2 x 5 channels).
//
// Passes A, C and E (the run kernels below) instead:
// - walk strips: a thread owns 64 consecutive pixels of the flat raster and
//   keeps its lanes' partial sums in registers while the slot stays the
//   same (inside an object a raster row gives one label for tens of
//   pixels); background pixels leave the run open; a run is flushed when
//   the slot changes and at the strip's end;
// - stage the pixels in shared memory: a block's 128 strips are copied 4
//   pixels a strip per step (labels, channel-last values, pass E's ranks)
//   with cp.async, double-buffered, consecutive threads on consecutive
//   16-byte chunks (4-byte words where a site's pixel count is not a
//   multiple of 4); the border byte of the edge lanes is read in the walk;
// - fix the lane groups at compile time: blockIdx.x picks a group body, a
//   template holding only its own accumulators. Pass C has two groups:
//   moments and quadratics (central and bbox products, intensity, cross
//   and edge quadratics; up to 74 sums) and Zernike (60 sums); only the
//   Zernike body builds the radials, each R_n^m from its (n - m)/2 + 1
//   non-zero coefficients (SAG_ZERNIKE_N/M below, copied to shared memory
//   once a block). Pass E has a group per SAG_E_PAIRS channel pairs, the
//   first also holding the tot_thr lanes (one group at up to 5 channels);
//   the pairs' channels and constants sit in shared memory. Pass A has one
//   group (up to 73 sums); it reads the perimeter weight and the border
//   byte in the walk. The blocks of
//   one span run next to each other, so a second group reads it from L2;
// - flush straight to the (B, mc, lanes) output with global float atomics
//   (red.global.add), each lane's offset computed in the body: no shared
//   accumulator, so any mc fits and shared memory holds only the staged
//   pixels (24 KB a block for A and C at 5 channels, 44 KB for E).
// Measured on an H100 SXM at 700 W with chip_smoke's inputs
// (tools/k4_variants.py, which times text-patched variants of this file;
// PERF.md §6). Along the way: four lane groups for C cost about 0.1 ms
// a pass more than two; a per-accumulator lane table and a zero test in
// the divergent flush cost more than the atomics they saved; 4-byte copies
// spent their time on address arithmetic (hence 16-byte copies); and
// without __launch_bounds__ the bodies took up to 248 registers, two
// blocks a SM (C 0.66 ms, E 0.65 ms). With SAG_RUN_MIN_BLOCKS = 3 (at most
// 168 registers, no spills) C takes about 0.47 ms and E, one group at 5
// channels, about 0.48 ms. The flush atomics cost about 0.1 ms of that
// (plain stores in their place: C 0.39, E 0.45 ms); the staging and walk
// alone, building no lane, take C 0.38 and E 0.46 ms, three to four times
// the byte bound. So bytes do not bound them; which wait holds the walk
// back (each step's copies, the table rows of new runs, the barriers) is
// not measured yet.
// Float atomics make the summation order vary between runs.
#include "common.cuh"

#define SAG_MAX_CH 8

// ---------------------------------------------------------------------------
// passes A, C and E: register runs over staged pixel strips

#define SAG_RUN_THREADS 128
#define SAG_STEP_PX 4                                    // pixels of a strip per step
#define SAG_STEPS 16                                     // steps per strip
#define SAG_STRIP (SAG_STEP_PX * SAG_STEPS)              // 64 pixels a thread
#define SAG_SPAN (SAG_RUN_THREADS * SAG_STRIP)           // 8192 pixels a block
#define SAG_STAGE_PX (SAG_RUN_THREADS * SAG_STEP_PX)     // 512 pixels a step
#define SAG_STAGES 2                                     // stage buffers
#define SAG_E_PAIRS 10    // channel pairs of a pass E group
#define SAG_RUN_MIN_BLOCKS 3  // resident blocks a SM: at most 168 registers a thread
#define SAG_ZERNIKE_TERMS 70

// Zernike index j -> (n, m), in ZERNIKE_INDEXES order. R_n^m has non-zero
// coefficients at rho^m, rho^(m+2), ..., rho^n only.
#define SAG_ZERNIKE_N 0, 1, 2, 2, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9
#define SAG_ZERNIKE_M 0, 1, 0, 2, 1, 3, 0, 2, 4, 1, 3, 5, 0, 2, 4, 6, 1, 3, 5, 7, 0, 2, 4, 6, 8, 1, 3, 5, 7, 9

__host__ __device__ constexpr int sag_zn(int j) {
  constexpr int t[30] = {SAG_ZERNIKE_N};
  return t[j];
}
__host__ __device__ constexpr int sag_zm(int j) {
  constexpr int t[30] = {SAG_ZERNIKE_M};
  return t[j];
}

// 4-byte async copy global -> shared; ok == false writes a zero instead.
__device__ __forceinline__ void sag_cp4(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// 16-byte async copy global -> shared; ok == false writes zeros instead.
__device__ __forceinline__ void sag_cp16(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// Issues the copies of one step of a block's strips into a stage buffer:
// the labels of the 512 pixels [first + t*STRIP, + STEP_PX) for t < 128,
// then their n_ch values from v0 (and v1), channel-last; consecutive
// threads copy consecutive words (VEC: 16-byte chunks, which needs n % 4
// == 0 and 16-byte aligned arrays). Pixels past n read as label 0.
template <bool VEC>
__device__ __forceinline__ void sag_stage(float* buf, const int* __restrict__ lab_site,
                                          const float* __restrict__ v0_site,
                                          const float* __restrict__ v1_site, long long first,
                                          long long n, int n_ch) {
  constexpr int W = VEC ? 4 : 1;  // words a copy
  int* lab_sh = reinterpret_cast<int*>(buf);
  float* v0_sh = buf + SAG_STAGE_PX;
  float* v1_sh = v0_sh + SAG_STAGE_PX * n_ch;
  for (int e = threadIdx.x * W; e < SAG_STAGE_PX; e += SAG_RUN_THREADS * W) {
    const long long i = first + (long long)(e / SAG_STEP_PX) * SAG_STRIP + e % SAG_STEP_PX;
    const bool ok = i < n;
    if (VEC)
      sag_cp16(lab_sh + e, lab_site + (ok ? i : 0), ok);
    else
      sag_cp4(lab_sh + e, lab_site + (ok ? i : 0), ok);
  }
  const int per = SAG_STEP_PX * n_ch;
  const long long nv = n * n_ch;
  for (int e = threadIdx.x * W; e < SAG_STAGE_PX * n_ch; e += SAG_RUN_THREADS * W) {
    const int seg = e / per;
    const long long src = (first + (long long)seg * SAG_STRIP) * n_ch + (e - seg * per);
    const bool ok = src < nv;
    if (VEC) {
      sag_cp16(v0_sh + e, v0_site + (ok ? src : 0), ok);
      if (v1_site != nullptr) sag_cp16(v1_sh + e, v1_site + (ok ? src : 0), ok);
    } else {
      sag_cp4(v0_sh + e, v0_site + (ok ? src : 0), ok);
      if (v1_site != nullptr) sag_cp4(v1_sh + e, v1_site + (ok ? src : 0), ok);
    }
  }
}

// Adds a run's register sum v into lane p of the output and clears it.
// Unconditional: skipping zero sums cost more in the divergent flush than
// the extra atomics (measured, see the note at the top).
__device__ __forceinline__ void sag_red(float* p, float& v) {
  atomicAdd(p, v);
  v = 0.0f;
}

// The strip walk shared by every group body. A body provides start(i)
// (position of the strip's first pixel), advance(), row(slot) (load the
// slot's table values), pixel(v, rk, i) (add pixel i's lanes, v and rk its
// staged values) and flush(out_row) (add the run's sums to the slot's
// output row and clear them).
template <bool VEC, class Body>
__device__ __forceinline__ void sag_run_strips(Body& body, const int* __restrict__ lab_site,
                                               const float* __restrict__ v0_site,
                                               const float* __restrict__ v1_site, long long n,
                                               int n_ch, int mc, float* __restrict__ out_site,
                                               int n_lanes) {
  extern __shared__ __align__(16) float sag_run_sh[];
  const int buf_floats = SAG_STAGE_PX * (1 + (v1_site != nullptr ? 2 : 1) * n_ch);
  const int per = SAG_STEP_PX * n_ch;
  const long long span0 = (long long)blockIdx.y * SAG_SPAN;
  long long i = span0 + (long long)threadIdx.x * SAG_STRIP;
  body.start(i);
  int cur = -1;  // the open run's slot
  // SAG_STAGES - 1 steps in flight ahead of the one walked
#pragma unroll
  for (int j = 0; j < SAG_STAGES - 1; ++j) {
    sag_stage<VEC>(sag_run_sh + j * buf_floats, lab_site, v0_site, v1_site,
                   span0 + (long long)j * SAG_STEP_PX, n, n_ch);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int j = 0; j < SAG_STEPS; ++j) {
    const int ahead = j + SAG_STAGES - 1;
    if (ahead < SAG_STEPS)
      sag_stage<VEC>(sag_run_sh + (ahead % SAG_STAGES) * buf_floats, lab_site, v0_site, v1_site,
                     span0 + (long long)ahead * SAG_STEP_PX, n, n_ch);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(SAG_STAGES - 1) : "memory");
    __syncthreads();
    const float* buf = sag_run_sh + (j % SAG_STAGES) * buf_floats;
    const int* lab = reinterpret_cast<const int*>(buf) + threadIdx.x * SAG_STEP_PX;
    const float* v0 = buf + SAG_STAGE_PX + threadIdx.x * per;
    const float* v1 = v0 + SAG_STAGE_PX * n_ch;
#pragma unroll 1
    for (int k = 0; k < SAG_STEP_PX; ++k, ++i) {
      const int raw = lab[k];
      if (raw > 0) {
        const int slot = raw < mc ? raw : 0;
        if (slot != cur) {
          if (cur >= 0) body.flush(out_site + (size_t)cur * n_lanes);
          cur = slot;
          body.row(slot);
        }
        body.pixel(v0 + k * n_ch, v1 + k * n_ch, i);
      }
      body.advance();
    }
    __syncthreads();  // the buffer is refilled by a later step's copies
  }
  if (cur >= 0) body.flush(out_site + (size_t)cur * n_lanes);
}

// Pass C's pixel position and table rows, shared by its group bodies.
// Table row: cy, cx, [ymin, xmin], [rmax], mean (C), [edge mean (C)].
struct SagCSite {
  const float* __restrict__ table;  // this site's (mc, k_tab) rows
  int k_tab, w, ix, iy;
  __device__ __forceinline__ void start(long long i) {
    iy = (int)(i / w);
    ix = (int)(i - (long long)iy * w);
  }
  __device__ __forceinline__ void advance() {
    if (++ix == w) {
      ix = 0;
      ++iy;
    }
  }
  __device__ __forceinline__ float at(int slot, int col) const {
    return sag_clean(__ldg(table + (size_t)slot * k_tab + col));
  }
};

// (p, q) != (0, 0) products of (dy^p, dx^q), p, q < 4, into acc[OFF...].
template <int OFF, int NACC>
__device__ __forceinline__ void sag_moment_products(float (&acc)[NACC], float dy, float dx) {
  const float y2 = dy * dy, x2 = dx * dx;
  const float yp[4] = {1.0f, dy, y2, y2 * dy};
  const float xp[4] = {1.0f, dx, x2, x2 * dx};
  int l = OFF;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (p != 0 || q != 0) acc[l++] += yp[p] * xp[q];
}

// Pass C's first group: central products [15], bbox-local products [15] if
// M, then vc^2 [8], vc_a*vc_b for a < b < 8 [28] and ec^2 [8] if E; the
// accumulators of channels >= n_ch stay unused.
template <bool M, bool Z, bool E>
struct SagCMomQuad {
  static constexpr int N_MOM = M ? 30 : 15;
  static constexpr int O_QUAD = N_MOM + (Z ? 60 : 0);  // output lane of vc^2
  static constexpr int NACC = N_MOM + SAG_MAX_CH * (SAG_MAX_CH + 1) / 2 + (E ? SAG_MAX_CH : 0);
  SagCSite s;
  const uint8_t* __restrict__ border;  // this site's border flags
  int n_ch, o_mean;
  float acc[NACC];
  float cy, cx, ymin, xmin;
  float mean[SAG_MAX_CH], emean[SAG_MAX_CH];
  __device__ __forceinline__ void start(long long i) { s.start(i); }
  __device__ __forceinline__ void advance() { s.advance(); }
  __device__ __forceinline__ void row(int slot) {
    cy = s.at(slot, 0);
    cx = s.at(slot, 1);
    if (M) {
      ymin = s.at(slot, 2);
      xmin = s.at(slot, 3);
    }
#pragma unroll
    for (int c = 0; c < SAG_MAX_CH; ++c) {
      mean[c] = c < n_ch ? s.at(slot, o_mean + c) : 0.0f;
      if (E) emean[c] = c < n_ch ? s.at(slot, o_mean + n_ch + c) : 0.0f;
    }
  }
  __device__ __forceinline__ void pixel(const float* v, const float*, long long i) {
    const float y = (float)s.iy, x = (float)s.ix;
    sag_moment_products<0>(acc, y - cy, x - cx);
    if constexpr (M) sag_moment_products<15>(acc, y - ymin, x - xmin);
    float vc[SAG_MAX_CH];
#pragma unroll
    for (int c = 0; c < SAG_MAX_CH; ++c) vc[c] = c < n_ch ? v[c] - mean[c] : 0.0f;
#pragma unroll
    for (int c = 0; c < SAG_MAX_CH; ++c)
      if (c < n_ch) acc[N_MOM + c] += vc[c] * vc[c];
    int l = N_MOM + SAG_MAX_CH;
#pragma unroll
    for (int a = 0; a < SAG_MAX_CH; ++a) {
#pragma unroll
      for (int bb = a + 1; bb < SAG_MAX_CH; ++bb) {
        if (bb < n_ch) acc[l] += vc[a] * vc[bb];
        ++l;
      }
    }
    if constexpr (E) {
      if (!__ldg(border + i)) return;
#pragma unroll
      for (int c = 0; c < SAG_MAX_CH; ++c) {
        if (c < n_ch) {
          const float ec = v[c] - emean[c];
          acc[l + c] += ec * ec;
        }
      }
    }
  }
  // output lanes: the products at [0, N_MOM), vc^2 at O_QUAD + c, pair
  // (a, b) at O_QUAD + n_ch + its index in (0,1), (0,2), ..., ec^2 after
  // the pairs
  __device__ __forceinline__ void flush(float* out_row) {
#pragma unroll
    for (int k = 0; k < N_MOM; ++k) sag_red(out_row + k, acc[k]);
    float* q = out_row + O_QUAD;
#pragma unroll
    for (int c = 0; c < SAG_MAX_CH; ++c)
      if (c < n_ch) sag_red(q + c, acc[N_MOM + c]);
    float* pr = q + n_ch;
    int l = N_MOM + SAG_MAX_CH;
#pragma unroll
    for (int a = 0; a < SAG_MAX_CH; ++a) {
      float* pa = pr + a * n_ch - a * (a + 1) / 2 - a - 1;
#pragma unroll
      for (int bb = a + 1; bb < SAG_MAX_CH; ++bb) {
        if (bb < n_ch) sag_red(pa + bb, acc[l]);
        ++l;
      }
    }
    if constexpr (E) {
      float* e = pr + n_ch * (n_ch - 1) / 2;
#pragma unroll
      for (int c = 0; c < SAG_MAX_CH; ++c)
        if (c < n_ch) sag_red(e + c, acc[l + c]);
    }
  }
};

// re / im lanes of Zernike indexes [J, 30): R_n^m(rho) from its non-zero
// terms in ascending powers (the f32 value of the dense 10-term sum, whose
// other terms add an exact 0), times cos / sin(m theta). coef: the 70
// non-zero coefficients, radial by radial, from coefficient K on.
template <int J, int K>
__device__ __forceinline__ void sag_zernike_lanes(float (&acc)[60], const float* coef,
                                                  const float* rp, const float* cm,
                                                  const float* sm) {
  if constexpr (J < 30) {
    constexpr int n = sag_zn(J), m = sag_zm(J);
    float r = 0.0f;
#pragma unroll
    for (int t = 0; t <= (n - m) / 2; ++t) r = fmaf(coef[K + t], rp[m + 2 * t], r);
    acc[J] += r * cm[m];
    acc[30 + J] += r * sm[m];
    sag_zernike_lanes<J + 1, K + (n - m) / 2 + 1>(acc, coef, rp, cm, sm);
  }
}

// The 70 non-zero radial coefficients, radial by radial in ascending
// powers, from the dense (30, 10) table.
template <int J, int K>
__device__ __forceinline__ void sag_zernike_coefs(float* coef, const float* __restrict__ zcoef) {
  if constexpr (J < 30) {
    constexpr int n = sag_zn(J), m = sag_zm(J);
#pragma unroll
    for (int t = 0; t <= (n - m) / 2; ++t) coef[K + t] = __ldg(zcoef + J * 10 + m + 2 * t);
    sag_zernike_coefs<J + 1, K + (n - m) / 2 + 1>(coef, zcoef);
  }
}

// Pass C's Zernike group: re [30] then im [30], at output lanes N_MOM + j
// and N_MOM + 30 + j. coef: the block's shared copy of the 70 non-zero
// coefficients.
template <bool M>
struct SagCZernike {
  static constexpr int N_MOM = M ? 30 : 15;
  static constexpr int NACC = 60;
  SagCSite s;
  const float* coef;
  int o_rmax;
  float acc[NACC];
  float cy, cx, inv_rmax;
  __device__ __forceinline__ void start(long long i) { s.start(i); }
  __device__ __forceinline__ void advance() { s.advance(); }
  __device__ __forceinline__ void row(int slot) {
    cy = s.at(slot, 0);
    cx = s.at(slot, 1);
    inv_rmax = 1.0f / fmaxf(s.at(slot, o_rmax), 1e-6f);
  }
  __device__ __forceinline__ void pixel(const float*, const float*, long long) {
    const float dy = (float)s.iy - cy, dx = (float)s.ix - cx;
    const float dist = sqrtf(fmaf(dy, dy, __fmul_rn(dx, dx)));
    const float rho = fminf(dist * inv_rmax, 1.0f);
    // rho**k rounded as the reference's integer powers (square and multiply)
    const float x2 = __fmul_rn(rho, rho), x4 = __fmul_rn(x2, x2), x8 = __fmul_rn(x4, x4);
    const float x3 = __fmul_rn(rho, x2);
    const float rp[10] = {1.0f, rho, x2, x3, x4, __fmul_rn(rho, x4), __fmul_rn(x2, x4),
                          __fmul_rn(x3, x4), x8, __fmul_rn(rho, x8)};
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
    sag_zernike_lanes<0, 0>(acc, coef, rp, cm, sm);
  }
  __device__ __forceinline__ void flush(float* out_row) {
#pragma unroll
    for (int k = 0; k < NACC; ++k) sag_red(out_row + N_MOM + k, acc[k]);
  }
};

template <class Body>
__device__ __forceinline__ void sag_run_c(Body& body, const float* table, int k_tab, int w,
                                          const int* lab_site, const float* image_site,
                                          long long n, int n_ch, int mc, float* out_site,
                                          int n_lanes, bool vec) {
  body.s.table = table;
  body.s.k_tab = k_tab;
  body.s.w = w;
#pragma unroll
  for (int k = 0; k < Body::NACC; ++k) body.acc[k] = 0.0f;
  if (vec)
    sag_run_strips<true>(body, lab_site, image_site, nullptr, n, n_ch, mc, out_site, n_lanes);
  else
    sag_run_strips<false>(body, lab_site, image_site, nullptr, n, n_ch, mc, out_site, n_lanes);
}

// Pass C: blockIdx.x = lane group (0 moments and quadratics, 1 Zernike when
// Z), blockIdx.y = span of SAG_SPAN pixels, blockIdx.z = site.
template <bool M, bool Z, bool E>
__global__ void __launch_bounds__(SAG_RUN_THREADS, SAG_RUN_MIN_BLOCKS)
sag_lanes_c_kernel(const int* __restrict__ labels, const float* __restrict__ image,
                   const uint8_t* __restrict__ border, const float* __restrict__ table, int k_tab,
                   const float* __restrict__ zcoef, float* __restrict__ out, long long n, int w,
                   int n_ch, int mc, int n_lanes, int vec) {
  const int b = blockIdx.z;
  const int* lab_site = labels + (size_t)b * n;
  const float* image_site = image + (size_t)b * n * n_ch;
  const float* tab = table + (size_t)b * mc * k_tab;
  float* out_site = out + (size_t)b * mc * n_lanes;
  const int o_rmax = 2 + (M ? 2 : 0);
  if (blockIdx.x == 0) {
    SagCMomQuad<M, Z, E> body;
    body.border = border + (size_t)b * n;
    body.n_ch = n_ch;
    body.o_mean = o_rmax + (Z ? 1 : 0);
    sag_run_c(body, tab, k_tab, w, lab_site, image_site, n, n_ch, mc, out_site, n_lanes, vec);
  } else if constexpr (Z) {
    __shared__ float coef_sh[SAG_ZERNIKE_TERMS];
    if (threadIdx.x == 0) sag_zernike_coefs<0, 0>(coef_sh, zcoef);  // read after the first sync
    SagCZernike<M> body;
    body.coef = coef_sh;
    body.o_rmax = o_rmax;
    sag_run_c(body, tab, k_tab, w, lab_site, image_site, n, n_ch, mc, out_site, n_lanes, vec);
  }
}

// A pass E group: channel pairs [q0, q0 + SAG_E_PAIRS) (those < n_pairs),
// 8 accumulators each [Manders a, b | RWC a, b | Costes a, b, denom_a,
// denom_b], then tot_thr [8] if TOT. above = vr > tff (the label's Manders
// threshold row), w = 1 - |rank_a - rank_b| * inv_r, ca = vr_a > thr_f,
// cb = vr_b > thr_s. The pairs' channels and constants are block-uniform
// and read from shared memory.
template <bool TOT>
struct SagE {
  static constexpr int NACC = 8 * SAG_E_PAIRS + (TOT ? SAG_MAX_CH : 0);
  const float* __restrict__ tff;  // this site's (mc, n_ch) thresholds
  const int* pab;                 // per pair: a | b << 8
  const float* cst;               // per pair: thr_f, then thr_s, then inv_r
  int n_ch, n_pairs, q0, n_live;
  float tt[SAG_MAX_CH];
  float acc[NACC];
  __device__ __forceinline__ void start(long long) {}
  __device__ __forceinline__ void advance() {}
  __device__ __forceinline__ void row(int slot) {
    const float* r = tff + (size_t)slot * n_ch;
#pragma unroll
    for (int c = 0; c < SAG_MAX_CH; ++c) tt[c] = c < n_ch ? sag_clean(__ldg(r + c)) : 0.0f;
  }
  __device__ __forceinline__ void pixel(const float* v, const float* rk, long long) {
    unsigned above = 0u;
#pragma unroll
    for (int c = 0; c < SAG_MAX_CH; ++c) {
      if (c < n_ch) {
        const float vc = v[c];
        if (vc > tt[c]) {
          above |= 1u << c;
          if constexpr (TOT) acc[8 * SAG_E_PAIRS + c] += vc;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < SAG_E_PAIRS; ++k) {
      if (k < n_live) {
        const int ab = pab[k];
        const int a = ab & 0xff, bb = ab >> 8;
        const float va = v[a], vb = v[bb];
        if ((above >> a) & (above >> bb) & 1u) {
          const float wr = 1.0f - fabsf(rk[a] - rk[bb]) * cst[2 * SAG_E_PAIRS + k];
          acc[8 * k] += va;
          acc[8 * k + 1] += vb;
          acc[8 * k + 2] += va * wr;
          acc[8 * k + 3] += vb * wr;
        }
        const bool ca = va > cst[k], cb = vb > cst[SAG_E_PAIRS + k];
        if (ca && cb) {
          acc[8 * k + 4] += va;
          acc[8 * k + 5] += vb;
        }
        if (ca) acc[8 * k + 6] += va;
        if (cb) acc[8 * k + 7] += vb;
      }
    }
  }
  // output lanes: tot_thr at c, Manders at n_ch + 2q, RWC at n_ch + 2P +
  // 2q, Costes at n_ch + 4P + 4q
  __device__ __forceinline__ void flush(float* out_row) {
    float* mand = out_row + n_ch + 2 * q0;
    float* rwc = mand + 2 * n_pairs;
    float* cot = out_row + n_ch + 4 * n_pairs + 4 * q0;
#pragma unroll
    for (int k = 0; k < SAG_E_PAIRS; ++k) {
      if (k < n_live) {
        sag_red(mand + 2 * k, acc[8 * k]);
        sag_red(mand + 2 * k + 1, acc[8 * k + 1]);
        sag_red(rwc + 2 * k, acc[8 * k + 2]);
        sag_red(rwc + 2 * k + 1, acc[8 * k + 3]);
#pragma unroll
        for (int t = 0; t < 4; ++t) sag_red(cot + 4 * k + t, acc[8 * k + 4 + t]);
      }
    }
    if constexpr (TOT) {
#pragma unroll
      for (int c = 0; c < SAG_MAX_CH; ++c)
        if (c < n_ch) sag_red(out_row + c, acc[8 * SAG_E_PAIRS + c]);
    }
  }
};

template <bool TOT>
__device__ __forceinline__ void sag_run_e(const int* pab, const float* cst, int q0,
                                          const float* tff, const int* lab_site,
                                          const float* image_site, const float* ranks_site,
                                          long long n, int n_ch, int mc, int n_pairs,
                                          float* out_site, int n_lanes, bool vec) {
  SagE<TOT> body;
  body.tff = tff;
  body.pab = pab;
  body.cst = cst;
  body.n_ch = n_ch;
  body.n_pairs = n_pairs;
  body.q0 = q0;
  body.n_live = min(SAG_E_PAIRS, n_pairs - q0);
#pragma unroll
  for (int k = 0; k < SagE<TOT>::NACC; ++k) body.acc[k] = 0.0f;
  if (vec)
    sag_run_strips<true>(body, lab_site, image_site, ranks_site, n, n_ch, mc, out_site, n_lanes);
  else
    sag_run_strips<false>(body, lab_site, image_site, ranks_site, n, n_ch, mc, out_site, n_lanes);
}

// Pass E: blockIdx.x = pair group (the first also holds tot_thr), y = span,
// z = site.
__global__ void __launch_bounds__(SAG_RUN_THREADS, SAG_RUN_MIN_BLOCKS)
sag_lanes_e_kernel(const int* __restrict__ labels, const float* __restrict__ image,
                   const float* __restrict__ ranks, const float* __restrict__ tff,
                   const float* __restrict__ consts, float* __restrict__ out, long long n,
                   int n_ch, int mc, int n_pairs, int n_lanes, int vec) {
  __shared__ int pab_sh[SAG_E_PAIRS];
  __shared__ float cst_sh[3 * SAG_E_PAIRS];
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * SAG_E_PAIRS;
  const float* cst = consts + (size_t)b * 3 * n_pairs;
  if (threadIdx.x < SAG_E_PAIRS) {  // read after the first sync
    const int k = threadIdx.x, q = q0 + k;
    int a = 0, rem = q;
    while (a < n_ch - 1 && rem >= n_ch - 1 - a) rem -= n_ch - 1 - a++;
    pab_sh[k] = q < n_pairs ? a | (a + 1 + rem) << 8 : 0;
    for (int t = 0; t < 3; ++t) cst_sh[t * SAG_E_PAIRS + k] = q < n_pairs ? __ldg(cst + t * n_pairs + q) : 0.0f;
  }
  const int* lab_site = labels + (size_t)b * n;
  const float* image_site = image + (size_t)b * n * n_ch;
  const float* ranks_site = ranks + (size_t)b * n * n_ch;
  const float* tff_site = tff + (size_t)b * mc * n_ch;
  float* out_site = out + (size_t)b * mc * n_lanes;
  if (blockIdx.x == 0)
    sag_run_e<true>(pab_sh, cst_sh, q0, tff_site, lab_site, image_site, ranks_site, n, n_ch, mc,
                    n_pairs, out_site, n_lanes, vec);
  else
    sag_run_e<false>(pab_sh, cst_sh, q0, tff_site, lab_site, image_site, ranks_site, n, n_ch, mc,
                     n_pairs, out_site, n_lanes, vec);
}

static inline int sag_run_smem(int n_ch, int n_vec) {
  return SAG_STAGES * SAG_STAGE_PX * (1 + n_vec * n_ch) * (int)sizeof(float);
}

template <typename... KArgs, typename... Args>
static int sag_run_launch(void (*kernel)(KArgs...), int n_groups, int batch, long long n,
                          int smem, cudaStream_t stream, Args... args) {
  if (n == 0) return 0;
  const long long spans = (n + SAG_SPAN - 1) / SAG_SPAN;
  if (spans > 65535 || batch > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_groups, (unsigned)spans, batch);
  kernel<<<grid, SAG_RUN_THREADS, smem, stream>>>(args...);
  return sag_status();
}

typedef void (*SagCKernel)(const int*, const float*, const uint8_t*, const float*, int,
                           const float*, float*, long long, int, int, int, int, int);

// The staged arrays of a site allow 16-byte copies.
static inline int sag_vec(long long n, const void* a, const void* b, const void* c) {
  const uintptr_t bits = (uintptr_t)a | (uintptr_t)b | (uintptr_t)c;
  return n % 4 == 0 && bits % 16 == 0;
}

// Pass A: [in, y*in, x*in, bnd, pw, v (C), y*v (C), x*v (C), (vr*bnd) (C)
// if E, vr*v (C), vr_a*v_b for a < b] with v = vr*in. The walk visits only
// labelled pixels, so in = 1 and v = vr here. The border flag and the
// perimeter weight are read in the walk; the accumulators of channels >=
// n_ch stay unused. 5 + 4 * 8 + 8 + 28 = 73 sums at 8 channels with E.
template <bool E>
struct SagA {
  static constexpr int O_EDGE = 5 + 3 * SAG_MAX_CH;
  static constexpr int O_QUAD = O_EDGE + (E ? SAG_MAX_CH : 0);
  static constexpr int NACC = O_QUAD + SAG_MAX_CH + SAG_MAX_CH * (SAG_MAX_CH - 1) / 2;
  const uint8_t* __restrict__ border;  // this site's border flags
  const float* __restrict__ pweight;   // this site's perimeter weights
  int w, n_ch, ix, iy;
  float acc[NACC];
  __device__ __forceinline__ void start(long long i) {
    iy = (int)(i / w);
    ix = (int)(i - (long long)iy * w);
  }
  __device__ __forceinline__ void advance() {
    if (++ix == w) {
      ix = 0;
      ++iy;
    }
  }
  __device__ __forceinline__ void row(int) {}
  __device__ __forceinline__ void pixel(const float* v, const float*, long long i) {
    const float y = (float)iy, x = (float)ix;
    const float bnd = __ldg(border + i) ? 1.0f : 0.0f;
    acc[0] += 1.0f;
    acc[1] += y;
    acc[2] += x;
    acc[3] += bnd;
    acc[4] += __ldg(pweight + i);
#pragma unroll
    for (int c = 0; c < SAG_MAX_CH; ++c) {
      if (c < n_ch) {
        const float vc = v[c];
        acc[5 + c] += vc;
        acc[5 + SAG_MAX_CH + c] += y * vc;
        acc[5 + 2 * SAG_MAX_CH + c] += x * vc;
        if constexpr (E) acc[O_EDGE + c] += vc * bnd;
        acc[O_QUAD + c] += vc * vc;
      }
    }
    int l = O_QUAD + SAG_MAX_CH;
#pragma unroll
    for (int a = 0; a < SAG_MAX_CH; ++a) {
#pragma unroll
      for (int bb = a + 1; bb < SAG_MAX_CH; ++bb) {
        if (bb < n_ch) acc[l] += v[a] * v[bb];
        ++l;
      }
    }
  }
  // output lanes at n_ch channels: the five scalars, v at 5 + c, y*v at
  // 5 + n_ch + c, x*v at 5 + 2 n_ch + c, [edge at 5 + 3 n_ch + c], vr*v
  // next, then pair (a, b) at its index in (0,1), (0,2), ...
  __device__ __forceinline__ void flush(float* out_row) {
#pragma unroll
    for (int k = 0; k < 5; ++k) sag_red(out_row + k, acc[k]);
    float* q = out_row + 5;
#pragma unroll
    for (int t = 0; t < (E ? 5 : 4); ++t) {
      const int o = t < 3 ? 5 + t * SAG_MAX_CH : (t == 3 && E ? O_EDGE : O_QUAD);
#pragma unroll
      for (int c = 0; c < SAG_MAX_CH; ++c)
        if (c < n_ch) sag_red(q + c, acc[o + c]);
      q += n_ch;
    }
    int l = O_QUAD + SAG_MAX_CH;
#pragma unroll
    for (int a = 0; a < SAG_MAX_CH; ++a) {
      float* pa = q + a * n_ch - a * (a + 1) / 2 - a - 1;
#pragma unroll
      for (int bb = a + 1; bb < SAG_MAX_CH; ++bb) {
        if (bb < n_ch) sag_red(pa + bb, acc[l]);
        ++l;
      }
    }
  }
};

// Pass A: one lane group (blockIdx.x = 0), blockIdx.y = span of SAG_SPAN
// pixels, blockIdx.z = site.
template <bool E>
__global__ void __launch_bounds__(SAG_RUN_THREADS, SAG_RUN_MIN_BLOCKS)
sag_lanes_a_kernel(const int* __restrict__ labels, const float* __restrict__ image,
                   const float* __restrict__ pweight, const uint8_t* __restrict__ border,
                   float* __restrict__ out, long long n, int w, int n_ch, int mc, int n_lanes,
                   int vec) {
  const int b = blockIdx.z;
  SagA<E> body;
  body.border = border + (size_t)b * n;
  body.pweight = pweight + (size_t)b * n;
  body.w = w;
  body.n_ch = n_ch;
#pragma unroll
  for (int k = 0; k < SagA<E>::NACC; ++k) body.acc[k] = 0.0f;
  const int* lab_site = labels + (size_t)b * n;
  const float* image_site = image + (size_t)b * n * n_ch;
  float* out_site = out + (size_t)b * mc * n_lanes;
  if (vec)
    sag_run_strips<true>(body, lab_site, image_site, nullptr, n, n_ch, mc, out_site, n_lanes);
  else
    sag_run_strips<false>(body, lab_site, image_site, nullptr, n, n_ch, mc, out_site, n_lanes);
}

typedef void (*SagAKernel)(const int*, const float*, const float*, const uint8_t*, float*,
                           long long, int, int, int, int, int);

static SagAKernel sag_a_kernel(int with_edge) {
  return with_edge ? sag_lanes_a_kernel<true> : sag_lanes_a_kernel<false>;
}

// Pass A. labels (B, h*w) int32 raw; image (B, h*w, C) f32; pweight (B, h*w)
// f32; border (B, h*w) uint8; out (B, mc, n_lanes) f32 zero-filled.
extern "C" int sag_lanes_a(const int* labels, const float* image, const float* pweight,
                           const uint8_t* border, float* out, int batch, int h, int w,
                           int n_ch, int mc, int with_edge, int n_lanes, void* stream) {
  if (n_ch < 1 || n_ch > SAG_MAX_CH || mc < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)h * w;
  return sag_run_launch(sag_a_kernel(with_edge), 1, batch, n, sag_run_smem(n_ch, 1),
                        (cudaStream_t)stream, labels, image, pweight, border, out, n, w, n_ch, mc,
                        n_lanes, sag_vec(n, labels, image, image));
}

static SagCKernel sag_c_kernel(int flags) {
  switch (flags) {
    case 0: return sag_lanes_c_kernel<false, false, false>;
    case 1: return sag_lanes_c_kernel<false, false, true>;
    case 2: return sag_lanes_c_kernel<false, true, false>;
    case 3: return sag_lanes_c_kernel<false, true, true>;
    case 4: return sag_lanes_c_kernel<true, false, false>;
    case 5: return sag_lanes_c_kernel<true, false, true>;
    case 6: return sag_lanes_c_kernel<true, true, false>;
    case 7: return sag_lanes_c_kernel<true, true, true>;
  }
  return nullptr;
}

// Pass C. labels (B, h*w) int32 raw; image (B, h*w, C) f32; border (B, h*w)
// uint8; table (B, mc, k_tab) f32; zcoef (30, 10) f32 radial coefficients
// (read at the non-zero places SAG_ZERNIKE_N/M name); out (B, mc, n_lanes)
// f32 zero-filled.
extern "C" int sag_lanes_c(const int* labels, const float* image, const uint8_t* border,
                           const float* table, int k_tab, const float* zcoef, float* out,
                           int batch, int h, int w, int n_ch, int mc, int with_moments,
                           int with_zernike, int with_edge, int n_lanes, void* stream) {
  if (n_ch < 1 || n_ch > SAG_MAX_CH || mc < 1) return (int)cudaErrorInvalidValue;
  const int flags = (with_moments ? 4 : 0) | (with_zernike ? 2 : 0) | (with_edge ? 1 : 0);
  const long long n = (long long)h * w;
  return sag_run_launch(sag_c_kernel(flags), with_zernike ? 2 : 1, batch, n,
                        sag_run_smem(n_ch, 1), (cudaStream_t)stream, labels, image, border,
                        table, k_tab, zcoef, out, n, w, n_ch, mc, n_lanes,
                        sag_vec(n, labels, image, image));
}

// Pass E. labels (B, n) int32 raw; image (B, n, C) f32; ranks (B, n, C) f32
// dense ranks of this object set; tff (B, mc, C) f32 per-label Manders
// thresholds; consts (B, 3, n_pairs) f32 = (Costes thr_f, thr_s, 1/R) in raw
// units per site; out (B, mc, C + 8 * n_pairs) f32 zero-filled.
extern "C" int sag_lanes_e(const int* labels, const float* image, const float* ranks,
                           const float* tff, const float* consts, float* out, int batch,
                           long long n, int n_ch, int mc, int n_pairs, void* stream) {
  if (n_ch < 2 || n_ch > SAG_MAX_CH || n_pairs != n_ch * (n_ch - 1) / 2 || mc < 1)
    return (int)cudaErrorInvalidValue;
  return sag_run_launch(sag_lanes_e_kernel, (n_pairs + SAG_E_PAIRS - 1) / SAG_E_PAIRS, batch, n,
                        sag_run_smem(n_ch, 2), (cudaStream_t)stream, labels, image, ranks, tff,
                        consts, out, n, n_ch, mc, n_pairs, n_ch + 8 * n_pairs,
                        sag_vec(n, labels, image, ranks));
}

// Resources of a run kernel (pass 0 = A with flags & 1 = edge, pass 1 = C
// with flags M*4 + Z*2 + E, pass 2 = E) at n_ch channels: info = {registers
// a thread, local bytes a thread, dynamic shared bytes a block, resident
// blocks a SM}.
extern "C" int sag_lanes_info(int pass, int flags, int n_ch, int* info) {
  const void* fn = pass == 0   ? (const void*)sag_a_kernel(flags & 1)
                   : pass == 1 ? (const void*)sag_c_kernel(flags)
                               : (pass == 2 ? (const void*)sag_lanes_e_kernel : nullptr);
  if (fn == nullptr || n_ch < 1 || n_ch > SAG_MAX_CH) return (int)cudaErrorInvalidValue;
  const int smem = sag_run_smem(n_ch, pass == 2 ? 2 : 1);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, SAG_RUN_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = smem;
  info[3] = blocks;
  return 0;
}
