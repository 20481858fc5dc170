// K5: bounded horizontal sweep of the exact label-aware EDT.
//
// Replaces saguaro_tpu/kernels/segment_pallas.py::edt_sweep_pallas
// (kernel _edt_sweep_fn: 32-row VMEM blocks, 2R+1 shifted min-adds).
//
// out[b, y, x] = min(d2[b, y, x], min over 1 <= dx <= R of
//                    min(v2[b, y, x - dx], v2[b, y, x + dx]) + dx*dx)
// with candidates outside the row read as +inf. The mins keep NaN (PTX
// min.NaN), as jnp.minimum and torch.minimum do, and every add is one f32
// rounding, as in the plain form, so the result is bit-exact.
//
// Bound on the H100: bytes (12 B a pixel: v2 and d2 read, one float
// written). The sweep's work is what these inputs need, not 2R a pixel:
// - one warp a row: it stages the row of v2 with halos of +inf and the row
//   of d2 in shared memory (16-byte loads where rows are 16-byte aligned,
//   K5_STAGE in flight a lane), the minimum of every K5_BLOCK values of v2
//   and, from those, the bound of each group of K5_P outputs; no CTA
//   barrier;
// - a lane sweeps one group at a time with two register windows of
//   K5_P + K5_S candidates, left and right of its pixels. A block of K5_S
//   steps of dx reads K5_S new values of each side from shared memory
//   (16-byte loads); the rest are registers;
// - an exact early exit. Every candidate a group has left at dx is at
//   least fl(smin + dx^2), smin the NaN-keeping minimum of the blocks that
//   cover every value its pixels can reach (rounding is monotone, dx^2
//   grows). Before each block the group stops once that bound is >= best
//   for all its pixels. A NaN within reach, or a NaN best, never passes
//   the test, so such a group runs all of R. Groups of one label (v2 = 1e18
//   everywhere within reach) stop at once;
// - the row's groups are a queue: a lane whose group is done stores it and
//   takes the next, so the warp's lanes stay busy however unequal the
//   groups' sweeps are (the inputs need 11 steps a pixel on average at
//   chip_smoke's nuclei, and a group by an object's edge needs 1).
// What is left is the min pipe: two NaN-keeping mins a candidate, which
// run at half the f32 rate (PERF.md, tools/k5_k4r_variants.py).
#include "common.cuh"

#define K5_P 8             // consecutive outputs a group (a lane's) holds, a multiple of 4
#define K5_S 8             // steps of dx a block, a multiple of 4
#define K5_BLOCK 32        // values a block minimum covers (4, 8, 16 or 32)
#define K5_WARPS 4         // rows a CTA at most, one a warp
#define K5_STAGE 4         // loads a lane keeps in flight while staging
#define K5_SMEM_MAX 232448 // dynamic shared bytes a CTA can have on the H100

__device__ __forceinline__ float k5_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The geometry of rows of w: reff = min(radius, w - 1) steps (steps past
// the row's width only meet +inf), kp = reff rounded up to K5_S (the
// halo), wp = w rounded up to K5_P, span = the staged v2 (wp and both
// halos) rounded up to 32.
struct K5Geom {
  int reff, kp, wp, span;
};

static inline K5Geom k5_geom(int w, int radius) {
  K5Geom g;
  g.reff = radius < w - 1 ? radius : w - 1;
  g.kp = (g.reff + K5_S - 1) / K5_S * K5_S;
  g.wp = (w + K5_P - 1) / K5_P * K5_P;
  g.span = (g.wp + 2 * g.kp + 31) / 32 * 32;
  return g;
}

// shared bytes one warp (one row) needs: the staged rows of v2 (with its
// halos) and d2, the block minima and each group's bound
static inline size_t k5_warp_bytes(const K5Geom& g) {
  return (size_t)(g.span + g.wp + g.span / K5_BLOCK + g.wp / K5_P) * sizeof(float);
}

// a lane's group of K5_P outputs: its best values, how many of them lie
// in the row, its bound smin and its candidate windows
struct K5Group {
  float best[K5_P];
  int nv;
  float smin;
  // v2 at x0 - (k+1)S .. x0 - kS + P - 1 and at x0 + kS .. x0 + (k+1)S + P - 1
  float lw[K5_P + K5_S], rw[K5_P + K5_S];
  int x0, k;
};

__device__ __forceinline__ void k5_load4(float* dst, const float* src) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  dst[0] = a.x;
  dst[1] = a.y;
  dst[2] = a.z;
  dst[3] = a.w;
}

// the least value group g's candidates can read: the minimum of the
// blocks covering x0 - reff .. x0 + K5_P - 1 + reff
__device__ __forceinline__ float k5_reach_min(int g, int reff, int kp, const float* bmin) {
  float m = __int_as_float(0x7f800000);
  const int jlo = g * K5_P + kp - reff, jhi = g * K5_P + K5_P - 1 + kp + reff;
#pragma unroll 4
  for (int bb = jlo / K5_BLOCK; bb <= jhi / K5_BLOCK; ++bb) m = k5_min(m, bmin[bb]);
  return m;
}

// takes group g of the staged row of w outputs: d2 from dsh, its bound
// from gmin, the windows at k = 0 (none when there is no step to take)
__device__ __forceinline__ void k5_take(K5Group& t, int g, int w, int kp, int n_blk,
                                        const float* buf, const float* dsh, const float* gmin) {
  t.x0 = g * K5_P;
  t.k = 0;
  t.nv = w - t.x0;
#pragma unroll
  for (int q = 0; q < K5_P; q += 4) k5_load4(t.best + q, dsh + t.x0 + q);
  if (n_blk == 0) return;
  t.smin = gmin[g];
  const float* c = buf + kp + t.x0;
#pragma unroll
  for (int q = 0; q < K5_P + K5_S; q += 4) {
    k5_load4(t.lw + q, c - K5_S + q);
    k5_load4(t.rw + q, c + q);
  }
}

// whether every candidate the group has left is >= its best: the group's
// sweep is over (exact; NaN never passes)
__device__ __forceinline__ bool k5_done(const K5Group& t, int n_blk) {
  if (t.k >= n_blk) return true;
  const float fd0 = __int2float_rn(1 + t.k * K5_S);
  const float lb = __fadd_rn(t.smin, __fmul_rn(fd0, fd0));
  bool done = true;
#pragma unroll
  for (int i = 0; i < K5_P; ++i) done &= i >= t.nv || lb >= t.best[i];
  return done;
}

// steps dx = 1 + kS + j, j < jn. dx^2 is one rounded product and each
// candidate one rounded add, never contracted, as in the plain form.
template <bool FULL>
__device__ __forceinline__ void k5_steps(K5Group& t, int jn) {
  const float fd0 = __int2float_rn(1 + t.k * K5_S);
#pragma unroll
  for (int j = 0; j < K5_S; ++j) {
    if (!FULL && j >= jn) break;
    const float fx = fd0 + (float)j;
    const float f = __fmul_rn(fx, fx);
#pragma unroll
    for (int i = 0; i < K5_P; ++i)
      t.best[i] = k5_min(t.best[i], __fadd_rn(k5_min(t.lw[K5_S - 1 + i - j], t.rw[i + 1 + j]), f));
  }
}

// one block of steps, then both windows move on by K5_S
__device__ __forceinline__ void k5_block(K5Group& t, int n_blk, int reff, int kp,
                                         const float* buf) {
  const int rem = reff - t.k * K5_S;  // steps left within the radius
  if (rem >= K5_S)
    k5_steps<true>(t, K5_S);
  else
    k5_steps<false>(t, rem);
#pragma unroll
  for (int m = 0; m < K5_P; ++m) t.rw[m] = t.rw[m + K5_S];
#pragma unroll
  for (int m = K5_P + K5_S - 1; m >= K5_S; --m) t.lw[m] = t.lw[m - K5_S];
  ++t.k;
  if (t.k < n_blk) {
    const float* c = buf + kp + t.x0;
#pragma unroll
    for (int q = 0; q < K5_S; q += 4) {
      k5_load4(t.lw + q, c - (t.k + 1) * K5_S + q);
      k5_load4(t.rw + K5_P + q, c + t.k * K5_S + K5_P + q);
    }
  }
}

// The launch's shape, the same for every warp.
struct K5Args {
  const float* v2;
  const float* d2;
  float* out;
  int rows, w, reff, kp, span;
};

template <bool VEC>
__global__ void __launch_bounds__(K5_WARPS * 32)
sag_edt_sweep_kernel(const K5Args a) {
  extern __shared__ __align__(16) float k5_sh[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * warps + warp;
  if (row >= a.rows) return;  // the whole warp: nothing below syncs the CTA
  const int w = a.w, kp = a.kp, span = a.span;
  const int wp = (w + K5_P - 1) / K5_P * K5_P;
  const int nb = span / K5_BLOCK, n_grp = wp / K5_P;
  const int n_blk = kp / K5_S;  // blocks of K5_S steps of dx
  float* buf = k5_sh + (size_t)warp * (span + wp);  // v2 at x: buf[x + kp]
  float* dsh = buf + span;                          // d2 at x: dsh[x]
  float* bmin = k5_sh + (size_t)warps * (span + wp) + (size_t)warp * (nb + n_grp);
  float* gmin = bmin + nb;                          // each group's bound
  const size_t base = (size_t)row * w;
  const float inf = __int_as_float(0x7f800000);

  // stage the row of v2 (+inf outside it) with each block's minimum, and
  // the row of d2
  if (VEC) {
    constexpr int G = K5_BLOCK / 4;  // lanes a block: whole groups are in or out
    const int nu = span / 4, nd = wp / 4;
    for (int u0 = 0; u0 < nu; u0 += 32 * K5_STAGE) {
      float4 q[K5_STAGE], e[K5_STAGE];
#pragma unroll
      for (int t = 0; t < K5_STAGE; ++t) {
        const int u = u0 + 32 * t + lane, x = 4 * u - kp;
        q[t] = make_float4(inf, inf, inf, inf);
        e[t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (u < nu && x >= 0 && x < w)
          q[t] = __ldg(reinterpret_cast<const float4*>(a.v2 + base + x));
        if (u < nd && 4 * u < w) e[t] = __ldg(reinterpret_cast<const float4*>(a.d2 + base) + u);
      }
#pragma unroll
      for (int t = 0; t < K5_STAGE; ++t) {
        const int u = u0 + 32 * t + lane;
        if (u < nu) reinterpret_cast<float4*>(buf)[u] = q[t];
        if (u < nd) reinterpret_cast<float4*>(dsh)[u] = e[t];
        float m = k5_min(k5_min(q[t].x, q[t].y), k5_min(q[t].z, q[t].w));
#pragma unroll
        for (int o = 1; o < G; o <<= 1) m = k5_min(m, __shfl_xor_sync(SAG_FULL_MASK, m, o));
        if (lane % G == 0 && u < nu) bmin[u / G] = m;
      }
    }
  } else {
    for (int j0 = 0; j0 < span; j0 += 32 * K5_STAGE) {  // span is a multiple of 32
      float q[K5_STAGE], e[K5_STAGE];
#pragma unroll
      for (int t = 0; t < K5_STAGE; ++t) {
        const int j = j0 + 32 * t + lane, x = j - kp;
        q[t] = (j < span && x >= 0 && x < w) ? __ldg(a.v2 + base + x) : inf;
        e[t] = (j < w) ? __ldg(a.d2 + base + j) : 0.0f;
      }
#pragma unroll
      for (int t = 0; t < K5_STAGE; ++t) {
        const int j = j0 + 32 * t + lane;
        if (j < span) buf[j] = q[t];
        if (j < wp) dsh[j] = e[t];
        float m = q[t];
#pragma unroll
        for (int o = 1; o < K5_BLOCK; o <<= 1) m = k5_min(m, __shfl_xor_sync(SAG_FULL_MASK, m, o));
        if (lane % K5_BLOCK == 0 && j < span) bmin[j / K5_BLOCK] = m;
      }
    }
  }
  __syncwarp();
  if (n_blk > 0) {
    for (int g = lane; g < n_grp; g += 32) gmin[g] = k5_reach_min(g, a.reff, kp, bmin);
    __syncwarp();
  }

  // The row's groups of K5_P outputs go to the lanes as a queue: a lane
  // whose group is done stores it and takes the next one, so the lanes
  // stay busy however unequal the groups' sweeps are.
  const unsigned below = (1u << lane) - 1u;
  K5Group t;
  bool live = lane < n_grp;
  if (live) k5_take(t, lane, w, kp, n_blk, buf, dsh, gmin);
  int next = 32;  // warp-uniform: the next group to hand out
  for (;;) {
    bool check = live;  // the groups to test: all after a block, then the new ones
    for (;;) {  // retire the groups that are done and hand out new ones
      const bool fin = check && k5_done(t, n_blk);
      if (fin) {
        float* o = a.out + base + t.x0;
        if (VEC) {
#pragma unroll
          for (int i = 0; i < K5_P; i += 4)
            if (i < t.nv)
              *reinterpret_cast<float4*>(o + i) =
                  make_float4(t.best[i], t.best[i + 1], t.best[i + 2], t.best[i + 3]);
        } else {
#pragma unroll
          for (int i = 0; i < K5_P; ++i)
            if (i < t.nv) o[i] = t.best[i];
        }
      }
      const unsigned fm = __ballot_sync(SAG_FULL_MASK, fin);
      if (fm == 0u) break;
      check = false;
      if (fin) {
        const int g = next + __popc(fm & below);
        live = g < n_grp;
        if (live) k5_take(t, g, w, kp, n_blk, buf, dsh, gmin);
        check = live;
      }
      next += __popc(fm);
    }
    if (__ballot_sync(SAG_FULL_MASK, live) == 0u) break;
    if (live) k5_block(t, n_blk, a.reff, kp, buf);
  }
}

// warps (rows) a CTA and its dynamic shared bytes for geometry g (0: a
// row does not fit)
static inline int k5_warps(const K5Geom& g, size_t* smem) {
  const size_t per_warp = k5_warp_bytes(g);
  if (per_warp > K5_SMEM_MAX) return 0;
  int warps = (int)(K5_SMEM_MAX / per_warp);
  warps = warps < K5_WARPS ? warps : K5_WARPS;
  *smem = per_warp * warps;
  return warps;
}

// v2, d2, out (B, h, w) f32. 16-byte loads and stores when w is a multiple
// of 4 and the three pointers are 16-byte aligned, else 4-byte ones.
extern "C" int sag_edt_sweep(const float* v2, const float* d2, float* out, int batch, int h,
                             int w, int radius, void* stream) {
  if (radius < 0 || h < 1 || w < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  const K5Geom g = k5_geom(w, radius);
  size_t smem = 0;
  int warps = k5_warps(g, &smem);
  const long long rows = (long long)batch * h;
  if (warps == 0 || rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (rows < warps) {
    smem = smem / warps * rows;
    warps = (int)rows;
  }
  const bool vec = w % 4 == 0 && ((uintptr_t)v2 | (uintptr_t)d2 | (uintptr_t)out) % 16 == 0;
  const void* fn = vec ? (const void*)sag_edt_sweep_kernel<true>
                       : (const void*)sag_edt_sweep_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return sag_clear(e);
  }
  const K5Args a = {v2, d2, out, (int)rows, w, g.reff, g.kp, g.span};
  void* args[] = {(void*)&a};
  cudaLaunchKernel(fn, dim3((unsigned)((rows + warps - 1) / warps), 1, 1), dim3(32 * warps, 1, 1),
                   args, smem, (cudaStream_t)stream);
  return sag_status();
}

// Resources of the sweep kernel (vec: the 16-byte form) for rows of w
// pixels at radius: info[0] registers a thread, info[1] local (spilled)
// bytes a thread, info[2] dynamic shared bytes a CTA, info[3] resident
// CTAs a SM, info[4] warps (rows) a CTA.
extern "C" int sag_edt_sweep_info(int vec, int w, int radius, int* info) {
  if (radius < 0 || w < 1) return (int)cudaErrorInvalidValue;
  const K5Geom g = k5_geom(w, radius);
  size_t smem = 0;
  const int warps = k5_warps(g, &smem);
  if (warps == 0) return (int)cudaErrorInvalidValue;
  const void* fn = vec ? (const void*)sag_edt_sweep_kernel<true>
                       : (const void*)sag_edt_sweep_kernel<false>;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int fits = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fits, fn, 32 * warps, smem);
  if (e != cudaSuccess) return sag_clear(e);
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)smem;
  info[3] = fits;
  info[4] = warps;
  return 0;
}
