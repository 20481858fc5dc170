// K3: per-label sums of real-valued lanes.
//
// Replaces saguaro_tpu/kernels/segment_pallas.py::seg_sums_pallas
// (kernel _sums_fn: bf16 hi/lo split of the values contracted against a
// VMEM label one-hot on the MXU).
//
// out[b, lab, c0 + k] = sum of vals[b, i, k] over pixels i with labels[b, i]
// == lab, for 0 <= lab < mc (other labels are dropped), k < KC.
//
// Bound on the H100: bytes. It is a pure stream of 4 + 4 KC bytes a pixel
// (one add per value), and the main path's Euler stream is almost all
// zeros. The design keeps the stream moving and pays for nothing else:
// - the launch plan (segment_cuda.sums_plan) gives each site a few
//   contiguous pixel ranges, one a CTA, so the whole batch is about one
//   wave of resident CTAs;
// - a thread reads 4 pixels at a time with 16-byte loads of labels and
//   values and keeps K3_UNROLL such vectors in flight (32 B of labels and
//   32 KC B of values: 2 measured faster than 4 or 8 at both main-path
//   shapes, PERF.md); the ragged head and tail of a site (its offset is
//   not always 16-byte aligned) are read one pixel at a time;
// - in registers, equal consecutive labels of a vector merge into one run
//   and zero contributions are dropped before any warp instruction: a warp
//   whose values are all 0 spends one ballot a vector and nothing else;
// - a vector's last non-zero run goes through a warp merge (a segmented
//   sum over neighbouring lanes of equal label) and one shared atomic a
//   segment; its other runs take one shared atomic each;
// - the (mc x KC) table lives in shared memory and is flushed once a CTA,
//   one global atomic per non-zero slot.
// Float atomics make the summation order, and so the last bits of a sum,
// vary between runs; sums of small integers (the Euler contributions) stay
// exact.
#include "common.cuh"

#define K3_THREADS 256
#define K3_UNROLL 2  // 16-byte label vectors a thread keeps in flight

template <int KC>
__device__ __forceinline__ void k3_add(float* tab, int lab, const float (&s)[KC]) {
#pragma unroll
  for (int k = 0; k < KC; ++k)
    if (s[k] != 0.0f) atomicAdd(tab + lab * KC + k, s[k]);
}

// One vector of 4 pixels: labels `lab`, values `v` (pixel p, lane k at
// v[p * KC + k]). Warp-collective: every lane of the warp calls it.
template <int KC>
__device__ __forceinline__ void k3_vector(const int (&lab)[4], const float (&v)[4 * KC],
                                          float* tab, int mc) {
  int rl = -1;  // the current run's label, -1 while there is none
  float rs[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) rs[k] = 0.0f;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    bool nz = false;
#pragma unroll
    for (int k = 0; k < KC; ++k) nz |= v[p * KC + k] != 0.0f;
    if (!nz || (unsigned)lab[p] >= (unsigned)mc) continue;
    if (lab[p] != rl) {
      if (rl >= 0) k3_add<KC>(tab, rl, rs);
      rl = lab[p];
#pragma unroll
      for (int k = 0; k < KC; ++k) rs[k] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < KC; ++k) rs[k] += v[p * KC + k];
  }
  if (__ballot_sync(SAG_FULL_MASK, rl >= 0) == 0u) return;
  // segmented sum of the lanes' last runs over neighbouring lanes of equal
  // label; the last lane of each segment adds the segment's total
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(SAG_FULL_MASK, rl, 1);
  const unsigned heads = __ballot_sync(SAG_FULL_MASK, lane == 0 || prev != rl);
  const int first = 31 - __clz(heads & (SAG_FULL_MASK >> (31 - lane)));
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const float o = __shfl_up_sync(SAG_FULL_MASK, rs[k], off);
      if (lane - off >= first) rs[k] += o;
    }
  }
  const bool last = lane == 31 || ((heads >> (lane + 1)) & 1u);
  if (last && rl >= 0) k3_add<KC>(tab, rl, rs);
}

template <int KC>
__global__ void __launch_bounds__(K3_THREADS)
sag_sums_kernel(const int* __restrict__ labels, const float* __restrict__ vals,
                float* __restrict__ out, long long n, int k_total, int c0, int mc,
                long long vecs_per_cta) {
  extern __shared__ float tab[];  // (mc, KC)
  for (int j = threadIdx.x; j < mc * KC; j += K3_THREADS) tab[j] = 0.0f;
  __syncthreads();

  // the site's pixels [g_lo, g_hi) of the flat (B * n) stream: a ragged
  // head [g_lo, a_lo) and tail [a_hi, g_hi) of at most 3 pixels each around
  // the 16-byte vectors [a_lo / 4, a_hi / 4)
  const int b = blockIdx.y;
  const long long g_lo = (long long)b * n, g_hi = g_lo + n;
  const long long a_lo = min((g_lo + 3) & ~3LL, g_hi);
  const long long a_hi = max(g_hi & ~3LL, a_lo);
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const long long g = threadIdx.x < 4 ? g_lo + threadIdx.x : a_hi + (threadIdx.x - 4);
    const int lab = (g < (threadIdx.x < 4 ? a_lo : g_hi)) ? labels[g] : -1;
    if ((unsigned)lab < (unsigned)mc) {
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const float v = vals[g * KC + k];
        if (v != 0.0f) atomicAdd(tab + lab * KC + k, v);
      }
    }
  }

  const int4* lab4 = reinterpret_cast<const int4*>(labels);
  const float4* val4 = reinterpret_cast<const float4*>(vals);
  const long long v0 = a_lo / 4 + (long long)blockIdx.x * vecs_per_cta;
  const long long v1 = min(a_hi / 4, v0 + vecs_per_cta);
  // the trip count is the same for every thread of the block: the warp
  // instructions in k3_vector see full warps
  for (long long base = v0; base < v1; base += (long long)K3_THREADS * K3_UNROLL) {
    int4 lv[K3_UNROLL];
    float4 vv[K3_UNROLL][KC];
#pragma unroll
    for (int u = 0; u < K3_UNROLL; ++u) {
      const long long v = base + u * K3_THREADS + threadIdx.x;
      if (v < v1) {
        lv[u] = __ldg(lab4 + v);
#pragma unroll
        for (int k = 0; k < KC; ++k) vv[u][k] = __ldg(val4 + v * KC + k);
      } else {
        lv[u] = make_int4(-1, -1, -1, -1);
#pragma unroll
        for (int k = 0; k < KC; ++k) vv[u][k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int u = 0; u < K3_UNROLL; ++u) {
      const int lab[4] = {lv[u].x, lv[u].y, lv[u].z, lv[u].w};
      float v[4 * KC];
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        v[4 * k] = vv[u][k].x;
        v[4 * k + 1] = vv[u][k].y;
        v[4 * k + 2] = vv[u][k].z;
        v[4 * k + 3] = vv[u][k].w;
      }
      k3_vector<KC>(lab, v, tab, mc);
    }
  }
  __syncthreads();
  float* out_site = out + (size_t)b * mc * k_total + c0;
  for (int j = threadIdx.x; j < mc * KC; j += K3_THREADS) {
    const float s = tab[j];
    if (s != 0.0f) atomicAdd(out_site + (size_t)(j / KC) * k_total + j % KC, s);
  }
}

template <int KC>
static const void* k3_fn() {
  return (const void*)sag_sums_kernel<KC>;
}

static const void* k3_kernel(int kc) {
  switch (kc) {
    case 1: return k3_fn<1>();
    case 2: return k3_fn<2>();
    case 3: return k3_fn<3>();
    case 4: return k3_fn<4>();
    default: return nullptr;
  }
}

// labels (B, n) int32 and vals (B, n, kc) f32, both 16-byte aligned; out
// (B, mc, k_total) f32 zero-filled, of which this launch adds columns
// [c0, c0 + kc). The plan: ctas CTAs a site, vecs_per_cta 16-byte label
// vectors each (segment_cuda.sums_plan).
extern "C" int sag_sums(const int* labels, const float* vals, float* out, int batch, long long n,
                        int kc, int k_total, int c0, int mc, int ctas, long long vecs_per_cta,
                        void* stream) {
  const void* fn = k3_kernel(kc);
  if (fn == nullptr || batch < 1 || batch > 65535 || ctas < 1 || mc < 1 || n < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)mc * kc * sizeof(float);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return sag_clear(e);
  }
  void* args[] = {(void*)&labels, (void*)&vals, (void*)&out, (void*)&n, (void*)&k_total,
                  (void*)&c0, (void*)&mc, (void*)&vecs_per_cta};
  cudaLaunchKernel(fn, dim3((unsigned)ctas, (unsigned)batch, 1), dim3(K3_THREADS, 1, 1), args,
                       smem, (cudaStream_t)stream);
  return sag_status();
}

// Resources of the kc-lane kernel with an (mc x kc) table: info[0]
// registers a thread, info[1] local (spilled) bytes a thread, info[2]
// dynamic shared bytes, info[3] resident CTAs a SM.
extern "C" int sag_sums_info(int kc, int mc, int* info) {
  const void* fn = k3_kernel(kc);
  if (fn == nullptr || mc < 1) return (int)cudaErrorInvalidValue;
  const int smem = mc * kc * (int)sizeof(float);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int fits = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fits, fn, K3_THREADS, smem);
  if (e != cudaSuccess) return sag_clear(e);
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = smem;
  info[3] = fits;
  return 0;
}
