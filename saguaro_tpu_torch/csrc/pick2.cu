// K6: per-pixel two-level table pick (colocalization dense ranks).
//
// Replaces saguaro_tpu/kernels/segment_pallas.py::pick2_pallas (kernel
// _pick2_fn: hi-byte one-hot s8 MXU dot over byte planes of the tables,
// lo-byte masked reduction).
//
// out[k][b, i, c] = tables[b, c, hi[b, i, c], lo[b, i, c], k]: the output is
// set-major, (K, B, N, C), and the wrapper returns it as a (B, N, C, K)
// view, so that each object set's ranks are contiguous for their consumer
// (colocalization's pass E). Codes outside [0, 256) give 0.
//
// Bound on the H100: bytes. An item (a pixel's channel) reads 8 B of codes
// and writes 4K B of ranks (20 B in all at the main path's K = 3); the
// tables (3.9 MB a site, 31.5 MB a batch) stay in the 50 MB L2, and the
// rows the main path's intensities reach (a few thousand a channel) mostly
// in L1. The TPU needed the byte-plane split and the one-hot dot because
// its gathers are slow; the H100 gathers directly, so the design only
// keeps the code and rank streams moving (PERF.md gives the variants
// measured against it):
// - the launch plan (segment_cuda.pick2_plan) cuts each site into ranges
//   of 512 16-byte vectors of 4 items, two a thread, one range a CTA: many
//   short CTAs, as PyTorch's elementwise kernels run (one wave of
//   long-lived CTAs over longer ranges, as K3 runs, measured 20 % slower
//   here); a site's ragged head and tail (its offset is not always 16-byte
//   aligned) go to its first CTA, an item a thread;
// - a thread reads a vector of hi codes and one of lo codes with 16-byte
//   loads and loads its next vector's before it gathers the current one's;
// - the channel of an item comes from a 32-bit index advanced without a
//   division (the host refuses sites of 2^31 items or more);
// - all 4 KC table loads of a vector are issued before its stores, and the
//   stores are one float4 an object set, coalesced over the warp in the
//   set-major output;
// - the code loads and rank stores are streamed (ld/st.global.cs, evict
//   first), measured 3 % faster than plain ones. More than K6_MAX_KC sets
//   are picked in chunks, one launch each.
#include "common.cuh"

#define K6_THREADS 256
#define K6_MAX_KC 4  // object sets a launch

struct K6Args {
  const int* hi;
  const int* lo;
  const float* tables;  // (B, n_ch, 256, 256, k_tab)
  float* out;           // (k_tab, plane): set k's (B, n, n_ch) items at out + k * plane
  long long items;      // items a site, n * n_ch (< 2^31)
  long long plane;      // floats between two sets' planes (a multiple of 4)
  int n_ch, k_tab, k0;  // channels; sets a table row; this launch's first set
  int vecs;             // 16-byte vectors a CTA
};

// The KC ranks of one item of channel c: its table row is hi * 256 + lo.
template <int KC>
__device__ __forceinline__ void k6_pick(const float* tab, int k_tab, int c, int h, int l,
                                        float (&v)[KC]) {
  const bool ok = (unsigned)h < 256u && (unsigned)l < 256u;
  const float* row = tab + ((c << 16) | (ok ? (h << 8) | l : 0)) * k_tab;
#pragma unroll
  for (int k = 0; k < KC; ++k) v[k] = ok ? __ldg(row + k) : 0.0f;
}

// One vector: 4 items from channel c on (wrapping at n_ch); its ranks go out
// as one float4 a set at o (set k at o + k * plane).
template <int KC>
__device__ __forceinline__ void k6_vector(const float* tab, const K6Args& a, int c, int4 h,
                                          int4 l, float* o) {
  const int hh[4] = {h.x, h.y, h.z, h.w}, ll[4] = {l.x, l.y, l.z, l.w};
  float v[4][KC];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    k6_pick<KC>(tab, a.k_tab, c, hh[p], ll[p], v[p]);
    c = c + 1 == a.n_ch ? 0 : c + 1;
  }
#pragma unroll
  for (int k = 0; k < KC; ++k)
    __stcs(reinterpret_cast<float4*>(o + k * a.plane),
           make_float4(v[0][k], v[1][k], v[2][k], v[3][k]));
}

template <int KC>
__global__ void __launch_bounds__(K6_THREADS) sag_pick2_kernel(K6Args a) {
  // the site's items [g_lo, g_hi) of the flat (B * n * n_ch) stream: a
  // ragged head [g_lo, a_lo) and tail [a_hi, g_hi) of at most 3 items each
  // around the 16-byte vectors [a_lo / 4, a_hi / 4)
  const int b = blockIdx.y;
  const long long g_lo = (long long)b * a.items, g_hi = g_lo + a.items;
  const long long a_lo = min((g_lo + 3) & ~3LL, g_hi);
  const long long a_hi = max(g_hi & ~3LL, a_lo);
  const float* tab = a.tables + (size_t)b * a.n_ch * 65536 * a.k_tab + a.k0;
  float* out = a.out + a.k0 * a.plane;
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const long long g = threadIdx.x < 4 ? g_lo + threadIdx.x : a_hi + (threadIdx.x - 4);
    if (g < (threadIdx.x < 4 ? a_lo : g_hi)) {
      float v[KC];
      k6_pick<KC>(tab, a.k_tab, (int)((g - g_lo) % a.n_ch), a.hi[g], a.lo[g], v);
#pragma unroll
      for (int k = 0; k < KC; ++k) out[k * a.plane + g] = v[k];
    }
  }

  // this CTA's vectors [blockIdx.x * vecs, u1) of the site's, from a_lo: a
  // thread's are K6_THREADS apart
  const int nv = (int)((a_hi - a_lo) >> 2);
  const int u1 = min(nv, (int)(blockIdx.x + 1) * a.vecs);
  int u = (int)blockIdx.x * a.vecs + threadIdx.x;
  if (u >= u1) return;
  const int4* hv = reinterpret_cast<const int4*>(a.hi + a_lo);
  const int4* lv = reinterpret_cast<const int4*>(a.lo + a_lo);
  float* ov = out + a_lo;
  // the channel of vector u's first item, and its advance from one of the
  // thread's vectors to the next
  int c = (int)(((a_lo - g_lo) + 4LL * u) % a.n_ch);
  const int dc = (4 * K6_THREADS) % a.n_ch;
  int4 h = __ldcs(hv + u), l = __ldcs(lv + u);
  for (;;) {
    const int un = u + K6_THREADS;
    int4 hn, ln;
    if (un < u1) {
      hn = __ldcs(hv + un);
      ln = __ldcs(lv + un);
    }
    k6_vector<KC>(tab, a, c, h, l, ov + 4LL * u);
    if (un >= u1) break;
    c = c + dc >= a.n_ch ? c + dc - a.n_ch : c + dc;
    u = un;
    h = hn;
    l = ln;
  }
}

template <int KC>
static const void* k6_fn() {
  return (const void*)sag_pick2_kernel<KC>;
}

static const void* k6_kernel(int kc) {
  switch (kc) {
    case 1: return k6_fn<1>();
    case 2: return k6_fn<2>();
    case 3: return k6_fn<3>();
    case 4: return k6_fn<4>();
    default: return nullptr;
  }
}

// hi, lo (B, n, n_ch) int32 and out 16-byte aligned; tables (B, n_ch, 256,
// 256, k_tab) f32; out (k_tab, plane) f32, plane a multiple of 4 of at
// least B * n * n_ch. The plan: ctas CTAs a site, vecs 16-byte vectors each
// (segment_cuda.pick2_plan); the sets in chunks of at most K6_MAX_KC, one
// launch each.
extern "C" int sag_pick2(const int* hi, const int* lo, const float* tables, float* out, int batch,
                         long long n, int n_ch, int k_tab, long long plane, int ctas, int vecs,
                         void* stream) {
  if (batch < 1 || batch > 65535 || n < 0 || n_ch < 1 || k_tab < 1 || ctas < 1 || vecs < 0 ||
      n * n_ch >= (1LL << 31) || (long long)n_ch * 65536 * k_tab >= (1LL << 31) ||
      plane % 4 != 0 || plane < batch * n * n_ch)
    return (int)cudaErrorInvalidValue;
  K6Args a{hi, lo, tables, out, n * n_ch, plane, n_ch, k_tab, 0, vecs};
  for (int k0 = 0; k0 < k_tab; k0 += K6_MAX_KC) {
    a.k0 = k0;
    void* args[] = {(void*)&a};
    cudaLaunchKernel(k6_kernel(min(K6_MAX_KC, k_tab - k0)), dim3((unsigned)ctas, (unsigned)batch, 1),
                     dim3(K6_THREADS, 1, 1), args, 0, (cudaStream_t)stream);
    const int rc = sag_status();
    if (rc != 0) return rc;
  }
  return 0;
}

// Resources of the kc-set kernel: info[0] registers a thread, info[1] local
// (spilled) bytes a thread, info[2] resident CTAs a SM.
extern "C" int sag_pick2_info(int kc, int* info) {
  const void* fn = k6_kernel(kc);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  int fits = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fits, fn, K6_THREADS, 0);
  if (e != cudaSuccess) return sag_clear(e);
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = fits;
  return 0;
}
