// Banded-traceback staging shift and banded affine-gap fill, for sm_90a.
//
// shift_sub replaces hashreadmapper_tpu/ops/bandtb.py::_shift_sub_pallas
// (_shift_kernel): o[t, p] = x[t + (sh[p] & mask), p] where that row is
// below L, else code 4.  mask = 2^B - 1 with B the log2 steps the Pallas
// barrel shift takes (it drops shift bits at or above its L + size rows);
// the wrapper computes it.  Bound by memory (one read, one write per
// element, a few microseconds per batch); one thread per output element.
//
// fill_pass replaces bandtb.py::_fill_pallas (_fill_kernel): one banded
// DP pass of bandtb._row_core per pair, rows i < m over ref lanes j < NL,
// band [max(0, i-bw), min(r-1, i+bw)]:
//   e      = max(h_up - GO, e_up - GE)              (row above, in band)
//   a      = max(max(e, 0), h_diag + score)
//   f      = max(cummax_j(max(a[j-1], 0) - GO + j) - j, beg - 1 - j)
//   h      = max(a, max(f, 0)),  best = max over in-band cells of h
// and, when emitting, the direction dh with the oracle's tie rules and
// the full run length the walk takes from the cell (M chain D2, vertical
// I chain J, in-row D chain K from a second cummax), packed as int16
// dh | min(run, 4095) << 3 into dirs[p, i, j].  Rows m..m_max-1 of an
// emitting pass are written 0; a pair with done set writes best 0 and no
// directions (the walk never reads it).
//
// What bounds it: the row loop's latency (m rows, two max-plus scans per
// row, up to 9 passes per traceback); in the emitting pass also the
// int16 direction writes (m_max * NL * 2 bytes per pair).  Design: one
// warp per pair, K = ceil(NL / 32) consecutive ref lanes per thread.  The
// row-above values (h, e, D2, J) stay in registers, every j-1 neighbour
// is the thread's own previous lane or one __shfl_up_sync, and both scans
// are a K-step serial prefix plus a 5-step warp shuffle scan: no shared
// memory and no block barrier.  A done pair's warp returns at once, so
// the per-pair early exit replaces the Pallas kernel's all-done-block
// skip (and the band-width sort that fed it).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGapOpen = 3;
constexpr int kGapExtend = 1;
constexpr int kMatch = 2;
constexpr int kMismatch = 2;
constexpr int kBig = 0x3FFFFFFF;
constexpr int kPoison = -4096;
constexpr int kRunMax = (1 << 12) - 1;
constexpr unsigned kFull = 0xffffffffu;

__global__ void shift_sub_kernel(const int32_t* __restrict__ x,
                                 const int32_t* __restrict__ sh,
                                 int32_t* __restrict__ out, int l, int p,
                                 int size, int mask) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (idx >= static_cast<long long>(size) * p) return;
  const int pi = static_cast<int>(idx % p);
  const int t = static_cast<int>(idx / p);
  const int src = t + (sh[pi] & mask);
  out[idx] = src < l ? x[static_cast<size_t>(src) * p + pi] : 4;
}

// value of lane j-1 for the K lanes j = lane*K + q of this thread: the
// previous lane of the thread, or the last lane of thread lane-1 (fill
// for lane 0)
template <int K>
__device__ __forceinline__ void left_of(const int (&v)[K], int (&out)[K],
                                        int lane, int fill) {
  const int carry = __shfl_up_sync(kFull, v[K - 1], 1);
  out[0] = lane == 0 ? fill : carry;
#pragma unroll
  for (int q = 1; q < K; ++q) out[q] = v[q - 1];
}

// inclusive max-scan over the warp's 32*K lanes, in place
template <int K>
__device__ __forceinline__ void cummax(int (&v)[K], int lane) {
#pragma unroll
  for (int q = 1; q < K; ++q) v[q] = max(v[q], v[q - 1]);
  int x = v[K - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x = max(x, o);
  }
  int excl = __shfl_up_sync(kFull, x, 1);
  if (lane == 0) excl = -kBig;
#pragma unroll
  for (int q = 0; q < K; ++q) v[q] = max(v[q], excl);
}

template <int K, bool kEmit>
__global__ void fill_kernel(const int32_t* __restrict__ read_t,
                            const int32_t* __restrict__ ref_t,
                            const int32_t* __restrict__ m_a,
                            const int32_t* __restrict__ r_a,
                            const int32_t* __restrict__ bw_a,
                            const int32_t* __restrict__ done_a,
                            int32_t* __restrict__ best_out,
                            int16_t* __restrict__ dirs, int p_total,
                            int m_max, int nl) {
  const int p = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (p >= p_total) return;                 // whole warps only
  if (done_a[p]) {
    if (lane == 0) best_out[p] = 0;
    return;
  }
  const size_t P = static_cast<size_t>(p_total);
  const int m = min(m_a[p], m_max);
  const int r = r_a[p];
  const int bw = bw_a[p];

  int ref[K], h[K], e[K], d2[K], jj[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int j = lane * K + q;
    ref[q] = j < nl ? ref_t[static_cast<size_t>(j) * P + p] : 4;
    h[q] = 0;
    e[q] = 0;
    d2[q] = 0;
    jj[q] = 0;
  }
  int best = 0;
  int16_t* row_out = dirs + static_cast<size_t>(p) * m_max * nl;

  for (int i = 0; i < m; ++i) {
    const int rd = read_t[static_cast<size_t>(i) * P + p];
    const int beg = max(0, i - bw);
    const int end_j = min(r - 1, i + bw);
    int hd[K], d2_diag[K];
    left_of<K>(h, hd, lane, 0);
    if (kEmit) left_of<K>(d2, d2_diag, lane, 0);

    int t1e[K], t2e[K], e_cur[K], e1[K], t2[K], a[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int j = lane * K + q;
      const bool in_up = j <= i - 1 + bw;
      t1e[q] = (in_up ? h[q] : 0) - kGapOpen;
      t2e[q] = (in_up ? e[q] : 0) - kGapExtend;
      e_cur[q] = max(t1e[q], t2e[q]);
      e1[q] = max(e_cur[q], 0);
      const int s = (ref[q] == rd && ref[q] < 4) ? kMatch : -kMismatch;
      t2[q] = (j == beg ? 0 : hd[q]) + s;
      a[q] = max(e1[q], t2[q]);
    }
    int am1[K], run[K];
    left_of<K>(a, am1, lane, 0);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int j = lane * K + q;
      const bool inb = j >= beg && j <= end_j;
      run[q] = inb ? max(j == beg ? 0 : am1[q], 0) - kGapOpen + j : -kBig;
    }
    cummax<K>(run, lane);
    int f[K], f1[K], hh[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int j = lane * K + q;
      f[q] = max(run[q] - j, beg - 1 - j);
      f1[q] = max(f[q], 0);
      hh[q] = max(a[q], f1[q]);
    }

    if (!kEmit) {
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int j = lane * K + q;
        const bool ok = j >= beg && j <= end_j;
        h[q] = ok ? hh[q] : 0;
        e[q] = ok ? e_cur[q] : 0;
        if (ok && j < nl) best = max(best, hh[q]);
      }
      continue;
    }

    int hm1[K], fm1[K];
    left_of<K>(hh, hm1, lane, 0);
    left_of<K>(f, fm1, lane, 0);
    int dh[K], d2n[K], jjn[K], z[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int j = lane * K + q;
      const bool inb = j >= beg && j <= end_j;
      const bool at_beg = j == beg;
      const int de = t1e[q] > t2e[q] ? 1 : 0;
      const int h_l = at_beg ? 0 : hm1[q];
      const int f_l = at_beg ? 0 : fm1[q];
      const int df = h_l - kGapOpen > f_l - kGapExtend ? 1 : 0;
      const int t1h = max(e1[q], f1[q]);
      dh[q] = t1h <= t2[q] ? 1 : (e1[q] > f1[q] ? 2 + de : 4 + df);
      const int dg = at_beg ? 0 : d2_diag[q];
      d2n[q] = dh[q] == 1 ? 1 + max(dg, 0) : 0;
      jjn[q] = inb ? (de == 0 ? 1 + jj[q] : 1) : kPoison;
      int w = df == 1 ? 2 * j : -kBig;
      if (at_beg && df == 0) w = beg > 0 ? 2 * j - 1 : 0;
      z[q] = inb ? w : -kBig;
    }
    cummax<K>(z, lane);
    int kk[K], km1[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int j = lane * K + q;
      kk[q] = (z[q] & 1) ? kPoison : j - (z[q] >> 1) + 1;
    }
    left_of<K>(kk, km1, lane, kPoison);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int j = lane * K + q;
      const bool ok = j >= beg && j <= end_j;
      const int k_l = j == beg ? kPoison : km1[q];
      int rl = dh[q] == 1 ? d2n[q]
             : dh[q] == 2 ? 1 + jj[q]
             : dh[q] == 4 ? 1 + k_l : 1;
      rl = min(max(rl, 0), kRunMax);
      const int packed = (ok && rl > 0) ? (dh[q] | (rl << 3)) : 0;
      if (j < nl) row_out[static_cast<size_t>(i) * nl + j] =
          static_cast<int16_t>(packed);
      h[q] = ok ? hh[q] : 0;
      e[q] = ok ? e_cur[q] : 0;
      d2[q] = ok ? d2n[q] : 0;
      jj[q] = ok ? jjn[q] : kPoison;
      if (ok && j < nl) best = max(best, hh[q]);
    }
  }
  if (kEmit) {
    for (int i = max(m, 0); i < m_max; ++i)
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int j = lane * K + q;
        if (j < nl) row_out[static_cast<size_t>(i) * nl + j] = 0;
      }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    best = max(best, __shfl_xor_sync(kFull, best, d));
  if (lane == 0) best_out[p] = best;
}

template <int K>
void launch_fill(const int32_t* read_t, const int32_t* ref_t,
                 const int32_t* m, const int32_t* r, const int32_t* bw,
                 const int32_t* done, int32_t* best, int16_t* dirs, int p,
                 int m_max, int nl, int emit, cudaStream_t stream) {
  const int threads = 128;                 // 4 pairs per block
  const int blocks = (p + threads / 32 - 1) / (threads / 32);
  if (emit)
    fill_kernel<K, true><<<blocks, threads, 0, stream>>>(
        read_t, ref_t, m, r, bw, done, best, dirs, p, m_max, nl);
  else
    fill_kernel<K, false><<<blocks, threads, 0, stream>>>(
        read_t, ref_t, m, r, bw, done, best, dirs, p, m_max, nl);
}

}  // namespace

// x [l, p] int32, sh [p] int32 -> out [size, p] int32
extern "C" int hrm_shift_sub(const void* x, const void* sh, void* out, int l,
                             int p, int size, int mask, void* stream) {
  const long long total = static_cast<long long>(size) * p;
  if (total > 0) {
    const int threads = 256;
    shift_sub_kernel<<<static_cast<int>((total + threads - 1) / threads),
                       threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(x), static_cast<const int32_t*>(sh),
        static_cast<int32_t*>(out), l, p, size, mask);
  }
  return static_cast<int>(cudaGetLastError());
}

// read_t [m_max, p], ref_t [nl, p] int32; m, r, bw, done [p] int32 ->
// best [p] int32; dirs [p, m_max, nl] int16 when emit != 0
extern "C" int hrm_fill_pass(const void* read_t, const void* ref_t,
                             const void* m, const void* r, const void* bw,
                             const void* done, void* best, void* dirs, int p,
                             int m_max, int nl, int emit, void* stream) {
  if (nl < 1 || nl > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (p > 0) {
    const auto* rt = static_cast<const int32_t*>(read_t);
    const auto* ft = static_cast<const int32_t*>(ref_t);
    const auto* mm = static_cast<const int32_t*>(m);
    const auto* rr = static_cast<const int32_t*>(r);
    const auto* bb = static_cast<const int32_t*>(bw);
    const auto* dd = static_cast<const int32_t*>(done);
    auto* bo = static_cast<int32_t*>(best);
    auto* dr = static_cast<int16_t*>(dirs);
    auto st = static_cast<cudaStream_t>(stream);
    if (nl <= 32) launch_fill<1>(rt, ft, mm, rr, bb, dd, bo, dr, p, m_max, nl, emit, st);
    else if (nl <= 64) launch_fill<2>(rt, ft, mm, rr, bb, dd, bo, dr, p, m_max, nl, emit, st);
    else if (nl <= 128) launch_fill<4>(rt, ft, mm, rr, bb, dd, bo, dr, p, m_max, nl, emit, st);
    else launch_fill<8>(rt, ft, mm, rr, bb, dd, bo, dr, p, m_max, nl, emit, st);
  }
  return static_cast<int>(cudaGetLastError());
}
