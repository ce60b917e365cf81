// Banded traceback for sm_90a: the staging shift, the banded affine-gap
// fill, and the whole traceback (band doubling, fill, run-length walk) in
// one launch.
//
// shift_sub replaces hashreadmapper_tpu/ops/bandtb.py::_shift_sub_pallas
// (_shift_kernel): o[t, p] = x[t + (sh[p] & mask), p] where that row is
// below L, else code 4.  mask = 2^B - 1 with B the log2 steps the Pallas
// barrel shift takes (it drops shift bits at or above its L + size rows);
// the wrapper computes it.  Bound by memory: one read and one write per
// element, microseconds a batch, so what counts is that every byte moves
// once and in whole sectors.  A block owns a tile of 32 adjacent pairs
// and all L rows: it loads the tile with 16-byte loads (int8 or int32
// codes as they come) into shared memory as int32, then every thread
// copies tile[t + sh][pair] with its pair's shift in a register.  In the
// [size, P] int32 layout a warp's 32 lanes are 32 adjacent pairs (banks =
// pair, stores of 128 contiguous bytes); in the pair-major [P, size]
// uint8 layout, the one the traceback kernel reads, the lanes are 32
// consecutive rows of one pair and the tile's rows are 33 words apart
// (banks = row + pair).  No division per element.
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
// directions.  One warp per pair, K = ceil(NL / 32) consecutive ref
// lanes per thread, the row above in registers, neighbours by shuffle.
// It is the single-pass counterpart of the TPU kernel; the main path
// runs the traceback kernel below, which shares its row (band_row).
//
// traceback replaces the same _fill_pallas together with the two scans
// around it in bandtb._tb_core_t (the band-doubling scan and the
// run-length walk): per pair, passes at band width bw = |r - m| + 1,
// doubled until best >= score1 or 2 * bw > max(m, r); the directions of
// the final width; the walk over them into at most n_entries entries
// op | len << 2, status 0 / 1 (failed) / 2 (entry budget exceeded).
// What bounds it: the latency of the row loop (a row is two 5-step
// shuffle scans and a dozen more shuffles, rows depend on each other),
// not bytes (a pair reads 2 * 128 code bytes and writes under 150) and
// not operations.  The design therefore cuts rows x passes x lanes and
// keeps everything on the chip:
//   - a warp owns a pair from its first pass to its last entry, and pulls
//     the next pair from an atomic counter, so a pair that needs nine
//     passes holds up nobody and a pair that needs none costs one pull;
//   - the pair's codes are loaded once into shared memory;
//   - lanes are band-relative cells c = j - (i - bw) while the band's
//     2 * bw + 1 cells fit fewer lanes than NL: one cell a lane up to
//     bw = 15, two up to 31, four up to 63; then the diagonal neighbour
//     is the thread's own value of the row above and the upper one the
//     next cell's.  Wider bands use absolute lanes as fill_pass does;
//   - every pass emits (directions depend on bw only), so the pass that
//     ends the doubling is not run a second time to emit;
//   - directions go band-relative ([rows, 2 * bw + 1] int16) into the
//     warp's share of shared memory and the walk reads them there; a pair
//     whose final band does not fit uses the warp's row of a scratch
//     buffer in device memory instead (counted in counters[1]).  The
//     [P, m_max, NL] array of fill_pass is never allocated.
//   - the walk runs in the same warp, every lane in step; a step's entry
//     is kept by lane step % 32 and a group of 32 entries is one store.

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

constexpr int kTilePairs = 32;       // pairs a shift_sub block owns
constexpr int kShiftThreads = 256;
constexpr int kTbThreads = 128;      // 4 warps, a pair each, per block

// element q (pair c + q of the tile row) of one 16-byte load
template <typename T>
__device__ __forceinline__ int32_t vec_elem(const int4& w, int q) {
  const int words[4] = {w.x, w.y, w.z, w.w};
  if (sizeof(T) == 4) return words[q];
  return static_cast<int8_t>(words[q >> 2] >> (8 * (q & 3)));
}

// x [l, p] of T (int8 or int32), tile of kTilePairs pairs per block.
// vec: p is a multiple of the pairs a 16-byte load holds and x is
// 16-byte aligned.
template <typename T, bool kPairMajor>
__global__ void __launch_bounds__(kShiftThreads)
shift_sub_kernel(const T* __restrict__ x, const int32_t* __restrict__ sh,
                 void* __restrict__ out_v, int l, int p, int size, int mask,
                 int vec) {
  extern __shared__ int32_t tile[];            // [l][kStride]
  constexpr int kStride = kPairMajor ? kTilePairs + 1 : kTilePairs;
  const int p0 = blockIdx.x * kTilePairs;
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
    constexpr int kVecRow = kTilePairs / kPer;
    for (int v = tid; v < l * kVecRow; v += kShiftThreads) {
      const int t = v / kVecRow;
      const int c = (v % kVecRow) * kPer;
      if (p0 + c < p) {
        const int4 w = *reinterpret_cast<const int4*>(
            x + static_cast<size_t>(t) * p + p0 + c);
#pragma unroll
        for (int q = 0; q < kPer; ++q)
          tile[t * kStride + c + q] = vec_elem<T>(w, q);
      }
    }
  } else {
    for (int idx = tid; idx < l * kTilePairs; idx += kShiftThreads) {
      const int t = idx / kTilePairs;
      const int c = idx % kTilePairs;
      if (p0 + c < p)
        tile[t * kStride + c] = x[static_cast<size_t>(t) * p + p0 + c];
    }
  }
  __syncthreads();
  const int lane = tid % 32;
  const int warp = tid / 32;
  constexpr int kWarps = kShiftThreads / 32;
  if (!kPairMajor) {
    // lanes = 32 adjacent pairs, warps stride the rows
    const int pi = p0 + lane;
    if (pi >= p) return;
    const int s = sh[pi] & mask;
    int32_t* out = static_cast<int32_t*>(out_v);
    for (int t = warp; t < size; t += kWarps) {
      const int src = t + s;
      out[static_cast<size_t>(t) * p + pi] =
          src < l ? tile[src * kStride + lane] : 4;
    }
  } else {
    // lanes = 32 consecutive rows of one pair, warps stride the pairs
    uint8_t* out = static_cast<uint8_t*>(out_v);
    for (int c = warp; c < kTilePairs && p0 + c < p; c += kWarps) {
      const int s = sh[p0 + c] & mask;
      uint8_t* row = out + static_cast<size_t>(p0 + c) * size;
      for (int t = lane; t < size; t += 32) {
        const int src = t + s;
        row[t] = static_cast<uint8_t>(src < l ? tile[src * kStride + c] : 4);
      }
    }
  }
}

// out[q] = value of cell - 1 for the K cells lane*K + q of this thread:
// the thread's previous cell, or the last cell of thread lane-1 (fill
// for lane 0)
template <int K>
__device__ __forceinline__ void left_of(const int (&v)[K], int (&out)[K],
                                        int lane, int fill) {
  const int carry = __shfl_up_sync(kFull, v[K - 1], 1);
  out[0] = lane == 0 ? fill : carry;
#pragma unroll
  for (int q = 1; q < K; ++q) out[q] = v[q - 1];
}

// out[q] = value of cell + 1 (fill past the last cell of lane 31)
template <int K>
__device__ __forceinline__ void right_of(const int (&v)[K], int (&out)[K],
                                         int lane, int fill) {
  const int carry = __shfl_down_sync(kFull, v[0], 1);
#pragma unroll
  for (int q = 0; q + 1 < K; ++q) out[q] = v[q + 1];
  out[K - 1] = lane == 31 ? fill : carry;
}

// inclusive max-scan over the warp's 32*K cells, in place
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

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = max(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

// Row i of bandtb._row_core over the warp's 32*K cells.  Cell lane*K + q
// is ref position j = o + lane*K + q with code ref[q].  kRel: o = i - bw
// (band-relative cells; the row above had o - 1, so its cell of the same
// index is the diagonal neighbour and the next cell the upper one); else
// o = 0 for every row (the same cell is the upper neighbour, the cell
// before it the diagonal one).  h, e, d2, jj carry the row above in and
// this row out: 0 outside the band, jj kPoison there.  kEmit: packed[q] =
// dh | run << 3, 0 outside the band.
template <int K, bool kRel, bool kEmit>
__device__ __forceinline__ void band_row(int i, int o, int rd,
                                         const int (&ref)[K], int r, int bw,
                                         int nl, int lane, int (&h)[K],
                                         int (&e)[K], int (&d2)[K],
                                         int (&jj)[K], int& best,
                                         int (&packed)[K]) {
  const int beg = max(0, i - bw);
  const int end_j = min(min(r, nl) - 1, i + bw);
  int h_up[K], e_up[K], j_up[K], hd[K], d2_diag[K];
  if (kRel) {
    right_of<K>(h, h_up, lane, 0);
    right_of<K>(e, e_up, lane, 0);
    if (kEmit) right_of<K>(jj, j_up, lane, kPoison);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      hd[q] = h[q];
      d2_diag[q] = d2[q];
    }
  } else {
    left_of<K>(h, hd, lane, 0);
    if (kEmit) left_of<K>(d2, d2_diag, lane, 0);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      h_up[q] = h[q];
      e_up[q] = e[q];
      j_up[q] = jj[q];
    }
  }

  int t1e[K], t2e[K], e_cur[K], e1[K], t2[K], a[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int j = o + lane * K + q;
    const bool in_up = j <= i - 1 + bw;
    t1e[q] = (in_up ? h_up[q] : 0) - kGapOpen;
    t2e[q] = (in_up ? e_up[q] : 0) - kGapExtend;
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
    const int j = o + lane * K + q;
    const bool inb = j >= beg && j <= end_j;
    run[q] = inb ? max(j == beg ? 0 : am1[q], 0) - kGapOpen + j : -kBig;
  }
  cummax<K>(run, lane);
  int f[K], f1[K], hh[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int j = o + lane * K + q;
    f[q] = max(run[q] - j, beg - 1 - j);
    f1[q] = max(f[q], 0);
    hh[q] = max(a[q], f1[q]);
  }

  if (!kEmit) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int j = o + lane * K + q;
      const bool ok = j >= beg && j <= end_j;
      h[q] = ok ? hh[q] : 0;
      e[q] = ok ? e_cur[q] : 0;
      if (ok) best = max(best, hh[q]);
    }
    return;
  }

  int hm1[K], fm1[K];
  left_of<K>(hh, hm1, lane, 0);
  left_of<K>(f, fm1, lane, 0);
  int dh[K], d2n[K], jjn[K], z[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int j = o + lane * K + q;
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
    jjn[q] = inb ? (de == 0 ? 1 + j_up[q] : 1) : kPoison;
    int w = df == 1 ? 2 * j : -kBig;
    if (at_beg && df == 0) w = beg > 0 ? 2 * j - 1 : 0;
    z[q] = inb ? w : -kBig;
  }
  cummax<K>(z, lane);
  int kk[K], km1[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int j = o + lane * K + q;
    kk[q] = (z[q] & 1) ? kPoison : j - (z[q] >> 1) + 1;
  }
  left_of<K>(kk, km1, lane, kPoison);
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int j = o + lane * K + q;
    const bool ok = j >= beg && j <= end_j;
    const int k_l = j == beg ? kPoison : km1[q];
    int rl = dh[q] == 1 ? d2n[q]
           : dh[q] == 2 ? 1 + j_up[q]
           : dh[q] == 4 ? 1 + k_l : 1;
    rl = min(max(rl, 0), kRunMax);
    packed[q] = (ok && rl > 0) ? (dh[q] | (rl << 3)) : 0;
    h[q] = ok ? hh[q] : 0;
    e[q] = ok ? e_cur[q] : 0;
    d2[q] = ok ? d2n[q] : 0;
    jj[q] = ok ? jjn[q] : kPoison;
    if (ok) best = max(best, hh[q]);
  }
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

  int ref[K], h[K], e[K], d2[K], jj[K], packed[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int j = lane * K + q;
    ref[q] = j < nl ? ref_t[static_cast<size_t>(j) * P + p] : 4;
    h[q] = 0;
    e[q] = 0;
    d2[q] = 0;
    jj[q] = 0;
    packed[q] = 0;
  }
  int best = 0;
  int16_t* row_out = dirs + static_cast<size_t>(p) * m_max * nl;

  for (int i = 0; i < m; ++i) {
    const int rd = read_t[static_cast<size_t>(i) * P + p];
    band_row<K, false, kEmit>(i, 0, rd, ref, r, bw, nl, lane, h, e, d2, jj,
                              best, packed);
    if (kEmit) {
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int j = lane * K + q;
        if (j < nl) row_out[static_cast<size_t>(i) * nl + j] =
            static_cast<int16_t>(packed[q]);
      }
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
  best = warp_max(best);
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

// One emitting pass of a pair at band width bw: rows i < rows, the codes
// from shared memory, directions to dirs[i * wd + cell] for cell < wd
// (kRel: wd = 2 * bw + 1 band-relative cells; else wd = nl).  Returns the
// pass's best score.
template <int K, bool kRel>
__device__ int emit_pass(const uint8_t* rd_s, const uint8_t* rf_s, int rows,
                         int r, int bw, int nl, int lane, int16_t* dirs,
                         int wd) {
  int ref[K], h[K], e[K], d2[K], jj[K], packed[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int j = lane * K + q;
    ref[q] = (!kRel && j < nl) ? rf_s[j] : 4;
    h[q] = 0;
    e[q] = 0;
    d2[q] = 0;
    jj[q] = 0;
    packed[q] = 0;
  }
  int best = 0;
  for (int i = 0; i < rows; ++i) {
    const int o = kRel ? i - bw : 0;
    if (kRel) {
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int j = o + lane * K + q;
        ref[q] = (j >= 0 && j < nl) ? rf_s[j] : 4;
      }
    }
    band_row<K, kRel, true>(i, o, rd_s[i], ref, r, bw, nl, lane, h, e, d2,
                            jj, best, packed);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int c = lane * K + q;
      if (c < wd) dirs[i * wd + c] = static_cast<int16_t>(packed[q]);
    }
  }
  return warp_max(best);
}

__device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

// KA = ceil(nl / 32) rounded up to a power of two: the cells a thread
// holds in absolute lanes.
template <int KA>
__global__ void __launch_bounds__(kTbThreads)
traceback_kernel(const uint8_t* __restrict__ read_s,
                 const uint8_t* __restrict__ ref_s,
                 const int32_t* __restrict__ m_a,
                 const int32_t* __restrict__ r_a,
                 const int32_t* __restrict__ score_a,
                 const uint8_t* __restrict__ need_a, void* entries_v,
                 int8_t* __restrict__ status_out,
                 int32_t* __restrict__ bw_out, int16_t* scratch,
                 int32_t* counters, int p_total, int m_max, int nl,
                 int n_entries, int run_cap, int entry_bytes, int n_passes,
                 int smem_cells) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  const int code_bytes = round16(m_max) + round16(nl);
  unsigned char* mine = smem + static_cast<size_t>(warp) *
                                   (code_bytes + 2 * smem_cells);
  uint8_t* rd_s = mine;
  uint8_t* rf_s = mine + round16(m_max);
  int16_t* dirs_s = reinterpret_cast<int16_t*>(mine + code_bytes);
  int16_t* dirs_g = scratch + static_cast<size_t>(blockIdx.x * warps + warp) *
                                  m_max * nl;

  // lane 0 holds the pull in flight; its latency hides behind a pair
  int pulled = lane == 0 ? atomicAdd(&counters[0], 1) : 0;
  for (;;) {
    const int p = __shfl_sync(kFull, pulled, 0);
    if (p >= p_total) break;
    if (lane == 0) pulled = atomicAdd(&counters[0], 1);

    const int m = m_a[p];
    const int r = r_a[p];
    int bw = abs(r - m) + 1;
    const bool wanted = need_a == nullptr || need_a[p] != 0;
    const int rows = max(min(m, m_max), 0);
    const int16_t* dirs = dirs_s;
    int wd = nl;
    bool rel = false;
    if (wanted) {
      const uint8_t* rd_g = read_s + static_cast<size_t>(p) * m_max;
      const uint8_t* rf_g = ref_s + static_cast<size_t>(p) * nl;
      for (int t = lane; t < m_max; t += 32) rd_s[t] = rd_g[t];
      for (int t = lane; t < nl; t += 32) rf_s[t] = rf_g[t];
      __syncwarp();
      const int score1 = score_a[p];
      const int max_len = max(m, r);
      bool spilled = false;
      for (int pass = 0;; ++pass) {
        const int w = 2 * bw + 1;
        const int k_rel = w <= 32 ? 1 : w <= 64 ? 2 : w <= 128 ? 4 : 8;
        rel = k_rel < KA;
        wd = rel ? w : nl;
        spilled = rows * wd > smem_cells;
        int16_t* out = spilled ? dirs_g : dirs_s;
        int best;
        if (KA > 1 && rel && k_rel == 1)
          best = emit_pass<1, true>(rd_s, rf_s, rows, r, bw, nl, lane, out,
                                    wd);
        else if (KA > 2 && rel && k_rel == 2)
          best = emit_pass<2, true>(rd_s, rf_s, rows, r, bw, nl, lane, out,
                                    wd);
        else if (KA > 4 && rel)
          best = emit_pass<4, true>(rd_s, rf_s, rows, r, bw, nl, lane, out,
                                    wd);
        else
          best = emit_pass<KA, false>(rd_s, rf_s, rows, r, bw, nl, lane, out,
                                      wd);
        dirs = out;
        // a pair still short after n_passes passes takes the doubled
        // width's directions, as the fixed-length scan does
        if (pass == n_passes) break;
        if (best >= score1 || 2 * bw > max_len) break;
        bw *= 2;
      }
      if (spilled && lane == 0) atomicAdd(&counters[1], 1);
      __syncwarp();
    }

    // the run-length walk, every lane in step
    int i = m - 1;
    int j = r - 1;
    bool failed = false;
    bool ndone = !wanted || !(i >= 0 && j > 0);
    for (int base = 0; base < n_entries; base += 32) {
      const int lim = min(32, n_entries - base);
      int kept = 0;
      for (int s = 0; s < lim && !ndone; ++s) {
        const int ic = min(max(i, 0), m_max - 1);
        const int jc = min(max(j, 0), nl - 1);
        const int c = rel ? jc - (ic - bw) : jc;
        int g = 0;
        if (ic < rows && c >= 0 && c < wd) g = dirs[ic * wd + c];
        const int dh = g & 7;
        const int rl = g >> 3;
        int ent = 0;
        if (dh == 0 || dh > 5) {
          failed = true;
        } else {
          // the oracle's loop condition (i >= 0 && j > 0) before every
          // step caps how much of the run is consumed
          const int op = dh == 1 ? 1 : dh <= 3 ? 2 : 3;
          const int cap = dh == 1 ? min(i + 1, j) : dh <= 3 ? i + 1 : j;
          int ln = min(rl, cap);
          if (run_cap > 0) ln = min(ln, run_cap);
          if (op != 3) i -= ln;
          if (op != 2) j -= ln;
          ent = op | (ln << 2);
        }
        ndone = failed || !(i >= 0 && j > 0);
        if (s == lane) kept = ent;
      }
      if (lane < lim) {
        const size_t at = static_cast<size_t>(p) * n_entries + base + lane;
        if (entry_bytes == 1)
          static_cast<uint8_t*>(entries_v)[at] = static_cast<uint8_t>(kept);
        else
          static_cast<int16_t*>(entries_v)[at] = static_cast<int16_t>(kept);
      }
    }
    if (lane == 0) {
      // ndone is set by a failure too: failed wins, as in the plain walk
      status_out[p] = failed ? 1 : (!ndone ? 2 : 0);
      bw_out[p] = bw;
    }
    __syncwarp();
  }
}

template <int KA>
cudaError_t launch_traceback(const uint8_t* read_s, const uint8_t* ref_s,
                             const int32_t* m, const int32_t* r,
                             const int32_t* score1, const uint8_t* need,
                             void* entries, int8_t* status, int32_t* bw,
                             int16_t* scratch, int32_t* counters, int p,
                             int m_max, int nl, int n_entries, int run_cap,
                             int entry_bytes, int n_passes, int smem_cells,
                             int blocks, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kTbThreads / 32) *
      (((m_max + 15) & ~15) + ((nl + 15) & ~15) + 2 * smem_cells);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        traceback_kernel<KA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  traceback_kernel<KA><<<blocks, kTbThreads, smem, stream>>>(
      read_s, ref_s, m, r, score1, need, entries, status, bw, scratch,
      counters, p, m_max, nl, n_entries, run_cap, entry_bytes, n_passes,
      smem_cells);
  return cudaGetLastError();
}

template <typename T, bool kPairMajor>
cudaError_t launch_shift(const void* x, const void* sh, void* out, int l,
                         int p, int size, int mask, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(l) *
      (kPairMajor ? kTilePairs + 1 : kTilePairs) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        shift_sub_kernel<T, kPairMajor>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int per = 16 / static_cast<int>(sizeof(T));
  const int vec = p % per == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 ? 1 : 0;
  const int blocks = (p + kTilePairs - 1) / kTilePairs;
  shift_sub_kernel<T, kPairMajor><<<blocks, kShiftThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(sh), out, l, p,
      size, mask, vec);
  return cudaGetLastError();
}

}  // namespace

// x [l, p] int8 (elem_bytes 1) or int32 (4), sh [p] int32 -> out
// [size, p] int32, or [p, size] uint8 when pair_major
extern "C" int hrm_shift_sub(const void* x, const void* sh, void* out, int l,
                             int p, int size, int mask, int elem_bytes,
                             int pair_major, void* stream) {
  if (elem_bytes != 1 && elem_bytes != 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p <= 0 || size <= 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (elem_bytes == 1)
    err = pair_major
        ? launch_shift<int8_t, true>(x, sh, out, l, p, size, mask, st)
        : launch_shift<int8_t, false>(x, sh, out, l, p, size, mask, st);
  else
    err = pair_major
        ? launch_shift<int32_t, true>(x, sh, out, l, p, size, mask, st)
        : launch_shift<int32_t, false>(x, sh, out, l, p, size, mask, st);
  return static_cast<int>(err);
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

// read_s [p, m_max], ref_s [p, nl] uint8 subregion codes; m, r, score1 [p]
// int32; need [p] bytes or null (every pair) -> entries [p, n_entries]
// (entry_bytes 1 or 2), status [p] int8, bw [p] int32.  scratch: one
// [m_max, nl] int16 row per warp of the grid (4 * blocks); counters [2]
// int32, zero on entry: the work queue's head and the pairs that spilled.
extern "C" int hrm_traceback(const void* read_s, const void* ref_s,
                             const void* m, const void* r, const void* score1,
                             const void* need, void* entries, void* status,
                             void* bw, void* scratch, void* counters, int p,
                             int m_max, int nl, int n_entries, int run_cap,
                             int entry_bytes, int n_passes, int smem_cells,
                             int blocks, void* stream) {
  if (nl < 1 || nl > 256 || m_max < 1 || n_entries < 1 || smem_cells < 0 ||
      blocks < 1 || (entry_bytes != 1 && entry_bytes != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p <= 0) return static_cast<int>(cudaGetLastError());
  const auto* rs = static_cast<const uint8_t*>(read_s);
  const auto* fs = static_cast<const uint8_t*>(ref_s);
  const auto* mm = static_cast<const int32_t*>(m);
  const auto* rr = static_cast<const int32_t*>(r);
  const auto* sc = static_cast<const int32_t*>(score1);
  const auto* nd = static_cast<const uint8_t*>(need);
  auto* so = static_cast<int8_t*>(status);
  auto* bo = static_cast<int32_t*>(bw);
  auto* sx = static_cast<int16_t*>(scratch);
  auto* ct = static_cast<int32_t*>(counters);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (nl <= 32)
    err = launch_traceback<1>(rs, fs, mm, rr, sc, nd, entries, so, bo, sx, ct, p, m_max, nl, n_entries, run_cap, entry_bytes, n_passes, smem_cells, blocks, st);
  else if (nl <= 64)
    err = launch_traceback<2>(rs, fs, mm, rr, sc, nd, entries, so, bo, sx, ct, p, m_max, nl, n_entries, run_cap, entry_bytes, n_passes, smem_cells, blocks, st);
  else if (nl <= 128)
    err = launch_traceback<4>(rs, fs, mm, rr, sc, nd, entries, so, bo, sx, ct, p, m_max, nl, n_entries, run_cap, entry_bytes, n_passes, smem_cells, blocks, st);
  else
    err = launch_traceback<8>(rs, fs, mm, rr, sc, nd, entries, so, bo, sx, ct, p, m_max, nl, n_entries, run_cap, entry_bytes, n_passes, smem_cells, blocks, st);
  return static_cast<int>(err);
}
