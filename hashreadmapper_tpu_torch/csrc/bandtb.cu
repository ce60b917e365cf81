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
// I chain J, in-row D chain K from a second scan), packed as int16
// dh | min(run, 4095) << 3 into dirs[p, i, j].  Rows m..m_max-1 of an
// emitting pass are written 0; a pair with done set writes best 0 and no
// directions.  What bounds it on the card: the latency of the row loop.
// A row depends on the row above through a chain of shuffles (the
// neighbours and the log2-step scans) and dependent selects, a few
// hundred cycles, so a launch takes at least the rows of its heaviest
// pair times that; the bytes (the direction array when emitting) come
// second.  The design cuts the lanes and the chain a row needs:
//   - band-relative lanes (cell c of row i is ref position i - bw + c)
//     wherever the band's 2 bw + 1 cells fit fewer lanes than NL; absolute
//     lanes only past that;
//   - narrow pairs share a warp: 2 bw + 1 <= 8 takes an 8-lane segment
//     (four pairs a warp), <= 16 a 16-lane one (two), and every shuffle,
//     scan and reduction stays in its segment (CUDA's width argument);
//   - each scan is exclusive and takes log2(segment) shuffles (the
//     window a lane receives at each step of the inclusive scan is the
//     exclusive prefix), so the in-row gap needs no shifted copy of a;
//   - a block stages the codes of a tile of 32 adjacent pairs once into
//     shared memory (16-byte loads of int8 or int32 codes as they come,
//     only the loads that hold a pair not done), and the next row's codes
//     are loaded while a row runs;
//   - the block's warps pull the tile's units (a wide pair, two 16-lane
//     or four 8-lane pairs) from a counter in shared memory, widest class
//     first, then, emitting, the zero rows m..m_max-1 a pair at a time,
//     so no unit waits on them;
//   - a row's directions leave in whole lines: absolute lanes store their
//     cells as one 8- or 16-byte store a lane; band-relative ones put the
//     band into a zeroed row of shared memory that the segment copies out
//     with 16-byte stores, zeroing it as it reads.
// traceback replaces the same _fill_pallas together with the two scans
// around it in bandtb._tb_core_t (the band-doubling scan and the
// run-length walk): per pair, passes at band width bw = |r - m| + 1,
// doubled until best >= score1 or 2 * bw > max(m, r); the directions of
// the final width; the walk over them into at most n_entries entries
// op | len << 2, status 0 / 1 (failed) / 2 (entry budget exceeded).
// What bounds it: the latency of the row loop (a row is two exclusive
// shuffle scans and a few more shuffles, rows depend on each other),
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
constexpr int kFillPairs = 32;       // pairs a fill block owns
constexpr int kFillWarps = 8;
constexpr int kFillThreads = 32 * kFillWarps;
constexpr int kFillSegs = 4;         // row slots a fill warp: 8-lane segments

__device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

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

// The warp's lanes in segments of S (8, 16 or 32) lanes, sl = lane % S;
// a segment is one pair's row and every shuffle stays inside it.
//
// out[q] = value of cell - 1 for the K cells sl*K + q of this thread:
// the thread's previous cell, or the last cell of lane sl-1 (fill for
// sl 0)
template <int S, int K>
__device__ __forceinline__ void left_of(const int (&v)[K], int (&out)[K],
                                        int sl, int fill) {
  const int carry = __shfl_up_sync(kFull, v[K - 1], 1, S);
  out[0] = sl == 0 ? fill : carry;
#pragma unroll
  for (int q = 1; q < K; ++q) out[q] = v[q - 1];
}

// out[q] = value of cell + 1 (fill past the last cell of lane S-1)
template <int S, int K>
__device__ __forceinline__ void right_of(const int (&v)[K], int (&out)[K],
                                         int sl, int fill) {
  const int carry = __shfl_down_sync(kFull, v[0], 1, S);
#pragma unroll
  for (int q = 0; q + 1 < K; ++q) out[q] = v[q + 1];
  out[K - 1] = sl == S - 1 ? fill : carry;
}

// exclusive max-scan over the segment's S*K cells, in place: v[q] = the
// maximum of the cells before it, -kBig before the first.  At each step
// of the lanes' inclusive scan a lane receives the window of lanes just
// below those it holds, so the same log2(S) shuffles give the exclusive
// prefix.
template <int S, int K>
__device__ __forceinline__ void cummax_excl(int (&v)[K], int sl) {
  int p[K];
  p[0] = v[0];
#pragma unroll
  for (int q = 1; q < K; ++q) p[q] = max(p[q - 1], v[q]);
  int x = p[K - 1];
  int ex = -kBig;
#pragma unroll
  for (int d = 1; d < S; d <<= 1) {
    const int o = __shfl_up_sync(kFull, x, d, S);
    if (sl >= d) {
      x = max(x, o);
      ex = max(ex, o);
    }
  }
  v[0] = ex;
#pragma unroll
  for (int q = 1; q < K; ++q) v[q] = max(ex, p[q - 1]);
}

template <int S = 32>
__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int d = S / 2; d > 0; d >>= 1)
    v = max(v, __shfl_xor_sync(kFull, v, d, S));
  return v;
}

// What row_emit needs of a row's scores: e1 = max(e, 0), the direction
// bits de = (h_up - GO > e_up - GE) of the cells (bit q), t2 = diagonal +
// score, f and h before the band mask.
template <int K>
struct RowVals {
  int e1[K], t2[K], f[K], hh[K];
  unsigned de;
};

// Row i of bandtb._row_core over the segment's S*K cells (lane = the
// lane in the segment), scores only.  Cell lane*K + q is ref position j =
// o + lane*K + q with code ref[q].  kRel: o = i - bw (band-relative
// cells; the row above had o - 1, so its cell of the same index is the
// diagonal neighbour and the next cell the upper one); else o = 0 for
// every row (the same cell is the upper neighbour, the cell before it the
// diagonal one).  h and e carry the row above in and this row out, 0
// outside the band.  The in-row gap takes one exclusive scan: bandtb's
// f[j] = max(cummax(max(a[j - 1], 0) - GO + j) - j, beg - 1 - j) is
// max(u[j] - j, beg - 1 - j) with u[j] the maximum over beg <= k < j of
// max(a[k], 0) - GO + k + 1 (its start, beg - GO, never exceeds beg - 1).
template <int S, int K, bool kRel>
__device__ __forceinline__ void row_score(int i, int o, int rd,
                                          const int (&ref)[K], int r, int bw,
                                          int nl, int lane, int (&h)[K],
                                          int (&e)[K], int& best,
                                          RowVals<K>& w) {
  const int beg = max(0, i - bw);
  const int end_j = min(min(r, nl) - 1, i + bw);
  int h_up[K], e_up[K], hd[K];
  if (kRel) {
    right_of<S, K>(h, h_up, lane, 0);
    right_of<S, K>(e, e_up, lane, 0);
#pragma unroll
    for (int q = 0; q < K; ++q) hd[q] = h[q];
  } else {
    left_of<S, K>(h, hd, lane, 0);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      h_up[q] = h[q];
      e_up[q] = e[q];
    }
  }
  int e_cur[K], a[K], u[K];
  w.de = 0;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int j = o + lane * K + q;
    const bool in_up = j <= i - 1 + bw;
    const int t1e = (in_up ? h_up[q] : 0) - kGapOpen;
    const int t2e = (in_up ? e_up[q] : 0) - kGapExtend;
    if (t1e > t2e) w.de |= 1u << q;
    e_cur[q] = max(t1e, t2e);
    w.e1[q] = max(e_cur[q], 0);
    const int s = (ref[q] == rd && ref[q] < 4) ? kMatch : -kMismatch;
    w.t2[q] = (j == beg ? 0 : hd[q]) + s;
    a[q] = max(w.e1[q], w.t2[q]);
    u[q] = j >= beg ? max(a[q], 0) + (j + 1 - kGapOpen) : -kBig;
  }
  cummax_excl<S, K>(u, lane);
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int j = o + lane * K + q;
    w.f[q] = max(u[q] - j, beg - 1 - j);
    w.hh[q] = max(a[q], max(w.f[q], 0));
    const bool ok = j >= beg && j <= end_j;
    h[q] = ok ? w.hh[q] : 0;
    e[q] = ok ? e_cur[q] : 0;
    best = max(best, h[q]);
  }
}

// The directions of row i from its scores w: packed[q] = dh | run << 3, 0
// outside the band, with the oracle's tie rules and the full run length
// the walk takes from the cell (M chain D2, vertical I chain J, in-row D
// chain K from an exclusive scan).  d2 and jj carry the row above in and
// this row out: 0 and kPoison outside the band.
template <int S, int K, bool kRel>
__device__ __forceinline__ void row_emit(int i, int o, int r, int bw, int nl,
                                         int lane, const RowVals<K>& w,
                                         int (&d2)[K], int (&jj)[K],
                                         int (&packed)[K]) {
  const int beg = max(0, i - bw);
  const int end_j = min(min(r, nl) - 1, i + bw);
  int j_up[K], d2_diag[K];
  if (kRel) {
    right_of<S, K>(jj, j_up, lane, kPoison);
#pragma unroll
    for (int q = 0; q < K; ++q) d2_diag[q] = d2[q];
  } else {
    left_of<S, K>(d2, d2_diag, lane, 0);
#pragma unroll
    for (int q = 0; q < K; ++q) j_up[q] = jj[q];
  }
  int hm1[K], fm1[K];
  left_of<S, K>(w.hh, hm1, lane, 0);
  left_of<S, K>(w.f, fm1, lane, 0);
  int dh[K], d2n[K], jjn[K], z[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int j = o + lane * K + q;
    const bool inb = j >= beg && j <= end_j;
    const bool at_beg = j == beg;
    const int de = (w.de >> q) & 1;
    const int h_l = at_beg ? 0 : hm1[q];
    const int f_l = at_beg ? 0 : fm1[q];
    const int df = h_l - kGapOpen > f_l - kGapExtend ? 1 : 0;
    const int f1 = max(w.f[q], 0);
    const int t1h = max(w.e1[q], f1);
    dh[q] = t1h <= w.t2[q] ? 1 : (w.e1[q] > f1 ? 2 + de : 4 + df);
    const int dg = at_beg ? 0 : d2_diag[q];
    d2n[q] = dh[q] == 1 ? 1 + max(dg, 0) : 0;
    jjn[q] = inb ? (de == 0 ? 1 + j_up[q] : 1) : kPoison;
    int v = df == 1 ? 2 * j : -kBig;
    if (at_beg && df == 0) v = beg > 0 ? 2 * j - 1 : 0;
    z[q] = inb ? v : -kBig;
  }
  // z[q] becomes the doubled position of the last D reset before cell j
  // (odd: the run crossed the band's start); K of cell j - 1 follows
  cummax_excl<S, K>(z, lane);
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int j = o + lane * K + q;
    const bool ok = j >= beg && j <= end_j;
    const int k_l = (j == beg || (z[q] & 1)) ? kPoison : j - (z[q] >> 1);
    int rl = dh[q] == 1 ? d2n[q]
           : dh[q] == 2 ? 1 + j_up[q]
           : dh[q] == 4 ? 1 + k_l : 1;
    rl = min(max(rl, 0), kRunMax);
    packed[q] = (ok && rl > 0) ? (dh[q] | (rl << 3)) : 0;
    d2[q] = ok ? d2n[q] : 0;
    jj[q] = ok ? jjn[q] : kPoison;
  }
}

// Row i of bandtb._row_core: the scores and, kEmit, the directions.
template <int S, int K, bool kRel, bool kEmit>
__device__ __forceinline__ void band_row(int i, int o, int rd,
                                         const int (&ref)[K], int r, int bw,
                                         int nl, int lane, int (&h)[K],
                                         int (&e)[K], int (&d2)[K],
                                         int (&jj)[K], int& best,
                                         int (&packed)[K]) {
  RowVals<K> w;
  row_score<S, K, kRel>(i, o, rd, ref, r, bw, nl, lane, h, e, best, w);
  if (kEmit) row_emit<S, K, kRel>(i, o, r, bw, nl, lane, w, d2, jj, packed);
}

// ---- fill_pass ----------------------------------------------------------

// Codes [rows, P] of T (row stride `stride` elements) of the block's tile
// of kFillPairs pairs into dst[pair * dst_stride + row] as int8 (int32
// codes of the int8 range: the wrapper checks); only the loads that hold
// a live pair.  vec: the rows' start and stride are
// 16-byte aligned.
template <typename T>
__device__ __forceinline__ void stage_codes(const T* __restrict__ src,
                                            int stride, int vec, int rows,
                                            int8_t* dst, int dst_stride,
                                            int p0, int valid,
                                            unsigned live) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  constexpr int kVecRow = kFillPairs / kPer;
  for (int v = threadIdx.x; v < rows * kVecRow; v += kFillThreads) {
    const int t = v / kVecRow;
    const int c = (v % kVecRow) * kPer;
    if (((live >> c) & ((1u << kPer) - 1)) == 0) continue;
    const T* row = src + static_cast<size_t>(t) * stride + p0 + c;
    if (vec && c + kPer <= valid) {
      const int4 w = *reinterpret_cast<const int4*>(row);
#pragma unroll
      for (int q = 0; q < kPer; ++q)
        dst[(c + q) * dst_stride + t] = static_cast<int8_t>(vec_elem<T>(w, q));
    } else {
      for (int q = 0; q < kPer && c + q < valid; ++q)
        dst[(c + q) * dst_stride + t] = static_cast<int8_t>(row[q]);
    }
  }
}

// n-th set bit of mask (from 0), -1 past the last: a binary search on
// the halves' popcounts
__device__ __forceinline__ int nth_set(unsigned mask, int n) {
  if (n >= __popc(mask)) return -1;
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const unsigned low = mask & ((1u << w) - 1);
    const int c = __popc(low);
    if (n >= c) {
      n -= c;
      mask >>= w;
      pos += w;
    } else {
      mask = low;
    }
  }
  return pos;
}

// count int16 zeros from dst by the S lanes of a segment (16-byte stores
// when vec: dst 16-byte aligned, count a multiple of 8)
template <int S>
__device__ __forceinline__ void zero_cells(int16_t* dst, size_t count,
                                           int vec, int sl) {
  if (vec) {
    int4* d = reinterpret_cast<int4*>(dst);
    for (size_t k = sl; k < count / 8; k += S) d[k] = make_int4(0, 0, 0, 0);
  } else {
    for (size_t k = sl; k < count; k += S) dst[k] = 0;
  }
}

struct FillArgs {
  const int32_t* m;
  const int32_t* r;
  const int32_t* bw;
  int32_t* best;
  int16_t* dirs;
  const int8_t* rd_tile;     // [kFillPairs][sr] read codes of the tile
  const int8_t* rf_tile;     // [kFillPairs][sf] ref codes
  int16_t* slots;            // the warp's kFillSegs rows of directions
  int p0, m_max, nl, sr, sf, rows_f, bstride, vec_d;
};

// A segment's row slot to its row out of dst when the row is below m,
// the slot zeroed as it is read (16-byte loads, stores and zeroing when
// vec).  The whole warp calls it, so that it syncs in step.
template <int S>
__device__ __forceinline__ void flush_row(int16_t* slot, int16_t* out,
                                          bool below_m, int nl, int vec,
                                          int sl) {
  __syncwarp();
  if (below_m) {
    if (vec) {
      for (int v = sl; v < nl / 8; v += S) {
        int4* s4 = reinterpret_cast<int4*>(slot) + v;
        const int4 x = *s4;
        *s4 = make_int4(0, 0, 0, 0);
        reinterpret_cast<int4*>(out)[v] = x;
      }
    } else {
      for (int v = sl; v < nl; v += S) {
        out[v] = slot[v];
        slot[v] = 0;
      }
    }
  }
  __syncwarp();
}

// A lane's K cells of a row of directions straight to dst (absolute
// lanes: the warp's cells cover the row): one 4-, 8- or 16-byte store
// when vec (NL a multiple of 8, so the cells are aligned).
template <int K>
__device__ __forceinline__ void store_cells(int16_t* dst, const int (&v)[K],
                                            int sl, int nl, int vec) {
  const int j0 = sl * K;
  if (K > 1 && vec && j0 + K <= nl) {
    int w[(K + 1) / 2];
#pragma unroll
    for (int q = 0; q < K / 2; ++q)
      w[q] = (v[2 * q] & 0xffff) | (v[2 * q + 1] << 16);
    if constexpr (K == 8)
      *reinterpret_cast<int4*>(dst + j0) = make_int4(w[0], w[1], w[2], w[3]);
    else if constexpr (K == 4)
      *reinterpret_cast<int2*>(dst + j0) = make_int2(w[0], w[1]);
    else if constexpr (K == 2)
      *reinterpret_cast<int*>(dst + j0) = w[0];
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q)
      if (j0 + q < nl) dst[j0 + q] = static_cast<int16_t>(v[q]);
  }
}

// The directions of row i (below m) from its scores: absolute lanes store
// the whole row at once; band-relative ones put the band's non-zero cells
// into the segment's zeroed row slot and store the slot.
template <int S, int K, bool kRel>
__device__ __forceinline__ void emit_row(const FillArgs& a, int i, int m,
                                         int r, int bw, int sl,
                                         const RowVals<K>& w, int (&d2)[K],
                                         int (&jj)[K], int16_t* slot,
                                         int16_t* out) {
  const int o = kRel ? i - bw : 0;
  int packed[K];
  row_emit<S, K, kRel>(i, o, r, bw, a.nl, sl, w, d2, jj, packed);
  if (!kRel) {
    if (i < m)
      store_cells<K>(out + static_cast<size_t>(i) * a.nl, packed, sl, a.nl,
                     a.vec_d);
    return;
  }
  if (i < m) {
#pragma unroll
    for (int q = 0; q < K; ++q)
      if (packed[q] != 0)
        slot[o + sl * K + q] = static_cast<int16_t>(packed[q]);
  }
  flush_row<S>(slot, out + static_cast<size_t>(i) * a.nl, i < m, a.nl,
               a.vec_d, sl);
}

// The codes of row i: the read's, and the ref's of the lane's cells
// (band-relative: they move with the row; absolute: loaded once)
template <int K, bool kRel>
__device__ __forceinline__ void row_codes(const int8_t* rd_s,
                                          const int8_t* rf_s, int i, int o,
                                          int rows, int rows_f, int sl,
                                          int& rd, int (&ref)[K]) {
  rd = i < rows ? rd_s[i] : 4;
  if (kRel) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int j = o + sl * K + q;
      ref[q] = (j >= 0 && j < rows_f) ? rf_s[j] : 4;
    }
  }
}

// The pass of the pairs of one unit, the whole warp in step: segment
// lane / S takes the pair of rank rank0 + lane / S in mask (none past the
// last).  Every lane takes part in the shuffles up to the largest m of
// the warp; a segment past its own m keeps its best and emits nothing.
// The codes of the next row are loaded while a row runs.  kEmit: a row's
// directions go through the segment's row slot in shared memory
// (zero outside the band) to 16-byte stores of whole rows, or straight
// from the lanes (absolute lanes); rows m..m_max-1 are the kernel's.
template <int S, int K, bool kRel, bool kEmit>
__device__ __forceinline__ void fill_unit(const FillArgs& a, unsigned mask,
                                          int rank0, int lane) {
  const int sl = lane % S;
  const int seg = lane / S;
  const int pair = nth_set(mask, rank0 + seg);
  int m = 0, r = 0, bw = 0;
  if (pair >= 0) {
    const int p = a.p0 + pair;
    m = max(min(a.m[p], a.m_max), 0);
    r = a.r[p];
    bw = a.bw[p];
  }
  const int rows = __reduce_max_sync(kFull, m);
  const int pc = max(pair, 0);
  const int8_t* rd_s = a.rd_tile + pc * a.sr;
  const int8_t* rf_s = a.rf_tile + pc * a.sf;
  int16_t* slot = a.slots + seg * a.bstride;
  int16_t* out = a.dirs + static_cast<size_t>(a.p0 + pc) * a.m_max * a.nl;
  if (kEmit && kRel) {
    zero_cells<S>(slot, a.bstride, 1, sl);
    __syncwarp();
  }
  int ref[K], h[K], e[K], d2[K], jj[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int j = sl * K + q;
    ref[q] = (!kRel && j < a.rows_f) ? rf_s[j] : 4;
    h[q] = 0;
    e[q] = 0;
    d2[q] = 0;
    jj[q] = 0;
  }
  int best = 0;
  int rd;
  row_codes<K, kRel>(rd_s, rf_s, 0, -bw, rows, a.rows_f, sl, rd, ref);
  for (int i = 0; i < rows; ++i) {
    const int o = kRel ? i - bw : 0;
    int rd_n, ref_n[K];
#pragma unroll
    for (int q = 0; q < K; ++q) ref_n[q] = ref[q];
    row_codes<K, kRel>(rd_s, rf_s, i + 1, o + 1, rows, a.rows_f, sl, rd_n,
                       ref_n);
    const int kept = best;
    RowVals<K> w;
    row_score<S, K, kRel>(i, o, rd, ref, r, bw, a.nl, sl, h, e, best, w);
    if (i >= m) best = kept;
    if (kEmit) emit_row<S, K, kRel>(a, i, m, r, bw, sl, w, d2, jj, slot, out);
    rd = rd_n;
#pragma unroll
    for (int q = 0; q < K; ++q) ref[q] = ref_n[q];
  }
  best = warp_max<S>(best);
  if (pair >= 0 && sl == 0) a.best[a.p0 + pair] = best;
}

// A pair's class, heaviest first: absolute lanes (KA cells a lane over
// all NL); band-relative lanes at 4, 2 or 1 cells a lane (2 bw + 1 cells
// fit 32 K lanes, K below KA); 16- and 8-lane segments of one cell a
// lane, 2 and 4 pairs a warp.  A pair with no row goes with the 8-lane
// segments (it only zeroes its directions).
enum FillClass { kAbs, kRel4, kRel2, kRel1, kSeg16, kSeg8, kClasses };

template <int KA>
__device__ __forceinline__ int fill_class(int m, int bw) {
  if (m <= 0 || bw <= 3) return kSeg8;
  if (bw <= 7) return kSeg16;
  if (KA > 1 && bw <= 15) return kRel1;
  if (KA > 2 && bw <= 31) return kRel2;
  if (KA > 4 && bw <= 63) return kRel4;
  return kAbs;
}

__device__ __forceinline__ int class_pairs(int c) {
  return c == kSeg8 ? 4 : c == kSeg16 ? 2 : 1;
}

// unit u of a tile -> its class c, its rank w in the class and the
// class's pairs (units are numbered class by class, heaviest first)
__device__ __forceinline__ void unit_of(int u,
                                        const unsigned (&masks)[kClasses],
                                        const int (&units)[kClasses], int& c,
                                        int& w, unsigned& mask) {
  c = kSeg8;
  w = u;
  mask = 0;
  bool found = false;
#pragma unroll
  for (int k = 0; k < kClasses; ++k) {
    if (!found) {
      if (w < units[k]) {
        c = k;
        mask = masks[k];
        found = true;
      } else {
        w -= units[k];
      }
    }
  }
}

// bytes a pair's codes take in shared memory: n rounded up to whole
// words, an odd count of them (segments of a warp read distinct banks)
__host__ __device__ inline int code_stride(int n) {
  return 4 * (((n + 3) / 4) | 1);
}

// A block owns a tile of kFillPairs adjacent pairs: it stages their codes
// once, then its warps take the tile's units (a pair of a wide class, two
// of kSeg16, four of kSeg8), the widest class first, each warp the next
// one when it is free.
template <int KA, bool kEmit>
__global__ void __launch_bounds__(kFillThreads, 2)
fill_kernel(const void* __restrict__ read_t, int read_stride,
            const void* __restrict__ ref_t, int ref_stride, int elem_bytes,
            int vec_r, int vec_f, const int32_t* __restrict__ m_a,
            const int32_t* __restrict__ r_a, const int32_t* __restrict__ bw_a,
            const int32_t* __restrict__ done_a, int32_t* __restrict__ best_out,
            int16_t* __restrict__ dirs, int p_total, int m_max, int nl,
            int vec_d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  FillArgs a;
  a.m = m_a;
  a.r = r_a;
  a.bw = bw_a;
  a.best = best_out;
  a.dirs = dirs;
  a.p0 = blockIdx.x * kFillPairs;
  a.m_max = m_max;
  a.nl = nl;
  a.sr = code_stride(m_max);
  a.sf = code_stride(nl);
  a.bstride = (nl + 7) & ~7;
  a.vec_d = vec_d;
  int8_t* rd_tile = reinterpret_cast<int8_t*>(smem);
  int8_t* rf_tile = rd_tile + kFillPairs * a.sr;
  a.rd_tile = rd_tile;
  a.rf_tile = rf_tile;
  a.slots = reinterpret_cast<int16_t*>(
      smem + round16(kFillPairs * (a.sr + a.sf))) +
      warp * kFillSegs * a.bstride;

  // lane = pair p0 + lane of the tile, in every warp
  const int valid = min(kFillPairs, p_total - a.p0);
  bool live = false;
  int m = 0, r = 0, bw = 0;
  if (lane < valid) {
    const int p = a.p0 + lane;
    live = done_a[p] == 0;
    m = min(m_a[p], m_max);
    r = r_a[p];
    bw = bw_a[p];
    if (!live && warp == 0) best_out[p] = 0;
  }
  const unsigned live_mask = __ballot_sync(kFull, live);
  const int rows_r = __reduce_max_sync(kFull, live ? max(m, 0) : 0);
  a.rows_f = min(nl, __reduce_max_sync(kFull, live ? max(r, 0) : 0));
  if (elem_bytes == 1) {
    stage_codes(static_cast<const int8_t*>(read_t), read_stride, vec_r,
                rows_r, rd_tile, a.sr, a.p0, valid, live_mask);
    stage_codes(static_cast<const int8_t*>(ref_t), ref_stride, vec_f,
                a.rows_f, rf_tile, a.sf, a.p0, valid, live_mask);
  } else {
    stage_codes(static_cast<const int32_t*>(read_t), read_stride, vec_r,
                rows_r, rd_tile, a.sr, a.p0, valid, live_mask);
    stage_codes(static_cast<const int32_t*>(ref_t), ref_stride, vec_f,
                a.rows_f, rf_tile, a.sf, a.p0, valid, live_mask);
  }

  const int cls = fill_class<KA>(m, bw);
  unsigned masks[kClasses];
  int units[kClasses];
  int total = 0;
#pragma unroll
  for (int c = 0; c < kClasses; ++c) {
    masks[c] = __ballot_sync(kFull, live && cls == c);
    units[c] = (__popc(masks[c]) + class_pairs(c) - 1) / class_pairs(c);
    total += units[c];
  }
  // the warps take the units in that order (the widest lanes first), each
  // the next one when it is free; emitting, then the zero rows m..m_max-1
  // of each pair not done, a task a pair, so that no unit waits on them
  __shared__ int next_unit;
  if (threadIdx.x == 0) next_unit = 0;
  __syncthreads();
  const int tasks = total + (kEmit ? __popc(live_mask) : 0);
  for (;;) {
    int u = lane == 0 ? atomicAdd(&next_unit, 1) : 0;
    u = __shfl_sync(kFull, u, 0);
    if (u >= tasks) break;
    if (u >= total) {
      const int p = a.p0 + nth_set(live_mask, u - total);
      const int mp = max(min(m_a[p], m_max), 0);
      zero_cells<32>(dirs + (static_cast<size_t>(p) * m_max + mp) * nl,
                     static_cast<size_t>(m_max - mp) * nl, vec_d, lane);
      continue;
    }
    int c, w;
    unsigned mask;
    unit_of(u, masks, units, c, w, mask);
    const int rank0 = w * class_pairs(c);
    if (c == kAbs) {
      fill_unit<32, KA, false, kEmit>(a, mask, rank0, lane);
    } else if (c == kRel4) {
      if constexpr (KA > 4)
        fill_unit<32, 4, true, kEmit>(a, mask, rank0, lane);
    } else if (c == kRel2) {
      if constexpr (KA > 2)
        fill_unit<32, 2, true, kEmit>(a, mask, rank0, lane);
    } else if (c == kRel1) {
      if constexpr (KA > 1)
        fill_unit<32, 1, true, kEmit>(a, mask, rank0, lane);
    } else if (c == kSeg16) {
      fill_unit<16, 1, true, kEmit>(a, mask, rank0, lane);
    } else {
      fill_unit<8, 1, true, kEmit>(a, mask, rank0, lane);
    }
  }
}

size_t fill_smem(int m_max, int nl, int emit) {
  const size_t codes = static_cast<size_t>(kFillPairs) *
      (code_stride(m_max) + code_stride(nl));
  return ((codes + 15) & ~static_cast<size_t>(15)) +
      (emit ? static_cast<size_t>(kFillWarps) * kFillSegs *
                  ((nl + 7) & ~7) * sizeof(int16_t)
            : 0);
}

template <int KA, bool kEmit>
cudaError_t launch_fill(const void* read_t, int read_stride, const void* ref_t,
                        int ref_stride, int elem_bytes, const int32_t* m,
                        const int32_t* r, const int32_t* bw,
                        const int32_t* done, int32_t* best, int16_t* dirs,
                        int p, int m_max, int nl, cudaStream_t stream) {
  const size_t smem = fill_smem(m_max, nl, kEmit);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fill_kernel<KA, kEmit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  auto aligned = [](const void* x, long stride_bytes) {
    return reinterpret_cast<uintptr_t>(x) % 16 == 0 && stride_bytes % 16 == 0
        ? 1 : 0;
  };
  const int vec_r = aligned(read_t, static_cast<long>(read_stride) *
                                        elem_bytes);
  const int vec_f = aligned(ref_t, static_cast<long>(ref_stride) * elem_bytes);
  const int vec_d = kEmit && nl % 8 == 0 &&
      reinterpret_cast<uintptr_t>(dirs) % 16 == 0 ? 1 : 0;
  const int blocks = (p + kFillPairs - 1) / kFillPairs;
  fill_kernel<KA, kEmit><<<blocks, kFillThreads, smem, stream>>>(
      read_t, read_stride, ref_t, ref_stride, elem_bytes, vec_r, vec_f, m, r,
      bw, done, best, dirs, p, m_max, nl, vec_d);
  return cudaGetLastError();
}

template <int KA>
cudaError_t launch_fill_emit(const void* read_t, int read_stride,
                             const void* ref_t, int ref_stride,
                             int elem_bytes, const int32_t* m,
                             const int32_t* r, const int32_t* bw,
                             const int32_t* done, int32_t* best,
                             int16_t* dirs, int p, int m_max, int nl,
                             int emit, cudaStream_t stream) {
  return emit
      ? launch_fill<KA, true>(read_t, read_stride, ref_t, ref_stride,
                              elem_bytes, m, r, bw, done, best, dirs, p,
                              m_max, nl, stream)
      : launch_fill<KA, false>(read_t, read_stride, ref_t, ref_stride,
                               elem_bytes, m, r, bw, done, best, dirs, p,
                               m_max, nl, stream);
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
    band_row<32, K, kRel, true>(i, o, rd_s[i], ref, r, bw, nl, lane, h, e, d2,
                            jj, best, packed);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int c = lane * K + q;
      if (c < wd) dirs[i * wd + c] = static_cast<int16_t>(packed[q]);
    }
  }
  return warp_max(best);
}

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

// read_t [>= m_max rows, p] (row stride read_stride elements), ref_t [nl,
// p] (ref_stride) subregion codes, int8 (elem_bytes 1) or int32 (4) of
// the int8 range; m, r, bw, done [p] int32 -> best [p] int32; dirs [p,
// m_max, nl] int16 when emit != 0
extern "C" int hrm_fill_pass(const void* read_t, int read_stride,
                             const void* ref_t, int ref_stride,
                             int elem_bytes, const void* m, const void* r,
                             const void* bw, const void* done, void* best,
                             void* dirs, int p, int m_max, int nl, int emit,
                             void* stream) {
  if (nl < 1 || nl > 256 || m_max < 0 || (elem_bytes != 1 && elem_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (p <= 0) return static_cast<int>(cudaGetLastError());
  const auto* mm = static_cast<const int32_t*>(m);
  const auto* rr = static_cast<const int32_t*>(r);
  const auto* bb = static_cast<const int32_t*>(bw);
  const auto* dd = static_cast<const int32_t*>(done);
  auto* bo = static_cast<int32_t*>(best);
  auto* dr = static_cast<int16_t*>(dirs);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (nl <= 32)
    err = launch_fill_emit<1>(read_t, read_stride, ref_t, ref_stride, elem_bytes, mm, rr, bb, dd, bo, dr, p, m_max, nl, emit, st);
  else if (nl <= 64)
    err = launch_fill_emit<2>(read_t, read_stride, ref_t, ref_stride, elem_bytes, mm, rr, bb, dd, bo, dr, p, m_max, nl, emit, st);
  else if (nl <= 128)
    err = launch_fill_emit<4>(read_t, read_stride, ref_t, ref_stride, elem_bytes, mm, rr, bb, dd, bo, dr, p, m_max, nl, emit, st);
  else
    err = launch_fill_emit<8>(read_t, read_stride, ref_t, ref_stride, elem_bytes, mm, rr, bb, dd, bo, dr, p, m_max, nl, emit, st);
  return static_cast<int>(err);
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
