// Striped byte-mode Smith-Waterman score passes, for sm_90a.
//
// hrm_sw_pass replaces hashreadmapper_tpu/ops/swdev_pallas.py::
// pass_batched_pallas (_sw_kernel), itself the lane-exact closed form of
// ssw.c's sw_sse2_byte (ssw.c:197-398): 16 uint8 SSE lanes, segLen rows
// per lane, striped position j + k * segLen.  Per column of the reference:
//
//   vh_in[0] = lane-shifted h[segLen-1], vh_in[j] = h[j-1]
//   a        = max(min(vh_in + score + BIAS, 255) - BIAS, 0)
//   pre[j]   = max(a, e[j]),  run[j] = max(run[j-1], pre[j] + j)
//   h_main   = max(pre[j], max(run[j-1] - GO - (j-1), 0))   (main vF loop)
//   e_new    = max(e - GE, h_main - GO, 0)
//   lazy-F   corr[k] = max_{s<k}(vf_init[s] + s*segLen) - (k-1)*segLen
//   h_fin    = max(h_main, corr - j, 0),  colmax = max over (j, k)
//
// then best / end_ref / snapshot / stopped / overflow exactly as the
// Pallas kernel does (swdev_pallas.py:161-178), end_read = smallest
// striped position holding best in the snapshot, capped at read_len - 1,
// overflowed |= best + BIAS >= 255 and best = 255 where overflowed.
//
// hrm_sw_forward and hrm_sw_reverse are the two passes of
// hashreadmapper_tpu/ops/swdev.py::_forward_t and _reverse_t with what
// stands around the pass there folded in: they take the pairs' codes as
// [LQ, P] and [n_cols, P] columns (int8 or int32), lay the read out in
// stripes themselves, and write rows of the [10, P] score tensor.  The
// forward entry keeps the per-column maxima in shared memory and finds
// the second best outside the masked window there (ssw.c:367-392, byte
// quirk included); the reverse entry reverses the read prefix and the ref
// columns by index, with the barrel shifts' rule that only the shift bits
// below the array length apply (swdev._shift_rows_up), and ends with the
// all-M certificate of swdev._diag_fastpath_flag on the codes it holds.
//
// What bounds the pass: integer instructions executed along the serial
// chain of columns; the bytes (a pair's 2 x 128 codes in, a few words out)
// are nothing beside them.  The design therefore cuts instructions a cell
// and columns a pair:
//   - every value of the closed form fits int16 (h, e, pre <= 253, run <=
//     260, the lazy-F prefix <= 253 + 15 * 8), so two SSE lanes share a
//     register and the cell updates are Hopper's DPX instructions on
//     s16x2: max(a + b, c) and max(a, b, c), with relu, two cells each.
//     4 threads a pair; thread q holds lanes q and q + 8 in one word and
//     q + 4 and q + 12 in a second, so the lane shift of h[segLen-1] and of
//     the lazy-F prefix is a rotation shuffle of the two words over the 4
//     threads plus a recombination in thread 0, the 16-lane cummax a
//     2-step scan over the threads in all four lane groups at once plus
//     one step that hands each group the totals of those before it,
//     colmax a 2-step xor max.  (8 threads with one word each measured
//     0.093 ms where this split takes 0.081 ms on 8,192 pairs of 100-base
//     reads, one H100 at 700 W: the per-column work that does not depend
//     on the rows is paid by half as many threads.)
//   - a query profile in shared memory, as ssw.c builds one: per pair and
//     ref code 0..4 the score words of its rows (mask of the read length
//     and `ref code < 4` folded in), so the scores of a thread's four
//     cells of a row are one 8-byte shared load;
//   - the saturating add and the bias fold into one step: max(min(v + s +
//     BIAS, 255) - BIAS, 0) = max(min(v + s, 253), 0), and the relu is the
//     max with e >= 0 that follows;
//   - the work follows the pair: a warp (8 pairs) leaves the column loop
//     when all its pairs are past their ref_len or stopped (nothing of a
//     pair changes after that), and runs only the rows below the largest
//     segLen of its pairs (the loop is instantiated per row count, chosen
//     per warp); rows at or above a pair's own segLen are masked to 0,
//     and where all pairs of the warp have that segLen (reads of one
//     length) the loop without the masks runs;
//   - a warp pays for its heaviest pair, so a block's 32 pairs go to its 4
//     warps in the order of their rows, then of their columns; every pair
//     still writes its own output slots.  (Reads of mixed lengths, every
//     fourth of 20-128 bases among reads of 25-40: 0.084 ms where 16
//     pairs a block in the order given take 0.099 ms, same card; reads of
//     one length: no change.)
//   - codes are read as they come, int8 or int32; the fused entries stage
//     their 32 pairs' columns in shared memory with 16-byte loads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 16;
constexpr int kRows = 8;             // striped rows a thread can hold
constexpr int kPairThreads = 4;      // threads a pair
constexpr int kWords = 2;            // s16x2 words a thread: four SSE lanes
constexpr int kBlockPairs = 32;
constexpr int kThreads = kBlockPairs * kPairThreads;
constexpr int kGapOpen = 3;
constexpr int kGapExtend = 1;
constexpr int kMatch = 2;
constexpr int kMismatch = 2;
constexpr int kBias = kMismatch;
constexpr int kSat = 255;
constexpr int kBig = 0x3FFFFFFF;
constexpr int kNeg = -16384;         // below every real int16 value here
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWords = kPairThreads * kWords;   // profile words a row
// words of one pair's profile: 5 ref codes x kRows rows x 8 words, and 8
// more so that 4 pairs (a half warp, one 8-byte load each thread) read 32
// different banks
constexpr int kProfWords = 5 * kRows * kRowWords + 8;

// SSE lane of half `hf` of word `w` in thread q
__device__ __forceinline__ int lane_of(int q, int w, int hf) {
  return q + kPairThreads * w + 2 * kPairThreads * hf;
}

enum Mode { kPass = 0, kForward = 1, kReverse = 2 };

__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
  return (static_cast<uint32_t>(lo) & 0xffffu) |
         (static_cast<uint32_t>(hi) << 16);
}
__device__ __forceinline__ uint32_t rep2(int v) { return pack2(v, v); }
__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
  return __vimax3_s16x2(a, b, b);
}
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  return __viaddmax_s16x2(a, b, 0x80008000u);
}

__device__ __forceinline__ int load_code(const void* x, size_t i, int bytes) {
  return bytes == 1 ? static_cast<const int8_t*>(x)[i]
                    : static_cast<const int32_t*>(x)[i];
}

// Columns [rows, p] of codes -> tile [rows][kBlockPairs] bytes for the
// block's pairs p0.., code 4 for pairs past the end and for any value
// outside 0..4 (which matches nothing, as in the plain version).
__device__ __forceinline__ void stage_tile(const void* x, int bytes, int rows,
                                           int p, int p0, uint8_t* tile) {
  const int tid = threadIdx.x;
  const bool vec = bytes == 1 && p % kBlockPairs == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (vec) {
    const int8_t* src = static_cast<const int8_t*>(x) + p0;
    constexpr int kVecs = kBlockPairs / 16;
    for (int idx = tid; idx < rows * kVecs; idx += kThreads)
      reinterpret_cast<int4*>(tile)[idx] = *reinterpret_cast<const int4*>(
          src + static_cast<size_t>(idx / kVecs) * p + 16 * (idx % kVecs));
  } else {
    for (int idx = tid; idx < rows * kBlockPairs; idx += kThreads) {
      const int t = idx / kBlockPairs;
      const int c = idx % kBlockPairs;
      int v = 4;
      if (p0 + c < p) v = load_code(x, static_cast<size_t>(t) * p + p0 + c,
                                    bytes);
      tile[idx] = static_cast<uint8_t>(static_cast<unsigned>(v) > 4u ? 4 : v);
    }
  }
}

struct PairResult {
  int best, end_ref, stop_col;
  bool overflowed;
};

// The column loop of one pair over R striped rows (R >= the segLen of
// every pair of the warp).  prof: the thread's profile words (its two
// words of row j at prof[(rb * kRows + j) * kRowWords]); ref_tile: the
// pair's column of the staged ref codes, column t at row r0 + t * dr (code
// 4 where that is below 0).  mc_s / mc_g: where the pair's per-column
// maxima go (shared int16, stride kBlockPairs; device int32, stride
// p_total), or null.  kSameSeg: every pair of the warp has segLen R, so
// no row is masked and the last row is row R - 1.  Returns the column at
// which the warp left the loop in stop_col.
template <int R, bool kSameSeg>
__device__ __forceinline__ PairResult sw_columns(
    uint32_t (&snap)[kRows][kWords], const uint32_t* prof,
    const uint8_t* ref_tile, int r0, int dr, int n_cols, int ref_len, int term,
    int ref_dir, int seg, int q, int16_t* mc_s, int32_t* mc_g,
    size_t p_total) {
  // mask: the pair's own rows; is_last: its row segLen - 1
  uint32_t h[R][kWords], e[R][kWords], mask[R], is_last[R];
  const int last_j = max(seg - 1, 0);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    mask[j] = j < seg ? 0xffffffffu : 0u;
    is_last[j] = j == last_j ? 0xffffffffu : 0u;
#pragma unroll
    for (int w = 0; w < kWords; ++w) h[j][w] = e[j][w] = 0;
  }
  const uint32_t c_vf = rep2(-(kGapOpen + seg - 1));
  uint32_t k_seg[kWords], neg_km1_seg[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    k_seg[w] = pack2(lane_of(q, w, 0) * seg, lane_of(q, w, 1) * seg);
    neg_km1_seg[w] = pack2(-(lane_of(q, w, 0) - 1) * seg,
                           -(lane_of(q, w, 1) - 1) * seg);
  }
  const int left = (q + kPairThreads - 1) % kPairThreads;
  PairResult st = {0, -1, 0, false};
  bool stopped = false;

  // lane k takes lane k - 1's value (`fill` in lane 0): thread q - 1's
  // words; in thread 0 lanes 4 and 12 follow thread 3's lanes 3 and 11
  // (its word 0), lane 8 its lane 7 (low half of its word 1)
  auto from_lane_before = [&](const uint32_t (&v)[kWords],
                              uint32_t (&out)[kWords], uint32_t fill) {
    const uint32_t v0 = __shfl_sync(kFull, v[0], left, kPairThreads);
    const uint32_t v1 = __shfl_sync(kFull, v[1], left, kPairThreads);
    out[0] = q == 0 ? (v1 << 16) | fill : v0;
    out[1] = q == 0 ? v0 : v1;
  };

  int t = 0;
  for (; t < n_cols; ++t) {
    const bool active = t < ref_len && !stopped;
    if (!__any_sync(kFull, active)) break;
    const int row = r0 + t * dr;
    const int rb = row >= 0 ? min(static_cast<int>(
                                      ref_tile[row * kBlockPairs]), 4) : 4;
    const uint2* pr =
        reinterpret_cast<const uint2*>(prof + rb * (kRows * kRowWords));

    uint32_t last[kWords], row0[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      last[w] = h[R - 1][w];
      if (!kSameSeg) {
        last[w] = 0;
#pragma unroll
        for (int j = 0; j < R; ++j) last[w] |= h[j][w] & is_last[j];
      }
    }
    from_lane_before(last, row0, 0u);

    uint32_t pre[R][kWords], run[R][kWords];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const uint2 sc = pr[j * (kRowWords / 2)];
      const uint32_t score[kWords] = {sc.x, sc.y};
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        const uint32_t vh = j == 0 ? row0[w] : h[j - 1][w];
        const uint32_t a = __viaddmin_s16x2(vh, score[w], rep2(kSat - kBias));
        pre[j][w] = max2(a, e[j][w]);
        run[j][w] = j == 0 ? pre[0][w]
                           : __viaddmax_s16x2(pre[j][w], rep2(j),
                                              run[j - 1][w]);
      }
    }
    uint32_t cmax[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      uint32_t run_last = kSameSeg ? run[R - 1][w] : 0u;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (!kSameSeg) run_last |= run[j][w] & is_last[j];
        const uint32_t hm =
            j == 0 ? pre[0][w]
                   : __viaddmax_s16x2(run[j - 1][w],
                                      rep2(-(kGapOpen + j - 1)), pre[j][w]);
        // max(e - GE, h_main - GO, 0)
        e[j][w] = __viaddmax_s16x2_relu(
            __viaddmax_s16x2(e[j][w], rep2(kGapOpen - kGapExtend), hm),
            rep2(-kGapOpen), 0u);
        h[j][w] = hm;
      }
      const uint32_t vf_init = __viaddmax_s16x2_relu(run_last, c_vf, 0u);
      cmax[w] = add2(vf_init, k_seg[w]);
    }
    // inclusive cummax over the 16 lanes: over the 4 threads in each of
    // the four lane groups (the halves of the two words), then every group
    // takes the totals of the groups before it: lanes 4-7 (word 1 low)
    // follow 0-3, lanes 8-11 (word 0 high) follow 0-7, lanes 12-15 all
#pragma unroll
    for (int d = 1; d < kPairThreads; d <<= 1) {
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        const uint32_t o = __shfl_up_sync(kFull, cmax[w], d, kPairThreads);
        if (q >= d) cmax[w] = max2(cmax[w], o);
      }
    }
    const uint32_t t0 =
        __shfl_sync(kFull, cmax[0], kPairThreads - 1, kPairThreads);
    const uint32_t t1 =
        __shfl_sync(kFull, cmax[1], kPairThreads - 1, kPairThreads);
    const uint32_t low01 = max2(t0, t1) << 16;            // high: lanes 0-7
    const uint32_t low012 = max2(low01, t0 & 0xffff0000u);  // high: 0-11
    cmax[0] = max2(cmax[0], low01 | 0x8000u);
    cmax[1] = max2(cmax[1], (low012 & 0xffff0000u) | (t0 & 0xffffu));
    uint32_t prev[kWords];
    from_lane_before(cmax, prev, static_cast<uint32_t>(kNeg) & 0xffffu);

    uint32_t cm = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const uint32_t corr = add2(prev[w], neg_km1_seg[w]);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        h[j][w] = __viaddmax_s16x2_relu(corr, rep2(-j), h[j][w]);
        if (!kSameSeg) h[j][w] &= mask[j];
        cm = max2(cm, h[j][w]);
      }
    }
#pragma unroll
    for (int d = kPairThreads / 2; d > 0; d >>= 1)
      cm = max2(cm, __shfl_xor_sync(kFull, cm, d, kPairThreads));
    const int colmax = max(static_cast<int>(cm & 0xffffu),
                           static_cast<int>(cm >> 16));

    const int i = ref_dir == 0 ? t : ref_len - 1 - t;
    const bool improved = active && colmax > st.best;
    const bool ovf_now = improved && colmax + kBias >= kSat;
    const bool take_end = improved && !ovf_now;
    if (improved) st.best = colmax;
    if (take_end) {
      st.end_ref = i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
#pragma unroll
        for (int w = 0; w < kWords; ++w) snap[j][w] = h[j][w];
      }
    }
    stopped = stopped || ovf_now || (active && colmax == term);
    st.overflowed = st.overflowed || ovf_now;
    if (q == 0) {
      const int v = active ? colmax : 0;
      if (mc_s) mc_s[t * kBlockPairs] = static_cast<int16_t>(v);
      if (mc_g) mc_g[static_cast<size_t>(t) * p_total] = v;
    }
  }
  st.stop_col = t;
  return st;
}

// One block: kBlockPairs pairs, kPairThreads threads each.
//   kPass     read_at [s, 16, p] striped codes, eff_len, seg_len, ref_t
//             [n_cols, p], ref_len, terminate as given; out [4, p] rows
//             best, end_ref, end_read, overflowed; max_column [n_cols, p]
//             when want_mc.
//   kForward  read_at is read_t [lq, p], eff_len is read_len, terminate
//             is mask_len; out [10, p]: rows 0-4 and 8.
//   kReverse  read_at is read_t [lq, p]; eff_len is query_end, ref_len
//             is ref_end, terminate is score1; out [10, p]: rows 5-7, row
//             8 or-ed, row 9 the all-M certificate.  lq_mask / nc_mask /
//             dg_mask: the shift bits applied over lq, n_cols and
//             n_cols + 2 * lq rows.
__global__ void __launch_bounds__(kThreads)
sw_kernel(int mode, const void* __restrict__ read_at, int read_bytes,
          const int32_t* __restrict__ eff_len_a,
          const int32_t* __restrict__ seg_len_a,
          const void* __restrict__ ref_t, int ref_bytes,
          const int32_t* __restrict__ ref_len_a,
          const int32_t* __restrict__ term_a, int32_t* __restrict__ out,
          int32_t* __restrict__ max_column, int s, int lq, int p_total,
          int n_cols, int ref_dir, int want_mc, int lq_mask, int nc_mask,
          int dg_mask) {
  extern __shared__ uint32_t smem[];
  uint32_t* prof_all = smem;
  uint8_t* ref_tile =
      reinterpret_cast<uint8_t*>(prof_all + kBlockPairs * kProfWords);
  uint8_t* read_tile = ref_tile + n_cols * kBlockPairs;
  // per-column maxima of the forward pass, after the read tile (its size
  // lq * kBlockPairs is a multiple of 16 bytes)
  int16_t* mc_tile = reinterpret_cast<int16_t*>(
      read_tile + (mode == kPass ? 0 : lq * kBlockPairs));

  const int p0 = blockIdx.x * kBlockPairs;
  const int q = threadIdx.x % kPairThreads;
  // thread groups take the block's pairs in the order of their rows, then
  // of their columns: group `group` works on the pair of slot `pair`
  __shared__ int sort_key[kBlockPairs];
  __shared__ int slot_of[kBlockPairs];
  const int group = threadIdx.x / kPairThreads;
  int key = 0;
  if (p0 + group < p_total) {
    const int pg = p0 + group;
    const int rows = mode == kPass ? seg_len_a[pg]
                                   : (eff_len_a[pg] + (mode == kReverse) +
                                      kLanes - 1) >> 4;
    const int cols = ref_len_a[pg] + (mode == kReverse);
    key = min(max(rows, 1), kRows) * 65536 + min(max(cols, 0), 65535);
  }
  if (q == 0) sort_key[group] = key;
  __syncthreads();
  int rank = 0;
#pragma unroll
  for (int k = 0; k < kBlockPairs; ++k) {
    const int o = sort_key[k];
    rank += o < key || (o == key && k < group);
  }
  if (q == 0) slot_of[rank] = group;
  const size_t P = static_cast<size_t>(p_total);

  stage_tile(ref_t, ref_bytes, n_cols, p_total, p0, ref_tile);
  if (mode != kPass) stage_tile(read_at, read_bytes, lq, p_total, p0,
                                read_tile);
  __syncthreads();
  const int pair = slot_of[group];
  const int p = p0 + pair;
  const bool live = p < p_total;

  // the pair's scalars; a pair past the end has no rows and no columns
  int rlen = 0, seg = 0, ref_len = 0, term = kSat, mask_len = 0;
  int qe = 0, eff_q = 0, r0 = 0, dr = 1;
  if (live) {
    if (mode == kPass) {
      rlen = eff_len_a[p];
      seg = seg_len_a[p];
      ref_len = ref_len_a[p];
      term = term_a[p];
    } else if (mode == kForward) {
      rlen = eff_len_a[p];
      seg = (rlen + kLanes - 1) >> 4;
      ref_len = ref_len_a[p];
      mask_len = term_a[p];
    } else {
      qe = eff_len_a[p];
      rlen = qe + 1;
      seg = (rlen + kLanes - 1) >> 4;
      const int re = ref_len_a[p];
      ref_len = re + 1;
      term = term_a[p];
      // rev[t] = flip[t + eff_q], flip[u] = read[lq - 1 - u]; the ref
      // column t is flip_ref[t + eff_r] = ref[n_cols - 1 - eff_r - t]
      eff_q = (lq - 1 - qe) & lq_mask;
      r0 = n_cols - 1 - ((n_cols - 1 - re) & nc_mask);
      dr = -1;
    }
  }

  // striped codes and read mask of the thread's four lanes, then its
  // profile words
  uint32_t* prof = prof_all + pair * kProfWords + q * kWords;
  unsigned pm_bits = 0;                // bit (w * 2 + half) * kRows + j
  const bool seg_ok = seg >= 1 && seg <= s;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      int code[2];
      bool pm[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k = lane_of(q, w, half);
        const int pos = j + k * seg;
        pm[half] = j < s && pos < rlen;
        int c = 4;
        if (j < s && live) {
          if (mode == kPass) {
            c = load_code(read_at,
                          (static_cast<size_t>(j) * kLanes + k) * P + p,
                          read_bytes);
          } else if (!seg_ok) {
            c = 0;
          } else {
            const int u = min(pos, lq - 1);
            if (mode == kForward) {
              c = read_tile[u * kBlockPairs + pair];
            } else if (u <= qe && u + eff_q < lq) {
              c = read_tile[(lq - 1 - u - eff_q) * kBlockPairs + pair];
            }
          }
        }
        code[half] = c;
        if (pm[half]) pm_bits |= 1u << ((w * 2 + half) * kRows + j);
      }
#pragma unroll
      for (int rb = 0; rb < 5; ++rb) {
        const int lo = pm[0] ? (code[0] == rb && rb < 4 ? kMatch : -kMismatch)
                             : 0;
        const int hi = pm[1] ? (code[1] == rb && rb < 4 ? kMatch : -kMismatch)
                             : 0;
        prof[(rb * kRows + j) * kRowWords + w] = pack2(lo, hi);
      }
    }
  }
  __syncwarp();

  uint32_t snap[kRows][kWords];
#pragma unroll
  for (int j = 0; j < kRows; ++j) snap[j][0] = snap[j][1] = 0xffffffffu;
  int16_t* mc_s = mode == kForward ? mc_tile + pair : nullptr;
  int32_t* mc_g = mode == kPass && want_mc && live ? max_column + p : nullptr;
  const uint8_t* ref_col = ref_tile + pair;

  // rows to run: the largest segLen of the warp's pairs
  int seg_w = min(max(seg, 1), min(s, kRows));
#pragma unroll
  for (int d = 16; d >= kPairThreads; d >>= 1)
    seg_w = max(seg_w, __shfl_xor_sync(kFull, seg_w, d));
  const bool same_seg = __all_sync(kFull, seg == seg_w);
  PairResult st = {0, -1, 0, false};
#define HRM_SW_RUN(R)                                                        \
  case R:                                                                    \
    st = same_seg ? sw_columns<R, true>(snap, prof, ref_col, r0, dr, n_cols, \
                                        ref_len, term, ref_dir, seg, q,      \
                                        mc_s, mc_g, P)                       \
                  : sw_columns<R, false>(snap, prof, ref_col, r0, dr,        \
                                         n_cols, ref_len, term, ref_dir,     \
                                         seg, q, mc_s, mc_g, P);             \
    break;
  switch (seg_w) {
    HRM_SW_RUN(1) HRM_SW_RUN(2) HRM_SW_RUN(3) HRM_SW_RUN(4)
    HRM_SW_RUN(5) HRM_SW_RUN(6) HRM_SW_RUN(7) HRM_SW_RUN(8)
  }
#undef HRM_SW_RUN
  // the columns the warp did not run hold no maximum
  for (int t = st.stop_col + q; t < n_cols; t += kPairThreads) {
    if (mc_s) mc_s[t * kBlockPairs] = 0;
    if (mc_g) mc_g[static_cast<size_t>(t) * P] = 0;
  }

  int cand = kBig, rl_m1 = 0;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pos = j + lane_of(q, w, half) * seg;
        const int v = half ? snap[j][w] >> 16 : snap[j][w] & 0xffffu;
        if (v == st.best) cand = min(cand, pos);
        if (pm_bits >> ((w * 2 + half) * kRows + j) & 1u)
          rl_m1 = max(rl_m1, pos);
      }
    }
  }
#pragma unroll
  for (int d = kPairThreads / 2; d > 0; d >>= 1) {
    cand = min(cand, __shfl_xor_sync(kFull, cand, d, kPairThreads));
    rl_m1 = max(rl_m1, __shfl_xor_sync(kFull, rl_m1, d, kPairThreads));
  }
  const bool overflowed = st.overflowed || st.best + kBias >= kSat;
  const int best = overflowed ? kSat : st.best;
  const int end_read = min(cand, rl_m1);

  if (mode == kPass) {
    if (live && q == 0) {
      out[p] = best;
      out[P + p] = st.end_ref;
      out[2 * P + p] = end_read;
      out[3 * P + p] = overflowed ? 1 : 0;
    }
    return;
  }
  if (mode == kReverse) {
    // the all-M certificate: equal subregion lengths and a gapless
    // diagonal score equal to score1.  ref_at[a] = x[(a + sh) mod size]
    // over x = lq pads ++ ref ++ lq pads, as the roll-based shift gives
    const int qb = qe - end_read;
    const int rbeg = st.end_ref;
    const int re = ref_len - 1;
    const int size = n_cols + 2 * lq;
    const int sh = (rbeg - qb + lq) & dg_mask;
    int diag_sum = 0;
    for (int a = q; a < lq; a += kPairThreads) {
      if (a < qb || a > qe) continue;
      const int idx = (a + sh) % size;
      int rc = 4;
      if (idx >= lq && idx < lq + n_cols)
        rc = ref_tile[(idx - lq) * kBlockPairs + pair];
      const int rd = read_tile[a * kBlockPairs + pair];
      diag_sum += rd == rc && rd < 4 ? kMatch : -kMismatch;
    }
#pragma unroll
    for (int d = kPairThreads / 2; d > 0; d >>= 1)
      diag_sum += __shfl_xor_sync(kFull, diag_sum, d, kPairThreads);
    if (live && q == 0) {
      const bool ovf_any = overflowed || out[8 * P + p] != 0;
      out[5 * P + p] = rbeg;
      out[6 * P + p] = qb;
      out[7 * P + p] = term > best ? 1 : 0;
      if (overflowed) out[8 * P + p] = 1;
      out[9 * P + p] = qe - qb == re - rbeg && diag_sum == term && !ovf_any &&
                               term > 0 && re >= 0
                           ? 1 : 0;
    }
    return;
  }
  // forward: the second best outside [end_ref - mask_len, min(ref_len,
  // end_ref + mask_len)], the second range starting one past the edge;
  // the earliest column on ties
  __syncwarp();
  const int lo = max(st.end_ref - mask_len, 0);
  const int hi = min(ref_len, st.end_ref + mask_len);
  int s2 = -1, at = kBig;
  for (int t = q; t < n_cols; t += kPairThreads) {
    const bool allowed = (t < lo || t >= hi + 1) && t < ref_len;
    const int v = allowed ? mc_s[t * kBlockPairs] : -1;
    if (v > s2) {
      s2 = v;
      at = t;
    }
  }
#pragma unroll
  for (int d = kPairThreads / 2; d > 0; d >>= 1) {
    const int o_s = __shfl_xor_sync(kFull, s2, d, kPairThreads);
    const int o_at = __shfl_xor_sync(kFull, at, d, kPairThreads);
    if (o_s > s2 || (o_s == s2 && o_at < at)) {
      s2 = o_s;
      at = o_at;
    }
  }
  if (live && q == 0) {
    const bool report = mask_len >= 15;
    out[p] = best;
    out[P + p] = st.end_ref;
    out[2 * P + p] = end_read;
    out[3 * P + p] = report ? max(s2, 0) : 0;
    out[4 * P + p] = report ? (s2 > 0 ? at : 0) : -1;
    out[8 * P + p] = overflowed ? 1 : 0;
  }
}

int launch(int mode, const void* read_at, int read_bytes, const void* eff_len,
           const void* seg_len, const void* ref_t, int ref_bytes,
           const void* ref_len, const void* term, void* out, void* max_column,
           int s, int lq, int p, int n_cols, int ref_dir, int want_mc,
           int lq_mask, int nc_mask, int dg_mask, void* stream) {
  if (s < 1 || s > kRows || (read_bytes != 1 && read_bytes != 4) ||
      (ref_bytes != 1 && ref_bytes != 4) || n_cols < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p <= 0) return static_cast<int>(cudaGetLastError());
  size_t smem = sizeof(uint32_t) * kBlockPairs * kProfWords +
                static_cast<size_t>(n_cols) * kBlockPairs;
  if (mode != kPass) smem += static_cast<size_t>(lq) * kBlockPairs;
  if (mode == kForward)
    smem += sizeof(int16_t) * static_cast<size_t>(n_cols) * kBlockPairs;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (p + kBlockPairs - 1) / kBlockPairs;
  sw_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      mode, read_at, read_bytes, static_cast<const int32_t*>(eff_len),
      static_cast<const int32_t*>(seg_len), ref_t, ref_bytes,
      static_cast<const int32_t*>(ref_len), static_cast<const int32_t*>(term),
      static_cast<int32_t*>(out), static_cast<int32_t*>(max_column), s, lq, p,
      n_cols, ref_dir, want_mc, lq_mask, nc_mask, dg_mask);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// read_at [s, 16, p] and ref_t [n_cols, p]: int8 or int32 codes
// (read_bytes, ref_bytes = 1 or 4).  out: [4, p] int32 rows best, end_ref,
// end_read, overflowed; max_column: [n_cols, p] int32, written only when
// want_mc != 0.
extern "C" int hrm_sw_pass(const void* read_at, int read_bytes,
                           const void* eff_len, const void* seg_len,
                           const void* ref_t, int ref_bytes,
                           const void* ref_len, const void* terminate,
                           void* out, void* max_column, int s, int p,
                           int n_cols, int ref_dir, int want_mc,
                           void* stream) {
  return launch(kPass, read_at, read_bytes, eff_len, seg_len, ref_t,
                ref_bytes, ref_len, terminate, out, max_column, s, 0, p,
                n_cols, ref_dir, want_mc, 0, 0, 0, stream);
}

// read_t [lq, p] and ref_t [n_cols, p] codes; read_len, ref_len, mask_len
// [p] int32.  Writes rows 0-4 (score1, ref_end, query_end, score2,
// ref_end2) and 8 (overflowed) of out [10, p] int32.
extern "C" int hrm_sw_forward(const void* read_t, int read_bytes,
                              const void* read_len, const void* ref_t,
                              int ref_bytes, const void* ref_len,
                              const void* mask_len, void* out, int lq, int p,
                              int n_cols, void* stream) {
  return launch(kForward, read_t, read_bytes, read_len, nullptr, ref_t,
                ref_bytes, ref_len, mask_len, out, nullptr,
                (lq + kLanes - 1) / kLanes, lq, p, n_cols, 0, 0, 0, 0, 0,
                stream);
}

// The reverse pass of the same pairs: score1, ref_end, query_end [p] int32
// (they may be rows 0-2 of out).  Writes rows 5-7 (ref_begin, query_begin,
// flag2) of out [10, p], sets row 8 where the pass overflowed, and writes
// row 9, the all-M certificate, which is 0 where row 8 was set before or is
// set now.
extern "C" int hrm_sw_reverse(const void* read_t, int read_bytes,
                              const void* ref_t, int ref_bytes,
                              const void* score1, const void* ref_end,
                              const void* query_end, void* out, int lq, int p,
                              int n_cols, int lq_mask, int nc_mask,
                              int dg_mask, void* stream) {
  return launch(kReverse, read_t, read_bytes, query_end, nullptr, ref_t,
                ref_bytes, ref_end, score1, out, nullptr,
                (lq + kLanes - 1) / kLanes, lq, p, n_cols, 1, 0, lq_mask,
                nc_mask, dg_mask, stream);
}
