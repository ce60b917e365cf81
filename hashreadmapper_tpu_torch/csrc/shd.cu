// Shifted Hamming distance on bit planes, for sm_90a: the best shift per
// orientation (hrm_shd_best), the whole Hamming matrix
// (hrm_shd_hamming_matrix) and the coarse mapper's SHD stage in one launch
// (hrm_shd_pairs_best).
//
// Replaces hashreadmapper_tpu/ops/shd_pallas.py::shd_best
// (_shd_best_kernel) and ::shd_hamming_matrix (_shd_kernel); the fused
// entry also does what hashreadmapper_tpu/ops/shd.py builds around the
// first on the production path (pack_read_planes, the per-pair gathers,
// shd_pairs_packed_planes, finalize_shd_from_best).  Per pair p,
// orientation o (0 forward, 1 reverse complement) and shift s:
//
//   ham(s) = sum_w popcount(((A_hi >> s)[w] ^ r_hi[w] | (A_lo >> s)[w] ^
//                            r_lo[w]) & mask[w])
//
// where A >> s is the anchor bit plane shifted right by s bits across
// words.  shd_best keeps, over s in [min_shift, max_shift] intersected
// with [0, 32 * ceil(n_shifts / 32)), the smallest ham at its earliest
// shift (a scan with strict '<'); an empty range gives (0x3FFFFFFF,
// min_shift).  Output rows: (best_f, shift_f, best_r, shift_r).
//
// What bounds it: the instructions, a popcount, three logic operations and
// an add for every read word of every shift (2 x 16,384 pairs x 129 shifts
// x 4 words on the main path); the popcounts set the pace, on a pipe of
// 16 lanes a clock a multiprocessor where the logic runs on 64
// (tools/int_rates.py); the planes in and the [P, 4] rows out are about
// 1 MB.  A thread a pair
// would leave one warp a scheduler, each on a serial chain of shifts.
//
// Design, the same for all three entries: a warp owns a pair (both
// orientations, for two independent chains), lane b takes the sub-word
// shift b and loops over the word offsets k, so its shifts are 32k + b.
// A warp, not 8 or 16 lanes, because then every lane has one sub-word
// shift and holds one aligned copy of the read (fewer lanes would hold two
// or four, in registers, to save broadcast loads; not tried), and the main
// path's 16,384 pairs are 16,384 warps of about 48 registers: two waves of
// 64 warps a multiprocessor.
// Since b is fixed for the lane, the lane shifts the READ planes and the
// mask left by b once (wr + 1 words: funnel shifts, in registers), and
// then compares them with the anchor words k .. k + wr as they stand: a
// shift costs (wr + 1) x (one 8-byte broadcast load from shared memory,
// three logic operations, a popcount, an add), no funnel shift and no
// guard, wr a template parameter (1 .. 16).  The anchor words are staged
// once a pair in shared memory as (hi, lo) pairs.  Each lane keeps the
// minimum of (ham << 16 | s), one warp minimum (__reduce_min_sync) then
// gives the smallest ham at its earliest shift, exactly what the scan
// with strict '<' keeps (ham <= 512 and s < 2^16 fit the 32-bit key).
// The matrix entry writes each lane's count: 32 consecutive int32 a warp.
// The fused entry builds the read planes itself (lane j holds base 32w + j,
// the reverse complement reads base len - 1 - pos; __ballot_sync packs the
// words), gathers the anchor words from the packed genome with the plain
// code's clamps and collapses, and finishes with the threshold, the
// too-long rule and the orientation, so one launch replaces about 150 small
// torch operations and the shd_best launch a batch.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kWrMax = 16;          // read words (512 bp)
constexpr int kBig = 0x3FFFFFFF;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoKey = 0xffffffffu;
constexpr int kMaxSmem = 48 * 1024;

// bit q of out = bit q - b of the wr-word plane w (0 below b): the plane
// shifted left by the lane's sub-word shift, wr + 1 words
template <int WR>
__device__ __forceinline__ void shift_left(const uint32_t (&w)[WR], int b,
                                           uint32_t (&out)[WR + 1]) {
#pragma unroll
  for (int j = 0; j <= WR; ++j)
    out[j] = __funnelshift_l(j > 0 ? w[j - 1] : 0u, j < WR ? w[j] : 0u, b);
}

// mismatches of the shifted read against the anchor words anc[0 .. WR]
template <int WR>
__device__ __forceinline__ uint32_t mismatches(const uint2* anc,
                                               const uint32_t (&h)[WR + 1],
                                               const uint32_t (&l)[WR + 1],
                                               const uint32_t (&m)[WR + 1]) {
  uint32_t n = 0;
#pragma unroll
  for (int j = 0; j <= WR; ++j) {
    const uint2 a = anc[j];
    n += __popc(((a.x ^ h[j]) | (a.y ^ l[j])) & m[j]);
  }
  return n;
}

// One orientation's read planes as the lanes use them.
template <int WR>
struct LaneRead {
  uint32_t h[WR + 1], l[WR + 1];
};

// (best, shift) of both orientations of one pair, its warp calling:
// anc0 / anc1 the anchor words of the two orientations in shared memory,
// rh / rl / mask the read words (the same in every lane).
template <int WR>
__device__ __forceinline__ void warp_best(
    const uint2* anc0, const uint2* anc1, const uint32_t (&rh0)[WR],
    const uint32_t (&rl0)[WR], const uint32_t (&rh1)[WR],
    const uint32_t (&rl1)[WR], const uint32_t (&mask)[WR], int min_s,
    int max_s, int n_shifts, int (&best)[2], int (&shift)[2]) {
  const int b = threadIdx.x & 31;
  LaneRead<WR> r0, r1;
  uint32_t m[WR + 1];
  shift_left<WR>(rh0, b, r0.h);
  shift_left<WR>(rl0, b, r0.l);
  shift_left<WR>(rh1, b, r1.h);
  shift_left<WR>(rl1, b, r1.l);
  shift_left<WR>(mask, b, m);
  const int lo_s = max(min_s, 0);
  const int hi_s = min(max_s, ((n_shifts + 31) / 32) * 32 - 1);
  uint32_t key0 = kNoKey, key1 = kNoKey;
  if (lo_s <= hi_s) {                       // the same in every lane
    const uint32_t span = static_cast<uint32_t>(hi_s - lo_s);
    for (int k = lo_s >> 5; k <= (hi_s >> 5); ++k) {
      const uint32_t s = static_cast<uint32_t>(32 * k + b);
      const uint32_t n0 = mismatches<WR>(anc0 + k, r0.h, r0.l, m);
      const uint32_t n1 = mismatches<WR>(anc1 + k, r1.h, r1.l, m);
      if (s - static_cast<uint32_t>(lo_s) <= span) {
        key0 = min(key0, (n0 << 16) | s);
        key1 = min(key1, (n1 << 16) | s);
      }
    }
  }
  key0 = __reduce_min_sync(kFull, key0);
  key1 = __reduce_min_sync(kFull, key1);
  best[0] = key0 == kNoKey ? kBig : static_cast<int>(key0 >> 16);
  shift[0] = key0 == kNoKey ? min_s : static_cast<int>(key0 & 0xFFFFu);
  best[1] = key1 == kNoKey ? kBig : static_cast<int>(key1 >> 16);
  shift[1] = key1 == kNoKey ? min_s : static_cast<int>(key1 & 0xFFFFu);
}

// Words of an anchor that any shift in [0, 32 * ceil(n_shifts / 32)) reads.
__host__ __device__ __forceinline__ int anchor_words(int n_shifts, int wr) {
  return (n_shifts + 31) / 32 + wr;
}

// Stage the two orientations' anchor rows of pair pi ([P, 2, wa] planes)
// as (hi, lo) pairs: anc[o * nw + j].
__device__ __forceinline__ void stage_anchor_rows(
    const uint32_t* __restrict__ a_hi, const uint32_t* __restrict__ a_lo,
    uint2* anc, int pi, int wa, int nw) {
  const int lane = threadIdx.x & 31;
  for (int o = 0; o < 2; ++o) {
    const size_t row = (static_cast<size_t>(pi) * 2 + o) * wa;
    for (int j = lane; j < nw; j += 32)
      anc[o * nw + j] = make_uint2(a_hi[row + j], a_lo[row + j]);
  }
}

// The read words of pair pi ([P, 2, WR] planes, [P, WR] mask), the same
// in every lane.
template <int WR>
__device__ __forceinline__ void load_read_rows(
    const uint32_t* __restrict__ r_hi, const uint32_t* __restrict__ r_lo,
    const uint32_t* __restrict__ mask, int pi, uint32_t (&rh0)[WR],
    uint32_t (&rl0)[WR], uint32_t (&rh1)[WR], uint32_t (&rl1)[WR],
    uint32_t (&m)[WR]) {
  const size_t r0 = static_cast<size_t>(pi) * 2 * WR;
#pragma unroll
  for (int w = 0; w < WR; ++w) {
    rh0[w] = r_hi[r0 + w];
    rl0[w] = r_lo[r0 + w];
    rh1[w] = r_hi[r0 + WR + w];
    rl1[w] = r_lo[r0 + WR + w];
    m[w] = mask[static_cast<size_t>(pi) * WR + w];
  }
}

template <int WR>
__global__ void __launch_bounds__(128)
shd_best_kernel(const uint32_t* __restrict__ a_hi,
                const uint32_t* __restrict__ a_lo,
                const uint32_t* __restrict__ r_hi,
                const uint32_t* __restrict__ r_lo,
                const uint32_t* __restrict__ mask,
                const int32_t* __restrict__ bounds, int32_t* __restrict__ out,
                int p, int wa, int n_shifts) {
  extern __shared__ uint2 smem[];
  const int warp = threadIdx.x >> 5;
  const int pi = blockIdx.x * (blockDim.x >> 5) + warp;
  if (pi >= p) return;                      // the whole warp
  const int nw = anchor_words(n_shifts, WR);
  uint2* anc = smem + static_cast<size_t>(warp) * 2 * nw;
  stage_anchor_rows(a_hi, a_lo, anc, pi, wa, nw);
  uint32_t rh0[WR], rl0[WR], rh1[WR], rl1[WR], m[WR];
  load_read_rows<WR>(r_hi, r_lo, mask, pi, rh0, rl0, rh1, rl1, m);
  __syncwarp();
  int best[2], shift[2];
  warp_best<WR>(anc, anc + nw, rh0, rl0, rh1, rl1, m, bounds[2 * pi],
                bounds[2 * pi + 1], n_shifts, best, shift);
  if ((threadIdx.x & 31) == 0)
    reinterpret_cast<int4*>(out)[pi] =
        make_int4(best[0], shift[0], best[1], shift[1]);
}

// shd_hamming_matrix: ham(s) for every shift s < n_shifts, no bounds and
// no argmin; out [P, 2, n_shifts] int32, contiguous.  What bounds it: the
// instructions as for shd_best, and the matrix written (2 * n_shifts
// words a pair against about 2 * wa + 5 * wr read).  Same layout as
// shd_best; lane b writes shift 32k + b, so a warp stores 32 consecutive
// words.
template <int WR>
__global__ void __launch_bounds__(128)
shd_hamming_matrix_kernel(const uint32_t* __restrict__ a_hi,
                          const uint32_t* __restrict__ a_lo,
                          const uint32_t* __restrict__ r_hi,
                          const uint32_t* __restrict__ r_lo,
                          const uint32_t* __restrict__ mask,
                          int32_t* __restrict__ out, int p, int wa,
                          int n_shifts) {
  extern __shared__ uint2 smem[];
  const int warp = threadIdx.x >> 5;
  const int b = threadIdx.x & 31;
  const int pi = blockIdx.x * (blockDim.x >> 5) + warp;
  if (pi >= p) return;
  const int nw = anchor_words(n_shifts, WR);
  uint2* anc = smem + static_cast<size_t>(warp) * 2 * nw;
  stage_anchor_rows(a_hi, a_lo, anc, pi, wa, nw);
  uint32_t rh0[WR], rl0[WR], rh1[WR], rl1[WR], mw[WR];
  load_read_rows<WR>(r_hi, r_lo, mask, pi, rh0, rl0, rh1, rl1, mw);
  __syncwarp();
  LaneRead<WR> r0, r1;
  uint32_t m[WR + 1];
  shift_left<WR>(rh0, b, r0.h);
  shift_left<WR>(rl0, b, r0.l);
  shift_left<WR>(rh1, b, r1.h);
  shift_left<WR>(rl1, b, r1.l);
  shift_left<WR>(mw, b, m);
  int32_t* o0 = out + static_cast<size_t>(pi) * 2 * n_shifts;
  int32_t* o1 = o0 + n_shifts;
  for (int k = 0; k < (n_shifts + 31) / 32; ++k) {
    const int s = 32 * k + b;
    const uint32_t n0 = mismatches<WR>(anc + k, r0.h, r0.l, m);
    const uint32_t n1 = mismatches<WR>(anc + nw + k, r1.h, r1.l, m);
    if (s < n_shifts) {
      o0[s] = static_cast<int32_t>(n0);
      o1[s] = static_cast<int32_t>(n1);
    }
  }
}

// Collapse modes of the fused entry (ops/shd.py: pack_read_planes and
// shd_pairs_packed_planes): orientation 0 / 1 of the read and the anchor.
enum Mode { kParity = 0, kThreeN = 1, kUndirectional = 2 };

// C(1) -> T(3) and G(2) -> A(0) on base codes
__device__ __forceinline__ int c_to_t(int c) { return c == 1 ? 3 : c; }
__device__ __forceinline__ int g_to_a(int c) { return c == 2 ? 0 : c; }

// hrm_shd_pairs_best: per pair p, read ridx[p] of bases [B, L] int8 and
// read_len [B] against the anchor of anchor_global_start[p] in the packed
// genome planes; the ShdResult (hamming, shift, orientation).
template <int WR>
__global__ void __launch_bounds__(128)
shd_pairs_best_kernel(const int8_t* __restrict__ bases,
                      const int32_t* __restrict__ read_len,
                      const int64_t* __restrict__ ridx,
                      const uint32_t* __restrict__ g_hi,
                      const uint32_t* __restrict__ g_lo,
                      const int64_t* __restrict__ gstart,
                      const int64_t* __restrict__ alen,
                      const int64_t* __restrict__ aleft,
                      const bool* __restrict__ valid,
                      int32_t* __restrict__ out_ham,
                      int32_t* __restrict__ out_shift,
                      int8_t* __restrict__ out_ori, int p, int l,
                      int g_words, int n_shifts, float max_pct, int mode) {
  extern __shared__ uint2 smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pi = blockIdx.x * (blockDim.x >> 5) + warp;
  if (pi >= p) return;
  const int nw = anchor_words(n_shifts, WR);
  uint2* anc = smem + static_cast<size_t>(warp) * 2 * nw;

  // anchor: word-aligned gather from the packed genome, indices clamped
  // to its last word; CT (hi | lo) / GA (hi & lo) collapses per mode
  const int64_t gs = gstart[pi];
  const int64_t word0 = (gs > 0 ? gs : 0) >> 5;
  const int bit0 = static_cast<int>(gs & 31);
  for (int j = lane; j < nw; j += 32) {
    const int64_t wi = word0 + j < g_words ? word0 + j : g_words - 1;
    const uint32_t hi = g_hi[wi], lo = g_lo[wi];
    const uint32_t ct = hi | lo, ga = hi & lo;
    anc[j] = make_uint2(mode == kThreeN ? ct
                        : mode == kUndirectional ? ga : hi, lo);
    anc[nw + j] = make_uint2(mode == kThreeN ? ga
                             : mode == kUndirectional ? ct : hi, lo);
  }

  // read planes: lane j holds position 32w + j; the reverse complement
  // reads base len - 1 - pos (clamped to the row); positions at or past
  // the length are zero in the planes and the mask, positions past the
  // row are code 0
  const int64_t r = ridx[pi];
  const int len = read_len[r];
  const int8_t* read = bases + r * l;
  uint32_t rh0[WR], rl0[WR], rh1[WR], rl1[WR], m[WR];
#pragma unroll
  for (int w = 0; w < WR; ++w) {
    const int pos = 32 * w + lane;
    const bool in = pos < len;
    int c0 = 0, c1 = 0;
    if (in && pos < l) {
      const int src = min(max(len - 1 - pos, 0), l - 1);
      c0 = read[pos];
      c1 = static_cast<int8_t>(3 - read[src]);
    }
    if (mode == kThreeN) {
      c0 = c_to_t(c0);
      c1 = g_to_a(c1);
    } else if (mode == kUndirectional) {
      c0 = g_to_a(c0);
      c1 = c_to_t(c1);
    }
    rh0[w] = __ballot_sync(kFull, in && ((c0 >> 1) & 1));
    rl0[w] = __ballot_sync(kFull, in && (c0 & 1));
    rh1[w] = __ballot_sync(kFull, in && ((c1 >> 1) & 1));
    rl1[w] = __ballot_sync(kFull, in && (c1 & 1));
    m[w] = __ballot_sync(kFull, in);
  }
  __syncwarp();

  // shifts bit0 .. bit0 + anchor_length - read_len in anchor-word
  // coordinates (the bounds as int32, as the plain code casts them)
  const int64_t al = alen[pi];
  const int max_s = static_cast<int>(bit0 + (al - len));
  int best[2], shift[2];
  warp_best<WR>(anc, anc + nw, rh0, rl0, rh1, rl1, m, bit0, max_s, n_shifts,
                best, shift);
  if (lane != 0) return;
  // finalize_shd_from_best: forward wins ties; NONE above
  // trunc(float32(read_len) * float32(max_hamming_percent)), for a read
  // longer than its anchor, or an invalid pair
  const bool use_rc = best[1] < best[0];
  const int b_ham = use_rc ? best[1] : best[0];
  const int b_shift = (use_rc ? shift[1] : shift[0]) - bit0;
  const bool too_long = len > al;
  const int threshold =
      static_cast<int>(__fmul_rn(static_cast<float>(len), max_pct));
  const bool good = b_ham <= threshold && !too_long && valid[pi];
  out_ori[pi] = static_cast<int8_t>(good ? (use_rc ? 2 : 1) : 3);
  out_ham[pi] = too_long ? len : b_ham;
  out_shift[pi] = too_long ? 0 : b_shift - static_cast<int32_t>(aleft[pi]);
}

// Call f(std::integral_constant<int, wr>) for wr in 1 .. kWrMax.
template <int W = 1, typename F>
int with_wr(int wr, F&& f) {
  if constexpr (W > kWrMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (wr == W) return f(std::integral_constant<int, W>{});
    return with_wr<W + 1>(wr, f);
  }
}

// Four warps (pairs) a block while their staged anchors fit the default
// 48 KB of shared memory, else one; 0 when not even one fits.
int warps_per_block(int nw) {
  const int per_warp = 2 * nw * static_cast<int>(sizeof(uint2));
  return 4 * per_warp <= kMaxSmem ? 4 : per_warp <= kMaxSmem ? 1 : 0;
}

}  // namespace

extern "C" int hrm_shd_best(const void* a_hi, const void* a_lo,
                            const void* r_hi, const void* r_lo,
                            const void* mask, const void* bounds, void* out,
                            int p, int wa, int wr, int n_shifts,
                            void* stream) {
  const int nw = anchor_words(n_shifts, wr);
  const int warps = warps_per_block(nw);
  if (wr < 1 || wr > kWrMax || n_shifts > 65536 || warps == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p == 0) return static_cast<int>(cudaGetLastError());
  return with_wr(wr, [&](auto w) {
    constexpr int WR = decltype(w)::value;
    shd_best_kernel<WR><<<(p + warps - 1) / warps, 32 * warps,
                          warps * 2 * nw * sizeof(uint2),
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a_hi), static_cast<const uint32_t*>(a_lo),
        static_cast<const uint32_t*>(r_hi), static_cast<const uint32_t*>(r_lo),
        static_cast<const uint32_t*>(mask),
        static_cast<const int32_t*>(bounds), static_cast<int32_t*>(out), p,
        wa, n_shifts);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int hrm_shd_hamming_matrix(const void* a_hi, const void* a_lo,
                                      const void* r_hi, const void* r_lo,
                                      const void* mask, void* out, int p,
                                      int wa, int wr, int n_shifts,
                                      void* stream) {
  const int nw = anchor_words(n_shifts, wr);
  const int warps = warps_per_block(nw);
  if (wr < 1 || wr > kWrMax || warps == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p == 0 || n_shifts <= 0) return static_cast<int>(cudaGetLastError());
  return with_wr(wr, [&](auto w) {
    constexpr int WR = decltype(w)::value;
    shd_hamming_matrix_kernel<WR><<<(p + warps - 1) / warps, 32 * warps,
                                    warps * 2 * nw * sizeof(uint2),
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a_hi), static_cast<const uint32_t*>(a_lo),
        static_cast<const uint32_t*>(r_hi), static_cast<const uint32_t*>(r_lo),
        static_cast<const uint32_t*>(mask), static_cast<int32_t*>(out), p, wa,
        n_shifts);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int hrm_shd_pairs_best(
    const void* bases, const void* read_len, const void* ridx,
    const void* g_hi, const void* g_lo, const void* gstart, const void* alen,
    const void* aleft, const void* valid, void* out_ham, void* out_shift,
    void* out_ori, int p, int l, int g_words, int n_shifts, float max_pct,
    int mode, void* stream) {
  const int wr = (l + 31) / 32;
  const int nw = anchor_words(n_shifts, wr);
  const int warps = warps_per_block(nw);
  if (wr < 1 || wr > kWrMax || n_shifts > 65536 || warps == 0 ||
      g_words < 1 || mode < kParity || mode > kUndirectional)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p == 0) return static_cast<int>(cudaGetLastError());
  return with_wr(wr, [&](auto w) {
    constexpr int WR = decltype(w)::value;
    shd_pairs_best_kernel<WR><<<(p + warps - 1) / warps, 32 * warps,
                                warps * 2 * nw * sizeof(uint2),
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(bases),
        static_cast<const int32_t*>(read_len),
        static_cast<const int64_t*>(ridx), static_cast<const uint32_t*>(g_hi),
        static_cast<const uint32_t*>(g_lo),
        static_cast<const int64_t*>(gstart),
        static_cast<const int64_t*>(alen), static_cast<const int64_t*>(aleft),
        static_cast<const bool*>(valid), static_cast<int32_t*>(out_ham),
        static_cast<int32_t*>(out_shift), static_cast<int8_t*>(out_ori), p, l,
        g_words, n_shifts, max_pct, mode);
    return static_cast<int>(cudaGetLastError());
  });
}
