// The coarse mapper's pair stage around the SHD launch, for sm_90a: the
// pair compaction and window location (hrm_pair_select) and the per-read
// best with the packing of the batch's outputs (hrm_read_best).
//
// Replaces the XLA fusions of hashreadmapper_tpu/pipeline/engine.py::
// coarse_pairs_best (with extended_window_location,
// hashreadmapper_tpu/ops/shd.py) and the packing of _map_batch_impl,
// which the port's plain versions (ops/pairs_kernel.py) run as some 95
// torch operations a batch.  No pallas_call stands behind them.
//
// pair_select, from the voted ids [B, K] (u32 window ids in int64,
// SENTINEL where empty): a pair is valid where its id is not SENTINEL.
// With 0 < budget < K the valid pairs, in flat b * K + k order, fill
// B * budget slots and the rest are dropped (pair_drops); slots past the
// valid pairs take pair 0, as the plain version's zero-filled scatter
// does, and are invalid.  Each block of 256 threads takes 1,024 pairs and
// counts the valid pairs before them and in all itself (every block reads
// the at most 65,536 ids, 512 KB, from L2, two a load), so one launch
// needs no second pass: it ranks its pairs, fills its share of the slots
// past the valid pairs, and block 0 writes pair_drops.  Without
// compaction, one thread a pair.  Per slot: the read index, the window's
// position and chromosome, the extended window (computeWindowLocation:
// read_len // 2 each side, the left all or nothing) and its start in the
// staged genome: the shd_pairs_best launch's inputs as they are.
//
// read_best, one thread a read: the directional SHD result and, under
// --undirectional, the mirrored one where it is not NONE and the
// directional one is NONE or has strictly larger Hamming (strand 1); the
// compacted slots spread back to the read's K grid pairs (the read's slots
// are consecutive: a binary search finds the first); the least Hamming,
// then the earliest window id (first index on ties); packed [B, 7] int32
// (orientation, Hamming, shift, chromosome, position, window id or -1,
// strand) and ori [B, K] int8.  Block 0 also writes the overflow vector
// [5] int64: the probes' over-cap counts, reads with num_kept > K,
// pair_drops, the probes' tail and head drops (stats rows summed).
//
// What bounds them: bytes, the ids, slots and per-pair results (about
// 1 MB a flagship batch).  The budget and the window size are launch
// arguments; nothing is read back, so a CUDA graph captures both.  Ids
// are window ordinals below the number of windows (the plain version's
// index would raise on others); the kernels clamp every gather index into
// its table so that no read leaves it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int64_t kSentinel = 0xFFFFFFFFll;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPairsPerThread = 4;
constexpr int kChunk = kThreads * kPairsPerThread;
constexpr int kNone = 3;               // ops/shd.py NONE
constexpr int64_t kBig = 0x3FFFFFFF;   // pipeline/engine.py _BIG

__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

__device__ __forceinline__ int64_t block_sum(int64_t v, int64_t* scratch) {
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, static_cast<long long>(v), o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  int64_t s = 0;
  for (int w = 0; w < kWarps; ++w) s += scratch[w];
  return s;
}

struct Tables {
  const int64_t* ids;
  const int32_t* read_len;
  const int64_t* win_pos;
  const int64_t* win_chrom;
  const int64_t* chrom_offset;
  const int64_t* chrom_len;
  int64_t b, k, n_win, n_chrom, window_size;
};

struct Slots {
  int64_t* pair_sel;
  int64_t* ridx;
  int64_t* gstart;
  int64_t* length;
  int64_t* left;
  bool* valid;
};

// slot s holds grid pair i (window gwin): its read and extended window
__device__ __forceinline__ void write_slot(const Tables& t, const Slots& o,
                                           int64_t s, int64_t i, int64_t gwin,
                                           bool valid) {
  const int64_t r = clamp_index(i / t.k, t.b);
  const int64_t w = clamp_index(gwin, t.n_win);
  const int64_t pos = t.win_pos[w];
  const int64_t c = clamp_index(t.win_chrom[w], t.n_chrom);
  const int64_t clen = t.chrom_len[c];
  const int64_t ext = static_cast<int64_t>(t.read_len[r]) >> 1;
  const int64_t left = ext < pos ? ext : 0;
  const int64_t end = pos + t.window_size;
  const bool in_bounds = end <= clen;
  const int64_t right = in_bounds ? (end + ext < clen ? ext : clen - end) : 0;
  o.pair_sel[s] = i;
  o.ridx[s] = i / t.k;
  o.gstart[s] = t.chrom_offset[c] + pos - left;
  o.length[s] = t.window_size + left + right - (in_bounds ? 0 : end - clen);
  o.left[s] = left;
  o.valid[s] = valid;
}

__global__ void __launch_bounds__(kThreads)
pair_select_dense_kernel(Tables t, Slots o, int64_t* __restrict__ drops) {
  const int64_t nk = t.b * t.k;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i == 0) drops[0] = 0;
  if (i >= nk) return;
  const int64_t id = t.ids[i];
  const bool valid = id != kSentinel;
  write_slot(t, o, i, i, valid ? id : 0, valid);
}

__global__ void __launch_bounds__(kThreads)
pair_select_compact_kernel(Tables t, Slots o, int64_t budget,
                           int64_t* __restrict__ drops) {
  __shared__ int64_t scratch[kWarps];
  __shared__ int64_t warp_totals[kWarps];
  const int64_t nk = t.b * t.k;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kChunk;
  // the valid pairs before this block's chunk and in all, two ids a load
  // (every block reads them all, so every block knows the slots past the
  // valid pairs and fills its share of them)
  int64_t pre = 0, all = 0;
  const int64_t n2 = nk / 2;
  const auto* ids2 = reinterpret_cast<const longlong2*>(t.ids);
#pragma unroll 4
  for (int64_t j = threadIdx.x; j < n2; j += kThreads) {
    const longlong2 v = ids2[j];
    const int c = (v.x != kSentinel) + (v.y != kSentinel);
    all += c;
    if (2 * j < first) pre += c;
  }
  if (threadIdx.x == 0 && nk % 2) {
    const int c = t.ids[nk - 1] != kSentinel;
    all += c;
    if (nk - 1 < first) pre += c;
  }
  pre = block_sum(pre, scratch);
  const int64_t n_valid = block_sum(all, scratch);
  // this thread's pairs and their exclusive rank in the block
  const int64_t mine = first + static_cast<int64_t>(threadIdx.x) *
                                   kPairsPerThread;
  int64_t id[kPairsPerThread];
  int count = 0;
#pragma unroll
  for (int q = 0; q < kPairsPerThread; ++q) {
    id[q] = mine + q < nk ? t.ids[mine + q] : kSentinel;
    count += id[q] != kSentinel;
  }
  int64_t incl = count;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t v =
        __shfl_up_sync(0xffffffffu, static_cast<long long>(incl), d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_totals[warp] = incl;
  __syncthreads();
  int64_t rank = pre + incl - count;
  for (int w = 0; w < warp; ++w) rank += warp_totals[w];
#pragma unroll
  for (int q = 0; q < kPairsPerThread; ++q) {
    if (id[q] != kSentinel) {
      if (rank < budget) write_slot(t, o, rank, mine + q, id[q], true);
      ++rank;
    }
  }
  // the slots past the valid pairs: pair 0, invalid, spread over the blocks
  const int64_t id0 = nk > 0 ? t.ids[0] : kSentinel;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t s = (n_valid < budget ? n_valid : budget) +
                   static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       s < budget; s += stride)
    write_slot(t, o, s, 0, id0 != kSentinel ? id0 : 0, false);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    drops[0] = n_valid > budget ? n_valid - budget : 0;
}

struct Shd {
  const int32_t* ham;
  const int32_t* shift;
  const int8_t* ori;
};

struct Merged {
  int32_t ham, shift, strand;
  int8_t ori;
};

// slot s's result: the directional one, or the mirrored one where it wins
__device__ __forceinline__ Merged merged(const Shd& d, const Shd& u, bool und,
                                         int64_t s) {
  Merged m{0, 0, 0, static_cast<int8_t>(kNone)};
  if (s < 0) return m;
  m.ham = d.ham[s];
  m.shift = d.shift[s];
  m.ori = d.ori[s];
  if (und) {
    const int32_t hu = u.ham[s];
    const int8_t ou = u.ori[s];
    if (ou != kNone && (m.ori == kNone || hu < m.ham)) {
      m.ham = hu;
      m.shift = u.shift[s];
      m.ori = ou;
      m.strand = 1;
    }
  }
  return m;
}

__global__ void __launch_bounds__(kThreads)
read_best_kernel(Shd d, Shd u, bool und, const int64_t* __restrict__ pair_sel,
                 const bool* __restrict__ sel_valid, int64_t p, bool compact,
                 const int64_t* __restrict__ ids, int64_t b, int64_t k,
                 const int64_t* __restrict__ win_pos,
                 const int64_t* __restrict__ win_chrom, int64_t n_win,
                 const int64_t* __restrict__ stats, int64_t n_stats,
                 const int32_t* __restrict__ num_kept,
                 const int64_t* __restrict__ pair_drops,
                 int32_t* __restrict__ packed, int8_t* __restrict__ ori_out,
                 int64_t* __restrict__ overflow) {
  __shared__ int64_t scratch[kWarps];
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r < b) {
    const int64_t g0 = r * k;
    // the first slot whose pair is at or past this read's first
    int64_t s0 = g0;
    if (compact) {
      int64_t lo = 0, hi = p;
      while (lo < hi) {
        const int64_t mid = lo + ((hi - lo) >> 1);
        if (sel_valid[mid] && pair_sel[mid] < g0) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      s0 = lo;
    }
    // pass 1: every pair's result, the least Hamming of the good ones
    int64_t s = s0;
    int64_t min_h = kBig;
    for (int64_t q = 0; q < k; ++q) {
      int64_t slot = g0 + q;
      if (compact) {
        slot = s < p && sel_valid[s] && pair_sel[s] == g0 + q ? s++ : -1;
      }
      const Merged m = merged(d, u, und, slot);
      ori_out[g0 + q] = m.ori;
      const int64_t hm = m.ori != kNone ? m.ham : kBig;
      min_h = hm < min_h ? hm : min_h;
    }
    // pass 2: the first pair of least key (its window id where good and
    // of least Hamming, else _BIG)
    s = s0;
    int64_t best_key = 0, best_q = 0, best_slot = -1;
    for (int64_t q = 0; q < k; ++q) {
      int64_t slot = g0 + q;
      if (compact) {
        slot = s < p && sel_valid[s] && pair_sel[s] == g0 + q ? s++ : -1;
      }
      const Merged m = merged(d, u, und, slot);
      const bool good = m.ori != kNone;
      const int64_t hm = good ? m.ham : kBig;
      const int64_t id = ids[g0 + q];
      const int64_t gw = id != kSentinel ? id : 0;
      const int64_t key = good && hm == min_h ? gw : kBig;
      if (q == 0 || key < best_key) {
        best_key = key;
        best_q = q;
        best_slot = slot;
      }
    }
    bool has = false;
    for (int64_t q = 0; q < k; ++q) has = has || ori_out[g0 + q] != kNone;
    const int64_t id = k > 0 ? ids[g0 + best_q] : 0;
    const int64_t gw = id != kSentinel ? id : 0;
    const Merged m = merged(d, u, und, best_slot);
    const int64_t w = clamp_index(gw, n_win);
    int32_t* row = packed + r * 7;
    row[0] = has ? m.ori : kNone;
    row[1] = has ? m.ham : 0;
    row[2] = has ? m.shift : 0;
    row[3] = has ? static_cast<int32_t>(win_chrom[w]) : 0;
    row[4] = has ? static_cast<int32_t>(win_pos[w]) : 0;
    row[5] = has ? static_cast<int32_t>(gw) : -1;
    row[6] = has ? m.strand : 0;
  }
  if (blockIdx.x == 0) {
    int64_t over = 0;
    for (int64_t j = threadIdx.x; j < b; j += kThreads)
      over += num_kept[j] > k;
    over = block_sum(over, scratch);
    if (threadIdx.x == 0) {
      int64_t sums[3] = {0, 0, 0};
      for (int64_t j = 0; j < n_stats; ++j)
        for (int c = 0; c < 3; ++c) sums[c] += stats[j * 3 + c];
      overflow[0] = sums[0];
      overflow[1] = over;
      overflow[2] = pair_drops[0];
      overflow[3] = sums[1];
      overflow[4] = sums[2];
    }
  }
}

}  // namespace

extern "C" int hrm_pair_select(
    const void* ids, const void* read_len, const void* win_pos,
    const void* win_chrom, const void* chrom_offset, const void* chrom_len,
    void* pair_sel, void* ridx, void* gstart, void* length, void* left,
    void* valid, void* drops, long long b, long long k, long long n_win,
    long long n_chrom, long long window_size, long long budget,
    void* stream) {
  if (b < 0 || k < 1 || n_win < 1 || n_chrom < 1 || budget < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables t{static_cast<const int64_t*>(ids),
                 static_cast<const int32_t*>(read_len),
                 static_cast<const int64_t*>(win_pos),
                 static_cast<const int64_t*>(win_chrom),
                 static_cast<const int64_t*>(chrom_offset),
                 static_cast<const int64_t*>(chrom_len),
                 b, k, n_win, n_chrom, window_size};
  const Slots o{static_cast<int64_t*>(pair_sel), static_cast<int64_t*>(ridx),
                static_cast<int64_t*>(gstart), static_cast<int64_t*>(length),
                static_cast<int64_t*>(left), static_cast<bool*>(valid)};
  auto* d = static_cast<int64_t*>(drops);
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t nk = b * k;
  if (budget > 0 && budget < k) {
    const int64_t blocks = nk > 0 ? (nk + kChunk - 1) / kChunk : 1;
    pair_select_compact_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                 s>>>(t, o, b * budget, d);
  } else {
    const int64_t blocks = nk > 0 ? (nk + kThreads - 1) / kThreads : 1;
    pair_select_dense_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                               s>>>(t, o, d);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hrm_read_best(
    const void* ham, const void* shift, const void* ori, const void* ham_u,
    const void* shift_u, const void* ori_u, const void* pair_sel,
    const void* sel_valid, const void* ids, const void* win_pos,
    const void* win_chrom, const void* stats, const void* num_kept,
    const void* pair_drops, void* packed, void* ori_out, void* overflow,
    long long p, long long b, long long k, long long n_win, long long n_stats,
    void* stream) {
  if (b < 0 || k < 1 || n_win < 1 || n_stats < 0 || p < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shd d{static_cast<const int32_t*>(ham),
              static_cast<const int32_t*>(shift),
              static_cast<const int8_t*>(ori)};
  const Shd u{static_cast<const int32_t*>(ham_u),
              static_cast<const int32_t*>(shift_u),
              static_cast<const int8_t*>(ori_u)};
  const bool und = ham_u != nullptr;
  const int64_t blocks = b > 0 ? (b + kThreads - 1) / kThreads : 1;
  read_best_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      d, u, und, static_cast<const int64_t*>(pair_sel),
      static_cast<const bool*>(sel_valid), p, p != b * k,
      static_cast<const int64_t*>(ids), b, k,
      static_cast<const int64_t*>(win_pos),
      static_cast<const int64_t*>(win_chrom), n_win,
      static_cast<const int64_t*>(stats), n_stats,
      static_cast<const int32_t*>(num_kept),
      static_cast<const int64_t*>(pair_drops), static_cast<int32_t*>(packed),
      static_cast<int8_t*>(ori_out), static_cast<int64_t*>(overflow));
  return static_cast<int>(cudaGetLastError());
}
