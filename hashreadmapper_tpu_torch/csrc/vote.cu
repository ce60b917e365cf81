// Candidate vote (merge, run-length count, min-table-hits filter,
// rank compaction), for sm_90a.
//
// Replaces hashreadmapper_tpu/ops/vote_pallas.py::vote_candidates_fnc
// (_vote_kernel).  Input is the probe's native [F, N, C] layout of u32
// window ids held in int64, SENTINEL (0xFFFFFFFF) padded.  Per read n:
// the F*C ids are sorted, every distinct non-SENTINEL id counted, and ids
// seen >= min_hits times are written in ascending id order to out_cap
// slots (ids SENTINEL-padded, counts 0-padded); num_kept may exceed
// out_cap.  Lists need not be sorted and C need not be a power of two.
//
// What bounds it: the instructions of the sort (a read's ids are 4 KB in
// and under 100 bytes out).  Design, for m_pad = F*C padded to a power of
// two <= 2048: a warp owns a read and keeps its ids as u32 keys in
// registers, E = m_pad / 32 consecutive ones a lane (at the flagship F 32,
// C 16 lane t holds table t's list), read with 16-byte loads.  The bitonic
// network's stages with a stride below E are min/max pairs inside a lane,
// the others one shuffle and a select: no shared memory and no block-wide
// barrier.  The same warp then counts and compacts: run starts by
// comparing neighbours (one shuffle for the lane's first key), a run's
// length from the next start (the lane's own later starts, else a suffix
// minimum over the lanes' first starts), ranks from a prefix sum of the
// lanes' kept counts.  Four warps a block, each its own read.
//
// The wide path, m_pad > 2048 (chr1 caps: C 128 at F 32, 4,096 slots a
// read, and at F 64 under --undirectional, 8,192).  Most slots are
// SENTINEL and most ids are seen once: on chr1-3n.coarse's reads a list
// holds a median of 5 ids, a read 408 (99th percentile 1,389, largest
// 2,210 of 65,536 reads), at F 64 882 (1,823, 2,794); an id kept at
// min_hits 4 is a read's own window, seen in most lists.  So the bytes of
// the input bound it (F 32: 134 MB a 4,096-read batch, 40 us at 3.35
// TB/s), as long as the sort stays small.  A warp owns a read:
//   1. it reads the F lists once, 16-byte loads (8 in flight a lane) on
//      neighbouring addresses, and gathers the non-SENTINEL low words into
//      its row of a scratch [N, m_pad] u32 with ballots: k ids;
//   2. meanwhile it counts each id into a count-min sketch in shared
//      memory (2,048 16-bit counters a warp, 4 KB); past 32 ids, with
//      min_hits over 1, it keeps in place only the ids whose counter
//      reaches min_hits.  A counter is at least the count of every id that
//      hashes to it, so every id that can be kept stays with all its
//      copies, and the output is exact; at chr1 caps some tens of ids stay;
//   3. it sorts and counts what is left in registers at the smallest
//      width 32 * E that holds it (E up to 32: 1,024 ids, which at chr1
//      caps holds what every read keeps but about one in a million; a
//      bound on all k would have been 2,210 and 2,794 ids, 2-3x the
//      registers).  More than that (min_hits 1, or ids seen that often) is
//      a bitonic sort of the count padded to a power of two in tiles of
//      1,024: each tile's stages in registers, the stages between tiles
//      through the scratch row, and the count carried from one tile to
//      the next.
// The choice is the read's own, from its k and its sketch.  Four warps a
// block, no barrier after the first; the block adds its reads' ids and
// their tiled sorts to a tally word with one atomic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;            // reads a block of the warp kernel
constexpr int kMaxWarpMerge = 2048;  // ids a warp sorts in registers
constexpr int kWideWarps = 4;        // reads a block of the wide kernel
constexpr int kTileE = 32;           // keys a lane holds in the wide kernel
constexpr int kTile = 32 * kTileE;   // ids a warp sorts in registers
constexpr int kLoads = 8;            // 16-byte loads a lane has in flight
constexpr int kSketchBits = 11;      // a warp's sketch: 2,048 counters
constexpr int kSketch = 1 << kSketchBits;
constexpr int kSiftFrom = 32;        // ids a read has before it is sifted
constexpr int kTallyTiledShift = 40;  // tally: ids below, tiled reads above

// id i of read `row` in the [F, N, C] int64 input (low word; SENTINEL past
// the F*C real ones)
__device__ __forceinline__ uint32_t load_id(const int64_t* cand, int i, int m,
                                            int n, int c, int row) {
  if (i >= m) return kSentinel;
  const int t = i / c;
  return static_cast<uint32_t>(
      cand[(static_cast<size_t>(t) * n + row) * c + (i - t * c)]);
}

template <int E>
__global__ void __launch_bounds__(kWarps * 32)
vote_warp_kernel(const int64_t* __restrict__ cand, int64_t* __restrict__ ids,
                 int32_t* __restrict__ counts, int32_t* __restrict__ num_kept,
                 int f, int n, int c, int min_hits, int out_cap) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n) return;
  const int m = f * c;
  constexpr int kPad = 32 * E;

  // lane holds ids lane * E .. lane * E + E - 1 of the concatenated lists
  uint32_t v[E];
  if (E % 2 == 0 && c % 2 == 0 &&
      reinterpret_cast<uintptr_t>(cand) % 16 == 0) {
    // two ids a load: an even id and its successor are in one list
    int i = lane * E;
    int t = i / c;
    int j = i - t * c;
#pragma unroll
    for (int r = 0; r < E; r += 2) {
      v[r] = v[r + 1] = kSentinel;
      if (i < m) {
        const int4 w = *reinterpret_cast<const int4*>(
            cand + (static_cast<size_t>(t) * n + row) * c + j);
        v[r] = static_cast<uint32_t>(w.x);
        v[r + 1] = static_cast<uint32_t>(w.z);
      }
      i += 2;
      j += 2;
      if (j >= c) {
        j -= c;
        ++t;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r)
      v[r] = load_id(cand, lane * E + r, m, n, c, row);
  }

  // bitonic sort of the warp's 32 * E keys, key g = lane * E + r
#pragma unroll
  for (int size = 2; size <= kPad; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= E) {
        const int lane_bit = stride / E;
        const bool lower = (lane & lane_bit) == 0;
        const bool ascending = (lane & (size / E)) == 0;
        const bool keep_min = lower == ascending;
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const uint32_t o = __shfl_xor_sync(kFull, v[r], lane_bit);
          v[r] = keep_min ? min(v[r], o) : max(v[r], o);
        }
      } else {
#pragma unroll
        for (int r = 0; r < E; ++r) {
          if ((r & stride) != 0) continue;
          const uint32_t lo = min(v[r], v[r | stride]);
          const uint32_t hi = max(v[r], v[r | stride]);
          // below E the direction is the key's own bit, from E up the
          // lane's
          const bool ascending =
              size < E ? (r & size) == 0 : (lane & (size / E)) == 0;
          v[r] = ascending ? lo : hi;
          v[r | stride] = ascending ? hi : lo;
        }
      }
    }
  }

  // boundaries: a key that differs from the one before it, or SENTINEL
  const uint32_t before = __shfl_up_sync(kFull, v[E - 1], 1);
  uint64_t bound = 0, sent = 0;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const bool first = lane == 0 && r == 0;
    const uint32_t prev = r == 0 ? before : v[r - 1];
    const bool is_sent = v[r] == kSentinel;
    if (is_sent || first || v[r] != prev) bound |= 1ull << r;
    if (is_sent) sent |= 1ull << r;
  }
  // the first boundary after this lane's keys
  int next_lane = bound ? lane * E + __ffsll(static_cast<long long>(bound)) - 1
                        : kPad;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_down_sync(kFull, next_lane, d);
    if (lane + d < 32) next_lane = min(next_lane, o);
  }
  next_lane = __shfl_down_sync(kFull, next_lane, 1);
  if (lane == 31) next_lane = kPad;

  // a run's length: from its start to the next boundary
  uint64_t keep = 0;
  int next = next_lane;
#pragma unroll
  for (int r = E - 1; r >= 0; --r) {
    if (bound >> r & 1ull) {
      const int g = lane * E + r;
      if (!(sent >> r & 1ull) && next - g >= min_hits) keep |= 1ull << r;
      next = g;
    }
  }
  const int mine = __popcll(keep);
  int upto = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, upto, d);
    if (lane >= d) upto += o;
  }
  const int kept = __shfl_sync(kFull, upto, 31);

  // the same walk again, now with the ranks (from the lane's last down)
  int64_t* out_ids = ids + static_cast<size_t>(row) * out_cap;
  int32_t* out_cnt = counts + static_cast<size_t>(row) * out_cap;
  int rank = upto;
  next = next_lane;
#pragma unroll
  for (int r = E - 1; r >= 0; --r) {
    if (bound >> r & 1ull) {
      const int g = lane * E + r;
      if (keep >> r & 1ull) {
        --rank;
        if (rank < out_cap) {
          out_ids[rank] = static_cast<int64_t>(v[r]);
          out_cnt[rank] = next - g;
        }
      }
      next = g;
    }
  }
  for (int slot = kept + lane; slot < out_cap; slot += 32) {
    out_ids[slot] = static_cast<int64_t>(kSentinel);
    out_cnt[slot] = 0;
  }
  if (lane == 0) num_kept[row] = kept;
}

// ---- the wide path: m_pad > kMaxWarpMerge -------------------------------

// bitonic network over a warp's 32 * E keys in registers, key g = lane * E
// + r (vote_warp_kernel's); the last size's merge (32 * E) runs in
// direction `up`, and with merge_only it is the only one that runs
template <int E>
__device__ __forceinline__ void warp_sort(uint32_t (&v)[E], int lane, bool up,
                                          bool merge_only) {
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
    if (merge_only && size < 32 * E) continue;
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= E) {
        const int lane_bit = stride / E;
        const bool lower = (lane & lane_bit) == 0;
        const bool ascending =
            size == 32 * E ? up : (lane & (size / E)) == 0;
        const bool keep_min = lower == ascending;
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const uint32_t o = __shfl_xor_sync(kFull, v[r], lane_bit);
          v[r] = keep_min ? min(v[r], o) : max(v[r], o);
        }
      } else {
#pragma unroll
        for (int r = 0; r < E; ++r) {
          if ((r & stride) != 0) continue;
          const uint32_t lo = min(v[r], v[r | stride]);
          const uint32_t hi = max(v[r], v[r | stride]);
          const bool ascending = size < E         ? (r & size) == 0
                                 : size == 32 * E ? up
                                                  : (lane & (size / E)) == 0;
          v[r] = ascending ? lo : hi;
          v[r | stride] = ascending ? hi : lo;
        }
      }
    }
  }
}

// What a read's count carries from one tile of its sorted ids to the next.
struct RunCarry {
  uint32_t prev = kSentinel;   // the last key of the tile before
  int open = -1;               // start of the run still open there, or -1
  int kept = 0;                // runs kept so far (the next rank)
};

// Counts one tile of a read's sorted ids (ascending, SENTINEL last): key g
// = lane * E + r at index base + g.  A run starts at a key that differs
// from the one before it; a run reaching the tile's end stays open unless
// `last`, and the run open before the tile ends at its first start.  Runs
// of >= min_hits non-SENTINEL ids are written in order from rank
// c.kept into out_cap slots (vote_warp_kernel's count, with the carry).
template <int E>
__device__ __forceinline__ void warp_count(const uint32_t (&v)[E], int lane,
                                           int base, bool last, RunCarry& c,
                                           int64_t* out_ids, int32_t* out_cnt,
                                           int min_hits, int out_cap) {
  constexpr int kPad = 32 * E;
  const uint32_t up1 = __shfl_up_sync(kFull, v[E - 1], 1);
  const uint32_t before = lane == 0 ? c.prev : up1;
  uint64_t bound = 0, sent = 0;
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const bool first = base == 0 && lane == 0 && r == 0;
    const uint32_t prev = r == 0 ? before : v[r - 1];
    const bool is_sent = v[r] == kSentinel;
    if (is_sent || first || v[r] != prev) bound |= 1ull << r;
    if (is_sent) sent |= 1ull << r;
  }
  int next_lane = bound ? lane * E + __ffsll(static_cast<long long>(bound)) - 1
                        : kPad;
  int last_start =
      bound ? lane * E + 63 - __clzll(static_cast<long long>(bound)) : -1;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_down_sync(kFull, next_lane, d);
    if (lane + d < 32) next_lane = min(next_lane, o);
    last_start = max(last_start, __shfl_xor_sync(kFull, last_start, d));
  }
  const int tile_first = __shfl_sync(kFull, next_lane, 0);
  next_lane = __shfl_down_sync(kFull, next_lane, 1);
  if (lane == 31) next_lane = kPad;

  // the run open before the tile, if it ends here
  if (c.open >= 0 && (tile_first < kPad || last)) {
    const int run = base + tile_first - c.open;
    if (run >= min_hits) {
      if (lane == 0 && c.kept < out_cap) {
        out_ids[c.kept] = static_cast<int64_t>(c.prev);
        out_cnt[c.kept] = run;
      }
      ++c.kept;
    }
    c.open = -1;
  }

  uint64_t keep = 0;
  int next = next_lane;
#pragma unroll
  for (int r = E - 1; r >= 0; --r) {
    if (bound >> r & 1ull) {
      const int g = lane * E + r;
      if (!(sent >> r & 1ull) && (last || next < kPad) &&
          next - g >= min_hits)
        keep |= 1ull << r;
      next = g;
    }
  }
  int upto = __popcll(keep);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, upto, d);
    if (lane >= d) upto += o;
  }

  int rank = c.kept + upto;
  next = next_lane;
#pragma unroll
  for (int r = E - 1; r >= 0; --r) {
    if (bound >> r & 1ull) {
      const int g = lane * E + r;
      if (keep >> r & 1ull) {
        --rank;
        if (rank < out_cap) {
          out_ids[rank] = static_cast<int64_t>(v[r]);
          out_cnt[rank] = next - g;
        }
      }
      next = g;
    }
  }
  c.kept += __shfl_sync(kFull, upto, 31);
  c.prev = __shfl_sync(kFull, v[E - 1], 31);
  if (!last && c.prev != kSentinel && tile_first < kPad)
    c.open = base + last_start;   // else the open run goes on, or none
}

// SENTINEL-pads the slots past the kept runs and writes num_kept
__device__ __forceinline__ void finish_row(const RunCarry& c, int lane,
                                           int64_t* out_ids, int32_t* out_cnt,
                                           int32_t* kept_out, int out_cap) {
  for (int slot = c.kept + lane; slot < out_cap; slot += 32) {
    out_ids[slot] = static_cast<int64_t>(kSentinel);
    out_cnt[slot] = 0;
  }
  if (lane == 0) *kept_out = c.kept;
}

// k <= kTile ids at buf[0, k), in any order: sorted and counted in
// registers at the smallest width that holds them, 32 * E >= k
template <int E>
__device__ __forceinline__ void vote_registers(const uint32_t* buf, int k,
                                               int lane, int64_t* out_ids,
                                               int32_t* out_cnt,
                                               int32_t* kept_out, int min_hits,
                                               int out_cap) {
  if constexpr (E < kTileE) {
    if (k > 32 * E) {
      vote_registers<2 * E>(buf, k, lane, out_ids, out_cnt, kept_out,
                            min_hits, out_cap);
      return;
    }
  }
  uint32_t v[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int i = r * 32 + lane;
    v[r] = i < k ? __ldcg(buf + i) : kSentinel;
  }
  warp_sort<E>(v, lane, true, false);
  RunCarry c;
  warp_count<E>(v, lane, 0, true, c, out_ids, out_cnt, min_hits, out_cap);
  finish_row(c, lane, out_ids, out_cnt, kept_out, out_cap);
}

// k > kTile ids at buf[0, k): a bitonic sort of p_pad (a power of two >= k)
// keys in tiles of kTile, each tile's stages in registers and the stages
// between tiles through buf (lane l always owns the slots l mod 32: no
// exchange between lanes); the last merge counts each tile as it ends
__device__ void vote_tiles(uint32_t* buf, int k, int p_pad, int lane,
                           int64_t* out_ids, int32_t* out_cnt,
                           int32_t* kept_out, int min_hits, int out_cap) {
  const int tiles = p_pad / kTile;
  uint32_t v[kTileE];
  auto load = [&](int t, int valid) {
#pragma unroll
    for (int r = 0; r < kTileE; ++r) {
      const int i = t * kTile + r * 32 + lane;
      v[r] = i < valid ? __ldcg(buf + i) : kSentinel;
    }
  };
  auto store = [&](int t) {
#pragma unroll
    for (int r = 0; r < kTileE; ++r)
      __stcg(buf + t * kTile + r * 32 + lane, v[r]);
  };
  for (int t = 0; t < tiles; ++t) {   // sizes up to kTile, tile by tile
    load(t, k);
    warp_sort<kTileE>(v, lane, (t & 1) == 0, false);
    store(t);
  }
  RunCarry c;
  for (int size = 2 * kTile; size <= p_pad; size <<= 1) {
    for (int stride = size / 2; stride >= kTile; stride /= 2) {
      const int step = stride / kTile;
      for (int t = 0; t < tiles; ++t) {
        if (t & step) continue;
        const bool up = ((t * kTile) & size) == 0;
        uint32_t* a = buf + t * kTile + lane;
        uint32_t* b = a + stride;
#pragma unroll 8
        for (int r = 0; r < kTileE; ++r) {
          const uint32_t x = __ldcg(a + r * 32), y = __ldcg(b + r * 32);
          __stcg(a + r * 32, up ? min(x, y) : max(x, y));
          __stcg(b + r * 32, up ? max(x, y) : min(x, y));
        }
      }
    }
    for (int t = 0; t < tiles; ++t) {
      load(t, p_pad);
      warp_sort<kTileE>(v, lane, ((t * kTile) & size) == 0, true);
      if (size < p_pad)
        store(t);
      else
        warp_count<kTileE>(v, lane, t * kTile, t == tiles - 1, c, out_ids,
                           out_cnt, min_hits, out_cap);
    }
  }
  finish_row(c, lane, out_ids, out_cnt, kept_out, out_cap);
}

// A warp's count-min sketch of its read's ids: kSketch 16-bit counters,
// two a word, in shared memory; an id's slot is the top bits of a
// multiplicative hash
__device__ __forceinline__ int sketch_slot(uint32_t id) {
  return static_cast<int>((id * 0x9E3779B1u) >> (32 - kSketchBits));
}

__device__ __forceinline__ void sketch_add(uint32_t* sketch, uint32_t id) {
  const int h = sketch_slot(id);
  atomicAdd(sketch + (h >> 1), 1u << (16 * (h & 1)));
}

__device__ __forceinline__ uint32_t sketch_count(const uint32_t* sketch,
                                                 uint32_t id) {
  const int h = sketch_slot(id);
  return sketch[h >> 1] >> (16 * (h & 1)) & 0xFFFFu;
}

// A warp reads read `row`'s F lists once, V ids a load (16-byte loads for
// V 2), kLoads loads a lane in flight, and gathers the non-SENTINEL low
// words into buf with ballots, in any order.  Returns how many there are.
template <int V>
__device__ __forceinline__ int gather_ids(const int64_t* __restrict__ cand,
                                          int f, int n, int c, int row,
                                          int lane, uint32_t* buf,
                                          uint32_t* sketch) {
  const int per_list = c / V;               // loads a list
  const unsigned below = (1u << lane) - 1u;
  // a lane's loads are lane, lane + 32, ... of the read: list t, load j
  int t = 0, j = lane;
  while (t < f && j >= per_list) {
    j -= per_list;
    ++t;
  }
  int k = 0;
  while (__any_sync(kFull, t < f)) {
    uint32_t w[kLoads][V];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
#pragma unroll
      for (int x = 0; x < V; ++x) w[u][x] = kSentinel;
      if (t < f) {
        const int64_t* p =
            cand + (static_cast<size_t>(t) * n + row) * c + j * V;
        if constexpr (V == 2) {
          const int4 q = __ldcs(reinterpret_cast<const int4*>(p));
          w[u][0] = static_cast<uint32_t>(q.x);
          w[u][1] = static_cast<uint32_t>(q.z);
        } else {
          w[u][0] = static_cast<uint32_t>(
              __ldcs(reinterpret_cast<const long long*>(p)));
        }
      }
      j += 32;
      while (t < f && j >= per_list) {
        j -= per_list;
        ++t;
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
#pragma unroll
      for (int x = 0; x < V; ++x) {
        const bool ok = w[u][x] != kSentinel;
        const unsigned b = __ballot_sync(kFull, ok);
        if (ok) {
          __stcg(buf + k + __popc(b & below), w[u][x]);
          if (sketch != nullptr) sketch_add(sketch, w[u][x]);
        }
        k += __popc(b);
      }
    }
  }
  return k;
}

// Keeps, in place at buf[0, k2), the ids whose sketch count reaches
// min_hits: every id that can be kept, with all its copies (a counter is
// at least the count of each id that hashes to it).  Returns k2.  A lane
// stores at round u only below the slots of round u + 1.
__device__ __forceinline__ int sift_ids(uint32_t* buf, int k,
                                        const uint32_t* sketch, int min_hits,
                                        int lane) {
  const unsigned below = (1u << lane) - 1u;
  int k2 = 0;
  for (int base = 0; base < k; base += 32 * kLoads) {
    uint32_t w[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = base + u * 32 + lane;
      w[u] = i < k ? __ldcg(buf + i) : kSentinel;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const bool ok = w[u] != kSentinel && sketch_count(sketch, w[u]) >=
                                               static_cast<uint32_t>(min_hits);
      const unsigned b = __ballot_sync(kFull, ok);
      if (ok) __stcg(buf + k2 + __popc(b & below), w[u]);
      k2 += __popc(b);
    }
  }
  return k2;
}

// m_pad > kMaxWarpMerge: a warp a read gathers the ids there are into its
// row of scratch ([n, m_pad] u32), counting them into its sketch; past
// kSiftFrom ids (and min_hits over 1) it sifts out those that cannot be
// kept; then it sorts and counts the rest: in registers up to kTile of
// them, else in tiles.  The block adds its ids and its tiled reads to the
// tally with one atomic.
template <int V>
__global__ void __launch_bounds__(kWideWarps * 32)
vote_wide_kernel(const int64_t* __restrict__ cand, int64_t* __restrict__ ids,
                 int32_t* __restrict__ counts, int32_t* __restrict__ num_kept,
                 uint32_t* __restrict__ scratch,
                 unsigned long long* __restrict__ tally, int f, int n, int c,
                 int m_pad, int min_hits, int out_cap) {
  __shared__ uint32_t sketches[kWideWarps][kSketch / 2];
  __shared__ unsigned long long block_tally;
  __shared__ int warps_done;
  if (threadIdx.x == 0) {
    block_tally = 0;
    warps_done = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWideWarps + threadIdx.x / 32;
  unsigned long long mine = 0;
  if (row < n) {
    uint32_t* buf = scratch + static_cast<size_t>(row) * m_pad;
    uint32_t* sketch = nullptr;
    if (min_hits > 1) {
      sketch = sketches[threadIdx.x / 32];
      for (int i = lane; i < kSketch / 2; i += 32) sketch[i] = 0;
      __syncwarp();
    }
    const int k = gather_ids<V>(cand, f, n, c, row, lane, buf, sketch);
    __syncwarp();
    int left = k;
    if (sketch != nullptr && k > kSiftFrom) {
      left = sift_ids(buf, k, sketch, min_hits, lane);
      __syncwarp();
    }
    int64_t* out_ids = ids + static_cast<size_t>(row) * out_cap;
    int32_t* out_cnt = counts + static_cast<size_t>(row) * out_cap;
    if (left <= kTile) {
      vote_registers<1>(buf, left, lane, out_ids, out_cnt, num_kept + row,
                        min_hits, out_cap);
    } else {
      int p_pad = 2 * kTile;
      while (p_pad < left) p_pad <<= 1;
      vote_tiles(buf, left, p_pad, lane, out_ids, out_cnt, num_kept + row,
                 min_hits, out_cap);
    }
    mine = static_cast<unsigned long long>(k) |
           static_cast<unsigned long long>(left > kTile) << kTallyTiledShift;
  }
  if (lane == 0 && tally != nullptr) {
    atomicAdd(&block_tally, mine);
    __threadfence_block();
    if (atomicAdd(&warps_done, 1) == kWideWarps - 1) {
      const unsigned long long sum = atomicAdd(&block_tally, 0ull);
      if (sum != 0) atomicAdd(tally, sum);
    }
  }
}

template <int E>
void launch_warp(const int64_t* cand, int64_t* ids, int32_t* counts,
                 int32_t* num_kept, int f, int n, int c, int min_hits,
                 int out_cap, cudaStream_t stream) {
  const int blocks = (n + kWarps - 1) / kWarps;
  vote_warp_kernel<E><<<blocks, kWarps * 32, 0, stream>>>(
      cand, ids, counts, num_kept, f, n, c, min_hits, out_cap);
}

}  // namespace

extern "C" int hrm_vote(const void* cand_v, void* ids_v, void* counts_v,
                        void* num_kept_v, void* scratch_v, void* tally_v, int f,
                        int n, int c, int min_hits, int out_cap,
                        void* stream_v) {
  const auto* cand = static_cast<const int64_t*>(cand_v);
  auto* ids = static_cast<int64_t*>(ids_v);
  auto* counts = static_cast<int32_t*>(counts_v);
  auto* num_kept = static_cast<int32_t*>(num_kept_v);
  auto* tally = static_cast<unsigned long long*>(tally_v);
  auto stream = static_cast<cudaStream_t>(stream_v);
  int m_pad = 32;
  while (m_pad < f * c) m_pad <<= 1;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (m_pad <= kMaxWarpMerge) {
    switch (m_pad / 32) {
      case 1: launch_warp<1>(cand, ids, counts, num_kept, f, n, c, min_hits, out_cap, stream); break;
      case 2: launch_warp<2>(cand, ids, counts, num_kept, f, n, c, min_hits, out_cap, stream); break;
      case 4: launch_warp<4>(cand, ids, counts, num_kept, f, n, c, min_hits, out_cap, stream); break;
      case 8: launch_warp<8>(cand, ids, counts, num_kept, f, n, c, min_hits, out_cap, stream); break;
      case 16: launch_warp<16>(cand, ids, counts, num_kept, f, n, c, min_hits, out_cap, stream); break;
      case 32: launch_warp<32>(cand, ids, counts, num_kept, f, n, c, min_hits, out_cap, stream); break;
      default: launch_warp<64>(cand, ids, counts, num_kept, f, n, c, min_hits, out_cap, stream); break;
    }
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel = c % 2 == 0 && reinterpret_cast<uintptr_t>(cand) % 16 == 0
                    ? vote_wide_kernel<2>
                    : vote_wide_kernel<1>;
  kernel<<<(n + kWideWarps - 1) / kWideWarps, kWideWarps * 32, 0, stream>>>(
      cand, ids, counts, num_kept, static_cast<uint32_t*>(scratch_v), tally,
      f, n, c, m_pad, min_hits, out_cap);
  return static_cast<int>(cudaGetLastError());
}
