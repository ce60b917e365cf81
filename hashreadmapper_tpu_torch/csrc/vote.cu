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
// Larger merges (up to 16384 ids) sort u32 keys in shared memory, a
// block a read, and one warp counts.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;            // reads a block of the warp kernel
constexpr int kMaxWarpMerge = 2048;  // ids a warp sorts in registers

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

// m_pad > kMaxWarpMerge: one block per read sorts in shared memory
__global__ void vote_block_kernel(const int64_t* __restrict__ cand,
                                  int64_t* __restrict__ ids,
                                  int32_t* __restrict__ counts,
                                  int32_t* __restrict__ num_kept, int f, int n,
                                  int c, int m_pad, int min_hits,
                                  int out_cap) {
  extern __shared__ uint32_t s[];
  const int row = blockIdx.x;
  const int m = f * c;
  for (int i = threadIdx.x; i < m_pad; i += blockDim.x)
    s[i] = load_id(cand, i, m, n, c, row);
  __syncthreads();

  for (int size = 2; size <= m_pad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < m_pad; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const uint32_t a = s[i], b = s[j];
          const bool ascending = (i & size) == 0;
          if ((a > b) == ascending) {
            s[i] = b;
            s[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int64_t* out_ids = ids + static_cast<size_t>(row) * out_cap;
  int32_t* out_cnt = counts + static_cast<size_t>(row) * out_cap;
  int kept = 0;
  for (int base = 0; base < m_pad; base += 32) {
    const int i = base + lane;
    const uint32_t y = i < m_pad ? s[i] : kSentinel;
    const bool start = y != kSentinel && (i == 0 || s[i - 1] != y);
    int run = 0;
    if (start) {
      int j = i + 1;
      while (j < m_pad && s[j] == y) ++j;
      run = j - i;
    }
    const bool keep = start && run >= min_hits;
    const unsigned ballot = __ballot_sync(kFull, keep);
    const int rank = kept + __popc(ballot & ((1u << lane) - 1u));
    if (keep && rank < out_cap) {
      out_ids[rank] = static_cast<int64_t>(y);
      out_cnt[rank] = run;
    }
    kept += __popc(ballot);
    if (__all_sync(kFull, y == kSentinel)) break;
  }
  for (int slot = kept + lane; slot < out_cap; slot += 32) {
    out_ids[slot] = static_cast<int64_t>(kSentinel);
    out_cnt[slot] = 0;
  }
  if (lane == 0) num_kept[row] = kept;
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
                        void* num_kept_v, int f, int n, int c, int min_hits,
                        int out_cap, void* stream_v) {
  const auto* cand = static_cast<const int64_t*>(cand_v);
  auto* ids = static_cast<int64_t*>(ids_v);
  auto* counts = static_cast<int32_t*>(counts_v);
  auto* num_kept = static_cast<int32_t*>(num_kept_v);
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
  const size_t smem = static_cast<size_t>(m_pad) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        vote_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  vote_block_kernel<<<n, 256, smem, stream>>>(cand, ids, counts, num_kept, f,
                                              n, c, m_pad, min_hits, out_cap);
  return static_cast<int>(cudaGetLastError());
}
