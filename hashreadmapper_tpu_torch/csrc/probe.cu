// The capped CSR probe of the read batch, for sm_90a: the lookup
// (hrm_probe_lookup) and the two compactions with the value gathers
// (hrm_probe_gather).
//
// Replaces the XLA fusions of hashreadmapper_tpu/index/minhash_index.py::
// probe_tables (with _bucketed_lower_bound and the dropped-key search),
// which the port's plain version (ops/probe_kernel.py) runs as some 112
// torch operations a batch.  No pallas_call stands behind it.
//
// Lookup, one thread a (table f, query n) of the [F, N] block, flat
// index i = f * N + n: the cuckoo slot table (two slots
// mul_lo32(sig ^ seed, C) >> (32 - bits), payload off0 << 10 | cnt), or
// exactly `steps` halvings of the radix bucket's range with mid clamped to
// the row's last column, or torch.searchsorted's left-side search over the
// padded row; then max_values_per_key, the dropped-key search, sig_valid
// and (cuckoo) the SENTINEL query.  It writes counts [F, N] int64 and off0
// [F, N] int64 as the plain version computes them, and per block of 256
// probes three tallies: probes with counts > 0 (the head tier), counts >
// c1 (the tail tier), counts > probe_cap (the overflow counter).
//
// Gather, the same 256-probe blocks: each block sums the tallies of the
// blocks before it, so every probe gets its rank among the selected ones
// in flat f * N + n order (what cumsum over reshape(-1) gives), then
// writes its block's [256, probe_cap] rows of cand with consecutive
// threads on consecutive int64 (coalesced): head slots [0, c1) dense, or
// only for the first head_budget found probes; tail slots [c1, probe_cap)
// only for the first tail_budget probes with counts > c1; SENTINEL
// elsewhere.  Value reads keep the plain version's clamps (dense: the
// row's column clamped to [0, V - 1]; compacted: the flat index clamped to
// [0, F * V - 1]) and happen only where the slot is inside the probe's
// capped count.  The last block writes stats [3] int64: probes over the
// cap, tail drops max(n_big - tail_budget, 0), head drops.
//
// What bounds it: bytes, the cand write (16.8 MB at F 32, N 4096, C 16)
// and a sector for each key, payload and value read.  Budgets, caps and
// modes are launch arguments and nothing is read back, so a CUDA graph
// captures both launches.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int64_t kSentinel = 0xFFFFFFFFll;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
enum { kCuckoo = 0, kBucketed = 1, kSearchsorted = 2 };

// torch.searchsorted's left side on row[lo, hi) (cus_lower_bound)
__device__ __forceinline__ int64_t search_left(const int64_t* row, int64_t lo,
                                               int64_t hi, int64_t q) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (!(row[mid] >= q)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
probe_lookup_kernel(const int64_t* __restrict__ sigs, int64_t sig_stride,
                    const bool* __restrict__ sig_valid,
                    const int64_t* __restrict__ keys,
                    const int64_t* __restrict__ offsets,
                    const int64_t* __restrict__ num_keys, int64_t u,
                    const int64_t* __restrict__ bucket_start, int bucket_bits,
                    int steps, const int64_t* __restrict__ ck,
                    const int64_t* __restrict__ cp, int cuckoo_bits,
                    uint32_t seed1, uint32_t seed2,
                    const int64_t* __restrict__ dkeys,
                    const int64_t* __restrict__ dnum, int64_t d_cols,
                    int64_t* __restrict__ counts, int64_t* __restrict__ off0,
                    int32_t* __restrict__ tallies, int f, int n, int mode,
                    int64_t max_values_per_key, int probe_cap, int c1,
                    int nblk) {
  const int fn = f * n;   // below 2**31 (the entry point checks)
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int64_t cnt_out = 0;
  if (i < fn) {
    const int t = i / n;
    const int r = i - t * n;
    const int64_t q = sigs[r * sig_stride + t];
    bool found;
    int64_t o0, cnt;
    if (mode == kCuckoo) {
      const int64_t slots = int64_t{1} << cuckoo_bits;
      const int sh = 32 - cuckoo_bits;
      const uint32_t q32 = static_cast<uint32_t>(q);
      const int64_t p1 = static_cast<int64_t>(
          static_cast<uint64_t>((q32 ^ seed1) * 0x9E3779B1u) >> sh);
      const int64_t p2 = static_cast<int64_t>(
          static_cast<uint64_t>((q32 ^ seed2) * 0x85EBCA77u) >> sh);
      const int64_t* krow = ck + t * slots;
      const bool hit1 = krow[p1] == q;
      const bool hit2 = krow[p2] == q;
      found = (hit1 || hit2) && sig_valid[r] && q != kSentinel;
      const int64_t pay = cp[t * slots + (hit1 ? p1 : p2)];
      o0 = found ? (pay >> 10) : 0;
      cnt = pay & 1023;
    } else {
      const int64_t* krow = keys + t * u;
      int64_t idx;
      if (mode == kBucketed) {
        const int64_t nb = int64_t{1} << bucket_bits;
        const int64_t* brow = bucket_start + t * (nb + 1);
        int64_t b = static_cast<int64_t>(static_cast<uint64_t>(q) >>
                                         (32 - bucket_bits));
        b = b < nb - 1 ? b : nb - 1;   // a query below 2**32 never clamps
        int64_t lo = brow[b], hi = brow[b + 1];
        for (int s = 0; s < steps; ++s) {
          const bool active = lo < hi;
          const int64_t mid = (lo + hi) >> 1;
          const int64_t kmid = krow[mid < u - 1 ? mid : u - 1];
          const bool go_right = active && kmid < q;
          if (go_right) {
            lo = mid + 1;
          } else if (active) {
            hi = mid;
          }
        }
        idx = lo;
      } else {
        idx = search_left(krow, 0, u, q);
      }
      const int64_t idx_c = idx < u - 1 ? idx : u - 1;
      found = krow[idx_c] == q && idx < num_keys[t] && sig_valid[r];
      const int64_t* orow = offsets + t * (u + 1);
      o0 = orow[idx_c];
      cnt = orow[idx_c + 1] - o0;
      if (max_values_per_key > 0) found = found && cnt <= max_values_per_key;
    }
    if (dkeys != nullptr) {
      const int64_t* drow = dkeys + t * d_cols;
      const int64_t didx = search_left(drow, 0, d_cols, q);
      const int64_t dc = didx < d_cols - 1 ? didx : d_cols - 1;
      if (drow[dc] == q && didx < dnum[t]) found = false;
    }
    cnt_out = found ? cnt : 0;
    counts[i] = cnt_out;
    off0[i] = o0;
  }
  const int n_found = __syncthreads_count(cnt_out > 0);
  const int n_big = __syncthreads_count(cnt_out > c1);
  const int n_over = __syncthreads_count(cnt_out > probe_cap);
  if (threadIdx.x == 0) {
    tallies[blockIdx.x] = n_found;
    tallies[nblk + blockIdx.x] = n_big;
    tallies[2 * nblk + blockIdx.x] = n_over;
  }
}

// the block's sum of v (every thread gets it)
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

// the number of threads before this one in the block with flag set
__device__ __forceinline__ int block_rank(bool flag, int* warp_counts) {
  const unsigned lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  __syncthreads();
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int before = __popc(ballot & ((1u << lane) - 1u));
  for (unsigned w = 0; w < warp; ++w) before += warp_counts[w];
  return before;
}

__global__ void __launch_bounds__(kThreads)
probe_gather_kernel(const int64_t* __restrict__ counts,
                    const int64_t* __restrict__ off0,
                    const int32_t* __restrict__ tallies,
                    const int64_t* __restrict__ values, int64_t v_cols,
                    int64_t* __restrict__ cand, int64_t* __restrict__ stats,
                    int f, int n, int probe_cap, int c1,
                    int64_t tail_budget, int64_t head_budget, int nblk) {
  __shared__ int64_t scratch[kWarps];
  __shared__ int warp_counts[kWarps];
  __shared__ int64_t s_o0[kThreads];
  __shared__ int32_t s_t[kThreads];
  __shared__ int32_t s_cap[kThreads];
  __shared__ unsigned char s_sel[kThreads];  // bit 0 head, bit 1 tail
  const int64_t fn = static_cast<int64_t>(f) * n;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t i = first + threadIdx.x;
  const bool active = i < fn;
  const bool two_tier = c1 < probe_cap;
  const bool head_compact = two_tier && head_budget > 0;
  const int64_t cnt = active ? counts[i] : 0;
  const int64_t o0 = active ? off0[i] : 0;

  // ranks among the probes selected by each tier, in flat order
  int64_t pre_found = 0, pre_big = 0;
  if (two_tier) {
    for (int j = threadIdx.x; j < static_cast<int>(blockIdx.x);
         j += kThreads) {
      pre_found += tallies[j];
      pre_big += tallies[nblk + j];
    }
    pre_found = block_sum(pre_found, scratch);
    pre_big = block_sum(pre_big, scratch);
  }
  const bool is_found = cnt > 0, is_big = cnt > c1;
  const int64_t rank_found = pre_found + block_rank(is_found, warp_counts);
  const int64_t rank_big = pre_big + block_rank(is_big, warp_counts);
  const bool head_sel = is_found && rank_found < head_budget;
  const bool tail_sel = is_big && rank_big < tail_budget;
  s_o0[threadIdx.x] = o0;
  s_t[threadIdx.x] = active ? static_cast<int32_t>(i) / n : 0;
  s_cap[threadIdx.x] = static_cast<int32_t>(cnt < probe_cap ? cnt : probe_cap);
  s_sel[threadIdx.x] = static_cast<unsigned char>((head_sel ? 1 : 0) |
                                                  (tail_sel ? 2 : 0));
  __syncthreads();

  // the block's rows of cand: elements e = p * probe_cap + j, coalesced;
  // (p, j) advance by kThreads elements without a division a step
  const int n_probes = static_cast<int>(fn - first < kThreads ? fn - first
                                                              : kThreads);
  const int n_elems = n_probes * probe_cap;
  const int64_t flat_max = static_cast<int64_t>(f) * v_cols - 1;
  int64_t* out = cand + first * probe_cap;
  const int dp = kThreads / (probe_cap > 0 ? probe_cap : 1);
  const int dj = kThreads - dp * probe_cap;
  int p = probe_cap > 0 ? static_cast<int>(threadIdx.x) / probe_cap : 0;
  int j = static_cast<int>(threadIdx.x) - p * probe_cap;
  for (int e = threadIdx.x; e < n_elems; e += kThreads) {
    int64_t v = kSentinel;
    if (j < s_cap[p]) {
      const int64_t row0 = static_cast<int64_t>(s_t[p]) * v_cols;
      if (j < c1 && !head_compact) {
        // dense head: the row's column off0 + j clamped to [0, V - 1]
        int64_t col = s_o0[p] + j;
        col = col < 0 ? 0 : (col > v_cols - 1 ? v_cols - 1 : col);
        v = values[row0 + col];
      } else if (s_sel[p] & (j < c1 ? 1 : 2)) {
        // compacted tiers: the flat index clamped to [0, F * V - 1]
        int64_t g = row0 + s_o0[p] + j;
        g = g < 0 ? 0 : (g > flat_max ? flat_max : g);
        v = values[g];
      }
    }
    out[e] = v;
    p += dp;
    j += dj;
    if (j >= probe_cap) {
      j -= probe_cap;
      ++p;
    }
  }

  if (blockIdx.x == gridDim.x - 1) {
    int64_t over = 0;
    for (int j = threadIdx.x; j < nblk; j += kThreads)
      over += tallies[2 * nblk + j];
    over = block_sum(over, scratch);
    const int64_t n_found = pre_found + block_sum(is_found ? 1 : 0, scratch);
    const int64_t n_big = pre_big + block_sum(is_big ? 1 : 0, scratch);
    if (threadIdx.x == 0) {
      stats[0] = over;
      stats[1] = two_tier && n_big > tail_budget ? n_big - tail_budget : 0;
      stats[2] = head_compact && n_found > head_budget
                     ? n_found - head_budget : 0;
    }
  }
}

}  // namespace

extern "C" int hrm_probe_lookup(
    const void* sigs, long long sig_stride, const void* sig_valid,
    const void* keys, const void* offsets, const void* num_keys, long long u,
    const void* bucket_start, int bucket_bits, int steps, const void* ck,
    const void* cp, int cuckoo_bits, long long seed1, long long seed2,
    const void* dkeys, const void* dnum, long long d_cols, void* counts,
    void* off0, void* tallies, int f, int n, int mode,
    long long max_values_per_key, int probe_cap, int c1, int nblk,
    void* stream) {
  if (mode < kCuckoo || mode > kSearchsorted || f < 0 || n < 0 || nblk < 1 ||
      static_cast<long long>(f) * n >= (1LL << 31) ||
      (mode != kCuckoo && u < 1) ||
      (mode == kCuckoo && (cuckoo_bits < 0 || cuckoo_bits > 32)) ||
      (mode == kBucketed && (bucket_bits < 1 || bucket_bits > 32)) ||
      (dkeys != nullptr && d_cols < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  probe_lookup_kernel<<<nblk, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(sigs), sig_stride,
      static_cast<const bool*>(sig_valid), static_cast<const int64_t*>(keys),
      static_cast<const int64_t*>(offsets),
      static_cast<const int64_t*>(num_keys), u,
      static_cast<const int64_t*>(bucket_start), bucket_bits, steps,
      static_cast<const int64_t*>(ck), static_cast<const int64_t*>(cp),
      cuckoo_bits, static_cast<uint32_t>(seed1), static_cast<uint32_t>(seed2),
      static_cast<const int64_t*>(dkeys), static_cast<const int64_t*>(dnum),
      d_cols, static_cast<int64_t*>(counts), static_cast<int64_t*>(off0),
      static_cast<int32_t*>(tallies), f, n, mode, max_values_per_key,
      probe_cap, c1, nblk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hrm_probe_gather(const void* counts, const void* off0,
                                const void* tallies, const void* values,
                                long long v_cols, void* cand, void* stats,
                                int f, int n, int probe_cap, int c1,
                                long long tail_budget, long long head_budget,
                                int nblk, void* stream) {
  if (f < 0 || n < 0 || nblk < 1 || probe_cap < 0 || c1 < 0 ||
      c1 > probe_cap || v_cols < 1 ||
      static_cast<long long>(f) * n >= (1LL << 31) ||
      static_cast<long long>(kThreads) * probe_cap >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  probe_gather_kernel<<<nblk, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(counts), static_cast<const int64_t*>(off0),
      static_cast<const int32_t*>(tallies),
      static_cast<const int64_t*>(values), v_cols,
      static_cast<int64_t*>(cand), static_cast<int64_t*>(stats), f, n,
      probe_cap, c1, tail_budget, head_budget, nblk);
  return static_cast<int>(cudaGetLastError());
}
