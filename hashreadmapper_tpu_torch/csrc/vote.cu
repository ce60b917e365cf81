// Candidate vote (merge, run-length count, min-table-hits filter,
// rank compaction), for sm_90a.
//
// Replaces hashreadmapper_tpu/ops/vote_pallas.py::vote_candidates_fnc
// (_vote_kernel).  Input is the probe's native [F, N, C] layout of u32
// window ids held in int64, SENTINEL (0xFFFFFFFF) padded.  Per read n:
// the F*C ids are sorted, every distinct non-SENTINEL id counted, and ids
// seen >= min_hits times are written in ascending id order to out_cap
// slots (ids SENTINEL-padded, counts 0-padded); num_kept may exceed
// out_cap.
//
// What bounds it: shared-memory traffic of the sort.  Design: one block
// per read keeps its m = F*C ids in shared memory (m padded to a power of
// two with SENTINEL; 8 bytes each, 4 KB at the flagship m = 512 and 16 KB
// at the CLI default m = 2048) and sorts them with a block-wide bitonic
// network, so any C works and nothing returns to device memory between
// stages.  One warp then walks the sorted ids 32 at a time: run lengths by
// a forward scan (a run is at most one id per table), kept ids ranked with
// a ballot and popcount.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kSentinel = 0xFFFFFFFFULL;

__global__ void vote_kernel(const int64_t* __restrict__ cand,
                            int64_t* __restrict__ ids,
                            int32_t* __restrict__ counts,
                            int32_t* __restrict__ num_kept, int f, int n,
                            int c, int m_pad, int min_hits, int out_cap) {
  extern __shared__ unsigned long long s[];
  const int row = blockIdx.x;
  const int m = f * c;
  for (int i = threadIdx.x; i < m_pad; i += blockDim.x) {
    unsigned long long v = kSentinel;
    if (i < m) {
      const int t = i / c;
      const int j = i - t * c;
      v = static_cast<unsigned long long>(
          cand[(static_cast<size_t>(t) * n + row) * c + j]);
    }
    s[i] = v;
  }
  __syncthreads();

  for (int size = 2; size <= m_pad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < m_pad; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = s[i], b = s[j];
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
    const unsigned long long y = i < m_pad ? s[i] : kSentinel;
    const bool start = y != kSentinel && (i == 0 || s[i - 1] != y);
    int run = 0;
    if (start) {
      int j = i + 1;
      while (j < m_pad && s[j] == y) ++j;
      run = j - i;
    }
    const bool keep = start && run >= min_hits;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, keep);
    const int rank = kept + __popc(ballot & ((1u << lane) - 1u));
    if (keep && rank < out_cap) {
      out_ids[rank] = static_cast<int64_t>(y);
      out_cnt[rank] = run;
    }
    kept += __popc(ballot);
    if (__all_sync(0xFFFFFFFFu, y == kSentinel)) break;
  }
  for (int slot = kept + lane; slot < out_cap; slot += 32) {
    out_ids[slot] = static_cast<int64_t>(kSentinel);
    out_cnt[slot] = 0;
  }
  if (lane == 0) num_kept[row] = kept;
}

}  // namespace

extern "C" int hrm_vote(const void* cand, void* ids, void* counts,
                        void* num_kept, int f, int n, int c, int min_hits,
                        int out_cap, void* stream) {
  int m_pad = 1;
  while (m_pad < f * c) m_pad <<= 1;
  const size_t smem = static_cast<size_t>(m_pad) * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        vote_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n > 0) {
    vote_kernel<<<n, 256, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(cand), static_cast<int64_t*>(ids),
        static_cast<int32_t*>(counts), static_cast<int32_t*>(num_kept), f,
        n, c, m_pad, min_hits, out_cap);
  }
  return static_cast<int>(cudaGetLastError());
}
