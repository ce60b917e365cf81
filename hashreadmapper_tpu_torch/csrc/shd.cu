// Shifted Hamming distance, best shift per orientation, for sm_90a.
//
// Replaces hashreadmapper_tpu/ops/shd_pallas.py::shd_best
// (_shd_best_kernel).  Per pair p and orientation o (0 forward, 1 reverse
// complement), over shifts s in [min_shift, max_shift] intersected with
// [0, 32 * ceil(n_shifts / 32)):
//
//   ham(s) = sum_w popcount(((A_hi >> s)[w] ^ r_hi[w] | (A_lo >> s)[w] ^
//                            r_lo[w]) & mask[w])
//
// where A >> s is the anchor bit plane shifted right by s bits across
// words.  Strict '<' keeps the earliest best shift; the running best
// starts at 0x3FFFFFFF with shift = min_shift (what an empty range
// returns).  Output rows: (best_f, shift_f, best_r, shift_r).
//
// What bounds it: the ALU (funnel shifts and popcounts: pairs x 2 x
// shifts x wr words), with the anchor and read words read once each.
// Design: one thread per pair; for each anchor word offset the wr+1
// anchor words and the read words sit in registers, __funnelshift_r
// builds each sub-word shift and __popc counts mismatches, so nothing but
// the [P, 4] result goes back to device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWrMax = 16;          // read words (512 bp)
constexpr int kBig = 0x3FFFFFFF;

__global__ void shd_best_kernel(const uint32_t* __restrict__ a_hi,
                                const uint32_t* __restrict__ a_lo,
                                const uint32_t* __restrict__ r_hi,
                                const uint32_t* __restrict__ r_lo,
                                const uint32_t* __restrict__ mask,
                                const int32_t* __restrict__ bounds,
                                int32_t* __restrict__ out, int p, int wa,
                                int wr, int n_shifts) {
  const int pi = blockIdx.x * blockDim.x + threadIdx.x;
  if (pi >= p) return;
  const int min_s = bounds[2 * pi];
  const int max_s = bounds[2 * pi + 1];
  const int lo_s = max(min_s, 0);
  const int hi_s = min(max_s, ((n_shifts + 31) / 32) * 32 - 1);

  uint32_t m[kWrMax];
#pragma unroll
  for (int w = 0; w < kWrMax; ++w)
    m[w] = w < wr ? mask[static_cast<size_t>(pi) * wr + w] : 0u;

  for (int o = 0; o < 2; ++o) {
    const size_t row = static_cast<size_t>(pi) * 2 + o;
    uint32_t rh[kWrMax], rl[kWrMax];
#pragma unroll
    for (int w = 0; w < kWrMax; ++w) {
      rh[w] = w < wr ? r_hi[row * wr + w] : 0u;
      rl[w] = w < wr ? r_lo[row * wr + w] : 0u;
    }
    const uint32_t* ah = a_hi + row * wa;
    const uint32_t* al = a_lo + row * wa;
    int best = kBig;
    int shift = min_s;
    for (int word = lo_s >> 5; word <= (hi_s >> 5); ++word) {
      uint32_t h[kWrMax + 1], l[kWrMax + 1];
#pragma unroll
      for (int w = 0; w <= kWrMax; ++w) {
        h[w] = w <= wr ? ah[word + w] : 0u;
        l[w] = w <= wr ? al[word + w] : 0u;
      }
      const int b0 = word == (lo_s >> 5) ? (lo_s & 31) : 0;
      const int b1 = word == (hi_s >> 5) ? (hi_s & 31) : 31;
      for (int bit = b0; bit <= b1; ++bit) {
        int ham = 0;
#pragma unroll
        for (int w = 0; w < kWrMax; ++w) {
          if (w < wr) {
            const uint32_t sh = __funnelshift_r(h[w], h[w + 1], bit);
            const uint32_t sl = __funnelshift_r(l[w], l[w + 1], bit);
            ham += __popc(((sh ^ rh[w]) | (sl ^ rl[w])) & m[w]);
          }
        }
        if (ham < best) {
          best = ham;
          shift = word * 32 + bit;
        }
      }
    }
    out[static_cast<size_t>(pi) * 4 + 2 * o] = best;
    out[static_cast<size_t>(pi) * 4 + 2 * o + 1] = shift;
  }
}

// shd_hamming_matrix: ham(s) for every shift s < n_shifts, no bounds and
// no argmin.
//
// Replaces hashreadmapper_tpu/ops/shd_pallas.py::shd_hamming_matrix
// (_shd_kernel).  Output [P, 2, n_shifts] int32, contiguous.  What bounds
// it: the write of the matrix (2 * n_shifts words per pair against
// 2 * (2 * wa + 2 * wr) + wr words read).  Design: one block per pair,
// one thread per (orientation, shift), so a warp writes 32 consecutive
// shifts (coalesced) and reads the pair's few anchor and read words from
// L1; the same funnel-shift word construction as shd_best.
__global__ void shd_hamming_matrix_kernel(
    const uint32_t* __restrict__ a_hi, const uint32_t* __restrict__ a_lo,
    const uint32_t* __restrict__ r_hi, const uint32_t* __restrict__ r_lo,
    const uint32_t* __restrict__ mask, int32_t* __restrict__ out, int wa,
    int wr, int n_shifts) {
  const size_t pi = blockIdx.x;
  const uint32_t* m = mask + pi * wr;
  for (int idx = threadIdx.x; idx < 2 * n_shifts; idx += blockDim.x) {
    const int o = idx >= n_shifts;
    const int s = idx - o * n_shifts;
    const int word = s >> 5;
    const int bit = s & 31;
    const size_t row = pi * 2 + o;
    const uint32_t* ah = a_hi + row * wa + word;
    const uint32_t* al = a_lo + row * wa + word;
    const uint32_t* rh = r_hi + row * wr;
    const uint32_t* rl = r_lo + row * wr;
    int ham = 0;
    uint32_t h0 = ah[0], l0 = al[0];
    for (int w = 0; w < wr; ++w) {
      const uint32_t h1 = ah[w + 1], l1 = al[w + 1];
      const uint32_t sh = __funnelshift_r(h0, h1, bit);
      const uint32_t sl = __funnelshift_r(l0, l1, bit);
      ham += __popc(((sh ^ rh[w]) | (sl ^ rl[w])) & m[w]);
      h0 = h1;
      l0 = l1;
    }
    out[row * n_shifts + s] = ham;
  }
}

}  // namespace

extern "C" int hrm_shd_hamming_matrix(const void* a_hi, const void* a_lo,
                                      const void* r_hi, const void* r_lo,
                                      const void* mask, void* out, int p,
                                      int wa, int wr, int n_shifts,
                                      void* stream) {
  if (p > 0 && n_shifts > 0) {
    const int need = ((2 * n_shifts + 31) / 32) * 32;
    const int threads = need < 256 ? need : 256;
    shd_hamming_matrix_kernel<<<p, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a_hi), static_cast<const uint32_t*>(a_lo),
        static_cast<const uint32_t*>(r_hi), static_cast<const uint32_t*>(r_lo),
        static_cast<const uint32_t*>(mask), static_cast<int32_t*>(out), wa,
        wr, n_shifts);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hrm_shd_best(const void* a_hi, const void* a_lo,
                            const void* r_hi, const void* r_lo,
                            const void* mask, const void* bounds, void* out,
                            int p, int wa, int wr, int n_shifts,
                            void* stream) {
  if (wr > kWrMax) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  if (p > 0) {
    shd_best_kernel<<<(p + threads - 1) / threads, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a_hi), static_cast<const uint32_t*>(a_lo),
        static_cast<const uint32_t*>(r_hi), static_cast<const uint32_t*>(r_lo),
        static_cast<const uint32_t*>(mask),
        static_cast<const int32_t*>(bounds), static_cast<int32_t*>(out), p,
        wa, wr, n_shifts);
  }
  return static_cast<int>(cudaGetLastError());
}
