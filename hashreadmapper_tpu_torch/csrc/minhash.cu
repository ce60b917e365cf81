// Minhash signatures from 2-bit base codes, for sm_90a.
//
// Replaces hashreadmapper_tpu/ops/minhash_pallas.py::sigs_from_bases
// (_bases_sig_kernel).  For every sequence n and hash id f:
//
//   sig[n, f] = low 32 bits of  min over positions p <= len - k of
//               murmur64_fmix((uint64)kmer(n, p) + hash_id[f])
//
// with the minimum taken over the full 64-bit hash (not over low words).
// Modes: 0 'fwd' (forward k-mers, out [N, F]); 1 'both' (forward rows
// then reverse-complement-k-mer rows, out [N, 2F]); 2 'canon'
// (min(fwd, rc) k-mer, out [N, F]).  A row with no valid position gets
// 0xFFFFFFFF.  k <= 16, so a k-mer fits one 32-bit register.
//
// What bounds it: compute.  Each (sequence, hash id) runs ~len fmix64
// chains (two 64-bit multiplies each, emulated by the SM as several
// 32-bit IMADs); the bases are read once per thread from L1.  Design: one
// thread per (sequence, hash id); the k-mer and its reverse complement
// roll in registers, so a position costs one shift/or plus the hash, and
// only the [N, F] minima are written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint64_t fmix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return x;
}

__global__ void minhash_sigs_kernel(const int8_t* __restrict__ bases,
                                    const int32_t* __restrict__ lengths,
                                    const int64_t* __restrict__ hash_ids,
                                    int64_t* __restrict__ out, int n,
                                    int maxlen, int k, int f, int mode) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * f) return;
  const int row = idx / f;
  const int fi = idx - row * f;
  const int len = min(lengths[row], maxlen);
  const uint32_t hid = static_cast<uint32_t>(hash_ids[fi]);
  const uint32_t kmask = k == 16 ? 0xFFFFFFFFu : ((1u << (2 * k)) - 1u);
  const int rc_shift = 2 * (k - 1);
  const int8_t* seq = bases + static_cast<size_t>(row) * maxlen;

  uint32_t fwd = 0, rc = 0;
  uint64_t best_f = ~0ULL, best_r = ~0ULL;
  for (int i = 0; i < len; ++i) {
    const uint32_t b = static_cast<uint32_t>(seq[i]);
    fwd = ((fwd << 2) | b) & kmask;
    rc = (rc >> 2) | ((3u - b) << rc_shift);
    if (i < k - 1) continue;
    const uint32_t km = (mode == 2 && rc < fwd) ? rc : fwd;
    const uint64_t h = fmix64(static_cast<uint64_t>(km) + hid);
    if (h < best_f) best_f = h;
    if (mode == 1) {
      const uint64_t hr = fmix64(static_cast<uint64_t>(rc) + hid);
      if (hr < best_r) best_r = hr;
    }
  }
  const int rows = mode == 1 ? 2 * f : f;
  int64_t* o = out + static_cast<size_t>(row) * rows;
  o[fi] = static_cast<int64_t>(best_f & 0xFFFFFFFFULL);
  if (mode == 1) o[f + fi] = static_cast<int64_t>(best_r & 0xFFFFFFFFULL);
}

// sig_min_murmur: the same minimum from precomputed k-mer low words.
//
// Replaces hashreadmapper_tpu/ops/minhash_pallas.py::sig_min_murmur
// (_sig_kernel).  kmer_lo [N, P] holds the k-mers (k <= 16: the high word
// is zero); position p is valid iff p <= min(len, P + k - 1) - k.  No
// k-mer mask and no SENTINEL rows: the caller applies those.  One thread
// per (sequence, hash id); the F threads of a sequence read the same
// k-mer word (one broadcast load), so the kernel is bound by the hashes.
__global__ void sig_min_murmur_kernel(const uint32_t* __restrict__ kmer_lo,
                                      const int32_t* __restrict__ lengths,
                                      const int64_t* __restrict__ hash_ids,
                                      int64_t* __restrict__ out, int n,
                                      int npos, int k, int f) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * f) return;
  const int row = idx / f;
  const int fi = idx - row * f;
  const int len = min(lengths[row], npos + k - 1);
  const int last = min(len - k, npos - 1);       // last valid position
  const uint32_t hid = static_cast<uint32_t>(hash_ids[fi]);
  const uint32_t* km = kmer_lo + static_cast<size_t>(row) * npos;
  uint64_t best = ~0ULL;
  for (int p = 0; p <= last; ++p) {
    const uint64_t h = fmix64(static_cast<uint64_t>(km[p]) + hid);
    if (h < best) best = h;
  }
  out[idx] = static_cast<int64_t>(best & 0xFFFFFFFFULL);
}

}  // namespace

extern "C" int hrm_sig_min_murmur(const void* kmer_lo, const void* lengths,
                                  const void* hash_ids, void* out, int n,
                                  int npos, int k, int f, void* stream) {
  const int threads = 256;
  const int total = n * f;
  if (total > 0) {
    sig_min_murmur_kernel<<<(total + threads - 1) / threads, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(kmer_lo),
        static_cast<const int32_t*>(lengths),
        static_cast<const int64_t*>(hash_ids), static_cast<int64_t*>(out),
        n, npos, k, f);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hrm_minhash_sigs(const void* bases, const void* lengths,
                                const void* hash_ids, void* out, int n,
                                int maxlen, int k, int f, int mode,
                                void* stream) {
  const int threads = 256;
  const int total = n * f;
  if (total > 0) {
    minhash_sigs_kernel<<<(total + threads - 1) / threads, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(bases),
        static_cast<const int32_t*>(lengths),
        static_cast<const int64_t*>(hash_ids), static_cast<int64_t*>(out),
        n, maxlen, k, f, mode);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hrm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
