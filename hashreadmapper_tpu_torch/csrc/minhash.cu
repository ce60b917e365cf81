// Minhash signatures for sm_90a: the signature stage from 2-bit base codes,
// and the same minimum from precomputed k-mer words.
//
// Replaces hashreadmapper_tpu/ops/minhash_pallas.py::sigs_from_bases
// (_bases_sig_kernel) and ::sig_min_murmur (_sig_kernel).  For sequence n
// and hash id f:
//
//   sig[n, f] = low 32 bits of  min over positions p <= len - k of
//               murmur64_fmix((uint64)kmer(n, p) + hash_id[f])
//
// with the minimum taken over the full 64-bit hash, len clamped to the
// row, and 0xFFFFFFFF for a row with no valid position.  k <= 16 and
// hash ids < 2**32 (the wrappers check both).
//
// Streams.  minhash_kernel hashes one or two k-mer streams a position:
//   MODE 0 'fwd'   forward k-mers                         out [N, F]
//   MODE 1 'both'  forward, then reverse-complement k-mers out [N, 2F]
//   MODE 2 'canon' min(forward, reverse complement)      out [N, F]
//   MODE 3 'pair'  forward k-mers of C->T(x), then of G->A(x) [N, 2F]
// (mode 3 is the 3N index build's two spaces in one launch).  The signature
// stage around it (ops/minhash.py) is optional and applied in the same
// launch: the C->T or G->A collapse of the bases, the k < 16 mask and the
// SENTINEL rows of lengths < k with their validity flag, and the swap of
// the two halves (`mirror`, the PBAT spaces of --undirectional).
//
// What bounds it: issue.  A hash is integer work and the bytes are few
// (4,096 reads of 128 bases are 0.5 MB against ~11 M hashes).  The design
// cuts the instructions a hash and keeps independent chains in flight:
//  * murmur on the input's range.  x = kmer + hid < 2**33, so fmix64's
//    first `x ^= x >> 33` is the identity and x * C1 = kmer * C1 + hid * C1
//    (mod 2**64): hid * C1 is a per-thread constant, kmer * C1 is shared by
//    every hash id of the thread, and a hash is a 64-bit add, the
//    xor-shift, the second multiply (one wide product, two multiply-adds),
//    the last xor-shift and the keep-min: 13 instructions (9 ALU, 4 FMA)
//    where the full fmix64 of the first design took 19.
//  * the roll and the loads shared.  A block packs its rows once into
//    shared memory as 2-bit words (16 bases a word; forward words MSB
//    first, reverse-complement words LSB first and complemented), from
//    16-byte loads where the rows allow.  A k-mer is then one funnel shift
//    of two words (and a shift or a mask when k < 16), and a thread takes kG
//    hash ids of one row, so a position's extraction and kmer * C1 are paid
//    once for kG (2 kG with two streams) hash chains; kSplit threads share
//    the ids and take every kSplit-th group of the row, which doubles the
//    warps at the main path's 4,096 rows.
//  * compile-time control.  MODE and k == 16 are template parameters, the
//    launch's shape constants (kG, kSplit, kThreads: on a read batch's
//    4,096 rows the fastest in every mode or within 1% of it, as
//    tools/minhash_sweep.py times by building this file with others);
//    positions run in unrolled groups of 16, a position's validity one
//    compare that predicates its keeps.
// What holds it back on the H100 (tools/int_rates.py, minhash_sweep.py):
// the hash alone at full occupancy issues about 4.9 a clock a
// multiprocessor, not the 7 its 9 ALU instructions would allow (the wide
// product issues at about 0.4 of IMAD's rate); and a launch of 4,096 rows
// holds about 4 warps a scheduler, so latency and the launch's fixed cost
// (a single row takes about 6 us) stand beside the issue time.

#include <cstdint>
#include <cuda_runtime.h>

#include "murmur.cuh"

namespace {

using hrm_murmur::kC1;
using hrm_murmur::keep;

// The launch's shape: kG hash ids a thread, kSplit threads to a set of ids
// (a power of two), kThreads threads a block.
constexpr int kG = 2;
constexpr int kSplit = 2;
constexpr int kThreads = 128;
constexpr int kGroups = 8;            // 16-base groups a shared-memory chunk
constexpr int kWords = kGroups + 1;   // words a row a chunk (funnel's right)
constexpr int kMaxRows = kThreads;    // rows a block
constexpr int kChunk = 64;            // k-mer positions a chunk (murmur)
static_assert(kThreads % kSplit == 0 && (kSplit & (kSplit - 1)) == 0,
              "kSplit: a power of two that divides kThreads");

__device__ __forceinline__ void keep_all(uint32_t km, bool ok,
                                         const uint64_t (&hc1)[kG],
                                         uint64_t (&best)[kG]) {
  const uint64_t kmc1 = static_cast<uint64_t>(km) * kC1;
#pragma unroll
  for (int g = 0; g < kG; ++g) keep(kmc1, hc1[g], ok, best[g]);
}

// 4 codes (0..3, one a byte) -> 8 bits, code i at bits 2i
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  x |= x >> 6;
  x |= x >> 12;
  return x & 0xFFu;
}

// C->T (1 -> 3) and G->A (2 -> 0) on 4 codes a word
__device__ __forceinline__ uint32_t collapse_ct(uint32_t x) {
  return x | ((x & ~(x >> 1) & 0x01010101u) << 1);
}
__device__ __forceinline__ uint32_t collapse_ga(uint32_t x) {
  return x & ~(((x >> 1) & ~x & 0x01010101u) << 1);
}
__device__ __forceinline__ uint32_t collapse(uint32_t x, int c) {
  return c == 1 ? collapse_ct(x) : c == 2 ? collapse_ga(x) : x;
}

// 16 codes (4 words of 4 bytes) -> LSB-first word (code i at bits 2i)
__device__ __forceinline__ uint32_t pack16(uint32_t x0, uint32_t x1,
                                           uint32_t x2, uint32_t x3) {
  return pack4(x0) | pack4(x1) << 8 | pack4(x2) << 16 | pack4(x3) << 24;
}

// LSB-first -> MSB-first (code i at bits 30 - 2i): reverse the 2-bit groups
__device__ __forceinline__ uint32_t msb_first(uint32_t lsb) {
  const uint32_t r = __brev(lsb);
  return ((r >> 1) & 0x55555555u) | ((r & 0x55555555u) << 1);
}

// The 16 codes of bases [16 w, 16 w + 16) of a row as 4 words; positions
// at or past maxlen read as 0.
__device__ __forceinline__ void load16(const int8_t* row, int maxlen, int w,
                                       bool vec, uint32_t (&x)[4]) {
  const int p0 = 16 * w;
  if (vec) {
    if (p0 < maxlen) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + p0);
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else {
      x[0] = x[1] = x[2] = x[3] = 0;
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int p = p0 + 4 * q + b;
      if (p < maxlen) word |= static_cast<uint32_t>(
          static_cast<uint8_t>(row[p])) << (8 * b);
    }
    x[q] = word;
  }
}

// One position s of a group, kept when `ok`: the k-mers of the streams
// from the group's words (a0, a1: stream A, MSB first; b0, b1: stream B,
// LSB-first complement in modes 1-2, MSB first in mode 3), hashed kG
// times each.
template <int MODE, bool K16>
__device__ __forceinline__ void position(int s, bool ok, uint32_t a0,
                                         uint32_t a1, uint32_t b0,
                                         uint32_t b1, int kshift,
                                         uint32_t kmask,
                                         const uint64_t (&hc1)[kG],
                                         uint64_t (&best_a)[kG],
                                         uint64_t (&best_b)[kG]) {
  uint32_t ka = __funnelshift_l(a1, a0, 2 * s);
  if (!K16) ka >>= kshift;
  if (MODE == 0) {
    keep_all(ka, ok, hc1, best_a);
    return;
  }
  uint32_t kb;
  if (MODE == 3) {
    kb = __funnelshift_l(b1, b0, 2 * s);
    if (!K16) kb >>= kshift;
  } else {
    kb = __funnelshift_r(b0, b1, 2 * s);
    if (!K16) kb &= kmask;
  }
  if (MODE == 2) {
    keep_all(min(ka, kb), ok, hc1, best_a);
  } else {
    keep_all(ka, ok, hc1, best_a);
    keep_all(kb, ok, hc1, best_b);
  }
}

// The minimum of v over the kSplit neighbouring lanes that share a row
// and hash ids (mask: the warp's lanes).
__device__ __forceinline__ uint64_t min_across(uint64_t v, unsigned mask) {
#pragma unroll
  for (int d = 1; d < kSplit; d <<= 1) {
    const uint64_t o = __shfl_xor_sync(mask, v, d);
    v = o < v ? o : v;
  }
  return v;
}

// The lanes of this thread's warp that exist (the last warp may be short).
__device__ __forceinline__ unsigned warp_lanes() {
  const int lanes = static_cast<int>(blockDim.x) - (threadIdx.x & ~31);
  return lanes >= 32 ? 0xFFFFFFFFu : (1u << lanes) - 1u;
}

// A block takes `rows` rows, each with `tpr` threads: kSplit neighbouring
// threads share kG hash ids and take every kSplit-th 16-base group of the
// row, so a row's chains are spread over more warps.  The bases come in
// chunks of kGroups groups, packed cooperatively into shared memory, then
// hashed by every thread from there; the split threads' minima meet by
// warp shuffles at the end.
template <int MODE, bool K16>
__global__ void __launch_bounds__(kThreads) minhash_kernel(
    const int8_t* __restrict__ bases, const int32_t* __restrict__ lengths,
    const int64_t* __restrict__ hash_ids, int64_t* __restrict__ out,
    uint8_t* __restrict__ valid, int n, int maxlen, int k, int f, int tpr,
    int rows, int collapse_mode, int finish, int mirror, int vec) {
  constexpr bool kTwo = MODE == 1 || MODE == 3;
  constexpr bool kNeedB = MODE != 0;
  __shared__ uint32_t sa[kMaxRows * kWords];
  __shared__ uint32_t sb[kNeedB ? kMaxRows * kWords : 1];

  const int r = threadIdx.x / tpr;            // row within the block
  const int t = threadIdx.x - r * tpr;        // thread within the row
  const int part = t % kSplit;                // its share of the groups
  const int hg = t / kSplit;                  // its hash ids
  const int id_groups = tpr / kSplit;
  const unsigned lanes = warp_lanes();
  const int row = blockIdx.x * rows + r;
  const bool active = r < rows && row < n;
  const int len = active ? min(lengths[row], maxlen) : 0;
  const int last = len - k;                   // last valid position
  const int kshift = 32 - 2 * k;
  const uint32_t kmask = K16 ? 0xFFFFFFFFu : ((1u << (2 * k)) - 1u);
  // chunks of the longest row a block may hold, the same for every thread
  const int n_pos = maxlen - k + 1;
  const int n_chunks = n_pos > 0 ? (n_pos + 16 * kGroups - 1) / (16 * kGroups)
                                 : 0;
  const int n_items = rows * kWords;
  const int8_t* block_rows = bases + static_cast<size_t>(blockIdx.x) * rows
                                         * maxlen;
  const int out_cols = kTwo ? 2 * f : f;

  // every thread runs every pass and chunk: the barriers agree
  const int n_pass = (f + id_groups * kG - 1) / (id_groups * kG);
  for (int pass = 0; pass < n_pass; ++pass) {
    const int g0 = (pass * id_groups + hg) * kG;  // the thread's first id
    uint64_t hc1[kG], best_a[kG], best_b[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int fi = g0 + g;
      hc1[g] = static_cast<uint64_t>(static_cast<uint32_t>(
          fi < f ? hash_ids[fi] : 0)) * kC1;
      best_a[g] = best_b[g] = ~0ULL;
    }
    for (int c = 0; c < n_chunks; ++c) {
      __syncthreads();                        // the last chunk's readers
      for (int it = threadIdx.x; it < n_items; it += blockDim.x) {
        const int rr = it / kWords;
        const int w = it - rr * kWords;
        uint32_t x[4] = {0, 0, 0, 0};
        if (blockIdx.x * rows + rr < n)
          load16(block_rows + static_cast<size_t>(rr) * maxlen, maxlen,
                 c * kGroups + w, vec, x);
        if (MODE == 3) {
          sa[it] = msb_first(pack16(collapse_ct(x[0]), collapse_ct(x[1]),
                                    collapse_ct(x[2]), collapse_ct(x[3])));
          sb[it] = msb_first(pack16(collapse_ga(x[0]), collapse_ga(x[1]),
                                    collapse_ga(x[2]), collapse_ga(x[3])));
        } else {
          const uint32_t lsb = pack16(
              collapse(x[0], collapse_mode), collapse(x[1], collapse_mode),
              collapse(x[2], collapse_mode), collapse(x[3], collapse_mode));
          sa[it] = msb_first(lsb);
          if (kNeedB) sb[it] = ~lsb;
        }
      }
      __syncthreads();
      if (!active || g0 >= f) continue;
      const uint32_t* wa = sa + r * kWords;
      const uint32_t* wb = sb + (kNeedB ? r * kWords : 0);
      const int j_end = min(kGroups, (last >> 4) - c * kGroups + 1);
      for (int j = part; j < j_end; j += kSplit) {
        const uint32_t a0 = wa[j], a1 = wa[j + 1];
        const uint32_t b0 = kNeedB ? wb[j] : 0, b1 = kNeedB ? wb[j + 1] : 0;
        const int lim = last - 16 * (c * kGroups + j);  // >= 15: all 16
#pragma unroll
        for (int s = 0; s < 16; ++s)
          position<MODE, K16>(s, s <= lim, a0, a1, b0, b1, kshift, kmask,
                                 hc1, best_a, best_b);
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      best_a[g] = min_across(best_a[g], lanes);
      if (kTwo) best_b[g] = min_across(best_b[g], lanes);
    }
    if (!active || g0 >= f || part != 0) continue;
    // the stage's finish: k < 16 mask, SENTINEL rows, validity, mirror
    const bool row_ok = lengths[row] >= k;
    const uint32_t fmask = finish ? kmask : 0xFFFFFFFFu;
    int64_t* o = out + static_cast<size_t>(row) * out_cols;
    const int col_a = kTwo && mirror ? f : 0;
    const int col_b = kTwo && mirror ? 0 : f;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int fi = g0 + g;
      if (fi >= f) break;
      uint32_t sig_a = static_cast<uint32_t>(best_a[g]) & fmask;
      uint32_t sig_b = static_cast<uint32_t>(best_b[g]) & fmask;
      if (finish && !row_ok) sig_a = sig_b = 0xFFFFFFFFu;
      o[col_a + fi] = static_cast<int64_t>(sig_a);
      if (kTwo) o[col_b + fi] = static_cast<int64_t>(sig_b);
    }
    if (finish && g0 == 0) valid[row] = row_ok ? 1 : 0;
  }
}

// sig_min_murmur: the minimum from precomputed k-mer words.  kmer [N, P]
// elements of elem_bytes (8: int64, whose low word is read; 4: int32 or
// uint32); position p is valid iff p <= min(len, P + k - 1) - k.  No
// k-mer mask and no SENTINEL rows: the caller applies those.  A block
// stages chunks of kChunk positions of its rows' words in shared memory
// with coalesced loads (each element read once); kSplit threads share kG
// hash ids of one row and take every kSplit-th run of 8 positions.
__global__ void __launch_bounds__(kThreads) sig_min_murmur_kernel(
    const uint32_t* __restrict__ kmer, int elem_words,
    const int32_t* __restrict__ lengths, const int64_t* __restrict__ hash_ids,
    int64_t* __restrict__ out, int n, int npos, int k, int f, int tpr,
    int rows) {
  constexpr int kStride = kChunk + 1;         // no bank conflicts by row
  __shared__ uint32_t sk[kMaxRows * kStride];
  const int r = threadIdx.x / tpr;
  const int t = threadIdx.x - r * tpr;
  const int part = t % kSplit;
  const int hg = t / kSplit;
  const int id_groups = tpr / kSplit;
  const unsigned lanes = warp_lanes();
  const int row = blockIdx.x * rows + r;
  const bool active = r < rows && row < n;
  const int len = active ? min(lengths[row], npos + k - 1) : 0;
  const int last = min(len - k, npos - 1);
  const int n_chunks = (npos + kChunk - 1) / kChunk;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * rows;
  const int block_rows = min(rows, static_cast<int>(n - row0));

  const int n_pass = (f + id_groups * kG - 1) / (id_groups * kG);
  for (int pass = 0; pass < n_pass; ++pass) {
    const int g0 = (pass * id_groups + hg) * kG;
    uint64_t hc1[kG], best[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int fi = g0 + g;
      hc1[g] = static_cast<uint64_t>(static_cast<uint32_t>(
          fi < f ? hash_ids[fi] : 0)) * kC1;
      best[g] = ~0ULL;
    }
    for (int c = 0; c < n_chunks; ++c) {
      const int p_begin = c * kChunk;
      const int width = min(kChunk, npos - p_begin);
      __syncthreads();
      for (int it = threadIdx.x; it < block_rows * width; it += blockDim.x) {
        const int rr = it / width;
        const int p = it - rr * width;
        sk[rr * kStride + p] =
            kmer[((row0 + rr) * npos + p_begin + p) * elem_words];
      }
      __syncthreads();
      if (!active || g0 >= f) continue;
      const uint32_t* w = sk + r * kStride;
      const int p_end = min(width, last - p_begin + 1);
      for (int p = 8 * part; p < p_end; p += 8 * kSplit) {  // p + 7 < kChunk
#pragma unroll
        for (int s = 0; s < 8; ++s)
          keep_all(w[p + s], p + s < p_end, hc1, best);
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) best[g] = min_across(best[g], lanes);
    if (!active || g0 >= f || part != 0) continue;
    int64_t* o = out + static_cast<size_t>(row) * f;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g0 + g >= f) break;
      o[g0 + g] = static_cast<int64_t>(static_cast<uint32_t>(best[g]));
    }
  }
}

// threads a row (tpr) and rows a block for f hash ids
void geometry(int f, int* tpr, int* rows) {
  const int need = (f + kG - 1) / kG * kSplit;
  *tpr = need < kThreads ? need : kThreads;
  *rows = kThreads / *tpr;
}

template <int MODE>
cudaError_t launch_stage(const int8_t* bases, const int32_t* lengths,
                         const int64_t* hash_ids, int64_t* out,
                         uint8_t* valid, int n, int maxlen, int k, int f,
                         int collapse, int finish, int mirror,
                         cudaStream_t stream) {
  int tpr, rows;
  geometry(f, &tpr, &rows);
  const int vec = (maxlen % 16 == 0)
                  && (reinterpret_cast<uintptr_t>(bases) % 16 == 0);
  const int blocks = (n + rows - 1) / rows;
  if (k == 16)
    minhash_kernel<MODE, true><<<blocks, rows * tpr, 0, stream>>>(
        bases, lengths, hash_ids, out, valid, n, maxlen, k, f, tpr, rows,
        collapse, finish, mirror, vec);
  else
    minhash_kernel<MODE, false><<<blocks, rows * tpr, 0, stream>>>(
        bases, lengths, hash_ids, out, valid, n, maxlen, k, f, tpr, rows,
        collapse, finish, mirror, vec);
  return cudaGetLastError();
}

}  // namespace

// The signature stage.  mode 0-3 as above; collapse 0 none, 1 C->T, 2
// G->A (modes 0-2; mode 3 applies both); finish 1 writes the k < 16 mask,
// SENTINEL rows and valid [N] (uint8), 0 the raw minima of
// sigs_from_bases (valid unused); mirror swaps the two halves of modes 1
// and 3.
extern "C" int hrm_minhash_stage(const void* bases, const void* lengths,
                                 const void* hash_ids, void* out, void* valid,
                                 int n, int maxlen, int k, int f, int mode,
                                 int collapse, int finish, int mirror,
                                 void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (n < 0 || f <= 0 || maxlen < 1 || k < 1 || k > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* b = static_cast<const int8_t*>(bases);
  const auto* l = static_cast<const int32_t*>(lengths);
  const auto* h = static_cast<const int64_t*>(hash_ids);
  auto* o = static_cast<int64_t*>(out);
  auto* v = static_cast<uint8_t*>(valid);
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return static_cast<int>(launch_stage<0>(
        b, l, h, o, v, n, maxlen, k, f, collapse, finish, mirror, s));
    case 1: return static_cast<int>(launch_stage<1>(
        b, l, h, o, v, n, maxlen, k, f, collapse, finish, mirror, s));
    case 2: return static_cast<int>(launch_stage<2>(
        b, l, h, o, v, n, maxlen, k, f, collapse, finish, mirror, s));
    case 3: return static_cast<int>(launch_stage<3>(
        b, l, h, o, v, n, maxlen, k, f, collapse, finish, mirror, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int hrm_sig_min_murmur(const void* kmer, int elem_bytes,
                                  const void* lengths, const void* hash_ids,
                                  void* out, int n, int npos, int k, int f,
                                  void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (n < 0 || f <= 0 || npos < 1 || k < 1 || k > 16
      || (elem_bytes != 4 && elem_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  int tpr, rows;
  geometry(f, &tpr, &rows);
  sig_min_murmur_kernel<<<(n + rows - 1) / rows, rows * tpr, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(kmer), elem_bytes / 4,
      static_cast<const int32_t*>(lengths),
      static_cast<const int64_t*>(hash_ids), static_cast<int64_t*>(out), n,
      npos, k, f, tpr, rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hrm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
