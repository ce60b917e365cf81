// STEP 2's per-read rows of one coarse-mapped batch, for sm_90a
// (hrm_step2_rows): what the score passes, the traceback and the host's
// finish, rescore and records read of each read, written once.
//
// The counterpart of the JAX package's pair build (hashreadmapper_tpu/
// pipeline/engine.py::fused_step2_scores: reverse complement, window
// gather, 3N collapse, interleave, with XLA on the card) and of its host
// STEP 2's numpy build of the same rows (hashreadmapper_tpu/pipeline/
// mapping.py::_run_cssw_device: the query, its reverse complement, the
// window and the RC window, their ASCII and 3N forms).  No pallas_call
// stands behind it.
//
// A read's rows (packed row: orientation, chromosome, position, strand):
//   query  the read, reverse-complemented in place when the orientation is
//          RC (2); the RC query its reverse complement; past the read's
//          length the forward read keeps its codes and a reverse
//          complement holds code 0;
//   window the staged letters at position + i for i below wlen (ws, or the
//          rest of the chromosome), 0 past it; the RC window the complement
//          of the letter at position - i, 0 where that falls before the
//          chromosome or i is not below wlen (the host oracle's
//          pipeline/mapping.py::_window_views);
//   3N     C->T, or G->A for a read whose strand is 1 in FORWARD
//          orientation under --undirectional; the window through the
//          TRANSLATE codes 0..4 first (N and every IUPAC letter 4).
// Outputs: pair_q_t [lq, 2B] and pair_ref_t [ws, 2B] int8, the score
// passes' transposed pairs (column 2i the 3N query, 2i + 1 the 3N RC query,
// both against the read's 3N window); q, rcq [B, lq] and win, win_rc
// [B, ws] uint8 ASCII; wlen [B] int32; q3 [2B, lq] int8 (the pairs' rows);
// win3 [B, ws] int8.
//
// A block takes 32 reads, a warp a read at a time: the row-major rows go
// out as each lane's bytes (a warp's store is 32 consecutive bytes), the
// 3N codes into shared memory; then each warp writes columns of the
// transposed pairs, the 32 reads' two codes of one column a 64-byte store.
// The letter and complement tables come from the caller (align/sw.py's
// TRANSLATE, io/genome.py's complement table) into shared memory.  What
// bounds it: bytes, about 1.5 kB of rows a read written once and the
// read's codes and 2 ws letters read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;              // reads a block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Inputs {
  const int8_t* bases;          // [B, lq]
  const int32_t* read_len;      // [B]
  const int32_t* packed;        // [B, 7]
  const int64_t* offset;        // [C] letters index of a chromosome's base 0
  const int64_t* chrom_len;     // [C]
  const uint8_t* letters;       // [G]
  const int8_t* translate;      // [256]
  const uint8_t* complement;    // [256]
  int64_t g, n_chrom;
};

struct Outputs {
  int8_t* pair_q_t;
  int8_t* pair_ref_t;
  uint8_t* q;
  uint8_t* rcq;
  uint8_t* win;
  uint8_t* win_rc;
  int32_t* wlen;
  int8_t* q3;
  int8_t* win3;
};

__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

__device__ __forceinline__ uint8_t ascii(int c) {
  // the letter of a code 0..3
  c &= 3;
  return c == 0 ? 'A' : (c == 1 ? 'C' : (c == 2 ? 'G' : 'T'));
}

__device__ __forceinline__ int collapse(int c, bool ga) {
  return ga ? (c == 2 ? 0 : c) : (c == 1 ? 3 : c);
}

// Shared tiles: one 32-bit word a code (a pair's two codes in its low
// bytes), rows of an odd number of words so that the 32 reads of one
// column fall in 32 banks.
__host__ __device__ __forceinline__ int tile_stride(int n) { return n | 1; }

__global__ void __launch_bounds__(kThreads) step2_rows_kernel(
    Inputs in, Outputs out, int64_t b, int lq, int ws, bool und) {
  extern __shared__ uint32_t smem[];
  const int sq = tile_stride(lq), sw = tile_stride(ws);
  uint32_t* s_q = smem;                      // [kTile][sq]
  uint32_t* s_w = s_q + kTile * sq;          // [kTile][sw]
  auto* s_tr = reinterpret_cast<int8_t*>(s_w + kTile * sw);   // [256]
  uint8_t* s_co = reinterpret_cast<uint8_t*>(s_tr + 256);     // [256]
  for (int t = threadIdx.x; t < 256; t += kThreads) {
    s_tr[t] = in.translate[t];
    s_co[t] = in.complement[t];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int nr = static_cast<int>(b - r0 < kTile ? b - r0 : kTile);
  for (int j = warp; j < nr; j += kWarps) {
    const int64_t r = r0 + j;
    const int32_t* pk = in.packed + r * 7;
    const int ori = pk[0];
    const bool is_rc = ori == 2;
    const bool ga = und && pk[6] != 0 && ori == 1;
    const int64_t chrom = clamp_index(pk[3], in.n_chrom);
    const int64_t pos = pk[4];
    int len = in.read_len[r];
    len = len < 0 ? 0 : (len > lq ? lq : len);
    const int8_t* rd = in.bases + r * lq;
    for (int i = lane; i < lq; i += 32) {
      const int f = rd[i];
      const bool v = i < len;
      const int rcc = v ? 3 - rd[len - 1 - i] : 0;
      const int fwd = is_rc ? rcc : f;
      const int rcq = is_rc ? (v ? f : 0) : rcc;
      out.q[r * lq + i] = ascii(fwd);
      out.rcq[r * lq + i] = ascii(rcq);
      const int cf = collapse(fwd, ga), cr = collapse(rcq, ga);
      out.q3[2 * r * lq + i] = static_cast<int8_t>(cf);
      out.q3[(2 * r + 1) * lq + i] = static_cast<int8_t>(cr);
      s_q[j * sq + i] = static_cast<uint32_t>(cf & 0xff)
                        | (static_cast<uint32_t>(cr & 0xff) << 8);
    }
    const int64_t clen = in.chrom_len[chrom];
    const int wl = static_cast<int>(pos + ws < clen ? ws : clen - pos);
    if (lane == 0) out.wlen[r] = wl;
    const int64_t base = in.offset[chrom] + pos;
    for (int i = lane; i < ws; i += 32) {
      const bool v = i < wl;
      const uint8_t w = v ? in.letters[clamp_index(base + i, in.g)] : 0;
      const uint8_t wr = (v && pos - i >= 0)
          ? s_co[in.letters[clamp_index(base - i, in.g)]] : 0;
      out.win[r * ws + i] = w;
      out.win_rc[r * ws + i] = wr;
      const int c3 = collapse(s_tr[w], ga);
      out.win3[r * ws + i] = static_cast<int8_t>(c3);
      s_w[j * sw + i] = static_cast<uint32_t>(c3 & 0xff);
    }
  }
  __syncthreads();
  // the transposed pairs: column i of the tile's reads, (query, RC query)
  // and the window twice, two bytes a read
  auto* pq = reinterpret_cast<uint16_t*>(out.pair_q_t);
  auto* pr = reinterpret_cast<uint16_t*>(out.pair_ref_t);
  if (lane < nr) {
    for (int i = warp; i < lq; i += kWarps)
      pq[i * b + r0 + lane] = static_cast<uint16_t>(s_q[lane * sq + i]);
    for (int i = warp; i < ws; i += kWarps) {
      const uint32_t c = s_w[lane * sw + i];
      pr[i * b + r0 + lane] = static_cast<uint16_t>(c | (c << 8));
    }
  }
}

}  // namespace

extern "C" int hrm_step2_rows(
    const void* bases, const void* read_len, const void* packed,
    const void* offset, const void* chrom_len, const void* letters,
    const void* translate, const void* complement, void* pair_q_t,
    void* pair_ref_t, void* q, void* rcq, void* win, void* win_rc,
    void* wlen, void* q3, void* win3, long long b, long long lq,
    long long ws, long long n_chrom, long long g, int undirectional,
    void* stream) {
  if (b < 0 || lq < 1 || ws < 1 || n_chrom < 1 || g < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = sizeof(uint32_t) * kTile
                      * (tile_stride(static_cast<int>(lq))
                         + tile_stride(static_cast<int>(ws))) + 512;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        step2_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Inputs in{static_cast<const int8_t*>(bases),
                  static_cast<const int32_t*>(read_len),
                  static_cast<const int32_t*>(packed),
                  static_cast<const int64_t*>(offset),
                  static_cast<const int64_t*>(chrom_len),
                  static_cast<const uint8_t*>(letters),
                  static_cast<const int8_t*>(translate),
                  static_cast<const uint8_t*>(complement), g, n_chrom};
  const Outputs out{static_cast<int8_t*>(pair_q_t),
                    static_cast<int8_t*>(pair_ref_t),
                    static_cast<uint8_t*>(q), static_cast<uint8_t*>(rcq),
                    static_cast<uint8_t*>(win), static_cast<uint8_t*>(win_rc),
                    static_cast<int32_t*>(wlen), static_cast<int8_t*>(q3),
                    static_cast<int8_t*>(win3)};
  const int64_t blocks = (b + kTile - 1) / kTile;
  step2_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      in, out, b, static_cast<int>(lq), static_cast<int>(ws),
      undirectional != 0);
  return static_cast<int>(cudaGetLastError());
}
