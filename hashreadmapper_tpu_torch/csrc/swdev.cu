// Striped byte-mode Smith-Waterman column pass, for sm_90a.
//
// Replaces hashreadmapper_tpu/ops/swdev_pallas.py::pass_batched_pallas
// (_sw_kernel), itself the lane-exact closed form of ssw.c's
// sw_sse2_byte (ssw.c:197-398): 16 uint8 SSE lanes, segLen = S rows per
// lane, striped position j + k * segLen.  Per column of the reference:
//
//   vh_in[0] = lane-shifted h[segLen-1], vh_in[j] = h[j-1]
//   a        = max(min(vh_in + score + BIAS, 255) - BIAS, 0)
//   pre[j]   = max(a, e[j]),  run[j] = max(run[j-1], pre[j] + j)
//   h_main   = max(pre[j], max(run[j-1] - GO - (j-1), 0))   (main vF loop)
//   e_new    = max(e - GE, h_main - GO, 0)
//   lazy-F   corr[k] = max_{s<k}(vf_init[s] + s*segLen) - (k-1)*segLen
//   h_fin    = max(h_main, corr - j, 0),  colmax = max over (j, k)
//
// then best / end_ref / snapshot / stopped / overflow exactly as the
// Pallas kernel does (swdev_pallas.py:161-178).  The column loop always
// runs n_cols columns; terminate and saturation only stop a pair's
// updates.  After the loop: end_read = smallest striped position holding
// best in the snapshot, capped at read_len - 1; overflowed |= best + BIAS
// >= 255 and best = 255 where overflowed (the Pallas wrapper's fix-up).
//
// What bounds it: the 128-column serial dependence in integer ALU work;
// memory traffic is one read of the pair's striped codes and one int per
// column of the reference.  Design: 16 threads per pair, thread k is SSE
// lane k and keeps its S (<= 8) H/E/snapshot values in registers; the
// lane shift of h[segLen-1] and of the lazy-F prefix are
// __shfl_up_sync(width 16), the lazy-F cummax is a 4-step shuffle scan,
// and colmax a 4-step __shfl_xor_sync max.  Nothing but the results (and
// max_column when asked) goes back to device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 16;
constexpr int kGapOpen = 3;
constexpr int kGapExtend = 1;
constexpr int kMatch = 2;
constexpr int kMismatch = 2;
constexpr int kBias = kMismatch;
constexpr int kSat = 255;
constexpr int kBig = 0x3FFFFFFF;
constexpr unsigned kFull = 0xffffffffu;

template <int S>
__global__ void sw_pass_kernel(const int32_t* __restrict__ read_at,
                               const int32_t* __restrict__ eff_len,
                               const int32_t* __restrict__ seg_len_a,
                               const int32_t* __restrict__ ref_t,
                               const int32_t* __restrict__ ref_len_a,
                               const int32_t* __restrict__ term_a,
                               int32_t* __restrict__ out,
                               int32_t* __restrict__ max_column, int p_total,
                               int n_cols, int ref_dir, int want_mc) {
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  const int p = gt / kLanes;
  const int k = threadIdx.x % kLanes;
  // both halves of a warp run every shuffle: a pair past the end computes
  // on the last pair's inputs and stores nothing
  const bool live = p < p_total;
  const int pc = live ? p : p_total - 1;
  const size_t P = static_cast<size_t>(p_total);

  const int seg = seg_len_a[pc];
  const int rlen = eff_len[pc];
  const int ref_len = ref_len_a[pc];
  const int term = term_a[pc];
  const int last_j = max(seg - 1, 0);

  int rd[S];
  bool pm[S];
  int h[S], e[S], snap[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    rd[j] = read_at[(static_cast<size_t>(j) * kLanes + k) * P + pc];
    pm[j] = j + k * seg < rlen;
    h[j] = 0;
    e[j] = 0;
    snap[j] = -1;
  }
  int best = 0, end_ref = -1;
  bool stopped = false, overflowed = false;

  for (int t = 0; t < n_cols; ++t) {
    const int rb = ref_t[static_cast<size_t>(t) * P + pc];
    const int i = ref_dir == 0 ? t : ref_len - 1 - t;
    const bool active = i >= 0 && i < ref_len && !stopped;

    int last = 0;
#pragma unroll
    for (int j = 0; j < S; ++j)
      if (j == last_j) last = h[j];
    int row0 = __shfl_up_sync(kFull, last, 1, kLanes);
    if (k == 0) row0 = 0;

    int pre[S], run[S];
    int r_prev = -kBig;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int vh = j == 0 ? row0 : h[j - 1];
      const bool match = rd[j] == rb && rb < 4;
      const int sc = pm[j] ? (match ? kMatch + kBias : -kMismatch + kBias)
                           : kBias;
      const int a = max(min(vh + sc, kSat) - kBias, 0);
      pre[j] = j < seg ? max(a, e[j]) : 0;
      r_prev = max(r_prev, pre[j] + j);
      run[j] = r_prev;
    }
    int h_main[S], e_new[S];
    int run_last = 0;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int vf = j > 0 ? max(run[j - 1] - kGapOpen - (j - 1), 0) : 0;
      h_main[j] = j < seg ? max(pre[j], vf) : 0;
      e_new[j] = j < seg ? max(max(e[j] - kGapExtend, 0),
                               max(h_main[j] - kGapOpen, 0))
                         : 0;
      if (j == last_j) run_last = max(run[j], 0);
    }
    const int vf_init = max(run_last - kGapOpen - (seg - 1), 0);
    int cmax = vf_init + k * seg;
#pragma unroll
    for (int d = 1; d < kLanes; d <<= 1) {
      const int o = __shfl_up_sync(kFull, cmax, d, kLanes);
      if (k >= d) cmax = max(cmax, o);
    }
    int prev = __shfl_up_sync(kFull, cmax, 1, kLanes);
    if (k == 0) prev = -kBig;
    const int corr = prev - (k - 1) * seg;

    int h_fin[S];
    int colmax = 0;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      h_fin[j] = j < seg ? max(h_main[j], max(corr - j, 0)) : 0;
      colmax = max(colmax, h_fin[j]);
    }
#pragma unroll
    for (int d = kLanes / 2; d > 0; d >>= 1)
      colmax = max(colmax, __shfl_xor_sync(kFull, colmax, d, kLanes));

    const bool improved = active && colmax > best;
    const bool ovf_now = improved && colmax + kBias >= kSat;
    const bool take_end = improved && !ovf_now;
    if (improved) best = colmax;
    if (take_end) end_ref = i;
    stopped = stopped || ovf_now || (active && colmax == term);
    overflowed = overflowed || ovf_now;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (take_end) snap[j] = h_fin[j];
      if (active) {
        h[j] = h_fin[j];
        e[j] = e_new[j];
      }
    }
    if (want_mc && live && k == 0)
      max_column[static_cast<size_t>(t) * P + p] = active ? colmax : 0;
  }

  int cand = kBig, rl_m1 = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int pos = j + k * seg;
    if (snap[j] == best) cand = min(cand, pos);
    if (pm[j]) rl_m1 = max(rl_m1, pos);
  }
#pragma unroll
  for (int d = kLanes / 2; d > 0; d >>= 1) {
    cand = min(cand, __shfl_xor_sync(kFull, cand, d, kLanes));
    rl_m1 = max(rl_m1, __shfl_xor_sync(kFull, rl_m1, d, kLanes));
  }
  overflowed = overflowed || best + kBias >= kSat;
  if (live && k == 0) {
    out[p] = overflowed ? kSat : best;
    out[P + p] = end_ref;
    out[2 * P + p] = min(cand, rl_m1);
    out[3 * P + p] = overflowed ? 1 : 0;
  }
}

template <int S>
void launch_sw(const int32_t* read_at, const int32_t* eff_len,
               const int32_t* seg_len, const int32_t* ref_t,
               const int32_t* ref_len, const int32_t* term, int32_t* out,
               int32_t* mc, int p, int n_cols, int ref_dir, int want_mc,
               cudaStream_t stream) {
  const int threads = 128;
  const long long total = static_cast<long long>(p) * kLanes;
  const int blocks = static_cast<int>((total + threads - 1) / threads);
  sw_pass_kernel<S><<<blocks, threads, 0, stream>>>(
      read_at, eff_len, seg_len, ref_t, ref_len, term, out, mc, p, n_cols,
      ref_dir, want_mc);
}

}  // namespace

// out: [4, p] int32 rows best, end_ref, end_read, overflowed;
// max_column: [n_cols, p] int32, written only when want_mc != 0.
extern "C" int hrm_sw_pass(const void* read_at, const void* eff_len,
                           const void* seg_len, const void* ref_t,
                           const void* ref_len, const void* terminate,
                           void* out, void* max_column, int s, int p,
                           int n_cols, int ref_dir, int want_mc,
                           void* stream) {
  if (s < 1 || s > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (p > 0) {
    const auto* ra = static_cast<const int32_t*>(read_at);
    const auto* el = static_cast<const int32_t*>(eff_len);
    const auto* sl = static_cast<const int32_t*>(seg_len);
    const auto* rt = static_cast<const int32_t*>(ref_t);
    const auto* rl = static_cast<const int32_t*>(ref_len);
    const auto* tm = static_cast<const int32_t*>(terminate);
    auto* o = static_cast<int32_t*>(out);
    auto* mc = static_cast<int32_t*>(max_column);
    auto st = static_cast<cudaStream_t>(stream);
    switch (s) {
      case 1: launch_sw<1>(ra, el, sl, rt, rl, tm, o, mc, p, n_cols, ref_dir, want_mc, st); break;
      case 2: launch_sw<2>(ra, el, sl, rt, rl, tm, o, mc, p, n_cols, ref_dir, want_mc, st); break;
      case 3: launch_sw<3>(ra, el, sl, rt, rl, tm, o, mc, p, n_cols, ref_dir, want_mc, st); break;
      case 4: launch_sw<4>(ra, el, sl, rt, rl, tm, o, mc, p, n_cols, ref_dir, want_mc, st); break;
      case 5: launch_sw<5>(ra, el, sl, rt, rl, tm, o, mc, p, n_cols, ref_dir, want_mc, st); break;
      case 6: launch_sw<6>(ra, el, sl, rt, rl, tm, o, mc, p, n_cols, ref_dir, want_mc, st); break;
      case 7: launch_sw<7>(ra, el, sl, rt, rl, tm, o, mc, p, n_cols, ref_dir, want_mc, st); break;
      default: launch_sw<8>(ra, el, sl, rt, rl, tm, o, mc, p, n_cols, ref_dir, want_mc, st); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
