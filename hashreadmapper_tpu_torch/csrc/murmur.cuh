// murmur64_fmix on the minhash kernels' input range, and the running
// minimum it feeds.  Included by minhash.cu and by the issue-rate probe of
// tools/int_rates.py, which times this very function.
#pragma once

#include <cstdint>

namespace hrm_murmur {

constexpr uint64_t kC1 = 0xff51afd7ed558ccdULL;
constexpr uint64_t kC2 = 0xc4ceb9fe1a85ec53ULL;

// murmur64_fmix(km + hid) from kmc1 = km * C1 and hc1 = hid * C1, for
// km, hid < 2**32, kept against a running minimum when `ok`.  In 32-bit
// words: the 64-bit add with an explicit carry (so the compiler does not
// fold it back into a wide multiply-add a hash: IMAD.WIDE issues at about
// 0.4 of IMAD's rate on the H100, tools/int_rates.py), the xor-shift,
// the second multiply with one wide product, the last xor-shift, the keep.
__device__ __forceinline__ void keep(uint64_t kmc1, uint64_t hc1, bool ok,
                                     uint64_t& best) {
  constexpr uint32_t c2_lo = static_cast<uint32_t>(kC2);
  constexpr uint32_t c2_hi = static_cast<uint32_t>(kC2 >> 32);
  uint32_t lo, hi;                    // (km + hid) * C1: the xor-shift
#ifdef __CUDA_ARCH__                  // before it is the identity here
  asm("add.cc.u32 %0, %2, %3;\n\taddc.u32 %1, %4, %5;"
      : "=r"(lo), "=r"(hi)
      : "r"(static_cast<uint32_t>(kmc1)), "r"(static_cast<uint32_t>(hc1)),
        "r"(static_cast<uint32_t>(kmc1 >> 32)),
        "r"(static_cast<uint32_t>(hc1 >> 32)));
#else
  const uint64_t sum = kmc1 + hc1;
  lo = static_cast<uint32_t>(sum);
  hi = static_cast<uint32_t>(sum >> 32);
#endif
  lo ^= hi >> 1;                      // x ^= x >> 33
  const uint64_t p = static_cast<uint64_t>(lo) * c2_lo;   // x *= C2
  const uint32_t hi3 = static_cast<uint32_t>(p >> 32) + lo * c2_hi
                       + hi * c2_lo;
  const uint64_t x = static_cast<uint64_t>(hi3) << 32
                     | (static_cast<uint32_t>(p) ^ (hi3 >> 1));   // >> 33
  best = ok && x < best ? x : best;
}

}  // namespace hrm_murmur
