"""Issue rates of the integer instructions the kernels are made of, on the
card, and from them the pipes that chip_smoke.py's bounds count on.

Each loop keeps every multiprocessor full (one block of 1,024 threads an
SM, eight independent chains a thread) and is timed by clock64(); a line
gives the instructions of the loop's kind a clock an SM.  A kind alone
gives its pipe's rate (64 lanes a clock an SM is a full pipe, 16 the
popcount's); two kinds together show whether they share a pipe (their sum
stays at one kind's rate) or issue side by side (it doubles, up to the
128 lanes a clock an SM that four schedulers issue).  The SASS counts of
every loop are printed first, so one sees what was timed.

    python -m hashreadmapper_tpu_torch.tools.int_rates

Compiles its own small source with the package's nvcc flags into a
temporary directory; the minhash hash it times is csrc/murmur.cuh's, the
kernels' own.  Needs nvcc, the cuobjdump beside it and one card.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

from .. import _build
from .kernel_build_report import sass_lines

# (name, instructions of one step a thread and chain) by the kernel's MODE
MODES = (("LOP3", 1), ("IADD", 1), ("IMAD", 1), ("max (VIMNMX)", 1),
         ("s16x2 add-max (VIADDMNMX DPX)", 1), ("POPC + IADD", 2),
         ("IMAD + LOP3", 2), ("max + LOP3", 2), ("s16x2 add-max + LOP3", 2),
         ("s16x2 add-max + IMAD", 2), ("max + IMAD", 2),
         ("IMAD.WIDE (64-bit accumulate)", 1), ("IMAD.WIDE + LOP3", 2),
         ("csrc/murmur.cuh's hash and keep (hashes, not instructions)", 1),
         ("IMAD.HI", 1), ("SHFL (xor)", 1), ("SHFL + max", 2))

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

#include "murmur.cuh"

template <int MODE>
__global__ void rate_kernel(uint32_t* out, long long* cycles, int iters,
                            uint32_t a, uint32_t b) {
  uint32_t x[8], y[8];
  uint64_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    x[i] = a * (threadIdx.x + 1) + i;
    y[i] = b * (threadIdx.x + 3) + i;
    w[i] = ~0ULL;
  }
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = (i + 1) & 7;
      if (MODE == 0 || MODE == 6 || MODE == 7 || MODE == 8)
        y[i] = (y[i] ^ a) & (y[i] | b);          // LOP3, three registers
      if (MODE == 1) x[i] += x[j];                             // IADD
      if (MODE == 2 || MODE == 6 || MODE == 9 || MODE == 10)
        x[i] = x[i] * a + b;                                   // IMAD
      if (MODE == 3 || MODE == 7)
        x[i] = static_cast<uint32_t>(max(static_cast<int>(x[i]),
                                         static_cast<int>(x[j])));
      if (MODE == 10)
        y[i] = static_cast<uint32_t>(max(static_cast<int>(y[i]),
                                         static_cast<int>(y[j])));
      if (MODE == 4 || MODE == 8)
        x[i] = __viaddmax_s16x2(x[i], a, x[j]);                // DPX
      if (MODE == 9) y[i] = __viaddmax_s16x2(y[i], a, y[j]);
      if (MODE == 5) x[i] += __popc(x[i]);
      if (MODE == 11 || MODE == 12)                      // IMAD.WIDE.U32
        w[i] = static_cast<uint64_t>(static_cast<uint32_t>(w[i] >> 32)) * a
               + w[i];
      if (MODE == 12) y[i] = (y[i] ^ a) & (y[i] | b);
      if (MODE == 13) {
        // csrc/murmur.cuh's keep() on k-mer x[i] and hash id b, with
        // x[i] * C1 a hash (the kernel shares it by the ids of a k-mer)
        hrm_murmur::keep(static_cast<uint64_t>(x[i]) * hrm_murmur::kC1,
                         static_cast<uint64_t>(b) * hrm_murmur::kC1, true,
                         w[i]);
        x[i] += a;
      }
      if (MODE == 14) x[i] = __umulhi(x[i], a) + x[j];     // IMAD.HI
      if (MODE == 15 || MODE == 16)                              // SHFL
        x[i] = __shfl_xor_sync(0xffffffffu, x[i], (i & 3) + 1);
      if (MODE == 16)
        y[i] = static_cast<uint32_t>(max(static_cast<int>(y[i]),
                                         static_cast<int>(y[j])));
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    s += x[i] ^ y[i] ^ static_cast<uint32_t>(w[i]) ^ (w[i] >> 32);
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

template <int MODE>
static void run(uint32_t* o, long long* c, int blocks, int iters) {
  rate_kernel<MODE><<<blocks, 1024>>>(o, c, iters, 1664525u, 1013904223u);
}

extern "C" int hrm_rate(int mode, void* out, void* cycles, int blocks,
                        int iters) {
  auto o = static_cast<uint32_t*>(out);
  auto c = static_cast<long long*>(cycles);
  switch (mode) {
    case 0: run<0>(o, c, blocks, iters); break;
    case 1: run<1>(o, c, blocks, iters); break;
    case 2: run<2>(o, c, blocks, iters); break;
    case 3: run<3>(o, c, blocks, iters); break;
    case 4: run<4>(o, c, blocks, iters); break;
    case 5: run<5>(o, c, blocks, iters); break;
    case 6: run<6>(o, c, blocks, iters); break;
    case 7: run<7>(o, c, blocks, iters); break;
    case 8: run<8>(o, c, blocks, iters); break;
    case 9: run<9>(o, c, blocks, iters); break;
    case 10: run<10>(o, c, blocks, iters); break;
    case 11: run<11>(o, c, blocks, iters); break;
    case 12: run<12>(o, c, blocks, iters); break;
    case 13: run<13>(o, c, blocks, iters); break;
    case 14: run<14>(o, c, blocks, iters); break;
    case 15: run<15>(o, c, blocks, iters); break;
    case 16: run<16>(o, c, blocks, iters); break;
    default: return -1;
  }
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def main():
    nvcc = _build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(os.path.realpath(nvcc)),
                             "cuobjdump")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "rates.cu")
        with open(src, "w") as fh:
            fh.write(SOURCE)
        lib_path = os.path.join(tmp, "librates.so")
        inc = ("-I", _build.CSRC_DIR)          # csrc/murmur.cuh
        subprocess.run([nvcc, *_build.NVCC_FLAGS, *inc, "-shared", "-o",
                        lib_path, src], check=True)
        cubin = os.path.join(tmp, "rates.cubin")
        subprocess.run([nvcc, *_build.NVCC_FLAGS, *inc, "-cubin", "-o", cubin,
                        src], check=True)
        if os.path.exists(cuobjdump):
            sass = subprocess.run([cuobjdump, "-sass", cubin],
                                  capture_output=True, text=True,
                                  check=True).stdout
            print("\n".join(sass_lines(sass, ["rate_kernel"])))
        lib = ctypes.CDLL(lib_path)
        lib.hrm_rate.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        out = torch.empty(sms * 1024, dtype=torch.int32, device="cuda")
        cycles = torch.empty(sms, dtype=torch.int64, device="cuda")
        iters = 4096
        for mode, (name, per_step) in enumerate(MODES):
            for _ in range(2):                 # the first call warms up
                rc = lib.hrm_rate(mode, out.data_ptr(), cycles.data_ptr(),
                                  sms, iters)
                if rc != 0:
                    raise RuntimeError(f"hrm_rate: CUDA error {rc}")
            lanes = 1024 * iters * 8 * per_step
            cyc = cycles.to(torch.float64)
            print(f"{name}: {lanes / cyc.median().item():.3f} instructions a "
                  f"clock a multiprocessor (median over {sms} blocks, one a "
                  f"multiprocessor; {lanes / cyc.max().item():.3f} for the "
                  f"slowest), {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
