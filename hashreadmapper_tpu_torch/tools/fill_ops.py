"""Instructions the fill kernel issues a cell, by the pipe they issue on,
from the SASS of csrc/bandtb.cu's own row code.  This is what the kernel
spends, scan steps, moves and shared-memory traffic included; the bound
in chip_smoke.py counts the function's own arithmetic instead
(OPS_PER_FILL_CELL and OPS_PER_FILL_CELL_EMIT), and the two are reported
side by side.

    python -m hashreadmapper_tpu_torch.tools.fill_ops

Compiles a small source that includes csrc/bandtb.cu and, for each lane
class of the fill kernel (segment width S, cells a lane K, band-relative
or absolute lanes) in score-only and emitting passes, a kernel whose one
loop is fill_unit's row without its stores to device memory: the next
row's codes from shared memory, row_score and, emitting, row_emit and
the cells' stores into the row slot in shared memory (the slot's copy to
device memory is bytes, which the bound counts apart).  Its instructions
are sorted by pipe as chip_smoke.py's bound() counts them: ALU (logic,
shifts, compares, selects, min / max), FMA (IMAD), an add on either,
shuffles, and the rest (moves, shared-memory loads and stores, branches),
which only take issue slots.  Divided by K, that is what a lane spends on
one cell of a row.  Needs nvcc and the cuobjdump beside it, no card.
"""

import collections
import os
import re
import subprocess
import sys
import tempfile

from .. import _build

# (S, K, band-relative) of fill_kernel's classes (csrc/bandtb.cu
# FillClass): 8- and 16-lane segments, band-relative lanes of 1, 2 and 4
# cells, absolute lanes of 4 and 8 cells (NL 128 and 256)
VARIANTS = ((8, 1, True), (16, 1, True), (32, 1, True), (32, 2, True),
            (32, 4, True), (32, 4, False), (32, 8, False))

SOURCE = r"""
#include "bandtb.cu"

// fill_unit's row loop without the slot's copy to device memory
template <int S, int K, bool kRel, bool kEmit>
__global__ void fill_row_probe(int rows, int m, int r, int bw, int nl,
                               int rows_f, int sf, int bstride, int* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32;
  const int sl = lane % S;
  const int8_t* rf_s = reinterpret_cast<const int8_t*>(smem) +
                       (lane / S) * sf;
  const int8_t* rd_s = rf_s + 4 * sf;
  int16_t* slot = reinterpret_cast<int16_t*>(smem + 8 * sf) +
                  (lane / S) * bstride;
  int ref[K], h[K], e[K], d2[K], jj[K], packed[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int j = sl * K + q;
    ref[q] = (!kRel && j < rows_f) ? rf_s[j] : 4;
    h[q] = e[q] = d2[q] = jj[q] = 0;
  }
  int best = 0, rd;
  row_codes<K, kRel>(rd_s, rf_s, 0, -bw, rows, rows_f, sl, rd, ref);
#pragma unroll 1
  for (int i = 0; i < rows; ++i) {
    const int o = kRel ? i - bw : 0;
    int rd_n, ref_n[K];
#pragma unroll
    for (int q = 0; q < K; ++q) ref_n[q] = ref[q];
    row_codes<K, kRel>(rd_s, rf_s, i + 1, o + 1, rows, rows_f, sl, rd_n,
                       ref_n);
    RowVals<K> w;
    row_score<S, K, kRel>(i, o, rd, ref, r, bw, nl, sl, h, e, best, w);
    if (kEmit) {
      row_emit<S, K, kRel>(i, o, r, bw, nl, sl, w, d2, jj, packed);
      if (i < m) {
#pragma unroll
        for (int q = 0; q < K; ++q)
          if (packed[q] != 0)
            slot[o + sl * K + q] = static_cast<int16_t>(packed[q]);
      }
    }
    rd = rd_n;
#pragma unroll
    for (int q = 0; q < K; ++q) ref[q] = ref_n[q];
  }
  out[threadIdx.x] = best;
}
"""

PIPES = {
    "alu": ("LOP3", "LOP", "SHF", "SHL", "SHR", "ISETP", "ICMP", "SEL",
            "FSEL", "IMNMX", "VIMNMX", "VIMNMX3", "VIADDMNMX", "PRMT",
            "PLOP3", "P2R", "R2P", "BMSK", "SGXT", "FLO", "BREV", "IABS",
            "LEA"),
    "fma": ("IMAD", "IMUL"),
    "either": ("IADD3", "IADD", "VIADD", "IADD32I"),
    "popc": ("POPC",),
    "shfl": ("SHFL",),
}
PIPE_OF = {op: pipe for pipe, ops in PIPES.items() for op in ops}

INSN = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                  r"([A-Z0-9_.]+)([^;]*);", re.M)


def kernels(sass):
    """(name, text) of each kernel of a cuobjdump -sass listing."""
    for block in re.split(r"(?=Function : )", sass):
        m = re.match(r"Function : (\w+)", block)
        if m:
            yield m.group(1), block


def row_loop(block):
    """The opcodes of the longest loop of one kernel that shuffles: from
    the target of a backward branch to the branch."""
    insns, labels, pending = [], {}, []
    for m in re.finditer(r"^(\.L_x_\d+):|" + INSN.pattern[1:], block,
                         re.M):
        if m.group(1):
            pending.append(m.group(1))
            continue
        addr = int(m.group(2), 16)
        for name in pending:
            labels[name] = addr
        pending = []
        insns.append((addr, m.group(3), m.group(4)))
    best = None
    for addr, op, rest in insns:
        if not op.startswith("BRA"):
            continue
        t = re.search(r"(\.L_x_\d+)", rest)
        target = labels.get(t.group(1)) if t else None
        if target is None:
            h = re.search(r"0x([0-9a-f]+)", rest)
            target = int(h.group(1), 16) if h else None
        if target is None or target > addr or not any(
                o.startswith("SHFL") for a_, o, _ in insns
                if target <= a_ <= addr):
            continue
        if best is None or addr - target > best[1] - best[0]:
            best = (target, addr)
    if best is None:
        raise RuntimeError("no loop in the kernel's SASS")
    return [op for addr, op, _ in insns if best[0] <= addr <= best[1]]


def by_pipe(opcodes):
    out = collections.Counter()
    for op in opcodes:
        out[PIPE_OF.get(op.split(".")[0], "other")] += 1
    return dict(out)


def main():
    nvcc = _build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(os.path.realpath(nvcc)),
                             "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "fill_ops.cu")
        with open(src, "w") as fh:
            fh.write(SOURCE)
            for s, k, rel in VARIANTS:
                for emit in ("false", "true"):
                    fh.write(f"template __global__ void fill_row_probe<{s}, "
                             f"{k}, {str(rel).lower()}, {emit}>(int, int, "
                             "int, int, int, int, int, int, int*);\n")
        cubin = os.path.join(tmp, "fill_ops.cubin")
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I", _build.CSRC_DIR,
                        "-cubin", "-o", cubin, src], check=True)
        sass = subprocess.run([cuobjdump, "-sass", cubin],
                              capture_output=True, text=True,
                              check=True).stdout
    found, cheapest = 0, {}
    for name, block in kernels(sass):
        m = re.search(r"fill_row_probeILi(\d+)ELi(\d+)ELb(\d)ELb(\d)E", name)
        if not m:
            continue
        s, k, rel, emit = (int(x) for x in m.groups())
        ops = row_loop(block)
        pipes = by_pipe(ops)
        per_cell = {p: round(n / k, 2) for p, n in sorted(pipes.items())}
        top = ", ".join(f"{op} {n}" for op, n in
                        collections.Counter(ops).most_common(12))
        print(f"S {s} K {k} {'band-relative' if rel else 'absolute'} "
              f"{'emitting' if emit else 'score only'}: row loop "
              f"{len(ops)} instructions, by pipe {dict(sorted(pipes.items()))}"
              f"; a cell {per_cell}, {sum(pipes.values()) / k:.2f} in all; "
              f"most: {top}", flush=True)
        found += 1
        total = sum(pipes.values()) / k
        if emit not in cheapest or total < cheapest[emit][0]:
            cheapest[emit] = (total, f"S {s} K {k}", per_cell)
    if found != 2 * len(VARIANTS):
        raise RuntimeError(f"found {found} probe kernels in the SASS")
    for emit, (total, where, per_cell) in sorted(cheapest.items()):
        print(f"fewest issued a cell, "
              f"{'emitting' if emit else 'score only'}: "
              f"{total:.2f} ({where}): {per_cell}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
