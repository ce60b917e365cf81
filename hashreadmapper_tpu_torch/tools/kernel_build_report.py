"""What the compiler made of the CUDA kernels: registers, spills and shared
memory of every kernel (`nvcc -Xptxas -v`), and for the kernels whose name
contains one of the given words the count of each SASS instruction
(`cuobjdump -sass`), so that one can see whether the s16x2 intrinsics of
csrc/swdev.cu came out as Hopper's VIMNMX / VIADDMNMX instructions or as
emulation sequences.

    python -m hashreadmapper_tpu_torch.tools.kernel_build_report sw_kernel vote

Compiles every csrc/*.cu with the package's flags into a temporary
directory of its own; the library that the package loads is not touched.
Needs nvcc and the cuobjdump beside it (the CUDA toolkit), no card.
"""

import collections
import os
import re
import shutil
import subprocess
import sys
import tempfile

from .. import _build


def ptxas_lines(log: str):
    """ptxas' resource and spill lines, each under its kernel's name."""
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif "Used" in line and name:
            yield f"{name}: {line.split(':', 1)[1].strip()}"
        elif "spill" in line and name:
            yield f"{name}: {line.strip()}"


def sass_lines(sass: str, words):
    """Instruction counts of the kernels whose name holds one of `words`."""
    for block in re.split(r"(?=Function : )", sass):
        m = re.match(r"Function : (\w+)", block)
        if not m or not any(w in m.group(1) for w in words):
            continue
        counts = collections.Counter(re.findall(
            r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d\s+)?([A-Za-z0-9_.]+)",
            block, re.M))
        top = ", ".join(f"{op} {n}" for op, n in counts.most_common(14))
        dpx = {op: n for op, n in counts.items() if op.startswith("VI")}
        yield (f"{m.group(1)}: {sum(counts.values())} instructions; "
               f"VI*: {dpx}; most: {top}")


def main(words):
    nvcc = _build._nvcc()
    beside = os.path.join(os.path.dirname(os.path.realpath(nvcc)),
                          "cuobjdump")
    cuobjdump = beside if os.path.exists(beside) else shutil.which("cuobjdump")
    if words and not cuobjdump:
        raise RuntimeError(f"cuobjdump not found beside {nvcc} nor on PATH")
    with tempfile.TemporaryDirectory() as tmp:
        for src in _build.sources():
            if not src.endswith(".cu"):
                continue
            cubin = os.path.join(tmp, os.path.basename(src) + ".cubin")
            done = subprocess.run(
                [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-cubin", "-o",
                 cubin, src], capture_output=True, text=True)
            if done.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} (code "
                                   f"{done.returncode}):\n{done.stdout}"
                                   f"{done.stderr}")
            print("\n".join(ptxas_lines(done.stdout + done.stderr)))
            if words:
                sass = subprocess.run([cuobjdump, "-sass", cubin],
                                      capture_output=True, text=True,
                                      check=True).stdout
                print("\n".join(sass_lines(sass, words)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
