"""Helpers shared by the tests/test_torch_*.py files.

ensure_reference_native() makes the JAX package's native loader safe to
use from a test of the port.  That loader (hashreadmapper_tpu/native.py)
runs `make` in native/ when libhrm_native.so is absent and loads whatever
file is there; several test processes starting at once on a fresh tree
each run that make, one linker truncates the library while another process
loads it ("file too short"), and that process has no native library for
the rest of its life.  The port's own build (_build.build_native) writes
whole files only, from the same sources with the same C interface, so the
reference loader is pointed at it unless it already holds a library.
"""

import numpy as np

from hashreadmapper_tpu import native as ref_native
from hashreadmapper_tpu_torch import _build

ACGT = np.array(list("ACGT"))


def ensure_reference_native():
    """The JAX package's native library handle, never None."""
    if ref_native._lib is None:
        ref_native._SO_PATH = _build.build_native()
        ref_native._load_attempted = False
    lib = ref_native.get_lib()
    assert lib is not None, "the reference's native loader found no library"
    return lib


def four_strand_reads(rng, chrom_bases, n_per, read_len=80, conv=0.9):
    """tests/test_undirectional.py's construction: (reads, lengths, starts,
    kind) with kind 0..3 = directional forward, directional reverse
    complement, PBAT forward, PBAT reverse complement; C->T (kinds 0, 1)
    or G->A (kinds 2, 3) applied in READ space at rate `conv`."""
    starts = rng.integers(0, len(chrom_bases) - read_len, size=4 * n_per)
    reads = chrom_bases[starts[:, None] + np.arange(read_len)[None, :]].copy()
    kind = np.repeat(np.arange(4), n_per)
    rc_rows = (kind == 1) | (kind == 3)
    reads[rc_rows] = 3 - reads[rc_rows][:, ::-1]
    ct_rows = kind < 2
    c_conv = (reads == 1) & (rng.random(reads.shape) < conv) & ct_rows[:, None]
    g_conv = (reads == 2) & (rng.random(reads.shape) < conv) & ~ct_rows[:, None]
    reads[c_conv] = 3
    reads[g_conv] = 0
    lengths = np.full(4 * n_per, read_len, dtype=np.int32)
    return reads.astype(np.int8), lengths, starts, kind
