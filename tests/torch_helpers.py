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

The module itself imports neither jax nor the JAX package (only
ensure_reference_native does), so the card tests, which run on a machine
without jax, share its fixtures.
"""

import numpy as np

from hashreadmapper_tpu_torch import _build

ACGT = np.array(list("ACGT"))


def ensure_reference_native():
    """The JAX package's native library handle, never None."""
    from hashreadmapper_tpu import native as ref_native
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


# index of each special pair of sw_edge_pairs
SW_EDGE = {"read_len 0": 0, "read_len 1": 1, "read_len 16": 2,
           "read_len 17": 3, "read_len LQ": 4, "ref_len 0": 5,
           "saturating": 6, "mask_len 14": 7, "second best left": 8,
           "second best right": 9, "second best at hi + 1": 10,
           "degenerate into reverse": 11}


def sw_edge_pairs(seed, lq, n_cols, n=40):
    """STEP-2 pairs for the forward and reverse score passes, codes 0..4
    and 4-padded: (read_codes [n, lq] int8, read_len, ref_codes
    [n, n_cols] int8, ref_len, mask_len).  The first pairs are the edge
    cases named in SW_EDGE (n_cols >= 96 for the second-best ones); the
    rest are reads cut from their ref with substitutions, every third
    random."""
    rng = np.random.default_rng(seed)
    rc = np.full((n, lq), 4, np.int8)
    fc = np.full((n, n_cols), 4, np.int8)
    rls = np.zeros(n, np.int32)
    fls = np.zeros(n, np.int32)

    def put(i, read, ref):
        rc[i, :len(read)] = read
        fc[i, :len(ref)] = ref
        rls[i], fls[i] = len(read), len(ref)

    for i in range(n):
        fl = int(rng.integers(30, n_cols + 1))
        ref = rng.integers(0, 4, fl).astype(np.int8)
        rl = int(rng.integers(10, min(lq, fl) + 1))
        if i % 3 == 0:
            read = rng.integers(0, 5, rl).astype(np.int8)
        else:
            start = int(rng.integers(0, fl - rl + 1))
            read = ref[start:start + rl].copy()
            sub = rng.random(rl) < 0.06
            read[sub] = rng.integers(0, 4, int(sub.sum()))
        put(i, read, ref)
    e = SW_EDGE
    for key, rl in (("read_len 0", 0), ("read_len 1", 1), ("read_len 16", 16),
                    ("read_len 17", 17), ("read_len LQ", lq)):
        ref = rng.integers(0, 4, n_cols).astype(np.int8)
        rc[e[key]] = 4
        put(e[key], np.resize(ref[3:], rl), ref)
    fc[e["ref_len 0"]] = 4
    fls[e["ref_len 0"]] = 0
    # the whole ref copied: 127+ matches saturate the byte mode at LQ 128
    ref = rng.integers(0, 4, n_cols).astype(np.int8)
    rc[e["saturating"]] = 4
    put(e["saturating"], ref[:min(lq, n_cols)], ref)
    # a 20-base read twice in its ref: an exact copy after one with two
    # substitutions, or before a second exact one (the first wins, and the
    # second outscores the decaying tail of the first); and the read's last
    # 10 bases ending exactly one column past the masked window (hi + 1)
    read = rng.integers(0, 4, 20).astype(np.int8)
    weak = read.copy()
    weak[[6, 13]] = (weak[[6, 13]] + 1) % 4
    for key, exact_at, other, other_at in (
            ("second best left", 70, weak, 5),
            ("second best right", 10, read, 60),
            ("second best at hi + 1", 10, read[10:], 36)):
        ref = np.full(96, 4, np.int8)         # code 4 matches nothing
        ref[exact_at:exact_at + 20] = read
        ref[other_at:other_at + len(other)] = other
        rc[e[key]] = 4
        fc[e[key]] = 4
        put(e[key], read, ref)
    masks = np.maximum(15, rls // 2).astype(np.int32)
    masks[e["mask_len 14"]] = 14
    masks[12::9] = 10
    return rc, rls, fc, fls, masks


def shd_pairs_case(seed, mode, n_reads=48, width=40, p=160, ws=64,
                   g_len=3000, max_pct=0.2):
    """Inputs of ops/shd.py::shd_pairs_best as numpy arrays (one
    chromosome at offset 0): reads planted at their pairs' windows (C->T
    converted in 3N mode, G->A under `undirectional`, a third reverse
    complemented) beside random pairs, with the edge cases: a read of
    length 0 and one longer than its row, anchors at the genome's first
    and last word, windows cut by the chromosome's end (reads longer than
    their anchor), invalid pairs, A/T palindromes on an A/T stretch (equal
    scores in both orientations) and a period-2 stretch (equal scores at
    many shifts).  Returns a dict of genome, reads [B, width], read_len,
    ridx, gstart, alen, aleft, valid, ws, max_pct."""
    import torch
    from hashreadmapper_tpu_torch.ops import shd
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, g_len).astype(np.int8)
    genome[1000:1200] = rng.choice([0, 3], 200)
    half = rng.choice([0, 3], width // 2).astype(np.int8)
    genome[1060:1060 + 2 * len(half)] = np.concatenate(
        [half, 3 - half[::-1]])                     # A/T palindrome
    genome[1500:1700] = np.tile([0, 1], 100)
    read_len = rng.integers(width // 2, width + 1, n_reads)
    read_len[:3] = [0, width + 3, width]
    src = rng.integers(0, g_len - width, n_reads)
    src[3:6] = [1060, 1060, 1540]                   # palindrome, period 2
    read_len[3:5] = 2 * len(half)
    src[6] = 0                                      # first word
    src[7] = g_len - width                          # last word
    reads = rng.integers(0, 4, (n_reads, width)).astype(np.int8)
    conv = rng.random((n_reads, width)) < 0.9
    for i in range(n_reads):
        n = min(int(read_len[i]), width)
        r = genome[src[i]:src[i] + n].copy()
        if i > 5 and i % 3 == 0:
            r = 3 - r[::-1]
        if mode == "threeN":
            r[(r == 1) & conv[i, :n]] = 3
        elif mode == "undirectional":
            r[(r == 2) & conv[i, :n]] = 0
        reads[i, :n] = r
    ridx = np.arange(p) % n_reads
    # window starts: the read's source less an offset inside the window,
    # or anywhere; then the edges
    pos = np.where(np.arange(p) % 4 == 3, rng.integers(0, g_len - 1, p),
                   np.clip(src[ridx] - rng.integers(0, ws // 2, p), 0,
                           g_len - 1))
    pos[6], pos[7], pos[8] = 0, g_len - 10, g_len - ws - 1
    ridx[6:9] = [6, 7, 7]
    loc = shd.extended_window_location(
        torch.from_numpy(pos), torch.full((p,), g_len),
        torch.from_numpy(read_len[ridx]), ws)
    valid = np.arange(p) % 7 != 5
    return dict(genome=genome, reads=reads, read_len=read_len.astype(np.int32),
                ridx=ridx.astype(np.int64), gstart=loc.start.numpy(),
                alen=loc.length.numpy(), aleft=loc.left.numpy(), valid=valid,
                ws=ws, max_pct=max_pct)


def step2_rows_case(seed, lq=72, ws=64, n_random=90):
    """A batch for ops/step2rows_kernel.py::step2_rows: (genome, read codes
    [B, lq] int8, lengths [B] int32, packed [B, 7] int32 coarse rows).
    Chromosome cA (3,000 bases) holds N and IUPAC letters (R, Y, K) in
    the window at 1,000; cB (300 bases) cuts a window at its end.  The
    first rows: a window cut by cB's end (wlen 50); a read at position 5
    in RC orientation (the RC window clipped at the chromosome's start);
    the N and IUPAC window; RC orientation; a mirrored PBAT read (strand
    1, FORWARD) and one in RC orientation (strand 1, no G->A); an
    unmapped read and a padding row (chromosome 0, position 0, the
    padding of length 0); reads of length lq and 1; then n_random reads
    at random positions, orientations and strands.  Codes past a read's
    length are random (a forward query keeps them)."""
    from hashreadmapper_tpu_torch.io.genome import Genome
    rng = np.random.default_rng(seed)
    ca = rng.choice(list("ACGT"), 3000)
    ca[[1005, 1010, 1011, 1030]] = ["N", "R", "Y", "K"]
    ca[rng.integers(0, 3000, size=20)] = "N"
    cb = rng.choice(list("ACGT"), 300)
    genome = Genome(["cA", "cB"], ["".join(ca), "".join(cb).lower()])
    # (orientation, chromosome, position, strand, length)
    fixed = [(1, 1, 250, 0, 60), (2, 0, 5, 0, 70), (1, 0, 1000, 0, 70),
             (2, 0, 2000, 0, 70), (1, 0, 2500, 1, 70), (2, 0, 2600, 1, 70),
             (3, 0, 0, 0, 70), (3, 0, 0, 0, 0), (1, 0, 40, 0, lq),
             (2, 1, 10, 1, 1)]
    n = len(fixed) + n_random
    ori = rng.integers(1, 3, size=n)
    chrom = rng.integers(0, 2, size=n)
    pos = np.where(chrom == 0, rng.integers(0, 3000, size=n),
                   rng.integers(0, 300, size=n))
    strand = rng.integers(0, 2, size=n)
    lens = rng.integers(1, lq + 1, size=n)
    for i, row in enumerate(fixed):
        ori[i], chrom[i], pos[i], strand[i], lens[i] = row
    lens = np.minimum(lens, lq)
    packed = np.zeros((n, 7), np.int32)
    packed[:, 0], packed[:, 3], packed[:, 4], packed[:, 6] = (
        ori, chrom, pos, strand)
    bases = rng.integers(0, 4, size=(n, lq), dtype=np.int8)
    return genome, bases, lens.astype(np.int32), packed
