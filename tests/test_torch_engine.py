"""Port parity: the coarse mapper's packed [B, 7] rows and [5] overflow
vector (PyTorch on the CPU) against the JAX package's CoarseMapper, in
--threeN, parity (canonical k-mers, read-side key drops) and --threeN
--undirectional (four-strand reads) modes."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hashreadmapper_tpu.config import ProgramOptions
from hashreadmapper_tpu.io.genome import Genome
from hashreadmapper_tpu.pipeline.engine import CoarseMapper as JaxMapper
from hashreadmapper_tpu_torch.ops.minhash_kernel import (signature_stage,
                                                         sigs_from_bases)
from hashreadmapper_tpu_torch.ops.shd_kernel import shd_best
from hashreadmapper_tpu_torch.ops.vote_kernel import vote_candidates_fnc
from hashreadmapper_tpu_torch.pipeline.engine import (
    OVERFLOW_KEYS, CoarseMapper)

from torch_helpers import ensure_reference_native, four_strand_reads

_ACGT = np.frombuffer(b"ACGT", np.uint8)


def _genome_and_reads(seed, genome_len, n_reads, read_len, repeats=0,
                      conv=0.9, dup=0):
    """bench.py's 3N recipe: 1% substitutions, half reverse-complemented,
    90% C->T in read space, 10% junk reads; `repeats` copies of a 600 bp
    segment make keys with many windows."""
    rng = np.random.default_rng(seed)
    chrom = rng.integers(0, 4, size=genome_len, dtype=np.int8)
    for i in range(1, repeats + 1):
        chrom[i * 1200:i * 1200 + 600] = chrom[:600]
    genome = Genome(["chrB"], [_ACGT[chrom].tobytes().decode()])
    starts = rng.integers(0, genome_len - read_len, size=n_reads)
    reads = chrom[starts[:, None] + np.arange(read_len)[None, :]].copy()
    sub = rng.random(reads.shape) < 0.01
    reads[sub] = rng.integers(0, 4, size=int(sub.sum()))
    rc = rng.random(n_reads) < 0.5
    reads[rc] = 3 - reads[rc][:, ::-1]
    reads[(reads == 1) & (rng.random(reads.shape) < conv)] = 3
    junk = rng.random(n_reads) < 0.10
    reads[junk] = rng.integers(0, 4, size=(int(junk.sum()), read_len),
                               dtype=np.int8)
    if dup:
        # many copies of a few reads: keys above maxResultsPerMap
        reads[-dup:] = reads[:4].repeat(dup // 4, axis=0)
    lengths = np.full(n_reads, read_len, np.int32)
    lengths[::17] = read_len - 9
    return genome, reads.astype(np.int8), lengths


def _four_strand(seed, genome_len, n_per, read_len, repeats=0):
    rng = np.random.default_rng(seed)
    chrom = rng.integers(0, 4, size=genome_len, dtype=np.int8)
    for i in range(1, repeats + 1):
        chrom[i * 1200:i * 1200 + 600] = chrom[:600]
    genome = Genome(["chrU"], [_ACGT[chrom].tobytes().decode()])
    reads, lengths, _, _ = four_strand_reads(rng, chrom, n_per, read_len)
    lengths[::17] = read_len - 9
    return genome, reads, lengths


# __graft_entry__.entry()'s configuration, bench.py's 3N flagship shape
# scaled down, and tight budgets so every overflow counter fires
_ENTRY = dict(kmer_length=16, num_hash_functions=16, window_size=128,
              min_table_hits=4, batchsize=64, max_hamming_percent=0.1,
              probe_cap=16, candidates_per_read_cap=8, max_read_length=64,
              three_n_seeding=True, shd_pairs_per_read_budget=4,
              probe_tail_budget_per_read=4)
_BENCH = dict(kmer_length=16, num_hash_functions=16, window_size=128,
              min_table_hits=4, batchsize=128, max_hamming_percent=0.05,
              probe_cap=16, candidates_per_read_cap=8, max_read_length=128,
              three_n_seeding=True, shd_pairs_per_read_budget=4,
              probe_tail_budget_per_read=4, probe_head_budget_per_read=18)
_TIGHT = dict(_BENCH, num_hash_functions=8, min_table_hits=1,
              candidates_per_read_cap=3, shd_pairs_per_read_budget=1,
              probe_tail_budget_per_read=1, probe_head_budget_per_read=3,
              probe_cap=8)
# parity mode: canonical k-mers, F tables, un-collapsed SHD, and the
# read-side key drops (48 copies of 4 reads against maxResultsPerMap 10)
_PARITY = dict(_BENCH, three_n_seeding=False, max_results_per_map=10)
_PARITY_TIGHT = dict(_TIGHT, three_n_seeding=False)
# --undirectional: mirrored signatures, the 4F-table vote, the second SHD
# evaluation and the strand column
_UND = dict(_BENCH, undirectional=True, num_hash_functions=8,
            min_table_hits=2, candidates_per_read_cap=16)
_UND_TIGHT = dict(_TIGHT, undirectional=True)
CASES = {
    "entry": (_ENTRY, (0, 4096, 64, 50, 0)),
    "bench3n": (_BENCH, (1, 64_000, 512, 100, 0)),
    "tight": (_TIGHT, (2, 20_000, 256, 100, 15)),
    "parity": (_PARITY, (3, 64_000, 384, 100, 0, 0.0, 192)),
    "parity_tight": (_PARITY_TIGHT, (4, 20_000, 256, 100, 15, 0.0)),
    "undirectional": (_UND, (5, 64_000, 96, 100)),
    "undirectional_tight": (_UND_TIGHT, (6, 20_000, 64, 100, 15)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_rows_and_overflow_match_jax(case):
    cfg, data = CASES[case]
    und = cfg.get("undirectional", False)
    genome, reads, lengths = (_four_strand if und
                              else _genome_and_reads)(*data)
    ensure_reference_native()
    jm = JaxMapper(genome, ProgramOptions(**cfg))
    tm = CoarseMapper(genome, ProgramOptions(**cfg), "cpu")
    # parity mode: the dropped-keys mask of the whole read set
    jm.ensure_read_drops(reads, lengths)
    tm.ensure_read_drops(reads, lengths)
    jm.ensure_empty_drops()
    tm.ensure_empty_drops()
    for t, j in zip(tm.dropped, jm.dropped):
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(j).astype(np.int64))
    if case == "parity":
        assert int(tm.dropped[1].sum()) > 0
    assert tm.index.cuckoo_keys is not None
    assert tm.index.num_tables == cfg["num_hash_functions"] * (
        2 if cfg["three_n_seeding"] else 1)
    for name in ("keys", "offsets", "values", "num_keys"):
        np.testing.assert_array_equal(
            getattr(tm.index, name).numpy(),
            np.asarray(getattr(jm.index, name)).astype(np.int64))

    bsz = cfg["batchsize"]
    ab, al, av, n_pad = jm.stage_reads_device(reads, lengths)
    tb, tl, tv, n_pad2 = tm.stage_reads_device(reads, lengths)
    assert n_pad == n_pad2
    counts = [f.launches for f in (sigs_from_bases, signature_stage,
                                   vote_candidates_fnc, shd_best)]
    ovf_sum = np.zeros(5, np.int64)
    for s in range(0, n_pad, bsz):
        jp, jo = jm._map_batch_at(ab, al, av, jnp.int32(s), bsz,
                                  jm.dropped[0], jm.dropped[1])
        tp, to = tm._map_batch(tb[s:s + bsz], tl[s:s + bsz], tv[s:s + bsz])
        assert tp.dtype == torch.int32 and tp.shape == (bsz, 7)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        ovf_sum += to.numpy()
    # CPU tensors take the plain versions: no kernel launched
    assert counts == [f.launches for f in (sigs_from_bases, signature_stage,
                                           vote_candidates_fnc, shd_best)]
    if case.endswith("tight"):
        assert (ovf_sum > 0).all(), ovf_sum

    jr = jm.map_reads(reads, lengths)
    tr = tm.map_reads(reads, lengths)
    for f in ("orientation", "hamming", "shift", "chromosome_id",
              "position", "global_window_id", "bs_strand"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f),
                                      err_msg=f)
    for k in OVERFLOW_KEYS + ("cuckoo_direct_probe",):
        assert tr.stats[k] == jr.stats[k], k
    if case in ("bench3n", "undirectional"):
        assert (tr.orientation != 3).mean() > 0.8
    if case == "parity":
        # the 4 reads with 48 copies each lost every key to the drop rule
        assert (tr.orientation[4:192] != 3).mean() > 0.8
        assert (tr.orientation[192:] == 3).all()
    if und:
        assert set(np.unique(tr.bs_strand)) == {0, 1}
    else:
        assert not tr.bs_strand.any()
