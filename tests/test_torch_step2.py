"""Port parity for STEP 2 as a whole: the fused coarse + score +
traceback step against the JAX package's, and the port's STEP 2 (the
fused bundle finished on the host, whole, in halves, with every walk
overflowed, and in _pipelined_sw's chunks) against the serial host
path, on the CPU."""

import numpy as np
import pytest

from hashreadmapper_tpu.pipeline import mapping as jmapping
from hashreadmapper_tpu.pipeline.engine import CoarseMapper as JaxMapper
from hashreadmapper_tpu_torch import native
from hashreadmapper_tpu_torch.pipeline import driver
from hashreadmapper_tpu_torch.pipeline import mapping as tmapping
from hashreadmapper_tpu_torch.pipeline.engine import (OVERFLOW_KEYS,
                                                     CoarseMapper,
                                                     Step2Bundle)
from hashreadmapper_tpu_torch.pipeline.records import MappingRecords, emit_sam

from hashreadmapper_tpu.config import ProgramOptions
from hashreadmapper_tpu.io.genome import Genome
from hashreadmapper_tpu.io.readstore import ReadStorage, pack_rows

from test_fused_scores import _setup
from torch_helpers import ACGT, ensure_reference_native, four_strand_reads


def _setup_case(und):
    """(genome, opts, store, padded, lengths).  Directional:
    test_fused_scores' setup (96 reads of 72 bp, 2% substitutions, half
    RC, 80% C->T, 15% junk, Ns in the genome).  Undirectional: 24 reads
    of each of the four strands (tests/test_undirectional.py), 2%
    substitutions and a 2-base deletion in every fifth read, Ns in the
    genome, mapped with --undirectional."""
    if not und:
        return _setup(np.random.default_rng(2))
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=20_000, dtype=np.int8)
    reads, lengths, _, _ = four_strand_reads(rng, codes, 24, read_len=72,
                                             conv=0.8)
    sub = rng.random(reads.shape) < 0.02
    reads[sub] = rng.integers(0, 4, size=int(sub.sum()))
    reads[::5, 30:-2] = reads[::5, 32:]
    chrom = ACGT[codes]
    chrom[rng.integers(0, len(chrom), size=40)] = "N"
    genome = Genome(["chrF"], ["".join(chrom)])
    opts = ProgramOptions(
        kmer_length=16, num_hash_functions=8, window_size=128,
        min_table_hits=2, batchsize=32, max_hamming_percent=0.5,
        probe_cap=16, candidates_per_read_cap=8, max_read_length=96,
        threads=2, three_n_seeding=True, undirectional=True)
    store = ReadStorage(pack_rows(reads, lengths, (72 + 15) // 16), lengths,
                        np.zeros(len(lengths), bool))
    padded = np.pad(reads, ((0, 0), (0, 96 - 72))).astype(np.int8)
    return genome, opts, store, padded, lengths


@pytest.fixture(scope="module", params=[False, True],
                ids=["directional", "undirectional"])
def case(request):
    """Both packages' fused coarse + STEP 2 of one read set; the
    undirectional one gives STEP 2 its G->A pairs (strand 1 in FORWARD
    orientation)."""
    ensure_reference_native()
    genome, opts, store, padded, lengths = _setup_case(request.param)
    jm = JaxMapper(genome, opts)
    jres, jbundle = jm.map_reads(padded, lengths, with_scores=True)
    tm = CoarseMapper(genome, opts, "cpu")
    tres, tbundle = tm.map_reads(padded, lengths, with_scores=True)
    return (genome, opts, store, (jres, jbundle), (tres, tbundle),
            (tm, padded, lengths))


def test_fused_scores_equal_jax(case):
    _, opts, store, (jres, jbundle), (tres, tbundle), _ = case
    for f in ("orientation", "hamming", "shift", "chromosome_id", "position",
              "global_window_id", "bs_strand"):
        np.testing.assert_array_equal(getattr(tres, f), getattr(jres, f),
                                      err_msg=f)
    n2 = 2 * store.num_reads
    assert tbundle[0].shape == (10, n2) and tbundle[0].dtype == np.int16
    assert tbundle[1].shape == (n2, 48) and tbundle[1].dtype == np.uint8
    assert tbundle[2].shape == (n2,) and tbundle[2].dtype == np.int8
    for name, got, want in zip(("scores", "tb_ops", "tb_status"), tbundle,
                               jbundle):
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
    scores, ops = tbundle[0], tbundle[1]
    need = ~((scores[9] != 0) | (scores[8] != 0) | (scores[0] == 0)
             | (scores[1] < 0))
    assert need.sum() > 10 and (ops[need] != 0).any()    # walks ran
    ga_pairs = (tres.bs_strand != 0) & (tres.orientation == 1)
    assert ga_pairs.sum() > (5 if opts.undirectional else -1)
    assert opts.undirectional or not tres.bs_strand.any()


def _fields(aas):
    """What SAM and VCF read of each read's two alignments (records carry
    the s_align flags per read, in flag and flag_rc)."""
    return [(a.flag, a.flag_rc, tuple(a.num_conversions),
             tuple((x.sw_score, x.sw_score_next_best, x.query_begin,
                    x.cigar_string) for x in a.alignments))
            for a in aas]


@pytest.mark.parametrize("branch", ["fused", "overflowed", "halves"])
def test_device_step2_equals_the_host_path(case, branch, monkeypatch,
                                           tmp_path):
    """Same alignments and SAM bytes as the port's _run_cssw_host and the
    JAX package's; the host path raises while run_cssw runs.  fused: the
    case's bundle.  overflowed: every pair's traceback status 2 and its
    entries zeroed, so the native finish's banded DP runs every pair the
    diagonal certificate does not cover.  halves: two map_reads over the
    read halves, run_cssw on each, the records concatenated."""
    genome, opts, store, _, (res, bundle), (tm, padded, lengths) = case
    genome_rc = genome.reverse_complement()
    args = (genome, genome_rc, res.orientation, res.position,
            res.chromosome_id, store, opts, res.bs_strand)
    # run_cssw applies the mirrored treatment to FORWARD PBAT reads only;
    # the same mask when driving the host path directly
    strand = ((res.bs_strand != 0)
              & (res.orientation == tmapping.FORWARD)).astype(np.int8)
    host = tmapping._run_cssw_host(*args[:-1], strand)
    assert _fields(host) == _fields(
        jmapping._run_cssw_host(*args[:-1], strand))

    def no_host(*a, **k):
        raise AssertionError("the host STEP 2 path ran")
    monkeypatch.setattr(tmapping, "_run_cssw_host", no_host)
    if branch == "halves":
        h = store.num_reads // 2
        parts = []
        for c0, c1 in ((0, h), (h, store.num_reads)):
            r, b = tm.map_reads(padded[c0:c1], lengths[c0:c1],
                                with_scores=True)
            parts.append(tmapping.run_cssw(
                genome, genome_rc, r.orientation, r.position,
                r.chromosome_id, store.slice_rows(c0, c1), opts,
                r.bs_strand, b))
        rec = MappingRecords.concat(parts)
    else:
        if branch == "overflowed":
            scores, ops, status = bundle
            bundle = Step2Bundle(scores, np.zeros_like(ops),
                                 np.full_like(status, 2), bundle.rows)
        rec = tmapping.run_cssw(*args, bundle)
    assert isinstance(rec, MappingRecords)
    assert _fields(rec.to_aas()) == _fields(host)
    emit_sam(rec, genome, str(tmp_path / "dev.SAM"))
    tmapping.print_to_sam(host, genome, str(tmp_path / "host.SAM"))
    assert (tmp_path / "dev.SAM").read_bytes() == \
        (tmp_path / "host.SAM").read_bytes()
    assert any("I" in a.alignments[0].cigar_string
               or "D" in a.alignments[0].cigar_string for a in host)


def test_device_step2_without_native_raises(case, monkeypatch):
    genome, opts, store, _, (res, bundle), _ = case

    def no_lib():
        raise RuntimeError("the native host library is unavailable: g++ ...")
    monkeypatch.setattr(native, "get_lib", no_lib)
    with pytest.raises(RuntimeError, match="native host library"):
        tmapping.run_cssw(genome, genome.reverse_complement(),
                          res.orientation, res.position, res.chromosome_id,
                          store, opts, res.bs_strand, bundle)


def test_pipelined_sw_one_chunk_equals_several(case, monkeypatch):
    """_pipelined_sw's STEP 2 in one chunk (--pipelineChunk 0, and a chunk
    of every read) and in chunks of 40 reads (the last one short): the
    same coarse rows and overflow counters, and the same records, as
    run_cssw over the case's bundle."""
    genome, opts, store, _, (res, bundle), (tm, padded, _) = case
    genome_rc = genome.reverse_complement()
    want = tmapping.run_cssw(genome, genome_rc, res.orientation,
                             res.position, res.chromosome_id, store, opts,
                             res.bs_strand, bundle)
    for chunk in (0, store.num_reads, 40):
        monkeypatch.setattr(opts, "step2_pipeline_chunk", chunk)
        got, rec = driver._pipelined_sw(tm, padded, store, genome,
                                        genome_rc, opts)
        for f in ("orientation", "hamming", "shift", "chromosome_id",
                  "position", "global_window_id", "bs_strand"):
            np.testing.assert_array_equal(getattr(got, f), getattr(res, f),
                                          err_msg=f"{chunk}: {f}")
        for k in OVERFLOW_KEYS:
            assert got.stats[k] == res.stats[k], (chunk, k)
        for f in ("n", "lq", "ws"):
            assert getattr(rec, f) == getattr(want, f), (chunk, f)
        # the CIGARs by value (an empty one's pool offset is the chunk's)
        for f in ("q", "q_len", "win", "win_len", "position", "chrom",
                  "flag0", "flag1", "sw", "nb", "qb", "conv", "cig_len"):
            np.testing.assert_array_equal(getattr(rec, f), getattr(want, f),
                                          err_msg=f"{chunk}: {f}")
        assert _fields(rec.to_aas()) == _fields(want.to_aas()), chunk
