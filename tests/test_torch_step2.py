"""Port parity for STEP 2 as a whole: the fused coarse + score +
traceback step against the JAX package's, and the port's device STEP 2
(fused bundle and host-staged chunks) against the serial host path, on
the CPU."""

import numpy as np
import pytest

from hashreadmapper_tpu.pipeline import mapping as jmapping
from hashreadmapper_tpu.pipeline.engine import CoarseMapper as JaxMapper
from hashreadmapper_tpu_torch import native
from hashreadmapper_tpu_torch.pipeline import mapping as tmapping
from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper
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
    return genome, opts, store, (jres, jbundle), (tres, tbundle)


def test_fused_scores_equal_jax(case):
    _, opts, store, (jres, jbundle), (tres, tbundle) = case
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


def test_scores_only_bundle_without_traceback(case):
    genome, opts, store, _, (_, tbundle) = case
    _, _, _, padded, lengths = _setup_case(opts.undirectional)
    opts.step2_device_traceback = False
    try:
        tm = CoarseMapper(genome, opts, "cpu")
        _, scores = tm.map_reads(padded, lengths, with_scores=True)
    finally:
        opts.step2_device_traceback = True
    np.testing.assert_array_equal(scores, tbundle[0])


def _fields(aas):
    """What SAM and VCF read of each read's two alignments (records carry
    the s_align flags per read, in flag and flag_rc)."""
    return [(a.flag, a.flag_rc, tuple(a.num_conversions),
             tuple((x.sw_score, x.sw_score_next_best, x.query_begin,
                    x.cigar_string) for x in a.alignments))
            for a in aas]


@pytest.mark.parametrize("branch", ["fused", "fused_scores_only", "staged"])
def test_device_step2_equals_the_host_path(case, branch, monkeypatch,
                                           tmp_path):
    """Same alignments and SAM bytes as the port's _run_cssw_host and the
    JAX package's; the host path raises while the device path runs."""
    genome, opts, store, _, (res, bundle) = case
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
    pre = {"fused": bundle, "fused_scores_only": bundle[0],
           "staged": None}[branch]
    rec = tmapping.run_cssw(*args, pre, device="cpu")
    assert isinstance(rec, MappingRecords)
    assert _fields(rec.to_aas()) == _fields(host)
    emit_sam(rec, genome, str(tmp_path / "dev.SAM"))
    tmapping.print_to_sam(host, genome, str(tmp_path / "host.SAM"))
    assert (tmp_path / "dev.SAM").read_bytes() == \
        (tmp_path / "host.SAM").read_bytes()
    assert any("I" in a.alignments[0].cigar_string
               or "D" in a.alignments[0].cigar_string for a in host)


def test_device_step2_without_native_raises(case, monkeypatch):
    genome, opts, store, _, (res, _) = case

    def no_lib():
        raise RuntimeError("the native host library is unavailable: g++ ...")
    monkeypatch.setattr(native, "get_lib", no_lib)
    with pytest.raises(RuntimeError, match="native host library"):
        tmapping.run_cssw(genome, genome.reverse_complement(),
                          res.orientation, res.position, res.chromosome_id,
                          store, opts, res.bs_strand, device="cpu")
