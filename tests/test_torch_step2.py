"""Port parity for STEP 2 as a whole: the fused coarse + score +
traceback step against the JAX package's, and the port's device STEP 2
(fused bundle and host-staged chunks) against the shared serial host
path, on the CPU."""

import numpy as np
import pytest

from hashreadmapper_tpu import native
from hashreadmapper_tpu.pipeline import mapping as shared
from hashreadmapper_tpu.pipeline.engine import CoarseMapper as JaxMapper
from hashreadmapper_tpu.pipeline.records import MappingRecords, emit_sam
from hashreadmapper_tpu_torch.pipeline import mapping as tmapping
from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper

from test_fused_scores import _setup

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library not built")


@pytest.fixture(scope="module")
def case():
    """test_fused_scores' directional setup: 96 reads of 72 bp, 2%
    substitutions, half RC, 80% C->T, 15% junk, Ns in the genome."""
    genome, opts, store, padded, lengths = _setup(np.random.default_rng(2))
    jm = JaxMapper(genome, opts)
    jres, jbundle = jm.map_reads(padded, lengths, with_scores=True)
    tm = CoarseMapper(genome, opts, "cpu")
    tres, tbundle = tm.map_reads(padded, lengths, with_scores=True)
    return genome, opts, store, (jres, jbundle), (tres, tbundle)


def test_fused_scores_equal_jax(case):
    _, _, store, (jres, jbundle), (tres, tbundle) = case
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


def test_scores_only_bundle_without_traceback(case):
    genome, opts, store, _, (_, tbundle) = case
    _, _, _, padded, lengths = _setup(np.random.default_rng(2))
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
    """Same alignments and SAM bytes as the shared _run_cssw_host; the
    host path raises while the port's device path runs."""
    genome, opts, store, _, (res, bundle) = case
    genome_rc = genome.reverse_complement()
    args = (genome, genome_rc, res.orientation, res.position,
            res.chromosome_id, store, opts, res.bs_strand)
    host = shared._run_cssw_host(*args)

    def no_host(*a, **k):
        raise AssertionError("the host STEP 2 path ran")
    monkeypatch.setattr(shared, "_run_cssw_host", no_host)
    pre = {"fused": bundle, "fused_scores_only": bundle[0],
           "staged": None}[branch]
    rec = tmapping.run_cssw(*args, pre, device="cpu")
    assert isinstance(rec, MappingRecords)
    assert _fields(rec.to_aas()) == _fields(host)
    emit_sam(rec, genome, str(tmp_path / "dev.SAM"))
    shared.print_to_sam(host, genome, str(tmp_path / "host.SAM"))
    assert (tmp_path / "dev.SAM").read_bytes() == \
        (tmp_path / "host.SAM").read_bytes()
    assert any("I" in a.alignments[0].cigar_string
               or "D" in a.alignments[0].cigar_string for a in host)


def test_device_step2_without_native_raises(case, monkeypatch):
    genome, opts, store, _, (res, _) = case
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native"):
        tmapping.run_cssw(genome, genome.reverse_complement(),
                          res.orientation, res.position, res.chromosome_id,
                          store, opts, res.bs_strand, device="cpu")
