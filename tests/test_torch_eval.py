"""Port parity: the evaluation tools (eval/analysis, compare, variants,
window_stats, copies of the JAX package's) byte for byte on
tests/golden/genomic_analysis/ and equal to the JAX tools on
tests/test_eval.py's inputs; and the engine's candidate collection
(CoarseMapper.map_reads(collect_candidates=True)) equal to the JAX
engine's."""

import dataclasses
import os
import random
import subprocess
import sys

import numpy as np
import pytest

from hashreadmapper_tpu.config import ProgramOptions as JaxOptions
from hashreadmapper_tpu.cpu import oracle
from hashreadmapper_tpu.eval import compare as jax_compare
from hashreadmapper_tpu.eval import variants as jax_variants
from hashreadmapper_tpu.eval import window_stats as jax_ws
from hashreadmapper_tpu.io.genome import Genome as JaxGenome
from hashreadmapper_tpu.pipeline.engine import CoarseMapper as JaxMapper
from hashreadmapper_tpu_torch.config import ProgramOptions
from hashreadmapper_tpu_torch.eval import (analysis, compare, variants,
                                           window_stats)
from hashreadmapper_tpu_torch.io.genome import Genome
from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper

from torch_helpers import ensure_reference_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "golden", "genomic_analysis")
OPTS = dict(kmer_length=16, num_hash_functions=16, window_size=128,
            min_table_hits=4, batchsize=32, max_hamming_percent=0.05,
            probe_cap=64, candidates_per_read_cap=32, max_read_length=64)


def _read(path):
    with open(path) as f:
        return f.read()


def test_variantcall_golden(tmp_path):
    out = tmp_path / "out.vcf"
    called, total = analysis.variantcall(
        os.path.join(GOLD, "golden.sam"),
        os.path.join(GOLD, "golden_ref.fasta"), str(out))
    assert (called, total) == (123, 124)
    assert _read(str(out)) == _read(os.path.join(GOLD, "golden_out.vcf"))


@pytest.mark.parametrize("region,golden", [
    ((0, 2_000_000), "out_full.csv"), ((40, 210), "out_region.csv")])
def test_analyse_golden(tmp_path, region, golden):
    """The production variants/chr<CHR>/ layout, whole and a region."""
    d = tmp_path / "variants" / "chrT"
    d.mkdir(parents=True)
    for name in os.listdir(os.path.join(GOLD, "variants_chrT")):
        (d / name).write_text(
            _read(os.path.join(GOLD, "variants_chrT", name)))
    (tmp_path / "metadata.csv").write_text(
        _read(os.path.join(GOLD, "metadata.csv")))
    out = tmp_path / "out.csv"
    n = analysis.analyse(str(tmp_path / "metadata.csv"), "T", *region,
                         str(out), base_dir=str(tmp_path))
    assert n == 3
    assert _read(str(out)) == _read(os.path.join(GOLD, golden))


def test_analysis_cli(tmp_path):
    """python -m hashreadmapper_tpu_torch.eval.analysis variantcall."""
    out = tmp_path / "o.vcf"
    proc = subprocess.run(
        [sys.executable, "-m", "hashreadmapper_tpu_torch.eval.analysis",
         "variantcall", os.path.join(GOLD, "golden.sam"),
         os.path.join(GOLD, "golden_ref.fasta"), str(out)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Called variants on 123/124 reads" in proc.stdout
    assert _read(str(out)) == _read(os.path.join(GOLD, "golden_out.vcf"))


def test_known_divergences_kept(tmp_path):
    """ROADMAP Queue 3, known divergences 1-2: an unparseable SAM line is
    skipped (analysis.py:242) and blank metadata lines are skipped
    (:296), as in the JAX copy."""
    ref = tmp_path / "ref.fa"
    ref.write_text("ACGTACGTAC" * 50)
    sam = tmp_path / "in.sam"
    sam.write_text("@HD\tVN:1.4\n"
                   ".\t.\t.\t1\t40\t4M\t.\t.\t.\tTTTT\t.\n")
    called, total = analysis.variantcall(str(sam), str(ref),
                                         str(tmp_path / "o.vcf"))
    assert (called, total) == (1, 1)
    from hashreadmapper_tpu.eval import analysis as jax_analysis
    assert (called, total) == jax_analysis.variantcall(
        str(sam), str(ref), str(tmp_path / "j.vcf"))
    assert _read(str(tmp_path / "o.vcf")) == _read(str(tmp_path / "j.vcf"))
    d = tmp_path / "variants" / "chrT"
    d.mkdir(parents=True)
    for name in os.listdir(os.path.join(GOLD, "variants_chrT")):
        (d / name).write_text(
            _read(os.path.join(GOLD, "variants_chrT", name)))
    meta = _read(os.path.join(GOLD, "metadata.csv")).split("\n", 1)
    (tmp_path / "metadata.csv").write_text(meta[0] + "\n\n" + meta[1])
    out = tmp_path / "out.csv"
    assert analysis.analyse(str(tmp_path / "metadata.csv"), "T", 0,
                            2_000_000, str(out), base_dir=str(tmp_path)) == 3
    assert _read(str(out)) == _read(os.path.join(GOLD, "out_full.csv"))


def _planted_dataset(seed=21, n_reads=40, chrom_len=3000, read_len=60):
    """tests/test_eval.py::_planted_dataset."""
    rng = random.Random(seed)
    chrom = "".join(rng.choice("ACGT") for _ in range(chrom_len))
    reads, truth = [], []
    for _ in range(n_reads):
        start = rng.randrange(0, chrom_len - read_len)
        b = oracle.encode_bases(chrom[start:start + read_len])
        rc = rng.random() < 0.5
        if rc:
            b = oracle.revcomp_bases(b)
        reads.append(b)
        truth.append((start, rc))
    bases = np.zeros((n_reads, 64), dtype=np.int8)
    lens = np.zeros(n_reads, dtype=np.int32)
    for i, r in enumerate(reads):
        bases[i, :len(r)] = r
        lens[i] = len(r)
    return chrom, bases, lens, truth


def test_compare_equals_jax_on_the_planted_reads():
    """tests/test_eval.py::test_compare_concordance_on_planted_reads: the
    port's records and comparison stats equal the JAX tools' on the JAX
    engine's results, and the port engine's records equal them too."""
    ensure_reference_native()
    chrom, bases, lens, truth = _planted_dataset()
    jg, g = JaxGenome(["chrC"], [chrom]), Genome(["chrC"], [chrom])
    opts = dict(OPTS, batchsize=64)
    ref_res = JaxMapper(jg, JaxOptions(**opts)).map_reads(bases.copy(),
                                                          lens.copy())
    res = CoarseMapper(g, ProgramOptions(**opts), "cpu").map_reads(
        bases.copy(), lens.copy())
    kw = [dict(read_id=i, flags=(0x10 if rc else 0), chromosome="chrC",
               position=s) for i, (s, rc) in enumerate(truth)]
    ref_recs = jax_compare.mapper_records_from_results(ref_res, jg, lens)
    recs = compare.mapper_records_from_results(res, g, lens)
    assert [dataclasses.astuple(r) for r in recs] == [
        dataclasses.astuple(r) for r in ref_recs]
    ref_stats = jax_compare.compare_mappings(
        jg, [jax_compare.TruthRecord(**k) for k in kw], ref_recs)
    stats = compare.compare_mappings(
        g, [compare.TruthRecord(**k) for k in kw], recs)
    assert dataclasses.asdict(stats) == dataclasses.asdict(ref_stats)
    assert stats.status_histogram.get(0b1111, 0) > len(truth) // 2


def test_window_stats_equal_jax():
    """tests/test_eval.py's truth windows, collector and overlap cases."""
    chrom = "ACGT" * 300
    g, jg = Genome(["c"], [chrom]), JaxGenome(["c"], [chrom])
    aligns = [(0, 0, 100, 60), (1, 0, 150, 60), (2, 0, 800, 60)]
    truth = window_stats.truth_windows_from_alignments(g, 128, 16, aligns)
    assert truth == jax_ws.truth_windows_from_alignments(jg, 128, 16, aligns)
    coll = window_stats.WindowHitStatisticCollector(truth)
    jcoll = jax_ws.WindowHitStatisticCollector(truth)
    for (cid, wid), rids in truth.items():
        coll.add_hits(cid, wid, list(rids) + [999])
        jcoll.add_hits(cid, wid, list(rids) + [999])
    assert coll.report() == jcoll.report()
    assert coll.report()["recall"] == 1.0
    g2, jg2 = Genome(["c"], ["A" * 2000]), JaxGenome(["c"], ["A" * 2000])
    for min_overlap, want in ((30, 1), (10, 0)):
        assert window_stats.window_id_with_overlap(
            g2, 128, 16, 0, 100, 60, min_overlap) == want
        assert jax_ws.window_id_with_overlap(
            jg2, 128, 16, 0, 100, 60, min_overlap) == want


def test_variants_equal_jax(tmp_path):
    """tests/test_eval.py::test_variant_matching's files."""
    ref_csv = tmp_path / "ref.csv"
    ref_csv.write_text("1;100;C;T;G1\n1;200;A;G;G2\n2;300;G;C;G3\n")
    vcf = tmp_path / "out.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n#CHROM\t...\n"
        "1\t100\t7\tC\tT\t44\t\t\t\t\n"
        "1\t200\t8\tA\tC\t44\t\t\t\t\n")
    rep = variants.match_variants(
        variants.load_reference_variants(str(ref_csv)),
        variants.load_called_variants_vcf(str(vcf)))
    ref = jax_variants.match_variants(
        jax_variants.load_reference_variants(str(ref_csv)),
        jax_variants.load_called_variants_vcf(str(vcf)))
    assert dataclasses.asdict(rep) == dataclasses.asdict(ref)
    assert (rep.total, rep.matched, rep.alt_mismatches, rep.missing) == (
        3, 1, 1, 1)


@pytest.mark.parametrize("three_n", [False, True], ids=["parity", "3N"])
def test_candidate_collection_equals_jax(three_n):
    """tests/test_eval.py::test_engine_candidate_collection_feeds_window_
    stats: the voted ids and the SHD orientation of every candidate equal
    the JAX engine's (two batches and a ragged end); the packed results
    and launch-free path are those of map_reads without collection; and
    the window statistics fed by them are the JAX ones."""
    ensure_reference_native()
    chrom, bases, lens, truth = _planted_dataset(seed=3, n_reads=45)
    if three_n:
        bases = np.where((bases == 1) & (np.arange(64) % 3 == 0), 3, bases
                         ).astype(np.int8)
    opts = dict(OPTS, three_n_seeding=three_n)
    jg, g = JaxGenome(["chrW"], [chrom]), Genome(["chrW"], [chrom])
    jm = JaxMapper(jg, JaxOptions(**opts))
    ref = jm.map_reads(bases.copy(), lens.copy(), collect_candidates=True)
    r_ids, r_ori = jm.last_candidates
    mapper = CoarseMapper(g, ProgramOptions(**opts), "cpu")
    plain = mapper.map_reads(bases.copy(), lens.copy())
    assert mapper.last_candidates is None
    got = mapper.map_reads(bases.copy(), lens.copy(),
                           collect_candidates=True)
    ids, ori = mapper.last_candidates
    assert ids.dtype == np.uint32 and ori.dtype == np.int8
    assert ids.shape == (len(lens), opts["candidates_per_read_cap"])
    np.testing.assert_array_equal(ids, np.asarray(r_ids))
    np.testing.assert_array_equal(ori, np.asarray(r_ori))
    for res in (plain, ref):
        np.testing.assert_array_equal(got.orientation, res.orientation)
        np.testing.assert_array_equal(got.position, res.position)
    assert (ori != 3).any() and (ids == 0xFFFFFFFF).any()

    aligns = [(i, 0, s, int(lens[i])) for i, (s, _) in enumerate(truth)]
    tw = window_stats.truth_windows_from_alignments(g, 128, 16, aligns)
    win_chrom = mapper.table.win_chrom.numpy()
    win_pos = mapper.table.win_pos.numpy()
    hits = window_stats.WindowHitStatisticCollector(tw)
    for rid, slot in zip(*np.nonzero((ids != 0xFFFFFFFF) & (ori != 3))):
        g_id = ids[rid, slot]
        hits.add_hits(int(win_chrom[g_id]),
                      int(win_pos[g_id]) // (128 - 16 + 1), [int(rid)])
    assert hits.report()["recall"] > 0.5
