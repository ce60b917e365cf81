"""Port parity: genome segments, the region plan and the region-sharded
mapper (PyTorch on the CPU) against the JAX package's; every CoarseResults
field and stat equal, on tests/test_region_sharded.py's cases; the fused
STEP-2 bundle of the regions against the port's single mapper; and the
CLI with --regions 2 against the JAX CLI, byte for byte."""

import random

import jax
import numpy as np
import pytest

from hashreadmapper_tpu.cli import main as jax_cli_main
from hashreadmapper_tpu.config import ProgramOptions as JaxOptions
from hashreadmapper_tpu.cpu import oracle
from hashreadmapper_tpu.io.genome import Genome as JaxGenome
from hashreadmapper_tpu.parallel import region_sharded as jax_rs
from hashreadmapper_tpu.parallel import segments as jax_seg
from hashreadmapper_tpu_torch import cli
from hashreadmapper_tpu_torch.config import ProgramOptions
from hashreadmapper_tpu_torch.io.genome import Genome
from hashreadmapper_tpu_torch.parallel import region_sharded as rs
from hashreadmapper_tpu_torch.parallel import segments as seg
from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper

from torch_helpers import ensure_reference_native

FIELDS = ("orientation", "hamming", "shift", "chromosome_id", "position",
          "global_window_id", "global_window_id64", "bs_strand")
BASE = dict(kmer_length=8, num_hash_functions=8, window_size=32,
            min_table_hits=2, batchsize=32, max_hamming_percent=0.15,
            probe_cap=64, candidates_per_read_cap=32, max_read_length=36)


def _dataset(seed=51, n_reads=70, chrom_lens=(600, 350, 500, 280),
             maxlen=36):
    """tests/test_region_sharded.py::_dataset."""
    rng = random.Random(seed)
    chroms = ["".join(rng.choice("ACGT") for _ in range(n))
              for n in chrom_lens]
    reads = []
    for _ in range(n_reads):
        rl = rng.randint(14, maxlen)
        if rng.random() < 0.85:
            c = rng.randrange(len(chroms))
            s = rng.randrange(len(chroms[c]) - rl)
            b = oracle.encode_bases(chroms[c][s:s + rl])
            if rng.random() < 0.5:
                b = oracle.revcomp_bases(b)
        else:
            b = [rng.randrange(4) for _ in range(rl)]
        reads.append(b)
    return chroms, *_pack(reads, maxlen)


def _pack(reads, maxlen):
    bases = np.zeros((len(reads), maxlen), dtype=np.int8)
    lens = np.zeros(len(reads), dtype=np.int32)
    for i, r in enumerate(reads):
        bases[i, :len(r)] = r
        lens[i] = len(r)
    return bases, lens


def _single_chromosome():
    """tests/test_region_sharded.py::test_window_partition_single_chromosome."""
    rng = random.Random(7)
    chrom = "".join(rng.choice("ACGT") for _ in range(1500))
    reads = []
    for _ in range(60):
        rl = rng.randint(14, 36)
        s = rng.randrange(len(chrom) - rl)
        b = oracle.encode_bases(chrom[s:s + rl])
        if rng.random() < 0.5:
            b = oracle.revcomp_bases(b)
        reads.append(b)
    return [chrom], *_pack(reads, 36)


def _three_n():
    """tests/test_region_sharded.py::test_window_partition_three_n."""
    rng = random.Random(11)
    chroms = ["".join(rng.choice("ACGT") for _ in range(500)),
              "".join(rng.choice("ACGT") for _ in range(400))]
    reads = []
    for _ in range(50):
        rl = rng.randint(16, 36)
        c = rng.randrange(2)
        s = rng.randrange(len(chroms[c]) - rl)
        b = oracle.encode_bases(chroms[c][s:s + rl])
        if rng.random() < 0.5:
            b = oracle.revcomp_bases(b)
        b = [3 if (x == 1 and rng.random() < 0.9) else x for x in b]
        reads.append(b)
    return chroms, *_pack(reads, 36)


def _segments_as_tuples(regions):
    return [[(s.chrom_id, s.win_start, s.win_stop) for s in r]
            for r in regions]


GENOMES = [["A" * 700, "A" * 300], ["A" * 100, "A" * 900, "A" * 50,
                                    "A" * 500, "A" * 450]]


@pytest.mark.parametrize("seqs", GENOMES)
def test_segment_functions_equal_jax(seqs):
    """partition_windows, segment_base_span, staged_bases,
    whole_chromosome_segments and regions_for_base_cap on
    test_partition_windows_covers_all's genome and the binning one."""
    names = [f"c{i}" for i in range(len(seqs))]
    g, jg = Genome(names, seqs), JaxGenome(names, seqs)
    opts, jopts = ProgramOptions(**BASE), JaxOptions(**BASE)
    for n in (1, 2, 3, 5, 8):
        got = seg.partition_windows(g, opts, n)
        ref = jax_seg.partition_windows(jg, jopts, n)
        assert _segments_as_tuples(got) == _segments_as_tuples(ref)
        for r_got, r_ref in zip(got, ref):
            assert (seg.staged_bases(g, opts, r_got, 36)
                    == jax_seg.staged_bases(jg, jopts, r_ref, 36))
            for s_got, s_ref in zip(r_got, r_ref):
                assert (seg.segment_base_span(g, opts, s_got, 36)
                        == jax_seg.segment_base_span(jg, jopts, s_ref, 36))
    ids = list(range(len(seqs)))
    assert _segments_as_tuples([seg.whole_chromosome_segments(
        g, opts, ids)]) == _segments_as_tuples(
        [jax_seg.whole_chromosome_segments(jg, jopts, ids)])
    for cap in (200, 500, 10**6):
        assert _segments_as_tuples(seg.regions_for_base_cap(
            g, opts, cap, 36)) == _segments_as_tuples(
            jax_seg.regions_for_base_cap(jg, jopts, cap, 36))
    assert rs.bin_chromosomes(g, 2) == jax_rs.bin_chromosomes(jg, 2)
    assert rs.SINGLE_MAPPER_BASE_CAP == jax_rs.SINGLE_MAPPER_BASE_CAP


def _huge(cls):
    class HugeGenome(cls):
        def chromosome_length(self, chrom_id):
            return 2**31 if chrom_id == 0 else 10**6
    return HugeGenome(["chrHuge", "chrSmall"], ["ACGT" * 64, "ACGT" * 64])


@pytest.mark.parametrize("partition,n", [
    ("auto", 1), ("auto", 2), ("auto", 3), ("chromosome", 2),
    ("window", 3)])
def test_plan_regions_equals_jax(partition, n):
    """The plan on a genome whose first chromosome is 2**31 bases long:
    auto cuts it under the staged-base cap (more regions than asked where
    one is asked); and on the binning genome."""
    opts, jopts = ProgramOptions(**BASE), JaxOptions(**BASE)
    got = rs.plan_regions(_huge(Genome), opts, n, partition)
    ref = jax_rs.plan_regions(_huge(JaxGenome), jopts, n, partition)
    assert _segments_as_tuples(got) == _segments_as_tuples(ref)
    if partition == "auto":
        assert len(got) >= max(n, 2)
        assert all(seg.staged_bases(_huge(Genome), opts, r, 36)
                   < rs.SINGLE_MAPPER_BASE_CAP for r in got)
    names = [f"c{i}" for i in range(5)]
    got = rs.plan_regions(Genome(names, GENOMES[1]), opts, n, partition)
    ref = jax_rs.plan_regions(JaxGenome(names, GENOMES[1]), jopts, n,
                              partition)
    assert _segments_as_tuples(got) == _segments_as_tuples(ref)


def _assert_regions_equal_jax(chroms, bases, lens, n_regions, partition,
                              **kw):
    ensure_reference_native()
    names = [f"c{i}" for i in range(len(chroms))]
    opts = dict(BASE, **kw)
    ref = jax_rs.RegionShardedMapper(
        JaxGenome(names, chroms), JaxOptions(**opts), n_regions,
        partition=partition).map_reads(bases.copy(), lens.copy())
    # as many (CPU) devices as the JAX side has, so that both place the
    # regions alike and build the same direct-probe tables
    mapper = rs.RegionShardedMapper(
        Genome(names, chroms), ProgramOptions(**opts), n_regions,
        devices=["cpu"] * len(jax.devices()), partition=partition)
    got = mapper.map_reads(bases.copy(), lens.copy())
    assert mapper.n_regions == n_regions
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
        assert getattr(got, f).dtype == getattr(ref, f).dtype, f
    assert got.stats == {k: v for k, v in ref.stats.items()
                         if not k.endswith("_fallback")}
    return got


@pytest.mark.parametrize("case,n_regions,partition,kw", [
    ("four", 2, "auto", {}), ("four", 4, "auto", {}),
    ("four", 3, "window", {}), ("four", 6, "window", {}),
    ("single", 5, "auto", {}),
    ("three_n", 4, "window", {"three_n_seeding": True})])
def test_region_mapper_equals_jax(case, n_regions, partition, kw):
    chroms, bases, lens = {"four": _dataset, "single": _single_chromosome,
                           "three_n": _three_n}[case]()
    got = _assert_regions_equal_jax(chroms, bases, lens, n_regions,
                                    partition, **kw)
    assert (got.orientation != 3).sum() > len(lens) // 2


def test_regions_with_scores_equal_the_single_mapper():
    """3N, window partition in 3 regions on one device (no cuckoo table):
    the merged rows and, for every mapped read, its two fused STEP-2 score
    columns, traceback entries and status equal the single mapper's."""
    chroms, bases, lens = _three_n()
    names = ["c0", "c1"]
    opts = ProgramOptions(**dict(BASE, three_n_seeding=True))
    single, (s_sc, s_to, s_ts) = CoarseMapper(
        Genome(names, chroms), opts, "cpu").map_reads(
        bases.copy(), lens.copy(), with_scores=True)
    mapper = rs.RegionShardedMapper(Genome(names, chroms), opts, 3,
                                    devices=["cpu"], partition="window")
    assert all(m.index.cuckoo_keys is None for m in mapper.mappers)
    got, (sc, to, ts) = mapper.map_reads(bases.copy(), lens.copy(),
                                         with_scores=True)
    assert got.stats["cuckoo_direct_probe"] == 0
    for f in FIELDS[:-2]:
        np.testing.assert_array_equal(getattr(got, f), getattr(single, f),
                                      err_msg=f)
    m = np.nonzero(single.orientation != 3)[0]
    assert len(m) > 25
    cols = np.sort(np.concatenate([2 * m, 2 * m + 1]))
    np.testing.assert_array_equal(sc[:, cols], s_sc[:, cols])
    np.testing.assert_array_equal(to[cols], s_to[cols])
    np.testing.assert_array_equal(ts[cols], s_ts[cols])
    unmapped = np.setdiff1d(np.arange(2 * len(lens)), cols)
    assert not sc[:, unmapped].any()


def test_cli_regions_equal_the_jax_cli(tmp_path):
    """--threeN --regions 2 (pipelined, fused STEP 2 in every region) on a
    two-chromosome genome: the port's SAM and VCF bytes are the JAX
    CLI's, and the regions reached RegionShardedMapper."""
    ensure_reference_native()
    rng = np.random.default_rng(9)
    acgt = np.array(list("ACGT"))
    seqs = {"chrA first": "".join(rng.choice(acgt, 5000)),
            "chrB": "".join(rng.choice(acgt, 3000))}
    with open(tmp_path / "g.fa", "w") as fh:
        for name, s in seqs.items():
            fh.write(f">{name}\n" + "\n".join(
                s[i:i + 60] for i in range(0, len(s), 60)) + "\n")
    comp = str.maketrans("ACGT", "TGCA")
    with open(tmp_path / "reads.fq", "w") as fh:
        for i in range(160):
            s = seqs[list(seqs)[i % 2]]
            st = int(rng.integers(0, len(s) - 90))
            r = s[st:st + 90]
            if rng.random() < 0.5:
                r = r.translate(comp)[::-1]
            r = "".join("T" if c == "C" and rng.random() < 0.8 else c
                        for c in r)
            fh.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    argv = ["--threeN", "--regions", "2", "--genomefile",
            str(tmp_path / "g.fa"), "-i", str(tmp_path / "reads.fq"), "-k",
            "12", "-m", "8", "--minTableHits", "3", "--batchsize", "64",
            "--maxHammingPercent", "0.1", "--maxReadLength", "96",
            "--pipelineChunk", "64", "-t", "2"]
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_cli_main(argv + ["-o", jax_out])
    res = cli.run(argv + ["--device", "cpu", "-o", out])
    assert isinstance(res["mapper"], rs.RegionShardedMapper)
    assert res["mapper"].n_regions == 2
    assert (res["results"].orientation != 3).sum() > 120
    for ext in (".SAM", ".VCF"):
        with open(jax_out + ext, "rb") as a, open(out + ext, "rb") as b:
            assert a.read() == b.read(), ext
