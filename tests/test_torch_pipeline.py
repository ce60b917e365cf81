"""Port parity end to end: the port's run_pipeline and CLI (device cpu)
against the JAX package's run_pipeline, byte-identical SAM and VCF, in
--threeN, parity and --threeN --undirectional modes; and the port's
independence of the JAX package (imports, native build)."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hashreadmapper_tpu.cli import options_from_args as jax_options
from hashreadmapper_tpu.pipeline.driver import run_pipeline as jax_pipeline
from hashreadmapper_tpu_torch import cli
from hashreadmapper_tpu_torch.io.genome import Genome
from hashreadmapper_tpu_torch.ops.bandtb_kernel import (fill_pass, shift_sub,
                                                        traceback)
from hashreadmapper_tpu_torch.ops.minhash_kernel import (signature_stage,
                                                         sigs_from_bases)
from hashreadmapper_tpu_torch.ops.shd_kernel import shd_best
from hashreadmapper_tpu_torch.ops.swdev_kernel import (pass_batched, sw_forward,
                                                       sw_reverse)
from hashreadmapper_tpu_torch.ops.vote_kernel import vote_candidates_fnc
from hashreadmapper_tpu_torch.pipeline.driver import run_pipeline
from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper

from torch_helpers import ACGT, ensure_reference_native, four_strand_reads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = (sigs_from_bases, signature_stage, vote_candidates_fnc, shd_best,
           pass_batched, sw_forward, sw_reverse, shift_sub, fill_pass,
           traceback)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The verify skill's recipe: a 12 kb and a 6 kb chromosome, 100 bp
    reads, 8% C->T in read space, half reverse-complemented, some N."""
    d = tmp_path_factory.mktemp("verify")
    rng = np.random.default_rng(21)
    chroms = {"chr1 first test chromosome": 12_000, "chr2": 6_000}
    seqs = {name: "".join(rng.choice(list("ACGT"), size=n))
            for name, n in chroms.items()}
    with open(d / "g.fa", "w") as fh:
        for name, s in seqs.items():
            fh.write(f">{name}\n" + "\n".join(
                s[i:i + 60] for i in range(0, len(s), 60)) + "\n")
    comp = str.maketrans("ACGT", "TGCA")
    with gzip.open(d / "reads.fq.gz", "wt") as fh:
        for i in range(240):
            s = seqs[list(seqs)[i % 2]]
            start = int(rng.integers(0, len(s) - 100))
            r = s[start:start + 100]
            if rng.random() < 0.5:
                r = r.translate(comp)[::-1]
            r = "".join("T" if c == "C" and rng.random() < 0.08 else c
                        for c in r)
            if i % 25 == 0:
                r = r[:40] + "N" + r[41:]
            fh.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return str(d)


@pytest.fixture(scope="module")
def four_strand_dataset(tmp_path_factory):
    """tests/test_undirectional.py's scenario: a 40 kb chromosome and 30
    reads of 80 bp of each strand kind (directional forward and reverse
    complement, PBAT forward and reverse complement), 90% converted in
    read space, every seventh with a substitution and every ninth with a
    3-base deletion; then 6 unconverted reads with 5 copies each, which
    parity mode's --maxResultsPerMap 4 drops."""
    d = tmp_path_factory.mktemp("four_strand")
    rng = np.random.default_rng(33)
    codes = rng.integers(0, 4, size=40_000, dtype=np.int8)
    chrom = "".join(ACGT[codes])
    with open(d / "g.fa", "w") as fh:
        fh.write(">chrU undirectional test\n" + "\n".join(
            chrom[i:i + 70] for i in range(0, len(chrom), 70)) + "\n")
    reads, _, starts, _ = four_strand_reads(rng, codes, 30)
    reads[::7, 40] = (reads[::7, 40] + 1) % 4
    seqs = ["".join(ACGT[r]) for r in reads]
    seqs[::9] = [q[:50] + q[53:] for q in seqs[::9]]
    plain = [chrom[s:s + 80] for s in starts[:6]]
    seqs += plain + plain * 4
    with gzip.open(d / "reads.fq.gz", "wt") as fh:
        for i, q in enumerate(seqs):
            fh.write(f"@r{i}\n{q}\n+\n{'I' * len(q)}\n")
    return str(d), len(seqs)


MODES = {"threeN": ["--threeN"], "parity": ["--maxResultsPerMap", "4"],
         "undirectional": ["--threeN", "--undirectional"]}


def _argv(d, out, chunk, mode="threeN"):
    return MODES[mode] + [
            "--genomefile", f"{d}/g.fa", "-i", f"{d}/reads.fq.gz",
            "-o", out, "-k", "16", "-m", "16", "--minTableHits", "4",
            "--maxHammingPercent", "0.25", "--batchsize", "128",
            "--maxReadLength", "112", "--probeCap", "16",
            "--candidatesPerRead", "8", "--shdPairBudget", "4",
            "--probeTailBudget", "4", "--probeHeadBudget", "18",
            "--pipelineChunk", str(chunk), "-t", "2"]


def _outputs(prefix):
    with open(prefix + ".SAM", "rb") as a, open(prefix + ".VCF", "rb") as b:
        return a.read(), b.read()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX CLI's SAM, VCF and coarse results per (dataset,
    --pipelineChunk, mode)."""
    ensure_reference_native()
    cache = {}

    def run(data, chunk, mode="threeN"):
        key = (data, chunk, mode)
        if key not in cache:
            out = str(tmp_path_factory.mktemp("jax") / "jax")
            res = jax_pipeline(jax_options(_argv(data, out, chunk, mode)))
            cache[key] = _outputs(out) + (res["results"],)
        return cache[key]
    return run


@pytest.mark.parametrize("chunk,step2", [
    pytest.param(0, "device", id="0"), pytest.param(100, "device", id="100"),
    pytest.param(0, "host", id="host-0"),
    pytest.param(100, "host", id="host-100")])
def test_sam_vcf_byte_identical_to_jax(dataset, tmp_path, jax_runs, chunk,
                                       step2):
    """Device STEP 2 (chunk 0: host-staged pairs; 100: fused into the
    coarse step) and host STEP 2 (opts.step2_device = False, set in code)
    against the JAX CLI; on the CPU no kernel launches."""
    jsam, jvcf, jres = jax_runs(dataset, chunk)
    before = [k.launches for k in KERNELS]
    topts, device = cli.options_from_args(
        _argv(dataset, str(tmp_path / "port"), chunk) + ["--device", "cpu"])
    assert topts.step2_device is True
    topts.step2_device = step2 == "device"
    tres = run_pipeline(topts, device)
    assert [k.launches for k in KERNELS] == before
    tsam, tvcf = _outputs(topts.outputfile)
    assert tsam == jsam
    assert tvcf == jvcf
    assert tsam.startswith(b"@HD\tVN:1.4")
    body = [ln for ln in tsam.split(b"\n") if ln and not ln.startswith(b"@")]
    assert len(body) == 240
    assert (tres["results"].orientation != 3).mean() > 0.9
    np.testing.assert_array_equal(tres["results"].position, jres.position)


@pytest.mark.parametrize("branch", ["fused", "staged", "host-fused",
                                    "host-staged"])
@pytest.mark.parametrize("mode", ["parity", "undirectional"])
def test_modes_sam_vcf_byte_identical_to_jax(four_strand_dataset, tmp_path,
                                             jax_runs, mode, branch):
    """Parity mode (canonical k-mers, the read-side key drops taken from
    the whole read set before the chunks) and --threeN --undirectional on
    the four-strand reads: device STEP 2 fused into the coarse step
    (--pipelineChunk 64) and on staged pairs (0), and host STEP 2, against
    the JAX CLI with the same flags."""
    data, n_reads = four_strand_dataset
    chunk = 64 if branch.endswith("fused") else 0
    jsam, jvcf, jres = jax_runs(data, chunk, mode)
    topts, device = cli.options_from_args(
        _argv(data, str(tmp_path / "port"), chunk, mode)
        + ["--device", "cpu"])
    topts.step2_device = not branch.startswith("host")
    tres = run_pipeline(topts, device)
    tsam, tvcf = _outputs(topts.outputfile)
    assert tsam == jsam
    assert tvcf == jvcf
    body = [ln for ln in tsam.split(b"\n") if ln and not ln.startswith(b"@")]
    assert len(body) == n_reads
    r = tres["results"]
    for f in ("orientation", "hamming", "shift", "chromosome_id", "position",
              "bs_strand"):
        np.testing.assert_array_equal(getattr(r, f), getattr(jres, f), f)
    for k in ("probe_overflow", "vote_overflow", "pair_budget_overflow",
              "probe_tail_overflow", "probe_head_overflow"):
        assert r.stats[k] == jres.stats[k], k
    mapped = r.orientation != 3
    kind = np.repeat(np.arange(4), 30)
    if mode == "undirectional":
        for k in range(4):
            assert mapped[:120][kind == k].mean() > 0.7, k
        # the strand column tells the PBAT strands from the directional
        # ones (at --maxHammingPercent 0.25 a stray read may cross over)
        assert (r.bs_strand[:120][mapped[:120] & (kind >= 2)] == 1).mean() \
            > 0.9
        assert (r.bs_strand[:120][kind < 2] == 0).mean() > 0.9
        assert mapped[120:].all()
    else:
        # 90% converted reads are invisible to parity mode; the unconverted
        # ones map, except the 6 x 5 copies that the key-drop rule removes
        assert mapped[:120].mean() < 0.2
        assert not mapped[120:].any() and not r.bs_strand.any()


def test_parity_maps_unconverted_reads_without_the_drop_rule(
        four_strand_dataset, tmp_path):
    """The same parity run with the default --maxResultsPerMap: nothing is
    dropped and the 30 unconverted reads map."""
    data, n_reads = four_strand_dataset
    argv = _argv(data, str(tmp_path / "port"), 0, "parity")
    topts, device = cli.options_from_args(argv[2:] + ["--device", "cpu"])
    assert topts.max_results_per_map == 65535
    r = run_pipeline(topts, device)["results"]
    assert (r.orientation[120:] != 3).all()


def test_edlib_sam_byte_identical_to_jax(dataset, tmp_path):
    """--mappertype edlib is host-only, so the port takes it unchanged."""
    edlib = ["--mappertype", "edlib"]
    jopts = jax_options(_argv(dataset, str(tmp_path / "jax"), 0) + edlib)
    jax_pipeline(jopts)
    topts, device = cli.options_from_args(
        _argv(dataset, str(tmp_path / "port"), 0) + edlib
        + ["--device", "cpu"])
    run_pipeline(topts, device)
    with open(jopts.outputfile + ".SAM", "rb") as a, \
            open(topts.outputfile + ".SAM", "rb") as b:
        jsam, tsam = a.read(), b.read()
    assert tsam == jsam and tsam.startswith(b"@HD")


def test_cli_subprocess_runs_without_jax(dataset, tmp_path):
    out = str(tmp_path / "cli")
    code = ("import sys; from hashreadmapper_tpu_torch.cli import main; "
            f"main({_argv(dataset, out, 0) + ['--device', 'cpu']!r}); "
            "assert 'jax' not in sys.modules, 'jax was imported'; "
            "print('NO_JAX_OK')")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    sam, _ = _outputs(out)
    assert b"Yf:i:" in sam and b"YZ:A:" in sam


def test_index_saved_by_the_cli_loads_back(dataset, tmp_path):
    """--save-hashtables-to, then --load-hashtables-from: the same SAM and
    VCF bytes."""
    idx = str(tmp_path / "idx.npz")
    outs = []
    for i, extra in enumerate((["--save-hashtables-to", idx],
                               ["--load-hashtables-from", idx])):
        out = str(tmp_path / f"run{i}")
        cli.run(_argv(dataset, out, 0) + ["--device", "cpu"] + extra)
        outs.append(_outputs(out))
    assert outs[0] == outs[1]


def test_genome_of_2_31_bases_raises():
    """A single mapper stages fewer than 2**31 bases; the error points to
    the regions."""
    class HugeGenome(Genome):
        def chromosome_length(self, chrom_id):
            return 2**31

    genome = HugeGenome(["chrHuge"], ["ACGT" * 64])
    opts, _ = cli.options_from_args(["--threeN", "--device", "cpu"])
    with pytest.raises(ValueError, match="RegionShardedMapper.*--regions"):
        CoarseMapper(genome, opts, "cpu")


@pytest.mark.parametrize("extra,item", [
    (["--threeN", "--mesh", "1", "2"], "item 15"),
    (["--threeN", "--regions", "2", "--mesh", "1", "2"], "item 15")])
def test_options_outside_the_slice_raise(extra, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.options_from_args(["--device", "cpu"] + extra)


def test_regions_reach_the_region_sharded_mapper(dataset, tmp_path):
    """--regions 2 is no longer refused: the driver builds a
    RegionShardedMapper of two regions, one a chromosome, on the device
    asked for, and writes a SAM with mapped rows."""
    from hashreadmapper_tpu_torch.parallel.region_sharded import \
        RegionShardedMapper
    out = str(tmp_path / "regions")
    res = cli.run(_argv(dataset, out, 0) + ["--device", "cpu",
                                            "--regions", "2"])
    mapper = res["mapper"]
    assert isinstance(mapper, RegionShardedMapper)
    assert mapper.n_regions == 2 and mapper.device == torch.device("cpu")
    assert [[s.chrom_id for s in r] for r in mapper.regions] == [[0], [1]]
    sam, _ = _outputs(out)
    assert b"Yf:i:" in sam


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        cli.options_from_args(["--threeN"])
