"""Port parity end to end: the port's run_pipeline and CLI (device cpu)
against the JAX package's run_pipeline, byte-identical SAM and VCF."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hashreadmapper_tpu.io.genome import Genome
from hashreadmapper_tpu.pipeline.driver import run_pipeline as jax_pipeline
from hashreadmapper_tpu_torch import cli
from hashreadmapper_tpu_torch.ops.bandtb_kernel import fill_pass, shift_sub
from hashreadmapper_tpu_torch.ops.minhash_kernel import sigs_from_bases
from hashreadmapper_tpu_torch.ops.shd_kernel import shd_best
from hashreadmapper_tpu_torch.ops.swdev_kernel import pass_batched
from hashreadmapper_tpu_torch.ops.vote_kernel import vote_candidates_fnc
from hashreadmapper_tpu_torch.pipeline.driver import run_pipeline
from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = (sigs_from_bases, vote_candidates_fnc, shd_best, pass_batched,
           shift_sub, fill_pass)


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


def _argv(d, out, chunk):
    return ["--threeN", "--genomefile", f"{d}/g.fa", "-i", f"{d}/reads.fq.gz",
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
def jax_runs(dataset, tmp_path_factory):
    """The JAX CLI's SAM, VCF and coarse positions per --pipelineChunk."""
    from hashreadmapper_tpu.cli import options_from_args
    cache = {}

    def run(chunk):
        if chunk not in cache:
            out = str(tmp_path_factory.mktemp("jax") / "jax")
            res = jax_pipeline(options_from_args(_argv(dataset, out, chunk)))
            cache[chunk] = _outputs(out) + (res["results"].position,)
        return cache[chunk]
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
    jsam, jvcf, jpos = jax_runs(chunk)
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
    np.testing.assert_array_equal(tres["results"].position, jpos)


def test_edlib_sam_byte_identical_to_jax(dataset, tmp_path):
    """--mappertype edlib is host-only, so the port takes it unchanged."""
    from hashreadmapper_tpu.cli import options_from_args
    edlib = ["--mappertype", "edlib"]
    jopts = options_from_args(_argv(dataset, str(tmp_path / "jax"), 0)
                              + edlib)
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
    class HugeGenome(Genome):
        def chromosome_length(self, chrom_id):
            return 2**31

    genome = HugeGenome(["chrHuge"], ["ACGT" * 64])
    opts, _ = cli.options_from_args(["--threeN", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 14"):
        CoarseMapper(genome, opts, "cpu")


@pytest.mark.parametrize("extra,item", [
    ([], "item 11"), (["--threeN", "--undirectional"], "item 11"),
    (["--threeN", "--mesh", "1", "2"], "item 15"),
    (["--threeN", "--regions", "2"], "item 14")])
def test_options_outside_the_slice_raise(extra, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.options_from_args(["--device", "cpu"] + extra)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        cli.options_from_args(["--threeN"])
