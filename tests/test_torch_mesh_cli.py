"""Port parity: the driver over a data x table mesh (--mesh D T, every
position the CPU) writes the JAX driver's SAM and VCF bytes on
tests/test_mesh_driver.py's dataset and options, alone and composed with
--regions; and the pipelined mesh run equals the sequential one.
(tests/test_torch_pipeline.py::test_options_outside_the_slice_raise holds
the refusal to save or load mesh-sharded tables.)"""

import gzip

import jax
import numpy as np
import pytest

from hashreadmapper_tpu.config import ProgramOptions as JaxOptions
from hashreadmapper_tpu.pipeline.driver import run_pipeline as jax_run
from hashreadmapper_tpu_torch.config import ProgramOptions
from hashreadmapper_tpu_torch.parallel.region_sharded import \
    RegionShardedMapper
from hashreadmapper_tpu_torch.parallel.sharded import ShardedCoarseMapper
from hashreadmapper_tpu_torch.pipeline.driver import run_pipeline

from torch_helpers import ensure_reference_native


def make_bs_dataset(tmp_path, n_reads=160, chrom_len=24000, read_len=60,
                    seed=7, pbat_half=False):
    """tests/test_mesh_driver.py::make_bs_dataset."""
    rng = np.random.default_rng(seed)
    b2c = np.array(list("ACGT"))
    chrom_bases = rng.integers(0, 4, chrom_len, dtype=np.int8)
    chrom = "".join(b2c[chrom_bases])
    fa = tmp_path / "g.fa"
    fa.write_text(">chrM test\n" + "\n".join(
        chrom[i:i + 70] for i in range(0, chrom_len, 70)) + "\n")
    comp = str.maketrans("ACGT", "TGCA")
    fq = tmp_path / "r.fq.gz"
    with gzip.open(fq, "wt") as f:
        for i in range(n_reads):
            s = rng.integers(0, chrom_len - read_len)
            r = list(chrom[s:s + read_len])
            if rng.random() < 0.5:
                r = list("".join(r).translate(comp)[::-1])
            src, dst = (("G", "A") if (pbat_half and i % 2) else ("C", "T"))
            for j, ch in enumerate(r):
                if ch == src and rng.random() < 0.9:
                    r[j] = dst
            f.write(f"@r{i}\n{''.join(r)}\n+\n{'I' * read_len}\n")
    return str(fa), str(fq)


def _options(tmp_path, fa, fq, label, mesh, undirectional, chunk=0,
             regions=0):
    """tests/test_mesh_driver.py::run_once's options (and --regions)."""
    return dict(
        inputfiles=[fq], genomefile=fa,
        outputfile=str(tmp_path / f"out_{label}"),
        kmer_length=12, num_hash_functions=8, window_size=64,
        min_table_hits=2, batchsize=16, max_hamming_percent=0.2,
        probe_cap=16, candidates_per_read_cap=8, max_read_length=64,
        three_n_seeding=True, undirectional=undirectional,
        shd_pairs_per_read_budget=4, probe_tail_budget_per_read=4,
        step2_pipeline_chunk=chunk, num_regions=regions,
        mesh_data=mesh[0] if mesh else None,
        mesh_table=mesh[1] if mesh else None)


def _outputs(opts):
    with open(opts["outputfile"] + ".SAM", "rb") as a, \
            open(opts["outputfile"] + ".VCF", "rb") as b:
        return a.read(), b.read()


@pytest.mark.parametrize("mesh,undirectional,regions", [
    ((2, 4), False, 0), ((4, 2), True, 0), ((2, 2), False, 2)],
    ids=["mesh 2 4", "mesh 4 2 undirectional", "regions 2 mesh 2 2"])
def test_mesh_cli_equals_the_jax_cli(tmp_path, mesh, undirectional, regions):
    if len(jax.devices()) < mesh[0] * mesh[1]:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    ensure_reference_native()
    fa, fq = make_bs_dataset(tmp_path, pbat_half=undirectional,
                             seed=11 if undirectional else 7)
    ref = _options(tmp_path, fa, fq, "jax", mesh, undirectional,
                   regions=regions)
    jax_run(JaxOptions(**ref))
    got = _options(tmp_path, fa, fq, "port", mesh, undirectional,
                   regions=regions)
    res = run_pipeline(ProgramOptions(**got), "cpu")
    mapper = res["mapper"]
    if regions:
        assert isinstance(mapper, RegionShardedMapper)
        assert mapper.n_regions == regions
        assert all(isinstance(m, ShardedCoarseMapper)
                   and m.mesh.shape == {"data": 2, "table": 2}
                   for m in mapper.mappers)
    else:
        assert isinstance(mapper, ShardedCoarseMapper)
        assert mapper.mesh.shape == {"data": mesh[0], "table": mesh[1]}
    sam, vcf = _outputs(got)
    assert (sam, vcf) == _outputs(ref)
    assert (res["results"].orientation != 3).sum() > 100
    if undirectional:
        assert b"YZ:A:<+>" in sam and (res["results"].bs_strand != 0).any()


def test_mesh_pipelined_equals_sequential(tmp_path):
    """--pipelineChunk 64 over a 4 x 2 mesh: the chunks' fused STEP 2 on
    the mesh writes the sequential mesh run's bytes."""
    ensure_reference_native()
    fa, fq = make_bs_dataset(tmp_path, seed=13)
    seq = _options(tmp_path, fa, fq, "seq", (4, 2), False, chunk=0)
    pipe = _options(tmp_path, fa, fq, "pipe", (4, 2), False, chunk=64)
    for opts in (seq, pipe):
        run_pipeline(ProgramOptions(**opts), "cpu")
    assert _outputs(pipe) == _outputs(seq)
