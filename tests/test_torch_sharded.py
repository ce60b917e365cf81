"""Port parity: the data x table mesh (parallel/sharded.py, PyTorch on a
mesh whose every position is the CPU) against the port's single
CoarseMapper on tests/test_sharded.py's shapes and options, and against
the JAX package's ShardedCoarseMapper at (2, 4): all 7 packed fields, the
5 overflow counters and cuckoo_direct_probe equal."""

import random

import jax
import numpy as np
import pytest

from hashreadmapper_tpu.config import ProgramOptions as JaxOptions
from hashreadmapper_tpu.cpu import oracle
from hashreadmapper_tpu.io.genome import Genome as JaxGenome
from hashreadmapper_tpu.parallel import sharded as jax_sharded
from hashreadmapper_tpu_torch.config import ProgramOptions
from hashreadmapper_tpu_torch.io.genome import Genome
from hashreadmapper_tpu_torch.parallel.sharded import (ShardedCoarseMapper,
                                                       make_mesh)
from hashreadmapper_tpu_torch.pipeline.engine import (OVERFLOW_KEYS,
                                                      CoarseMapper)

from torch_helpers import ensure_reference_native

FIELDS = ("orientation", "hamming", "shift", "chromosome_id", "position",
          "global_window_id", "bs_strand")
BASE = dict(kmer_length=8, num_hash_functions=8, window_size=32,
            min_table_hits=2, batchsize=8, max_hamming_percent=0.15,
            probe_cap=64, candidates_per_read_cap=32, max_read_length=32)


def _reads(rng, chrom, n_reads, maxlen, planted, convert=None):
    reads = []
    for _ in range(n_reads):
        rl = rng.randint(12, maxlen)
        if rng.random() < planted:
            s = rng.randrange(len(chrom) - rl)
            b = oracle.encode_bases(chrom[s:s + rl])
            if convert is not None:
                b = convert(b)
            if rng.random() < 0.5:
                b = oracle.revcomp_bases(b)
        else:
            b = [rng.randrange(4) for _ in range(rl)]
        reads.append(b)
    bases = np.zeros((n_reads, maxlen), dtype=np.int8)
    lens = np.zeros(n_reads, dtype=np.int32)
    for i, b in enumerate(reads):
        bases[i, :len(b)] = b
        lens[i] = len(b)
    return bases, lens


def _data(seed=11, n_reads=48, chrom_len=2000, maxlen=32):
    """tests/test_sharded.py::_data."""
    rng = random.Random(seed)
    chrom = "".join(rng.choice("ACGT") for _ in range(chrom_len))
    return chrom, *_reads(rng, chrom, n_reads, maxlen, 0.75)


def _bs_data(seed=17, n_reads=48, chrom_len=2000, maxlen=32, conv=0.9):
    """tests/test_sharded.py::_bs_data: C->T at `conv`, then 50% RC."""
    rng = random.Random(seed)
    chrom = "".join(rng.choice("ACGT") for _ in range(chrom_len))

    def convert(b):
        return [(3 if (x == 1 and rng.random() < conv) else x) for x in b]
    return chrom, *_reads(rng, chrom, n_reads, maxlen, 0.8, convert)


def _pbat_data(seed=29, n_reads=64, chrom_len=2000, maxlen=32):
    """Half the planted reads G->A converted (the PBAT strands)."""
    rng = random.Random(seed)
    chrom = "".join(rng.choice("ACGT") for _ in range(chrom_len))

    def convert(b):
        src, dst = (2, 0) if rng.random() < 0.5 else (1, 3)
        return [(dst if (x == src and rng.random() < 0.9) else x) for x in b]
    return chrom, *_reads(rng, chrom, n_reads, maxlen, 0.85, convert)


def _repeat_data(seed=31, n_reads=64, unit=300, copies=8, maxlen=32):
    """C->T converted reads of a genome of `copies` mutated copies of one
    unit: most probes find more windows than a small cap."""
    rng = random.Random(seed)
    base = [rng.choice("ACGT") for _ in range(unit)]
    chrom = "".join("".join(c if rng.random() > 0.02 else rng.choice("ACGT")
                            for c in base) for _ in range(copies))

    def convert(b):
        return [(3 if (x == 1 and rng.random() < 0.9) else x) for x in b]
    return chrom, *_reads(rng, chrom, n_reads, maxlen, 0.9, convert)


def _cpu_mesh(shape):
    return make_mesh(*shape, ["cpu"] * (shape[0] * shape[1]))


def _assert_equal(got, want, mapped_only=False):
    keep = (want.orientation != 3) if mapped_only else slice(None)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f)[keep],
                                      getattr(want, f)[keep], err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f


@pytest.mark.parametrize("three_n", [False, True], ids=["parity", "3N"])
@pytest.mark.parametrize("shape", [(4, 2), (8, 1), (2, 4), (1, 8)])
def test_mesh_equals_the_single_mapper(shape, three_n):
    """Every packed field and counter equals the port's single mapper
    (no counter is over on these reads), parity and 3N."""
    chrom, bases, lens = (_bs_data if three_n else _data)()
    opts = ProgramOptions(**BASE, three_n_seeding=three_n)
    genome = Genome(["c0"], [chrom])
    want = CoarseMapper(genome, opts, "cpu").map_reads(bases.copy(),
                                                       lens.copy())
    # tests/test_sharded.py::n_mapped_floor
    assert (want.orientation != 3).sum() > len(lens) // 4
    mapper = ShardedCoarseMapper(genome, opts, _cpu_mesh(shape))
    got = mapper.map_reads(bases.copy(), lens.copy())
    _assert_equal(got, want)
    assert got.stats == want.stats
    assert not any(got.stats[k] for k in OVERFLOW_KEYS)
    assert mapper.device.type == "cpu"


BUDGETS = {"three_n_seeding": True, "probe_cap": 8,
           "candidates_per_read_cap": 8, "shd_pairs_per_read_budget": 4,
           "probe_tail_budget_per_read": 4}
CASES = {
    "parity": (_data, {}),
    "3N": (_bs_data, {"three_n_seeding": True}),
    "3N undirectional": (_pbat_data, {"three_n_seeding": True,
                                      "undirectional": True}),
    # tests/test_sharded.py:158
    "budgets": (lambda: _bs_data(seed=23), BUDGETS),
    # a repetitive genome and tighter budgets: every counter over
    "budgets over": (_repeat_data, dict(BUDGETS, shd_pairs_per_read_budget=2,
                                        probe_tail_budget_per_read=1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_equals_the_jax_mesh(case):
    """(2, 4): the port's mesh and JAX's ShardedCoarseMapper give the same
    packed fields, counters and cuckoo_direct_probe."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    ensure_reference_native()
    make, kw = CASES[case]
    chrom, bases, lens = make()
    opts = dict(BASE, **kw)
    ref = jax_sharded.ShardedCoarseMapper(
        JaxGenome(["c0"], [chrom]), JaxOptions(**opts),
        jax_sharded.make_mesh(2, 4)).map_reads(bases.copy(), lens.copy())
    got = ShardedCoarseMapper(Genome(["c0"], [chrom]),
                              ProgramOptions(**opts), _cpu_mesh((2, 4))
                              ).map_reads(bases.copy(), lens.copy())
    _assert_equal(got, ref)
    assert got.stats == {k: v for k, v in ref.stats.items()
                         if not k.endswith("_fallback")}
    assert (got.orientation != 3).sum() > len(lens) // 4
    if case == "budgets over":
        assert all(got.stats[k] > 0 for k in OVERFLOW_KEYS[:4]), got.stats
    if case == "3N undirectional":
        assert (got.bs_strand != 0).any()


def test_mesh_with_scores_equals_the_single_mapper():
    """The fused STEP-2 bundle of the mesh (columns in read order) equals
    the single mapper's, 3N at (2, 4), 3 mesh batches and a ragged end."""
    chrom, bases, lens = _bs_data(n_reads=45)
    opts = ProgramOptions(**BASE, three_n_seeding=True)
    genome = Genome(["c0"], [chrom])
    want, w_bundle = CoarseMapper(genome, opts, "cpu").map_reads(
        bases.copy(), lens.copy(), with_scores=True)
    got, g_bundle = ShardedCoarseMapper(genome, opts, _cpu_mesh((2, 4))
                                        ).map_reads(bases.copy(), lens.copy(),
                                                    with_scores=True)
    _assert_equal(got, want)
    assert len(g_bundle) == 3
    for g, w in zip(g_bundle, w_bundle):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert g_bundle[0].shape == (10, 2 * len(lens))


def test_index_build_is_sharded():
    """tests/test_sharded.py::test_sharded_index_build_is_sharded per mesh
    position: no position holds more than its table shard; the shards
    partition the single mapper's tables; a shard shared by the positions
    of one device is stored once there."""
    chrom, bases, lens = _data(seed=5)
    opts = ProgramOptions(**BASE)
    genome = Genome(["c0"], [chrom])
    mapper = ShardedCoarseMapper(genome, opts, _cpu_mesh((2, 4)))
    per_pos = mapper.index_memory_per_position()
    assert len(per_pos) == 8
    total = sum(per_pos.values())
    for pos, b in per_pos.items():
        assert b <= total // mapper.mesh.shape["table"] + 1024, (pos, b)
    # one device: every shard once, not once a data row
    assert mapper.index_memory_per_device() == {
        "cpu": sum(per_pos[(0, t)] for t in range(4))}
    assert mapper.memory_bytes() == total // 2
    single = CoarseMapper(genome, opts, "cpu")
    keys = np.concatenate([mapper.shards[t][mapper.mesh.devices[0][t]]
                           .keys.numpy() for t in range(4)])
    np.testing.assert_array_equal(keys, single.index.keys.numpy())
    assert all(s.keys.shape[0] == 2 for by in mapper.shards
               for s in by.values())


def test_three_n_read_drops_are_refused():
    chrom, bases, lens = _bs_data()
    mapper = ShardedCoarseMapper(
        Genome(["c0"], [chrom]), ProgramOptions(**BASE, three_n_seeding=True),
        _cpu_mesh((2, 2)))
    sigs = np.zeros((len(lens), 16), np.uint32)
    with pytest.raises(ValueError, match="parity-mode"):
        mapper.set_read_drops(sigs, np.ones(len(lens), bool))
    with pytest.raises(ValueError, match="single-device"):
        mapper.map_reads(bases, lens, collect_candidates=True)


def test_parity_read_drops_split_by_table_columns():
    """A key carried by more reads than max_results_per_map is dropped in
    the mesh as in the single mapper: the same mask, split over the
    table shards, gives the same results."""
    chrom, bases, lens = _data(seed=7)
    bases = np.concatenate([bases, np.repeat(bases[:1], 6, axis=0)])
    lens = np.concatenate([lens, np.repeat(lens[:1], 6)])
    opts = ProgramOptions(**BASE, max_results_per_map=4)
    genome = Genome(["c0"], [chrom])
    single = CoarseMapper(genome, opts, "cpu")
    want = single.map_reads(bases.copy(), lens.copy())
    assert int(single.dropped[1].sum()) > 0
    mapper = ShardedCoarseMapper(genome, opts, _cpu_mesh((2, 4)))
    got = mapper.map_reads(bases.copy(), lens.copy())
    _assert_equal(got, want)
    drops = [mapper.dropped[(t, mapper.mesh.devices[0][t])][1]
             for t in range(4)]
    np.testing.assert_array_equal(np.concatenate(drops),
                                  single.dropped[1].numpy())


def test_make_mesh_counts_cards():
    """Without devices the mesh takes CUDA cards and raises, naming both
    counts, when there are fewer; an explicit list must fill the mesh."""
    import torch
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"needs {have + 1} CUDA devices, "
                                         f"have {have}"):
        make_mesh(have + 1, 1)
    with pytest.raises(ValueError, match="takes 4 devices, got 3"):
        make_mesh(2, 2, ["cpu"] * 3)
    mesh = make_mesh(2, 3, ["cpu"] * 6)
    assert mesh.shape == {"data": 2, "table": 3}
    assert mesh.column(1) == [torch.device("cpu")]
    # the driver's mesh for a CUDA device is made of cards, never the CPU
    from hashreadmapper_tpu_torch.pipeline.driver import build_mesh
    opts = ProgramOptions(**BASE, mesh_data=have + 1, mesh_table=1)
    with pytest.raises(ValueError, match="CUDA devices"):
        build_mesh(opts, torch.device("cuda"))
    assert build_mesh(opts, torch.device("cpu")).devices == [
        [torch.device("cpu")]] * (have + 1)
    assert build_mesh(ProgramOptions(**BASE), torch.device("cuda")) is None
