"""Port parity for the mesh's dispatch units (parallel/sharded.py): on the
CPU a data shard's batch runs its steps (pipeline/graphs.py) eagerly on
their static buffers, on a card each is a captured CUDA graph
(tests/test_torch_cuda.py).  The port's map_batch and
_map_reads_device_scored against the JAX ShardedCoarseMapper's; the row
split at the cards (head, a probe a card, tail) against the whole-row
step and the eager _map_shard_batch; regions over a mesh, every region
enqueued before the first fetch, against the JAX RegionShardedMapper; a
replaced drop mask drops the captured steps.  tests/test_torch_sharded.py's
data (batch 8, 2 kb genomes); every comparison exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashreadmapper_tpu.config import ProgramOptions as JaxOptions
from hashreadmapper_tpu.io.genome import Genome as JaxGenome
from hashreadmapper_tpu.parallel import region_sharded as jax_rs
from hashreadmapper_tpu.parallel import sharded as jax_sharded
from hashreadmapper_tpu_torch.config import ProgramOptions
from hashreadmapper_tpu_torch.io.genome import Genome
from hashreadmapper_tpu_torch.parallel import region_sharded as rs
from hashreadmapper_tpu_torch.parallel.sharded import (ShardedCoarseMapper,
                                                       make_mesh)

from test_torch_sharded import BASE, _bs_data, _data, _pbat_data
from torch_helpers import ensure_reference_native

STEP_OUTPUTS = ("packed", "overflow", "scores", "tb_ops", "tb_status")


def _need_eight():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    ensure_reference_native()


def _cpu_mesh(shape):
    return make_mesh(*shape, ["cpu"] * (shape[0] * shape[1]))


def _equal(label, got, want):
    for name, g, w in zip(STEP_OUTPUTS, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (label, name, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=f"{label} {name}")


@pytest.mark.parametrize("shape,three_n", [((2, 4), True), ((4, 2), False)],
                         ids=["3N 2x4", "parity 4x2"])
def test_map_batch_equals_jax(shape, three_n):
    """One mesh batch (batchsize * D rows): packed rows and the overflow
    summed over the data shards equal the JAX mesh's map_batch."""
    _need_eight()
    chrom, bases, lens = (_bs_data if three_n else _data)()
    opts = dict(BASE, three_n_seeding=three_n)
    rows = BASE["batchsize"] * shape[0]
    b, ln = bases[:rows], lens[:rows]
    valid = np.arange(rows) < rows - 3          # a ragged end
    jm = jax_sharded.ShardedCoarseMapper(
        JaxGenome(["c0"], [chrom]), JaxOptions(**opts),
        jax_sharded.make_mesh(*shape))
    want = jm.map_batch(jnp.asarray(b), jnp.asarray(ln), jnp.asarray(valid))
    tm = ShardedCoarseMapper(Genome(["c0"], [chrom]),
                             ProgramOptions(**opts), _cpu_mesh(shape))
    got = tm.map_batch(torch.from_numpy(b), torch.from_numpy(ln),
                       torch.from_numpy(valid))
    assert got[0].shape == (rows, 7) and got[0].dtype == torch.int32
    _equal("map_batch", got, want)
    assert (got[0][:, 0] != 3).any()
    with pytest.raises(ValueError, match="mesh batch"):
        tm.map_batch(*(torch.from_numpy(x[:-1]) for x in (b, ln, valid)))


def test_map_reads_device_scored_equals_jax():
    """(2, 2) under --undirectional, 64 reads staged as 4 mesh batches:
    packed, overflow, the 10 score rows, tb_ops and tb_status equal the
    JAX mesh's _map_reads_device_scored."""
    _need_eight()
    chrom, bases, lens = _pbat_data()
    opts = dict(BASE, three_n_seeding=True, undirectional=True)
    bsz = BASE["batchsize"]
    jm = jax_sharded.ShardedCoarseMapper(
        JaxGenome(["c0"], [chrom]), JaxOptions(**opts),
        jax_sharded.make_mesh(2, 2))
    want = jm._map_reads_device_scored(
        *jm.stage_reads_device(bases.copy(), lens.copy()), bsz)
    tm = ShardedCoarseMapper(Genome(["c0"], [chrom]),
                             ProgramOptions(**opts), _cpu_mesh((2, 2)))
    staged = tm.stage_reads_device(bases.copy(), lens.copy())
    assert staged[-1] == len(lens) and staged[0][1].shape == (4, bsz, 32)
    got = tm._map_reads_device_scored(*staged, bsz)
    _equal("_map_reads_device_scored", got, want)
    assert got[2].shape == (10, 2 * len(lens))
    assert (got[0][:, 6] != 0).any()
    # the coarse unit's rows and counters are the scored unit's
    coarse = tm._map_reads_device(*staged, bsz)
    _equal("_map_reads_device", coarse[:2], got[:2])
    assert coarse[2] is None


SPLITS = {
    # each table shard a card of its own
    "a card each": lambda t_n: [("cpu", (t,)) for t in range(t_n)],
    # two cards, table shards interleaved over them
    "interleaved": lambda t_n: [("cpu", tuple(range(0, t_n, 2))),
                                ("cpu", tuple(range(1, t_n, 2)))],
}


@pytest.fixture(scope="module")
def split_case():
    """(genome, options, reads, lengths) of the split-plan cases: 3N
    --undirectional at (2, 4), 45 reads (3 mesh batches, a ragged end)."""
    chrom, bases, lens = _pbat_data(n_reads=45)
    opts = ProgramOptions(**BASE, three_n_seeding=True, undirectional=True)
    return Genome(["c0"], [chrom]), opts, bases, lens


@pytest.mark.parametrize("with_scores", [False, True],
                         ids=["coarse", "scores"])
@pytest.mark.parametrize("split", list(SPLITS))
def test_split_plan_equals_whole_row_and_eager(split_case, split,
                                               with_scores):
    """The row split at the cards (the head, a probe step a card with the
    lists copied into the tail's inputs in table order, forward before
    mirrored, the tail) equals the whole-row step and the eager
    _map_shard_batch of every batch, with and without the fused STEP 2."""
    genome, opts, bases, lens = split_case
    mesh = _cpu_mesh((2, 4))
    whole = ShardedCoarseMapper(genome, opts, mesh)
    split_m = ShardedCoarseMapper(genome, opts, mesh,
                                  plan=[SPLITS[split](4)] * 2)
    assert whole._whole(0) and not split_m._whole(0)
    unit = "_map_reads_device_scored" if with_scores else "_map_reads_device"
    outs = {}
    for label, m in (("whole", whole), ("split", split_m)):
        staged = m.stage_reads_device(bases.copy(), lens.copy())
        outs[label] = getattr(m, unit)(*staged, opts.batchsize)
    assert {k[0] for k in split_m._steps} == {"head", "probe", "tail"}
    assert {k[0] for k in whole._steps} == {"row"}
    # the eager step of each data shard's batch, in read order
    bases_s, lens_s, valid_s, n_pad = staged
    eager = [split_m._map_shard_batch(d, bases_s[d][i], lens_s[d][i],
                                      valid_s[d][i], with_scores)
             for i in range(bases_s[0].shape[0]) for d in range(2)]
    want = [torch.cat([e[0] for e in eager]),
            torch.stack([e[1] for e in eager]).sum(dim=0)]
    if with_scores:
        want += [torch.cat([e[2] for e in eager], dim=1),
                 torch.cat([e[3] for e in eager]),
                 torch.cat([e[4] for e in eager])]
    _equal(f"{split} split == whole", outs["split"], outs["whole"])
    _equal(f"{split} split == eager", outs["split"], want)
    assert outs["split"][0].shape == (n_pad, 7)
    assert (outs["split"][0][:len(lens), 0] != 3).sum() > len(lens) // 4


def test_split_plan_is_checked(split_case):
    genome, opts, _, _ = split_case
    with pytest.raises(ValueError, match="each of its 2 table shards once"):
        ShardedCoarseMapper(genome, opts, _cpu_mesh((1, 2)),
                            plan=[[("cpu", (0,))]])
    with pytest.raises(ValueError, match="not on cuda:3"):
        ShardedCoarseMapper(genome, opts, _cpu_mesh((1, 2)),
                            plan=[[("cuda:3", (0, 1))]])


def test_regions_over_a_mesh_enqueue_every_region_first(monkeypatch):
    """2 window regions over a (1, 2) CPU mesh with the fused STEP 2: the
    reads staged once, every region's batches enqueued before the first
    fetch; the merged rows, stats and bundle equal the JAX
    RegionShardedMapper's over a (1, 2) mesh."""
    _need_eight()
    chrom, bases, lens = _bs_data(n_reads=40)
    opts = dict(BASE, three_n_seeding=True)
    calls = []
    for name in ("stage_reads_device", "map_staged", "fetch_results"):
        real = getattr(ShardedCoarseMapper, name)

        def logged(self, *a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(self, *a, **kw)
        monkeypatch.setattr(ShardedCoarseMapper, name, logged)
    got, g_bundle = rs.RegionShardedMapper(
        Genome(["c0"], [chrom]), ProgramOptions(**opts), 2,
        partition="window", mesh=_cpu_mesh((1, 2))).map_reads(
        bases.copy(), lens.copy(), with_scores=True)
    assert calls == ["stage_reads_device"] + ["map_staged"] * 2 \
        + ["fetch_results"] * 2
    want, w_bundle = jax_rs.RegionShardedMapper(
        JaxGenome(["c0"], [chrom]), JaxOptions(**opts), 2,
        partition="window", mesh=jax_sharded.make_mesh(1, 2)).map_reads(
        bases.copy(), lens.copy(), with_scores=True)
    for f in ("orientation", "hamming", "shift", "chromosome_id",
              "position", "global_window_id", "global_window_id64",
              "bs_strand"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.stats == {k: v for k, v in want.stats.items()
                         if not k.endswith("_fallback")}
    _equal("regions bundle", (None, None) + tuple(g_bundle),
           (None, None) + tuple(w_bundle))
    assert (got.orientation != 3).sum() > len(lens) // 4


def test_replaced_drop_mask_drops_the_steps():
    """Parity mode: the steps captured with one drop mask are dropped when
    set_read_drops replaces it, and the mesh then equals a new mapper
    given the same mask."""
    chrom, bases, lens = _data(seed=7)
    bases = np.concatenate([bases, np.repeat(bases[:1], 6, axis=0)])
    lens = np.concatenate([lens, np.repeat(lens[:1], 6)])
    opts = ProgramOptions(**BASE, max_results_per_map=4)
    genome = Genome(["c0"], [chrom])
    m = ShardedCoarseMapper(genome, opts, _cpu_mesh((2, 2)))
    m.map_reads_packed(bases, lens)
    empty = dict(m._steps)
    assert empty and m._steps_dropped is m.dropped
    m.map_reads(bases, lens)               # the read set's own drops
    assert m._steps and not set(map(id, m._steps.values())) & set(
        map(id, empty.values()))
    want = ShardedCoarseMapper(genome, opts, _cpu_mesh((2, 2))).map_reads(
        bases, lens)
    got = m.map_reads(bases, lens)
    assert int(sum(n.sum() for _, n in m.dropped.values())) > 0
    for f in ("orientation", "hamming", "position", "global_window_id"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert got.stats == want.stats
