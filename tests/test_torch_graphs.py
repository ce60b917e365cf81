"""Port parity for the batch steps of pipeline/graphs.py on the CPU, where a
step runs eagerly on its static buffers (on a card each is a captured CUDA
graph, tests/test_torch_cuda.py): the port's map_pool_scanned,
_map_reads_device and _map_reads_device_scored against the JAX engine's
one-dispatch units of the same names, in --threeN, --threeN
--undirectional and parity mode, at tests/test_engine_equiv.py's size
(300 kbp, 256 reads, batch 128); the window stream with per-batch device
offsets against the JAX package's map_genome; and the copy-out of a
step's static outputs.  Inputs from numpy seeds; every comparison exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashreadmapper_tpu.config import ProgramOptions as JaxOptions
from hashreadmapper_tpu.io.genome import Genome as JaxGenome
from hashreadmapper_tpu.pipeline.engine import CoarseMapper as JaxMapper
from hashreadmapper_tpu.pipeline.window_stream import \
    WindowStreamMapper as JaxStream
from hashreadmapper_tpu_torch.config import ProgramOptions
from hashreadmapper_tpu_torch.io.genome import Genome
from hashreadmapper_tpu_torch.pipeline import graphs
from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper
from hashreadmapper_tpu_torch.pipeline.window_stream import WindowStreamMapper

from torch_helpers import ACGT, ensure_reference_native, four_strand_reads

G_LEN, N_READS, BSZ = 300_000, 256, 128
# test_engine_equiv.py's options; parity with maxResultsPerMap 10 against
# 12 copies of a few reads (the read-side key drops)
OPTS = dict(kmer_length=16, num_hash_functions=8, window_size=128,
            min_table_hits=2, batchsize=BSZ, max_hamming_percent=0.05,
            probe_cap=16, candidates_per_read_cap=8, max_read_length=128,
            three_n_seeding=True, shd_pairs_per_read_budget=4,
            probe_tail_budget_per_read=4, probe_head_budget_per_read=18)
MODES = {"threeN": dict(OPTS),
         "undirectional": dict(OPTS, undirectional=True,
                               candidates_per_read_cap=16,
                               max_hamming_percent=0.1),
         "parity": dict(OPTS, three_n_seeding=False, max_results_per_map=10)}


def _case(mode):
    """(genome bases, reads [N, 100] int8, lengths): test_engine_equiv.py's
    planted reads with 90% C->T (four strands under --undirectional,
    unconverted with 1% substitutions and repeated reads in parity)."""
    rng = np.random.default_rng({"threeN": 4, "undirectional": 5,
                                 "parity": 6}[mode])
    gb = rng.integers(0, 4, size=G_LEN, dtype=np.int8)
    if mode == "undirectional":
        reads, lengths, _, _ = four_strand_reads(rng, gb, N_READS // 4, 100)
        return gb, reads, lengths
    starts = rng.integers(0, G_LEN - 100, size=N_READS)
    reads = gb[starts[:, None] + np.arange(100)[None, :]].copy()
    if mode == "threeN":
        reads[(reads == 1) & (rng.random(reads.shape) < 0.9)] = 3
    else:
        sub = rng.random(reads.shape) < 0.01
        reads[sub] = rng.integers(0, 4, size=int(sub.sum()))
        reads[-36:] = reads[:3].repeat(12, axis=0)
    lengths = np.full(N_READS, 100, np.int32)
    lengths[::17] = 91
    return gb, reads.astype(np.int8), lengths


@pytest.fixture(scope="module", params=sorted(MODES))
def mapped(request):
    """Both engines over one staged pool of a mode: the JAX units' and the
    port's outputs as numpy."""
    mode = request.param
    gb, reads, lengths = _case(mode)
    seq = "".join(ACGT[gb])
    ensure_reference_native()
    jm = JaxMapper(JaxGenome(["c"], [seq]), JaxOptions(**MODES[mode]))
    tm = CoarseMapper(Genome(["c"], [seq]), ProgramOptions(**MODES[mode]),
                      "cpu")
    for m in (jm, tm):
        m.ensure_read_drops(reads, lengths)
        m.ensure_empty_drops()
    if mode == "parity":
        assert int(tm.dropped[1].sum()) > 0
    ja = jm.stage_reads_device(reads, lengths)
    ta = tm.stage_reads_device(reads, lengths)
    assert ja[3] == ta[3] == N_READS
    host = lambda xs: [np.asarray(x) for x in xs]
    # the scored unit in every mode; JAX's coarse units cost a compile
    # each, so map_pool_scanned in 3N, _map_reads_device (and
    # _map_batch_at, the same program) under --undirectional, and in
    # parity the scored unit's coarse half, which is _map_batch_impl's
    scored = host(jm._map_reads_device_scored(*ja, BSZ))
    batch_at = [scored[0][BSZ:2 * BSZ]]
    if mode == "threeN":
        coarse = host(jm.map_pool_scanned(*ja, BSZ))
    elif mode == "undirectional":
        coarse = host(jm._map_reads_device(*ja, BSZ)[:2])
        batch_at = host(jm._map_batch_at(*ja[:3], jnp.int32(BSZ), BSZ,
                                         *jm.dropped))
    else:
        coarse = scored[:2]
    jax_out = {"scanned": coarse, "device": coarse, "scored": scored,
               "batch_at": batch_at}
    out = {
        "scanned": host(tm.map_pool_scanned(*ta, BSZ)),
        "device": host(tm._map_reads_device(*ta, BSZ)[:2]),
        "scored": host(tm._map_reads_device_scored(*ta, BSZ)),
        "batch_at": host(tm._map_batch_at(*ta[:3], BSZ, BSZ)),
    }
    return mode, jax_out, out, tm, (reads, lengths)


@pytest.mark.parametrize("unit", ["scanned", "device", "scored", "batch_at"])
def test_pool_units_equal_jax(mapped, unit):
    """map_pool_scanned and _map_reads_device: packed [n_pad, 7] rows and
    the [5] overflow vector; _map_reads_device_scored also the 10 score
    rows, the traceback entries and the status; _map_batch_at one batch
    (the second of the pool: its rows, and under --undirectional its
    overflow against JAX's _map_batch_at)."""
    mode, jax_out, out, _, _ = mapped
    if unit != "batch_at":
        assert len(out[unit]) == len(jax_out[unit])
    for got, want in zip(out[unit], jax_out[unit]):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    packed = out[unit][0]
    assert (packed[:, 0] != 3).mean() > (0.3 if unit == "batch_at" else 0.4)
    if unit == "scored":
        assert out["scored"][2].dtype == np.int16
        assert out["scored"][3].dtype == np.uint8
        assert out["scored"][4].dtype == np.int8


def test_pool_units_agree(mapped):
    """The coarse units equal each other and the scored unit's coarse
    half, and _map_batch_at's rows are the pool's second batch."""
    _, _, out, _, _ = mapped
    for unit in ("device", "scored"):
        for a, b in zip(out["scanned"], out[unit][:2]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out["batch_at"][0],
                                  out["scanned"][0][BSZ:2 * BSZ])


def test_one_step_serves_every_pool_and_a_short_last_chunk(mapped):
    """map_reads over chunks of 200 and 56 reads (pipeline/driver.py's last
    --pipelineChunk chunk is short) pads each to the batch shape: the
    mapper keeps one step a kind of output, and the rows and the bundle
    equal the pool units' over the whole set."""
    _, _, out, tm, (reads, lengths) = mapped
    steps = len(tm._steps)
    parts = [tm.map_reads(reads[a:b], lengths[a:b], with_scores=True)
             for a, b in ((0, 200), (200, N_READS))]
    assert len(tm._steps) == steps
    packed = out["scored"][0]
    for f, col in (("orientation", 0), ("hamming", 1), ("shift", 2),
                   ("position", 4), ("bs_strand", 6)):
        np.testing.assert_array_equal(
            np.concatenate([getattr(p[0], f) for p in parts]), packed[:, col])
    for i, axis in ((0, 1), (1, 0), (2, 0)):
        np.testing.assert_array_equal(
            np.concatenate([p[1][i] for p in parts], axis=axis),
            out["scored"][2 + i])


def test_a_replaced_drop_mask_drops_the_captured_steps(mapped):
    """A step reads the key drops from outside its inputs: a new mask
    (another read set in parity mode) drops the steps built with the old
    one, so no graph runs with a stale mask."""
    _, _, out, tm, _ = mapped
    assert tm._steps
    old = tm.dropped
    tm.dropped = tuple(x.clone() for x in old)
    try:
        packed, ovf = tm.map_pool_scanned(
            *tm.stage_reads_device(*mapped[4]), BSZ)
        assert len(tm._steps) == 1
        np.testing.assert_array_equal(packed.numpy(), out["scanned"][0])
    finally:
        tm.dropped = old


def test_copy_out_keeps_each_batch_rows():
    """run() returns the static outputs, which the next run overwrites:
    the caller's copy of batch i survives batch i + 1, and a view kept
    instead does not.  Inputs must match the static buffers."""
    step = graphs.CapturedStep((torch.zeros(4, dtype=torch.int64),))
    double = lambda x: (x * 2, x.sum())
    first = step.run(double, torch.arange(4))
    kept = [t.clone() for t in first]
    second = step.run(double, torch.arange(4) + 10)
    assert second[0] is first[0]
    np.testing.assert_array_equal(kept[0].numpy(), [0, 2, 4, 6])
    np.testing.assert_array_equal(first[0].numpy(), [20, 22, 24, 26])
    assert int(kept[1]) == 6 and int(second[1]) == 46
    with pytest.raises(ValueError, match="static buffer"):
        step.run(double, torch.arange(5))
    with pytest.raises(ValueError, match="static buffer"):
        step.run(double, torch.arange(4, dtype=torch.int32))
    assert graphs.options_key(ProgramOptions()) == graphs.options_key(
        ProgramOptions())


WS_OPTS = dict(kmer_length=12, num_hash_functions=8, window_size=64,
               min_table_hits=2, batchsize=32, max_hamming_percent=0.1,
               probe_cap=64, candidates_per_read_cap=16, max_read_length=48,
               shd_pairs_per_read_budget=4, probe_tail_budget_per_read=4,
               probe_head_budget_per_read=8, max_results_per_map=40)


@pytest.mark.parametrize("mode", ["threeN", "undirectional"])
def test_window_stream_offsets_equal_jax(mode):
    """Three chromosomes of several window batches each: each batch's
    chromosome offset and length come in as device data with its
    positions, so one step serves them all; every field and stat equal
    the JAX package's map_genome, and a second map_genome of the same
    genome reuses the step and gives the same rows."""
    rng = np.random.default_rng(7)
    chroms = [rng.integers(0, 4, size=n, dtype=np.int8)
              for n in (5_000, 2_300, 1_100)]
    cat = np.concatenate(chroms)
    reads, lengths, _, _ = four_strand_reads(rng, cat, 24, 44)
    if mode == "threeN":
        keep = np.repeat(np.arange(4), 24) < 2
        reads, lengths = reads[keep], lengths[keep]
    kw = dict(WS_OPTS, three_n_seeding=True,
              undirectional=mode == "undirectional")
    names = [f"c{i}" for i in range(3)]
    seqs = ["".join(ACGT[c]) for c in chroms]
    ensure_reference_native()
    ref = JaxStream(reads.copy(), lengths.copy(), JaxOptions(**kw)) \
        .map_genome(JaxGenome(names, seqs))
    ws = WindowStreamMapper(reads.copy(), lengths.copy(),
                            ProgramOptions(**kw), "cpu")
    genome = Genome(names, seqs)
    got = ws.map_genome(genome)
    again = ws.map_genome(genome)
    assert len(ws._steps) == 1
    for f in ("orientation", "hamming", "shift", "chromosome_id",
              "position", "global_window_id", "bs_strand"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), f)
        np.testing.assert_array_equal(getattr(again, f), getattr(got, f), f)
    assert got.stats == ref.stats == again.stats
    assert set(np.unique(got.chromosome_id[got.orientation != 3])) \
        == {0, 1, 2}
