"""The port's tracer (utils/tracing.py): off it records nothing; on it
records nested spans with their threads, parents and attributes on the
profiler's clock; and the spans of a small pipelined STEP 1 + STEP 2 run
and of its index build, on the CPU."""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hashreadmapper_tpu_torch import native
from hashreadmapper_tpu_torch.align import sw
from hashreadmapper_tpu_torch.config import ProgramOptions
from hashreadmapper_tpu_torch.io.genome import Genome
from hashreadmapper_tpu_torch.io.readstore import ReadStorage, pack_rows
from hashreadmapper_tpu_torch.pipeline import driver
from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper, Step2Bundle
from hashreadmapper_tpu_torch.utils import tracing
from hashreadmapper_tpu_torch.utils.timers import PhaseTimers

from torch_helpers import ACGT


@pytest.fixture
def tracer():
    """The tracer on and empty; off and empty again afterwards."""
    tracing.reset()
    tracing.enable()
    try:
        yield tracing
    finally:
        tracing.disable()
        tracing.reset()


def test_tracer_off_records_nothing():
    tracing.reset()
    assert not tracing.enabled()
    a, b = tracing.span("a", reads=1), tracing.span("b")
    assert a is b
    with a as got:
        assert got is None and tracing.current() is None
    with PhaseTimers().phase("phase"):
        pass
    assert tracing.snapshot() == []


def test_tracer_on_nests_names_threads_and_resets(tracer):
    with tracer.span("outer", reads=7) as outer:
        with tracer.span("inner", pairs=3) as inner:
            assert tracer.current() == inner.id
        seen = {}

        def work():
            seen["before"] = tracer.current()
            with tracer.span("remote", parent=outer.id):
                with tracer.span("leaf"):
                    pass
        t = threading.Thread(target=work, name="step2_0")
        t.start()
        t.join(10)
        assert not t.is_alive()
    assert seen["before"] is None and tracer.current() is None
    spans = {s.name: s for s in tracer.snapshot()}
    assert set(spans) == {"outer", "inner", "remote", "leaf"}
    main = threading.current_thread().name
    assert spans["outer"].parent is None
    assert spans["outer"].attrs == {"reads": 7}
    assert spans["inner"].parent == spans["outer"].id
    assert spans["inner"].attrs == {"pairs": 3}
    assert spans["remote"].parent == spans["outer"].id
    assert spans["leaf"].parent == spans["remote"].id
    assert {s.thread for s in spans.values()} == {main, "step2_0"}
    assert spans["remote"].thread == spans["leaf"].thread == "step2_0"
    for s in spans.values():
        assert s.t0_ns <= s.t1_ns
    assert spans["outer"].t0_ns <= spans["inner"].t0_ns \
        and spans["inner"].t1_ns <= spans["outer"].t1_ns
    assert len({s.id for s in spans.values()}) == 4
    tracer.reset()
    assert tracer.snapshot() == []


def test_threads_lose_no_span(tracer):
    """Sixteen threads open nested spans at once with a short switch
    interval: every span is recorded once, with a unique id and its own
    thread's parent."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(250):
                with tracer.span("outer"):
                    with tracer.span("inner"):
                        pass
        threads = [threading.Thread(target=work, name=f"t{i}")
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    spans = tracer.snapshot()
    assert len(spans) == 16 * 250 * 2
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        if s.name == "inner":
            parent = by_id[s.parent]
            assert parent.name == "outer" and parent.thread == s.thread
        else:
            assert s.parent is None


def test_a_profiler_event_lies_inside_its_span(tracer):
    """The tracer's clock is the profiler's: an op run inside a span is a
    profiler event within the span's [t0, t1], and so is the span's own
    record_function."""
    x = torch.arange(1 << 16, dtype=torch.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("work"):
            torch.cumsum(x, 0)
    (s,) = tracer.snapshot()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in ("aten::cumsum", "work")}
    op = events["aten::cumsum"]
    assert s.t0_ns <= op.start_ns() <= op.start_ns() + op.duration_ns() \
        <= s.t1_ns
    assert "work" in events


def _case(n_reads=96, read_len=72, genome_len=20_000, seed=5):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=genome_len, dtype=np.int8)
    genome = Genome(["chrF"], ["".join(ACGT[codes])])
    starts = rng.integers(0, genome_len - read_len, size=n_reads)
    reads = codes[starts[:, None] + np.arange(read_len)[None, :]].copy()
    sub = rng.random(reads.shape) < 0.02
    reads[sub] = rng.integers(0, 4, size=int(sub.sum()))
    rc = rng.random(n_reads) < 0.5
    reads[rc] = 3 - reads[rc][:, ::-1]
    opts = ProgramOptions(
        kmer_length=16, num_hash_functions=8, window_size=128,
        min_table_hits=2, batchsize=32, max_hamming_percent=0.5,
        probe_cap=16, candidates_per_read_cap=8, max_read_length=96,
        threads=2, three_n_seeding=True, step2_pipeline_chunk=32)
    lengths = np.full(n_reads, read_len, np.int32)
    store = ReadStorage(pack_rows(reads, lengths, (read_len + 15) // 16),
                        lengths, np.zeros(n_reads, bool))
    padded = np.pad(reads, ((0, 0), (0, opts.max_read_length - read_len))
                    ).astype(np.int8)
    return genome, opts, store, padded


class _HostDpMapper:
    """The mapper, with the fused bundle of each chunk marking every 11th
    pair saturated (the host rerun) and every 5th pair's traceback status
    2 (the native finish's host DP): both give the same records."""

    def __init__(self, mapper):
        self._mapper = mapper

    def map_reads(self, *args, **kwargs):
        res, bundle = self._mapper.map_reads(*args, **kwargs)
        scores, ops, status = bundle
        scores, status = scores.copy(), status.copy()
        scores[8, ::11] = 1
        status[::5] = 2
        return res, Step2Bundle(scores, ops, status, bundle.rows)

    def __getattr__(self, attr):
        return getattr(self._mapper, attr)


def test_pipelined_sw_spans(tracer, monkeypatch):
    """Three chunks through _pipelined_sw: each main-thread driver.chunk
    is the parent of one step2.chunk on a step2 worker, which holds
    step2.prep, step2.finish and step2.assemble (with step2.rescore);
    host_dp_pairs counts the saturated pairs' reruns and the native
    finish's pairs of status 2 that are not diagonal; step2.prep's rows
    are the card's for every mapped read (card_rows) and the host's for
    none (host_rows), engine.fetch counts the rows' bytes; the index
    build's phases lie inside index.build."""
    if not native.available():
        pytest.skip("the port's native library did not build")
    genome, opts, store, padded = _case()
    mapper = CoarseMapper(genome, opts, "cpu")
    build = tracer.snapshot()
    tracer.reset()

    reruns, finished = [], []
    ssw_align = sw.ssw_align
    finish = native.ssw_finish_batch

    def counted_align(*args, **kwargs):
        reruns.append(1)
        return ssw_align(*args, **kwargs)

    def counted_finish(*args, **kwargs):
        finished.append(int(np.count_nonzero(
            ~np.asarray(kwargs["diag"]) & (kwargs["dev_fail"] == 2))))
        return finish(*args, **kwargs)
    monkeypatch.setattr(sw, "ssw_align", counted_align)
    monkeypatch.setattr(native, "ssw_finish_batch", counted_finish)
    driver._pipelined_sw(_HostDpMapper(mapper), padded, store, genome,
                         genome.reverse_complement(), opts)
    spans = tracer.snapshot()
    main = threading.current_thread().name
    by_id = {s.id: s for s in spans}
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)

    chunks = [s for s in spans if s.name == "driver.chunk"]
    assert sorted(s.attrs["chunk"] for s in chunks) == [0, 32, 64]
    assert all(s.attrs["reads"] == 32 and s.thread == main for s in chunks)
    host_dp = 0
    for c in chunks:
        step2 = [k for k in kids[c.id] if k.name == "step2.chunk"]
        assert len(step2) == 1
        (w,) = step2
        assert w.thread.startswith("step2") and w.t0_ns >= c.t0_ns
        got = {k.name: k for k in kids[w.id]}
        assert set(got) == {"step2.prep", "step2.finish", "step2.assemble"}
        (rescore,) = kids[got["step2.assemble"].id]
        assert rescore.name == "step2.rescore"
        assert got["step2.finish"].attrs["pairs"] > 0
        host_dp += got["step2.finish"].attrs["host_dp_pairs"]
        engine = [k for k in kids[c.id] if k.name == "engine.map_reads"]
        assert [k.attrs["reads"] for k in engine] == [32]
        assert [k.name for k in sorted(kids[engine[0].id],
                                       key=lambda k: k.t0_ns)] \
            == ["engine.stage", "engine.enqueue", "engine.fetch"]
        prep = got["step2.prep"].attrs
        assert prep == {"card_rows": engine[0].attrs["mapped"],
                        "host_rows": 0} and prep["card_rows"] > 0
        (fetch,) = [k for k in kids[engine[0].id] if k.name == "engine.fetch"]
        lq, ws = opts.max_read_length, opts.window_size
        assert fetch.attrs["step2_row_bytes"] == 32 * (4 * lq + 3 * ws + 4)
    assert host_dp == len(reruns) + sum(finished) > 0
    assert len(reruns) > 0 and sum(finished) > 0
    (wait,) = [s for s in spans if s.name == "driver.wait"]
    assert wait.thread == main and wait.parent is None
    assert all(s.t1_ns <= wait.t1_ns for s in spans)
    assert {s.name for s in spans} == {
        "driver.chunk", "driver.wait", "engine.map_reads", "engine.stage",
        "engine.enqueue", "engine.fetch", "step2.chunk", "step2.prep",
        "step2.finish", "step2.assemble", "step2.rescore"}
    assert all(s.parent in by_id for s in spans
               if s.name not in ("driver.chunk", "driver.wait"))

    (top,) = [s for s in build if s.name == "index.build"]
    phases = [s.name for s in sorted(build, key=lambda s: s.t0_ns)
              if s.parent == top.id]
    assert phases == ["index.table", "index.signatures", "index.csr",
                      "index.buckets", "index.cuckoo"]
    assert {s.name for s in build} == {"index.build", *phases}
