"""Port parity: utils/memory.py and utils/tracing.py against the JAX
package's, and cpu/reference_pipeline.py::coarse_map (a copy) against the
JAX oracle pipeline and, on its mapped reads, the port's engine."""

import dataclasses
import json
import os
import random

import numpy as np

from hashreadmapper_tpu.config import ProgramOptions as JaxOptions
from hashreadmapper_tpu.cpu import reference_pipeline as jax_rp
from hashreadmapper_tpu.utils import memory as jax_memory
from hashreadmapper_tpu.utils import tracing as jax_tracing
from hashreadmapper_tpu_torch.config import ProgramOptions
from hashreadmapper_tpu_torch.cpu import oracle, reference_pipeline
from hashreadmapper_tpu_torch.io.genome import Genome
from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper
from hashreadmapper_tpu_torch.utils import memory, tracing


def test_memory_usage_equals_jax(capsys):
    """tests/test_utils.py::test_memory_usage; the device stats of a
    machine without a card are the JAX CPU devices' (none)."""
    a = memory.MemoryUsage(host=100, device={0: 50})
    b = memory.MemoryUsage(host=10, device={0: 5, 1: 7})
    c = a + b
    ja = jax_memory.MemoryUsage(host=100, device={0: 50}) + \
        jax_memory.MemoryUsage(host=10, device={0: 5, 1: 7})
    assert dataclasses.asdict(c) == dataclasses.asdict(ja)
    assert memory.get_available_host_memory_kb() > 0
    memory.print_data_structure_memory_usage("test", c)
    port = capsys.readouterr().out
    jax_memory.print_data_structure_memory_usage("test", ja)
    assert port == capsys.readouterr().out
    assert "MB on device 1" in port
    assert memory.device_memory_stats() == jax_memory.device_memory_stats()


def test_tracing_scopes_and_session(tmp_path):
    """tests/test_utils.py::test_tracing_scope on both packages, and a
    trace session whose Chrome trace holds the scope's span."""
    for mod in (tracing, jax_tracing):
        with mod.scoped_range("stage"):
            pass

        @mod.annotate("fn")
        def f(x):
            return x + 1

        assert f(1) == 2 and f.__name__ == "f"
    logdir = str(tmp_path / "trace")
    with tracing.trace_session(logdir) as where:
        assert where == logdir
        with tracing.scoped_range("stage_a"):
            np.arange(10).sum()
    with open(os.path.join(logdir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "stage_a" for e in events)


def _reads(seed=4):
    rng = random.Random(seed)
    chroms = ["".join(rng.choice("ACGT") for _ in range(n))
              for n in (500, 320)]
    reads = []
    for i in range(24):
        rl = rng.randint(24, 48)
        c = rng.randrange(2)
        s = rng.randrange(len(chroms[c]) - rl)
        b = oracle.encode_bases(chroms[c][s:s + rl])
        if i % 2:
            b = oracle.revcomp_bases(b)
        if i % 7 == 0:
            b = [rng.randrange(4) for _ in range(rl)]
        reads.append(b)
    return chroms, reads


def test_reference_pipeline_equals_jax_and_the_engine():
    chroms, reads = _reads()
    kw = dict(kmer_length=10, num_hash_functions=8, window_size=48,
              min_table_hits=2, batchsize=16, max_hamming_percent=0.1,
              probe_cap=64, candidates_per_read_cap=32, max_read_length=48)
    enc = [oracle.encode_bases(c) for c in chroms]
    got = reference_pipeline.coarse_map(enc, reads, ProgramOptions(**kw))
    ref = jax_rp.coarse_map(enc, reads, JaxOptions(**kw))
    assert [dataclasses.astuple(m) for m in got] == [
        dataclasses.astuple(m) for m in ref]
    mapped = [i for i, m in enumerate(got) if m.orientation != 3]
    assert len(mapped) > len(reads) // 2
    # the engine's inverted orientation finds the same hits
    bases = np.zeros((len(reads), 48), np.int8)
    lens = np.array([len(r) for r in reads], np.int32)
    for i, r in enumerate(reads):
        bases[i, :len(r)] = r
    res = CoarseMapper(Genome(["a", "b"], chroms), ProgramOptions(**kw),
                       "cpu").map_reads(bases, lens)
    for i in mapped:
        assert (res.orientation[i], res.chromosome_id[i], res.hamming[i]) \
            == (got[i].orientation, got[i].chromosome_id,
                got[i].hamming_distance), i
