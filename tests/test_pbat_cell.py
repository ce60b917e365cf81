"""The chr1-pbat.coarse cell on the CPU, with the port's plain versions:
its read mix (portbench/traffic/pbat.coarse.json) is PBAT read 1, the
port maps it as the plain reference does under the configuration's own
flags and wins every mapped read in the mirrored G->A space, the
engine.map_reads span counts those rows when the tracer is on, and
BENCHMARK.json names the cell with its metrics."""

import numpy as np
import pytest
import torch

from hashreadmapper_tpu_torch import cli
from hashreadmapper_tpu_torch.index import minhash_index as mi
from hashreadmapper_tpu_torch.io.genome import Genome
from hashreadmapper_tpu_torch.ops import vote_kernel
from hashreadmapper_tpu_torch.pipeline.engine import (OVERFLOW_KEYS,
                                                      CoarseMapper)
from hashreadmapper_tpu_torch.utils import tracing
from portbench import inputs, manifest
from portbench.check import reference_options, rows_differ
from portbench.entries import pack, stats_vector
from portbench.reference import coarse

CELL = "chr1-pbat.coarse"
SEED = 2**31 + 7
CPU = torch.device("cpu")
A, C, G, T = 0, 1, 2, 3
DIRECTIONAL = [["fwd", "ct"], ["rc", "ct"]]


def _mix():
    return manifest.traffic(manifest.cell(manifest.load(), CELL)["traffic"])


def _flags(**caps):
    """The configuration's flags, with a CPU-sized batch and the given
    caps (flag: value) in place of its own."""
    bench = manifest.load()
    flags = list(manifest.config(bench, manifest.cell(bench, CELL)["config"])
                 ["options"])
    for flag, value in dict(caps, **{"--batchsize": 512}).items():
        flags[flags.index(flag) + 1] = str(value)
    return flags


def _reads(chroms, pool, strands=None, **rates):
    reads = dict(_mix()["reads"], pool=pool, **rates)
    if strands is not None:
        reads["strands"] = strands
    return inputs.make_reads(reads, chroms, SEED, CPU)


def _with_sources(chroms, pool, **rates):
    """(reads, each read's source slice of the genome in read space, which
    reads are reverse-complemented)."""
    bases, _, truth = _reads(chroms, pool, **rates)
    src = chroms[0][truth["start"][:, None] + np.arange(bases.shape[1])]
    rc = truth["strand"] == 1
    src[rc] = 3 - src[rc, ::-1]
    return bases, src, rc


def _padded(bases, width=128):
    out = np.zeros((len(bases), width), np.int8)
    out[:, :bases.shape[1]] = bases
    return out


def _mapper(chroms, flags):
    opts, dev = cli.options_from_args(flags + ["--device", "cpu"])
    genome = Genome(["chr1"], inputs.genome_strings(chroms))
    return CoarseMapper(genome, opts, dev)


@pytest.fixture(scope="module")
def chroms():
    _, chroms = inputs.make_genome(
        {"genome": {"chromosomes": [["chr1", 150_000]]}}, SEED, CPU)
    return chroms


@pytest.fixture(scope="module")
def mapper(chroms):
    return _mapper(chroms, _flags())


@pytest.fixture
def tracer():
    tracing.reset()
    tracing.enable()
    try:
        yield tracing
    finally:
        tracing.disable()
        tracing.reset()


def _mirrored_share(packed):
    mapped = packed[:, 0] != coarse.NONE
    return mapped.mean(), (packed[mapped, 6] == 1).mean()


def test_mix_is_pbat_read_1(chroms):
    mix = _mix()["reads"]
    assert mix["strands"] == [["fwd", "ga"], ["rc", "ga"]]
    assert mix["conversion"] == 0.96 and mix["assign"] == "random"
    # without errors and variants every change from the source slice (in
    # read space) is the conversion's: G read as A, nothing else
    n = 8192
    bases, src, rc = _with_sources(chroms, n, errors=0.0, variants=0.0)
    changed = bases != src
    assert not (changed & (src == C) & (bases == T)).any()
    assert ((src == G) & (bases == A))[changed].all()
    assert abs((bases[src == G] == A).mean() - 0.96) <= 0.01
    # half each strand: within five binomial standard deviations,
    # 5 x sqrt(n) / 2 reads of n / 2
    assert abs(int(rc.sum()) - n // 2) <= 5 * np.sqrt(n) / 2
    # with the file's own rates too (errors and variants move the share
    # by under a thousandth)
    bases, src, rc = _with_sources(chroms, n)
    assert abs((bases[src == G] == A).mean() - 0.96) <= 0.01
    assert abs(int(rc.sum()) - n // 2) <= 5 * np.sqrt(n) / 2


def test_port_maps_pbat_as_the_reference_in_the_mirrored_space(chroms,
                                                               mapper):
    tracing.reset()
    bases, lengths, _ = _reads(chroms, 512)
    res = mapper.map_reads(_padded(bases), lengths)
    assert tracing.snapshot() == []      # the tracer is off: no span
    ref = coarse.ReferenceMapper(chroms, reference_options(_flags()), CPU)
    packed_ref, over_ref = ref.map_reads(bases, lengths)
    packed = pack(res)
    assert rows_differ(packed, packed_ref) == 0
    assert np.array_equal(stats_vector(res.stats), over_ref)
    mapped, mirrored = _mirrored_share(packed)
    assert mapped >= 0.9
    assert mirrored >= 0.99


def test_a_directional_mix_is_never_won_by_the_mirrored_space(chroms,
                                                              mapper):
    bases, lengths, _ = _reads(chroms, 512, strands=DIRECTIONAL)
    mapped, mirrored = _mirrored_share(pack(
        mapper.map_reads(_padded(bases), lengths)))
    assert mapped >= 0.9
    assert mirrored == 0


def test_map_reads_span_counts_mapped_mirrored_and_overflow(chroms, tracer):
    # caps tight enough that the overflow counters are not all 0
    mapper = _mapper(chroms, _flags(**{"--probeCap": 8,
                                       "--candidatesPerRead": 4,
                                       "--shdPairBudget": 1}))
    tracer.reset()
    bases, lengths, _ = _reads(chroms, 512)
    res = mapper.map_reads(_padded(bases), lengths)
    (span,) = [s for s in tracer.snapshot() if s.name == "engine.map_reads"]
    mapped = res.orientation != coarse.NONE
    assert span.attrs["reads"] == 512
    assert span.attrs["mapped"] == int(mapped.sum()) > 0
    assert span.attrs["mirrored"] == int((res.bs_strand[mapped] == 1).sum())
    assert span.attrs["mirrored"] > 0
    assert {k: span.attrs[k] for k in OVERFLOW_KEYS} == {
        k: res.stats[k] for k in OVERFLOW_KEYS}
    assert sum(span.attrs[k] for k in OVERFLOW_KEYS) > 0


def test_map_reads_span_counts_the_votes_ids(chroms, mapper, monkeypatch):
    """vote_ids and vote_wide_rows (F 64 lists of 128: the vote's wide
    path) equal counts over the probe's output, the vote's input, with
    the tracer on; with it off no span and nothing read back."""
    seen = []
    vote, counts = mi.vote_candidates_fnc_auto, vote_kernel.tally_counts
    reads_back = []

    def counting_vote(cand, *args):
        seen.append((cand != vote_kernel.SENTINEL).sum(dim=(0, 2)))
        return vote(cand, *args)

    def counted_read(tally):
        reads_back.append(tally)
        return counts(tally)
    monkeypatch.setattr(mi, "vote_candidates_fnc_auto", counting_vote)
    monkeypatch.setattr(vote_kernel, "tally_counts", counted_read)
    bases, lengths, _ = _reads(chroms, 700)
    tracing.reset()
    mapper.map_reads(_padded(bases), lengths)
    assert tracing.snapshot() == [] and reads_back == [] and seen
    seen.clear()
    tracing.enable()
    try:
        mapper.map_reads(_padded(bases), lengths)
        (span,) = [s for s in tracing.snapshot()
                   if s.name == "engine.map_reads"]
    finally:
        tracing.disable()
        tracing.reset()
    k = torch.cat(seen)
    assert len(reads_back) == 1 and k.shape == (1024,)
    assert span.attrs["vote_ids"] == int(k.sum()) > 0
    # a read is sorted in tiles only past TILE ids: none has that many
    assert int(k.max()) <= vote_kernel.TILE
    assert span.attrs["vote_wide_rows"] == 0


def test_benchmark_names_the_cell_and_its_metrics():
    bench = manifest.load()
    assert manifest.check(bench) == []
    cell = manifest.cell(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "chr1-pbat", "pbat.coarse", 1)
    assert [m["name"] for m in manifest.metrics_of(
        bench, CELL, "end_to_end")] == ["coarse_reads_per_s", "setup_s"]
    assert [m["name"] for m in manifest.metrics_of(
        bench, CELL, "per_layer")] == ["device.idle_share.coarse",
                                       "engine.device_ms_per_mread.coarse",
                                       "vote_roofline"]
    mix = _mix()
    assert set(mix["reads"]) <= set(mix["sources"])
    assert {"conversion", "length", "junk"} <= set(mix["assumed"])
