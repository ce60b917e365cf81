"""Rehearsals of the harness on the CPU at a tiny size, with the program's
plain versions: each entry reaches its last line and measures nothing;
the timed path broken underneath makes `correct` false; the control fails
the comparison; and, on a card, a cell runs correct.

    python -m pytest portbench/ -q            (the card test skips here)
    python -m pytest portbench/ -q -m cuda    (on a card)
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from portbench import control, manifest, run


# configurations whose cells wait for a sourced mix or for chip time
# (PERF.md, Open questions), rehearsed here with mixes of the tests' own
FOUR_STRANDS = {"pool": 4096, "length": 101, "variants": 0.00175,
                "errors": 0.001,
                "strands": [["fwd", "ct"], ["rc", "ct"], ["fwd", "ga"],
                            ["rc", "ga"]],
                "assign": "cycle", "conversion": 0.99, "junk": 0.0}
WAITING = {"chr1-pbat.coarse": ("chr1-pbat", FOUR_STRANDS, 1),
           "chr1-3n-mesh4x1.coarse": ("chr1-3n-mesh4x1", None, 4)}


def tiny(cell_name, genome_len=150_000, pool=4096):
    """The cell's configuration and mix at a CPU rehearsal's size (and
    BENCHMARK.json with the cell, where it waits outside it)."""
    bench = manifest.load()
    if cell_name in WAITING:
        name, reads, chips = WAITING[cell_name]
        bench["workloads"].append({"name": cell_name, "config": name,
                                   "traffic": "wgs.coarse", "chips": chips,
                                   "why": "rehearsal"})
        with open(os.path.join(manifest.HERE, "configs",
                               name + ".json")) as fh:
            config = json.load(fh)
        mix = manifest.traffic("wgs.coarse")
        if reads is not None:
            mix["reads"] = dict(reads)
    else:
        cell = manifest.cell(bench, cell_name)
        config = manifest.config(bench, cell["config"])
        mix = manifest.traffic(cell["traffic"])
    config["genome"]["chromosomes"] = [["chr1", genome_len]]
    opts = list(config["options"])
    opts[opts.index("--batchsize") + 1] = "512"
    opts[opts.index("--pipelineChunk") + 1] = "1024"
    config["options"] = opts
    mix["reads"]["pool"] = pool
    if "pass_reads" in mix:
        mix["pass_reads"] = pool // 2
        mix["check"] = {"sam_sample": 16, "vcf_reads": 64}
    return bench, config, mix


def rehearse(cell_name, seed=2**31 + 5, trace=False):
    bench, config, mix = tiny(cell_name)
    return run.run_cell(cell_name, seed, 0.5, trace, "cpu", bench, config,
                        mix, log=io.StringIO())


@pytest.mark.parametrize("cell", ["chr1-3n.sam", "chr1-3n.coarse"])
def test_rehearsal_reaches_its_last_line_and_measures_nothing(cell):
    res = rehearse(cell)
    assert res["correct"] is True and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert all(v["limit"] == 0 and v["value"] == 0
               for v in res["checks"].values())
    assert res["metrics"] and all(m["value"] == run.NOT_MEASURED
                                  for m in res["metrics"].values())
    assert res["device"]["platform"] == "cpu"
    assert res["device"]["memory_peak_bytes"] == run.NOT_MEASURED


def test_a_measuring_run_without_a_card_fails(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "chr1-3n.coarse", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


NONE_ROW = [3, 0, 0, 0, 0, -1, 0]


def _half_batch_left_out(monkeypatch):
    from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper
    orig = CoarseMapper.map_reads_packed

    def broken(self, read_bases, read_lengths, *a, **k):
        packed, overflow, bundle = orig(self, read_bases, read_lengths,
                                        *a, **k)
        bsz = self.opts.batchsize
        rows = np.arange(len(packed))
        packed[(rows % bsz) >= bsz // 2] = NONE_ROW
        return packed, overflow, bundle
    monkeypatch.setattr(CoarseMapper, "map_reads_packed", broken)


def _answer_altered(monkeypatch):
    from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper
    orig = CoarseMapper.map_reads_packed

    def broken(self, *a, **k):
        packed, overflow, bundle = orig(self, *a, **k)
        i = int(np.flatnonzero(packed[:, 0] != 3)[0])
        packed[i, 4] += 1
        return packed, overflow, bundle
    monkeypatch.setattr(CoarseMapper, "map_reads_packed", broken)


def _state_unchanged(monkeypatch):
    from hashreadmapper_tpu_torch.pipeline import graphs
    orig = graphs.CapturedStep.run_eager
    calls = {"n": 0}

    def broken(self, step, *args):
        calls["n"] += 1
        if self.outputs is not None and calls["n"] % 2 == 0:
            return self.outputs
        return orig(self, step, *args)
    monkeypatch.setattr(graphs.CapturedStep, "run_eager", broken)


def _exchange_left_out(monkeypatch):
    from hashreadmapper_tpu_torch.parallel.sharded import ShardedCoarseMapper
    orig = ShardedCoarseMapper.map_reads_packed

    def broken(self, *a, **k):
        packed, overflow, bundle = orig(self, *a, **k)
        bsz, d_n = self.opts.batchsize, self.mesh.shape["data"]
        shard = (np.arange(len(packed)) // bsz) % d_n
        packed[shard != 0] = NONE_ROW
        return packed, overflow, bundle
    monkeypatch.setattr(ShardedCoarseMapper, "map_reads_packed", broken)


def _sam_positions_altered(monkeypatch):
    from hashreadmapper_tpu_torch.pipeline import records
    orig = records.emit_sam

    def broken(rec, genome, path, threads=0):
        rec.position = rec.position + 1
        try:
            return orig(rec, genome, path, threads)
        finally:
            rec.position = rec.position - 1
    monkeypatch.setattr(records, "emit_sam", broken)


@pytest.mark.parametrize("cell,fault", [
    ("chr1-3n.coarse", _half_batch_left_out),
    ("chr1-3n.coarse", _answer_altered),
    ("chr1-3n.coarse", _state_unchanged),
    ("chr1-pbat.coarse", _answer_altered),
    ("chr1-3n-mesh4x1.coarse", _exchange_left_out),
    ("chr1-3n.sam", _half_batch_left_out),
    ("chr1-3n.sam", _sam_positions_altered),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    res = rehearse(cell)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", ["chr1-3n.coarse", "chr1-pbat.coarse"])
def test_the_control_fails_the_comparison(cell):
    _, config, mix = tiny(cell)
    got = control.readings(config, mix, 7, torch.device("cpu"))
    assert got["rows_differ"] > 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(card):
    res = run.run_cell("chr1-3n.coarse", 2**31 + 99, 2.0, False, "cuda",
                       log=io.StringIO())
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]["coarse_reads_per_s"]["value"] > 0
