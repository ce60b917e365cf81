"""CPU checks of BENCHMARK.json, the files it names, the no-JAX guard and
the bound arithmetic.  Run: python -m pytest portbench/ -q"""

import sys

import pytest

from portbench import manifest, peaks, run


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_manifest_keeps_the_rules(bench):
    assert manifest.check(bench) == []


def test_names_and_units_use_the_allowed_characters(bench):
    names = ([c["name"] for c in bench["configs"]]
             + [w[k] for w in bench["workloads"]
                for k in ("name", "config", "traffic")]
             + [m["name"] for k in ("end_to_end", "per_layer")
                for m in bench[k]]
             + [r for c in bench["configs"] for r in c["reduced"]])
    assert all(manifest.NAME_RE.match(n) for n in names)
    assert all(manifest.UNIT_RE.match(m["unit"])
               for k in ("end_to_end", "per_layer") for m in bench[k])
    assert not manifest.NAME_RE.match("a b")
    assert not manifest.NAME_RE.match("a/b")
    assert not manifest.UNIT_RE.match("reads per s")


def test_each_per_layer_metric_moves_a_metric_its_cells_report(bench):
    for m in bench["per_layer"]:
        for cell in m["workloads"]:
            got = [e["name"] for e in
                   manifest.metrics_of(bench, cell, "end_to_end")]
            assert m["moves"] in got, (m["name"], cell)


def test_check_catches_a_broken_manifest(bench):
    bad = dict(bench, per_layer=[dict(bench["per_layer"][0],
                                      moves="coarse_reads_per_s")])
    assert any("moves" in p for p in manifest.check(bad))
    bad = dict(bench, workloads=bench["workloads"] + [
        dict(bench["workloads"][0], name="x y")])
    assert manifest.check(bad)


def test_every_file_is_found_by_its_name(bench):
    for w in bench["workloads"]:
        assert manifest.config(bench, w["config"])["options"]
        assert manifest.traffic(w["traffic"])["entry"] in ("sam", "coarse")
    for m in bench["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hashreadmapper_tpu_torch.x",
                        sys.modules[__name__])
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "hashreadmapper_tpu.x",
                        sys.modules[__name__])
    assert run.forbidden_modules() == ["hashreadmapper_tpu"]
    monkeypatch.setitem(sys.modules, "jaxlib", sys.modules[__name__])
    assert run.forbidden_modules() == ["hashreadmapper_tpu", "jaxlib"]


def test_vote_bound_matches_a_hand_count():
    # F 2, N 3, C 4, out_cap 2: 8*2*3*4 = 192 bytes in, 3*2*(8+4) + 3*4
    # = 84 out; 3*2*4*(2*1+2) = 96 ALU operations
    t, by = peaks.vote_bound_s(2, 3, 4, 2)
    assert by == "bytes"
    assert t == pytest.approx(276 / 3.35e12)
    t_ops = 96 / 64 / (67e12 / 256)
    assert t_ops < t
    # at the chr1 shape the bytes bound it: 0.0405 ms a batch
    t, by = peaks.vote_bound_s(32, 4096, 128, 32)
    assert by == "bytes"
    assert t == pytest.approx((8 * 32 * 4096 * 128 + 4096 * 32 * 12
                               + 4096 * 4) / 3.35e12)
