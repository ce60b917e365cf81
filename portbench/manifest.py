"""BENCHMARK.json and the files it names: a cell's configuration, its
traffic mix and its per-layer metrics' readers, each found by its name.

    portbench/configs/<config>.json   (the file that BENCHMARK.json names)
    portbench/traffic/<traffic>.json
    portbench/metrics/<metric>.py     def read(rec) -> float or None

A new configuration, mix or metric is a new file and a new entry; no file
of the harness changes.  check() holds the manifest to the benchmark's
naming and shape rules.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (cells: "
                   f"{', '.join(w['name'] for w in bench['workloads'])})")


def config(bench: Dict, name: str, root: str = ROOT) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as fh:
                return json.load(fh)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as fh:
        return json.load(fh)


def metrics_of(bench: Dict, cell_name: str, kind: str) -> List[Dict]:
    """The end_to_end or per_layer metrics that a cell reports: those
    whose workloads list names it, or that have no list."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def reader(name: str) -> Callable:
    """read(rec) of portbench/metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _one_line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def check(bench: Dict, root: str = ROOT) -> List[str]:
    """Every rule of the manifest that BENCHMARK.json breaks, as text."""
    bad: List[str] = []
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    if set(bench) != keys:
        bad.append(f"top-level keys {sorted(bench)}")
    if not 1 <= len(bench["paths"]) <= 16:
        bad.append("paths: 1 to 16")
    for p in bench["paths"]:
        if not re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) or p.startswith(
                "/") or ".." in p.split("/"):
            bad.append(f"path {p!r}")
    if not 1 <= len(bench["command"]) <= 32 or not all(
            _one_line(w) for w in bench["command"]):
        bad.append("command")
    if not (isinstance(bench["run_seconds"], int)
            and 1 <= bench["run_seconds"] <= 51):
        bad.append("run_seconds")
    names: Dict[str, set] = {"configs": set(), "workloads": set(),
                             "metrics": set()}
    for c in bench["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            bad.append(f"config {c.get('name')}: keys {sorted(c)}")
        if not NAME_RE.match(c["name"]) or c["name"] in names["configs"]:
            bad.append(f"config name {c['name']!r}")
        names["configs"].add(c["name"])
        if not _one_line(c["source"]) or not _one_line(c["why"]):
            bad.append(f"config {c['name']}: source or why")
        if len(c["reduced"]) > 16 or not all(NAME_RE.match(k)
                                             for k in c["reduced"]):
            bad.append(f"config {c['name']}: reduced")
        if not any(c["file"].startswith(p.rstrip("/") + "/")
                   for p in bench["paths"]) or not os.path.exists(
                os.path.join(root, c["file"])):
            bad.append(f"config {c['name']}: file {c['file']}")
    pairs = set()
    for w in bench["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            bad.append(f"workload {w.get('name')}: keys {sorted(w)}")
        for k in ("name", "config", "traffic"):
            if not NAME_RE.match(w[k]):
                bad.append(f"workload {w['name']}: {k} {w[k]!r}")
        if w["name"] in names["workloads"]:
            bad.append(f"workload {w['name']} twice")
        names["workloads"].add(w["name"])
        if w["config"] not in names["configs"]:
            bad.append(f"workload {w['name']}: config {w['config']}")
        if (w["config"], w["traffic"]) in pairs:
            bad.append(f"workload {w['name']}: pair twice")
        pairs.add((w["config"], w["traffic"]))
        if w["chips"] not in (1, 4) or not _one_line(w["why"]):
            bad.append(f"workload {w['name']}: chips or why")
        if not os.path.exists(os.path.join(HERE, "traffic",
                                           w["traffic"] + ".json")):
            bad.append(f"workload {w['name']}: no traffic file")
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    if four > max(1, len(bench["workloads"]) // 4):
        bad.append(f"{four} four-chip cells")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            allowed = {"name", "unit", "better", "source", "workloads"} | (
                {"bound"} if kind == "end_to_end" else {"layer", "moves"})
            if not set(m) <= allowed or not set(m) >= allowed - {"workloads"}:
                bad.append(f"metric {m.get('name')}: keys {sorted(m)}")
            if not NAME_RE.match(m["name"]) or m["name"] in names["metrics"]:
                bad.append(f"metric name {m['name']!r}")
            names["metrics"].add(m["name"])
            if not UNIT_RE.match(m["unit"]) or m["better"] not in (
                    "lower", "higher"):
                bad.append(f"metric {m['name']}: unit or better")
            for w in m.get("workloads", []):
                if w not in names["workloads"]:
                    bad.append(f"metric {m['name']}: workload {w}")
            if kind == "end_to_end":
                if m["source"] not in ("host_clock", "device_trace"):
                    bad.append(f"metric {m['name']}: source")
                if not 0 < m["bound"] <= 0.25:
                    bad.append(f"metric {m['name']}: bound")
            else:
                if m["source"] not in SOURCES or not _one_line(m["layer"]):
                    bad.append(f"metric {m['name']}: source or layer")
                moved = e2e.get(m["moves"])
                cells = m.get("workloads", sorted(names["workloads"]))
                if moved is None or any(
                        c not in moved.get("workloads", [c]) for c in cells):
                    bad.append(f"metric {m['name']}: moves {m['moves']}")
                if not os.path.exists(os.path.join(HERE, "metrics",
                                                   m["name"] + ".py")):
                    bad.append(f"metric {m['name']}: no reader")
    if "setup_s" not in e2e:
        bad.append("no setup_s")
    for w in bench["workloads"]:
        got = [m["name"] for m in metrics_of(bench, w["name"], "end_to_end")]
        if "setup_s" not in got or len(got) < 2 or not metrics_of(
                bench, w["name"], "per_layer"):
            bad.append(f"workload {w['name']}: metrics {got}")
    return bad

