"""The single-pass fill and the fused traceback of this checkout beside
another checkout's (the parent commit's, say) on one card, in one process,
and the fill's latency floor.

    python -m hashreadmapper_tpu_torch.tools.fill_compare OTHER_DIR

Run from the repository root: it takes chip_smoke.py's phase-1 inputs
(bandtb_inputs, fill_cases, traceback_modes).  OTHER_DIR is the root of
another checkout; its hashreadmapper_tpu_torch is loaded under the name
hrm_other, with its own _build and build directory, and both libraries
are built first.

For each phase-1 fill_pass case and both traceback modes it checks that
the two checkouts give the same outputs (a fill's directions of the
pairs not done) and prints the device time a launch (chip_smoke's
device_ms: 20 launches back to back, median of 3) in the order other,
this, this, other, with the mean of each side's two.  Then the fill's
latency floor in each case: for each span of band (2 bw + 1 cells up to
8, 16, 32, ... ), the pair with the most rows alone (P = 1), and a done
pair alone (a launch with no row), for both checkouts.
"""

import importlib
import importlib.util
import os
import sys

import torch

def load_other(root):
    """OTHER_DIR/hashreadmapper_tpu_torch as the package hrm_other; returns
    its ops.bandtb_kernel."""
    pkg = os.path.join(os.path.abspath(root), "hashreadmapper_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "hrm_other", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["hrm_other"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("hrm_other.ops.bandtb_kernel")


def same(a, b, live=None):
    """Outputs of the two checkouts equal (tuples of tensors or None)."""
    for x, y in zip(a, b):
        if (x is None) != (y is None):
            return False
        if x is not None:
            if x.dim() == 3 and live is not None:
                x, y = x[live], y[live]
            if not torch.equal(x, y):
                return False
    return True


def alternate(cs, fns):
    """Device ms of fns["other"] and fns["this"] in the order other,
    this, this, other."""
    got = {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        got[side].append(cs.device_ms(fns[side]))
    return got


def show(label, got):
    mean = {k: sum(v) / len(v) for k, v in got.items()}
    print(f"{label}: other {got['other'][0]:.4f} / {got['other'][1]:.4f}, "
          f"this {got['this'][0]:.4f} / {got['this'][1]:.4f} ms; means "
          f"{mean['other']:.4f} -> {mean['this']:.4f} "
          f"({mean['this'] / mean['other']:.3f}x)", flush=True)


def band_span(bw):
    """2 bw + 1, the cells of a band, rounded up to a power of two of at
    least 8."""
    span = 8
    while span < 2 * bw + 1:
        span *= 2
    return span


def main(argv):
    if not torch.cuda.is_available():
        print("fill_compare: no CUDA device", file=sys.stderr)
        return 1
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from hashreadmapper_tpu_torch import _build
    from hashreadmapper_tpu_torch.ops import bandtb_kernel as bk
    other = load_other(argv[0])
    sys.modules["hrm_other._build"].build()
    _build.build()
    mods = {"other": other, "this": bk}
    dev = torch.device("cuda")
    print(f"card {torch.cuda.get_device_name(0)}; other checkout "
          f"{os.path.abspath(argv[0])}", flush=True)
    inp = cs.bandtb_inputs(dev)
    live = inp["done"] == 0
    for label, args in cs.fill_cases(inp):
        outs = {k: mod.fill_pass(*args) for k, mod in mods.items()}
        if not same(outs["other"], outs["this"], live):
            raise AssertionError(f"fill_pass {label}: the checkouts differ")
        show(f"fill_pass {label}", alternate(cs, {
            k: (lambda mod=mod: mod.fill_pass(*args))
            for k, mod in mods.items()}))
    for label, args, kw in cs.traceback_modes(inp):
        outs = {k: mod.traceback(*args, **kw) for k, mod in mods.items()}
        if not same(outs["other"], outs["this"]):
            raise AssertionError(f"traceback {label}: the checkouts differ")
        show(f"traceback {label}", alternate(cs, {
            k: (lambda mod=mod: mod.traceback(*args, **kw))
            for k, mod in mods.items()}))

    # the latency floor: one pair alone, its rows one after another
    m_max = inp["lq"]
    rows = inp["m"].clamp(0, m_max)
    for label, args in cs.fill_cases(inp):
        q, ref, m, r, bw, done, _, emit = args
        one = lambda i, d=None: (
            q[:, i:i + 1].contiguous(), ref[:, i:i + 1].contiguous(),
            m[i:i + 1], r[i:i + 1], bw[i:i + 1],
            done[i:i + 1] if d is None else torch.ones_like(done[i:i + 1]),
            m_max, emit)
        picks = {}
        for i in torch.nonzero(live & (rows > 0)).flatten().tolist():
            name = f"2 bw + 1 <= {band_span(int(bw[i]))}"
            if name not in picks or rows[i] > rows[picks[name]]:
                picks[name] = i
        print(f"fill_pass {label}, one pair alone:", flush=True)
        for name, i in picks.items():
            show(f"  {name}: m {int(rows[i])}, bw {int(bw[i])}, r "
                 f"{int(r[i])}", alternate(cs, {
                     k: (lambda mod=mod, a=one(i): mod.fill_pass(*a))
                     for k, mod in mods.items()}))
        i = int(torch.nonzero(~live)[0])
        show("  a done pair (no row)", alternate(cs, {
            k: (lambda mod=mod, a=one(i, 1): mod.fill_pass(*a))
            for k, mod in mods.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
