"""Port parity: the banded traceback's staging shift, fill pass and the
whole traceback (band doubling, fill, run-length walk; PyTorch on the
CPU) against the JAX package's ops/bandtb.py, its XLA twins and its
Pallas kernels in interpret mode.  All outputs are integers: exact
equality."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hashreadmapper_tpu.ops import bandtb as jbt
from hashreadmapper_tpu.ops import swdev as jsw
from hashreadmapper_tpu_torch.ops import bandtb as tbt
from hashreadmapper_tpu_torch.ops import swdev as tsw
from hashreadmapper_tpu_torch.ops.bandtb_kernel import (
    fill_pass, shift_sub, shift_sub_plain, traceback, traceback_plain)

from test_torch_swdev import indel_pairs

LQ = NL = 128
BP = 128


def _t(a):
    return torch.from_numpy(np.array(a))


def band_doubling_pairs(rng, n):
    """A d-base deletion, then d inserted bases, inside a read of the ref:
    r == m, so the first band |r - m| + 1 = 1 is too narrow and the fill
    doubles it up to d (4..15)."""
    rc = np.full((n, LQ), 4, np.int8)
    fc = np.full((n, NL), 4, np.int8)
    rls = np.zeros(n, np.int32)
    fls = np.zeros(n, np.int32)
    for i in range(n):
        fl = int(rng.integers(100, NL + 1))
        ref = rng.integers(0, 4, fl).astype(np.int8)
        d = int(rng.integers(4, 16))
        seg = np.concatenate([ref[5:30], ref[30 + d:60 + d],
                              rng.integers(0, 4, d), ref[60 + d:85 + d]])
        rc[i, :len(seg)] = seg
        rls[i] = len(seg)
        fc[i, :fl] = ref
        fls[i] = fl
    return rc, rls, fc, fls


@pytest.fixture(scope="module")
def scored():
    """128 scored pairs (indel and band-doubling) and their [10, P] rows."""
    rng = np.random.default_rng(23)
    parts = [indel_pairs(rng, 96), band_doubling_pairs(rng, 32)]
    rc, rls, fc, fls = (np.concatenate(x) for x in zip(*parts))
    masks = np.maximum(15, rls // 2).astype(np.int32)
    s10 = np.asarray(jsw.ssw_score_packed(rc, rls, fc, fls, masks, NL))
    return rc, fc, s10


def _pallas_shift(x, sh, size):
    L, P = x.shape
    return np.asarray(pl.pallas_call(
        functools.partial(jbt._shift_kernel, size=size),
        grid=(P // BP,),
        in_specs=[pl.BlockSpec((L, BP), lambda g: (0, g)),
                  pl.BlockSpec((1, BP), lambda g: (0, g))],
        out_specs=pl.BlockSpec((size, BP), lambda g: (0, g)),
        out_shape=jax.ShapeDtypeStruct((size, P), jnp.int32),
        scratch_shapes=[pltpu.VMEM((L + size, BP), jnp.int32)],
        interpret=True)(jnp.asarray(x), jnp.asarray(sh).reshape(1, P)))


@pytest.mark.parametrize("L,size", [(128, 128), (96, 128)])
def test_shift_sub_equals_both_jax_shifts(L, size):
    """Begins in [-1, L + size].  The Pallas kernel fills with 4 past the
    end; the XLA twin rolls (wraps around), so the two JAX shifts differ
    where begin & mask > L; the port follows the Pallas kernel everywhere
    and equals the XLA twin where they agree (every begin a walked pair
    has)."""
    rng = np.random.default_rng(L)
    P = 256
    x = rng.integers(0, 5, (L, P)).astype(np.int32)
    sh = rng.integers(-1, L + size + 1, P).astype(np.int32)
    sh[:4] = [-1, 0, L, L + size]
    before = shift_sub.launches
    got = shift_sub(_t(x), _t(sh), size).numpy()
    assert shift_sub.launches == before
    np.testing.assert_array_equal(got, shift_sub_plain(_t(x), _t(sh),
                                                       size).numpy())
    np.testing.assert_array_equal(got, _pallas_shift(x, sh, size))
    xla = np.asarray(jbt._shift_sub_xla(jnp.asarray(x), jnp.asarray(sh),
                                        size))
    eff = sh & ((1 << (L + size - 1).bit_length()) - 1)
    agree = eff <= L
    assert not agree[0] and agree[1:3].all() and (~agree).sum() > 10
    np.testing.assert_array_equal(got[:, agree], xla[:, agree])


def _pallas_fill(read_t, ref_t, m, r, bw, done, emit):
    """bandtb._fill_pallas in interpret mode (one grid step per block)."""
    P = ref_t.shape[1]
    row1 = lambda a: jnp.asarray(a, jnp.int32).reshape(1, P)
    blk = lambda: pl.BlockSpec((1, BP), lambda g: (0, g))
    out_specs, out_shape = [blk()], [jax.ShapeDtypeStruct((1, P), jnp.int32)]
    if emit:
        out_specs.insert(0, pl.BlockSpec((LQ, NL, BP), lambda g: (0, 0, g)))
        out_shape.insert(0, jax.ShapeDtypeStruct((LQ, NL, P), jnp.int16))
    out = pl.pallas_call(
        functools.partial(jbt._fill_kernel, m_max=LQ, emit_dirs=emit),
        grid=(P // BP,),
        in_specs=[pl.BlockSpec((LQ, BP), lambda g: (0, g)),
                  pl.BlockSpec((NL, BP), lambda g: (0, g)),
                  blk(), blk(), blk(), blk()],
        out_specs=out_specs, out_shape=out_shape,
        scratch_shapes=[pltpu.VMEM((NL, BP), jnp.int32)] * 4,
        interpret=True)(jnp.asarray(read_t), jnp.asarray(ref_t), row1(m),
                        row1(r), row1(bw), row1(done))
    if emit:
        return np.asarray(out[1][0]), np.asarray(out[0])
    return np.asarray(out[0][0]), None


def _subregions(scored):
    """The scored pairs' subregion codes ([LQ, P] and [NL, P] int32) and
    rows m and columns r (0 for pairs without an alignment)."""
    rc, fc, s10 = scored
    qb, qe, rb, re = s10[6], s10[2], s10[5], s10[1]
    ok = (s10[0] > 0) & (re >= 0) & (s10[8] == 0)
    qb, rb = np.where(ok, qb, 0), np.where(ok, rb, 0)
    m = np.where(ok, qe - qb + 1, 0).astype(np.int32)
    r = np.where(ok, re - rb + 1, 0).astype(np.int32)
    read_t = np.asarray(jbt._shift_sub_xla(
        jnp.asarray(rc).astype(jnp.int32).T, jnp.asarray(qb), LQ))
    ref_t = np.asarray(jbt._shift_sub_xla(
        jnp.asarray(fc).astype(jnp.int32).T, jnp.asarray(rb), NL))
    return read_t, ref_t, m, r


def _fill_equals_jax(read_t, ref_t, m, r, bw, done, emit):
    """fill_pass on the CPU (its plain version) == JAX _fill_pass (XLA
    scan) and _fill_pallas in interpret mode: best where not done, 0
    where done; directions of the pairs not done, rows >= m 0."""
    best_x, dirs_x = jbt._fill_pass(
        jnp.asarray(read_t), jnp.asarray(ref_t).T, jnp.asarray(m),
        jnp.asarray(r), jnp.asarray(bw), LQ, emit)
    best_p, dirs_p = _pallas_fill(read_t, ref_t, m, r, bw, done, emit)
    before = fill_pass.launches
    best, dirs = fill_pass(_t(read_t), _t(ref_t), _t(m), _t(r), _t(bw),
                           _t(done), LQ, emit)
    assert fill_pass.launches == before
    live = done == 0
    np.testing.assert_array_equal(best.numpy()[live], np.asarray(best_x)[live])
    np.testing.assert_array_equal(best.numpy()[live], best_p[live])
    assert (best.numpy()[~live] == 0).all()
    if not emit:
        assert dirs is None
        return None
    assert dirs.shape == (len(m), LQ, NL) and dirs.dtype == torch.int16
    got = dirs.numpy()[live]
    np.testing.assert_array_equal(
        got, np.asarray(dirs_x).transpose(1, 0, 2)[live])
    np.testing.assert_array_equal(got, dirs_p.transpose(2, 0, 1)[live])
    rows = np.arange(LQ)[None, :, None]
    assert (np.where(rows >= m[live][:, None, None], got, 0) == 0).all()
    return got


@pytest.mark.parametrize("emit", [False, True])
def test_fill_pass_equals_xla_and_interpret_pallas(scored, emit):
    """One fill pass on the subregions of 128 scored pairs, first bands
    and doubled ones, a quarter of the pairs done: best where not done,
    and directions (rows >= m are 0) for the pairs not done."""
    read_t, ref_t, m, r = _subregions(scored)
    rng = np.random.default_rng(4)
    bw = (np.abs(r - m) + 1) * rng.choice([1, 2, 4], size=len(m))
    bw = bw.astype(np.int32)
    done = (rng.random(len(m)) < 0.25).astype(np.int32)
    got = _fill_equals_jax(read_t, ref_t, m, r, bw, done, emit)
    if emit:
        assert (got & 7).max() >= 4                 # D runs present


# The CUDA fill kernel splits on the band's cells 2 bw + 1: up to 8 in an
# 8-lane segment, up to 16 in a 16-lane one, up to 32 K band-relative
# cells at K = 1, 2, 4, more on absolute lanes.  Each case sets bw for all
# pairs on both sides of an edge; a row near the top holds bw + 1 cells
# (8, 9, 16, 17, 32 and 33 of them at bw 7, 8, 15, 16, 31 and 32).
FILL_EDGES = {
    "bw 1, 3 cells": dict(bw=1),
    "bw 3, 7 cells": dict(bw=3),
    "bw 4, 9 cells": dict(bw=4),
    "bw 7, 15 cells": dict(bw=7),
    "bw 8, 17 cells": dict(bw=8),
    "bw 15, 31 cells": dict(bw=15),
    "bw 16, 33 cells": dict(bw=16),
    "bw 31, 63 cells": dict(bw=31),
    "bw 32, 65 cells": dict(bw=32),
    "band wider than NL": dict(bw=NL + 20),
    "r > NL": dict(r=NL + 9),
    "m = 0 every other pair": dict(m=0),
    "m = m_max": dict(m=LQ),
}


@pytest.mark.parametrize("edge", list(FILL_EDGES))
def test_fill_pass_at_the_kernels_edges_equals_jax(scored, edge):
    """fill_pass_plain against the JAX XLA pass and the interpret-mode
    Pallas kernel, emitting, at each band width where the CUDA kernel
    changes its lanes, a band wider than NL, r past NL, m = 0 and m =
    m_max (bw the first band |r - m| + 1 where the case does not set it);
    a quarter of the pairs done."""
    read_t, ref_t, m, r = _subregions(scored)
    case = FILL_EDGES[edge]
    if "r" in case:
        r = np.full_like(r, case["r"])
    if "m" in case:
        m = (np.where(np.arange(len(m)) % 2 == 0, case["m"], m) if
             case["m"] == 0 else np.full_like(m, case["m"])).astype(np.int32)
    bw = np.full_like(m, case["bw"]) if "bw" in case else np.abs(r - m) + 1
    done = (np.random.default_rng(5).random(len(m)) < 0.25).astype(np.int32)
    got = _fill_equals_jax(read_t, ref_t, m, r, bw.astype(np.int32), done,
                           True)
    assert got.any()


@pytest.mark.parametrize("mode", ["dispatch", "fused"])
def test_traceback_walk_equals_jax(scored, mode):
    """_tb_core_t in both entry modes (int16 entries over every pair;
    uint8-run entries over the needed pairs), the band doubling included,
    and fused_traceback_t."""
    rc, fc, s10 = scored
    need = ~((s10[9] != 0) | (s10[8] != 0) | (s10[0] == 0) | (s10[1] < 0))
    read_tt = jnp.asarray(rc).astype(jnp.int32).T
    ref_tt = jnp.asarray(fc).astype(jnp.int32).T
    if mode == "dispatch":
        sel = np.nonzero(need)[0]
        cols = lambda a: a[:, sel]
        kw = dict(m_max=LQ, n_entries=jbt.N_ENTRIES)
        want = jbt._banded_tb_jit(
            jnp.asarray(rc[sel]), s10[6][sel], s10[2][sel],
            jnp.asarray(fc[sel]), s10[5][sel], s10[1][sel], s10[0][sel],
            **kw)
        got = tbt._tb_core_t(_t(cols(np.asarray(read_tt))), _t(s10[6][sel]),
                             _t(s10[2][sel]), _t(cols(np.asarray(ref_tt))),
                             _t(s10[5][sel]), _t(s10[1][sel]),
                             _t(s10[0][sel]), **kw)
        live = slice(None)
        bw0 = np.abs((s10[1] - s10[5]) - (s10[2] - s10[6]))[sel] + 1
        ops, status = tbt.banded_traceback_batch(
            rc[sel], s10[6][sel], s10[2][sel], fc[sel], s10[5][sel],
            s10[1][sel], s10[0][sel], "cpu")
        np.testing.assert_array_equal(ops, np.asarray(want[0]))
        np.testing.assert_array_equal(status, np.asarray(want[1]))
    else:
        kw = dict(m_max=LQ, n_entries=jbt.FUSED_ENTRIES, run_cap=63)
        want = jax.jit(jbt._tb_core_t, static_argnames=(
            "m_max", "n_entries", "use_pallas", "run_cap"))(
            read_tt, s10[6], s10[2], ref_tt, s10[5], s10[1], s10[0],
            need=jnp.asarray(need), **kw)
        got = tbt._tb_core_t(_t(np.asarray(read_tt)), _t(s10[6]),
                             _t(s10[2]), _t(np.asarray(ref_tt)), _t(s10[5]),
                             _t(s10[1]), _t(s10[0]), need=_t(need), **kw)
        live = need
        bw0 = np.abs((s10[1] - s10[5]) - (s10[2] - s10[6]))[need] + 1
    ents, status, bw = (x.numpy() for x in got)
    assert ents.dtype == np.int16 and status.dtype == np.int8
    np.testing.assert_array_equal(ents, np.asarray(want[0]))
    np.testing.assert_array_equal(status, np.asarray(want[1]))
    np.testing.assert_array_equal(bw[live], np.asarray(want[2])[live])
    assert (bw[live] > bw0).sum() >= 5              # bands doubled
    assert ((ents & 3) == jbt.OP_D).any() and ((ents & 3) == jbt.OP_I).any()
    if mode == "fused":
        assert ents.max() >> 2 <= 63
        jops, jst = jbt.fused_traceback_t(read_tt, ref_tt, jnp.asarray(s10))
        tops, tst = tbt.fused_traceback_t(_t(np.asarray(read_tt)),
                                          _t(np.asarray(ref_tt)), _t(s10))
        assert tops.dtype == torch.uint8 and tst.dtype == torch.int8
        np.testing.assert_array_equal(tops.numpy(), np.asarray(jops))
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


def crafted_pairs(rng):
    """128 pairs with hand-set subregion bounds and target scores, for
    what scored pairs rarely show.  Returns (rc, fc, s10 [10, 128]).
    0..15   a 3-base deletion after a 70-base match: an M run past 63;
    16..31  two matching bases, then in turn a skipped ref base and an
            inserted read base, 40 times, target score out of reach: the
            band doubles from 1 to the end and the walk runs out of
            entries;
    32..127 random codes, bounds with m in [-1, 128] and r in [0, 128],
            small target scores: failed walks, m <= 0, r <= 1."""
    n = 128
    rc = np.full((n, LQ), 4, np.int8)
    fc = np.full((n, NL), 4, np.int8)
    s10 = np.zeros((10, n), np.int32)
    for i in range(n):
        ref = rng.integers(0, 4, NL).astype(np.int8)
        if i < 16:
            read = np.concatenate([ref[10:80], ref[83:113]])
            qb, qe, rb, re, score = 0, len(read) - 1, 10, 112, 2 * 100 - 4
        elif i < 32:
            parts, at = [], 0
            for k in range(40):
                parts.append(ref[at:at + 2])
                at += 2
                if k % 2 == 0:
                    at += 1
                else:
                    parts.append(rng.integers(0, 4, 1).astype(np.int8))
            read = np.concatenate(parts)
            qb, qe, rb, re, score = 0, len(read) - 1, 0, at - 1, 10 ** 6
        else:
            read = rng.integers(0, 5, LQ).astype(np.int8)
            qb = int(rng.integers(0, 100))
            qe = int(rng.integers(qb - 2, LQ))
            rb = int(rng.integers(0, 100))
            re = int(rng.integers(rb - 1, NL))
            if i % 8 == 0:
                re = rb                               # r == 1
            score = int(rng.integers(1, 30))
        rc[i, :len(read)] = read
        fc[i] = ref
        s10[:, i] = [score, re, qe, 0, 0, rb, qb, 0, 0, 0]
    return rc, fc, s10


@pytest.fixture(scope="module")
def rich(scored):
    """The 128 scored pairs and the 128 crafted ones, with the port's
    plain traceback of both modes; asserted to hold every kind of pair."""
    rng = np.random.default_rng(41)
    rc2, fc2, s10_2 = crafted_pairs(rng)
    rc, fc = np.concatenate([scored[0], rc2]), np.concatenate([scored[1], fc2])
    s10 = np.concatenate([scored[2], s10_2], axis=1)
    need = ~((s10[9] != 0) | (s10[8] != 0) | (s10[0] == 0) | (s10[1] < 0))
    m = s10[2] - s10[6] + 1
    r = s10[1] - s10[5] + 1
    read_s = shift_sub_plain(_t(rc).T, _t(s10[6]), LQ, pair_major=True)
    ref_s = shift_sub_plain(_t(fc).T, _t(s10[5]), NL, pair_major=True)
    out = {}
    for mode, kw in (("fused", dict(n_entries=tbt.FUSED_ENTRIES,
                                    need=_t(need), run_cap=63)),
                     ("dispatch", dict(n_entries=tbt.N_ENTRIES))):
        before = traceback.launches
        got = traceback(read_s, ref_s, _t(m), _t(r), _t(s10[0]), **kw)
        assert traceback.launches == before        # CPU tensors: plain
        want = traceback_plain(read_s, ref_s, _t(m), _t(r), _t(s10[0]), **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        out[mode] = tuple(x.numpy() for x in got)
    ents, status, bw = out["fused"]
    passes = np.log2(bw // (np.abs(r - m) + 1)).astype(int) + 1
    kinds = {"status 1": need & (status == 1),
             "status 2": need & (status == 2),
             "not needed": ~need,
             "m <= 0 or r <= 1": need & ((m <= 0) | (r <= 1)),
             "more than 4 passes": need & (passes > 4),
             "a run split at 63": need & ((ents >> 2) == 63).any(axis=1)}
    for kind, mask in kinds.items():
        assert mask.any(), kind
    assert (out["dispatch"][1] == 2).any() and (out["dispatch"][1] == 1).any()
    assert (ents[~need] == 0).all() and (status[~need] == 0).all()
    return rc, fc, s10, need, out, {k: int(v.sum()) for k, v in kinds.items()}


def test_fixture_holds_every_kind_of_pair(rich):
    counts = rich[5]
    assert min(counts.values()) >= 1, counts


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("mode", ["dispatch", "fused"])
def test_traceback_plain_equals_jax_tb_core(rich, mode, use_pallas,
                                            monkeypatch):
    """traceback_plain (through _tb_core_t, as the CPU path runs it)
    against the JAX _tb_core_t with its XLA fill and with its Pallas fill
    in interpret mode: entries, status and the final band width."""
    rc, fc, s10, need, out, _ = rich
    if use_pallas:
        monkeypatch.setattr(jbt.pl, "pallas_call", functools.partial(
            pl.pallas_call, interpret=True))
    read_tt = jnp.asarray(rc).astype(jnp.int32).T
    ref_tt = jnp.asarray(fc).astype(jnp.int32).T
    kw = (dict(m_max=LQ, n_entries=jbt.N_ENTRIES) if mode == "dispatch" else
          dict(m_max=LQ, n_entries=jbt.FUSED_ENTRIES, run_cap=63))
    jneed = None if mode == "dispatch" else jnp.asarray(need)
    want = jax.jit(jbt._tb_core_t, static_argnames=(
        "m_max", "n_entries", "use_pallas", "run_cap"))(
        read_tt, s10[6], s10[2], ref_tt, s10[5], s10[1], s10[0],
        use_pallas=use_pallas, need=jneed, **kw)
    # int8 codes as the engine hands them over, and int32 ones
    for dtype in (np.int8, np.int32):
        got = tbt._tb_core_t(
            _t(rc.astype(dtype)).T, _t(s10[6]), _t(s10[2]),
            _t(fc.astype(dtype)).T, _t(s10[5]), _t(s10[1]), _t(s10[0]),
            need=None if mode == "dispatch" else _t(need), **kw)
        ents, status, bw = (x.numpy() for x in got)
        assert ents.dtype == np.int16 and status.dtype == np.int8
        np.testing.assert_array_equal(ents, np.asarray(want[0]))
        np.testing.assert_array_equal(status, np.asarray(want[1]))
        live = slice(None) if mode == "dispatch" else need
        np.testing.assert_array_equal(bw[live], np.asarray(want[2])[live])
        for g, w in zip((ents, status, bw), out[mode]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", [np.int8, np.int32])
@pytest.mark.parametrize("L,size", [(128, 128), (96, 128)])
def test_shift_sub_int8_and_pair_major_equal_both_jax_shifts(L, size, dtype):
    """int8 codes in, and the pair-major [P, size] uint8 layout out: the
    same values as the Pallas shift everywhere and as the XLA twin where
    the two JAX shifts agree."""
    rng = np.random.default_rng(L + size)
    P = 128
    x = rng.integers(0, 5, (L, P)).astype(dtype)
    sh = rng.integers(-1, L + size + 1, P).astype(np.int32)
    sh[:4] = [-1, 0, L, L + size]
    rows = shift_sub(_t(x), _t(sh), size).numpy()
    assert rows.dtype == np.int32 and rows.shape == (size, P)
    pm = shift_sub(_t(x), _t(sh), size, pair_major=True)
    assert pm.dtype == torch.uint8 and pm.shape == (P, size)
    assert pm.is_contiguous()
    np.testing.assert_array_equal(pm.numpy().T, rows)
    np.testing.assert_array_equal(
        pm.numpy(), shift_sub_plain(_t(x), _t(sh), size, True).numpy())
    np.testing.assert_array_equal(rows, _pallas_shift(x.astype(np.int32), sh,
                                                      size))
    xla = np.asarray(jbt._shift_sub_xla(jnp.asarray(x).astype(jnp.int32),
                                        jnp.asarray(sh), size))
    agree = (sh & ((1 << (L + size - 1).bit_length()) - 1)) <= L
    np.testing.assert_array_equal(pm.numpy().T[:, agree], xla[:, agree])


@pytest.mark.parametrize("entry", ["ssw_score_batch",
                                   "banded_traceback_batch"])
def test_batch_entry_points_run_on_the_card_unless_asked(entry, scored):
    """No "cpu" default: without a device argument the numpy entry points
    go to the card, and raise when there is none."""
    rc, fc, s10 = scored
    n = 8
    lens = np.full(n, 30, np.int32)
    if entry == "ssw_score_batch":
        call = lambda *dev: tsw.ssw_score_batch(
            rc[:n], lens, fc[:n], lens + 10, lens // 2, *dev)["score1"]
    else:
        call = lambda *dev: tbt.banded_traceback_batch(
            rc[:n], s10[6][:n], s10[2][:n], fc[:n], s10[5][:n], s10[1][:n],
            s10[0][:n], *dev)[0]
    if torch.cuda.is_available():
        np.testing.assert_array_equal(call(), call("cpu"))
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            call()
