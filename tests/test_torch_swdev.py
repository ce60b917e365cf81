"""Port parity: the striped SW pass and the STEP-2 score rows (PyTorch on
the CPU) against the JAX package's ops/swdev.py and its Pallas kernel in
interpret mode.  All outputs are integers: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashreadmapper_tpu.ops import swdev as jsw
from hashreadmapper_tpu.ops.swdev_pallas import pass_batched_pallas
from hashreadmapper_tpu_torch.ops import swdev as tsw
from hashreadmapper_tpu_torch.ops import swdev_kernel as swk
from hashreadmapper_tpu_torch.ops.swdev_kernel import (pass_batched,
                                                       pass_batched_plain)
from torch_helpers import SW_EDGE, sw_edge_pairs


def random_pairs(rng, n, lq=128, lr=128):
    """Random and high-identity pairs (the latter up to full length, so
    some saturate the byte mode), codes 0..4, 4-padded."""
    rc = np.full((n, lq), 4, np.int8)
    fc = np.full((n, lr), 4, np.int8)
    rls = rng.integers(1, lq + 1, n).astype(np.int32)
    fls = rng.integers(1, lr + 1, n).astype(np.int32)
    for t in range(n):
        ref = rng.integers(0, 5, fls[t]).astype(np.int8)
        if t % 3 == 0:
            read = np.resize(ref, rls[t]).copy()
            mut = rng.random(rls[t]) < 0.05
            read[mut] = rng.integers(0, 4, int(mut.sum()))
        else:
            read = rng.integers(0, 5, rls[t]).astype(np.int8)
        if t % 11 == 0:                      # saturates: 128 matches
            rls[t], fls[t] = lq, lr
            ref = rng.integers(0, 4, lr).astype(np.int8)
            read = ref[:lq]
        rc[t, :rls[t]] = read
        fc[t, :fls[t]] = ref
    return rc, rls, fc, fls


def indel_pairs(rng, n, lq=128, lr=128):
    """Reads cut from the ref with substitutions and 1-3 base indels."""
    rc = np.full((n, lq), 4, np.int8)
    fc = np.full((n, lr), 4, np.int8)
    rls = np.zeros(n, np.int32)
    fls = np.zeros(n, np.int32)
    for i in range(n):
        fl = int(rng.integers(40, lr + 1))
        ref = rng.integers(0, 4, fl).astype(np.int8)
        start = int(rng.integers(0, fl - 30))
        seg = list(ref[start:start + int(rng.integers(25, 40))])
        for _ in range(int(rng.integers(0, 5))):
            seg[int(rng.integers(0, len(seg)))] = int(rng.integers(0, 4))
        if i % 3 == 1:
            d = int(rng.integers(1, 4))
            p = int(rng.integers(1, len(seg) - d))
            seg = seg[:p] + seg[p + d:]
        elif i % 3 == 2:
            p = int(rng.integers(1, len(seg)))
            seg = seg[:p] + list(rng.integers(0, 4, int(
                rng.integers(1, 4)))) + seg[p:]
        rc[i, :len(seg)] = seg
        rls[i] = len(seg)
        fc[i, :fl] = ref
        fls[i] = fl
    return rc, rls, fc, fls


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n,lq,lr", [(130, 128, 128), (40, 64, 96)])
def test_pass_equals_xla_and_interpret_pallas(n, lq, lr):
    """Forward with max_column and reverse-ordered columns with terminate
    set to the forward best (early stops fire); S = 8 and S = 4, P not a
    multiple of 128, saturating pairs included."""
    rng = np.random.default_rng(n)
    rc, rls, fc, fls = random_pairs(rng, n, lq, lr)
    read_at, pre_mask, pos, seg_len = jsw._striped_layout(
        jnp.asarray(rc), jnp.asarray(rls), lq)
    ref_t = jnp.asarray(fc).astype(jnp.int32).T
    sat = jnp.full((n,), jsw.SAT, jnp.int32)
    fwd_best = None
    for ref_dir, want_mc in ((0, True), (1, False)):
        ref_use = ref_t if ref_dir == 0 else ref_t[::-1]
        term = sat if ref_dir == 0 else jnp.asarray(fwd_best)
        want = jsw._pass_batched(read_at, pre_mask, pos, seg_len, ref_use,
                                 jnp.asarray(fls), term, ref_dir, lr,
                                 want_mc)
        pallas = pass_batched_pallas(read_at, jnp.asarray(rls), seg_len,
                                     ref_use, jnp.asarray(fls), term,
                                     ref_dir, lr, want_mc, interpret=True)
        args = (_t(read_at), _t(rls), _t(seg_len), _t(ref_use), _t(fls),
                _t(term), ref_dir, lr, want_mc)
        before = pass_batched.launches
        got = pass_batched(*args)
        assert pass_batched.launches == before      # CPU: plain version
        plain = pass_batched_plain(*args)
        for k, name in enumerate(("best", "end_ref", "end_read",
                                  "max_column", "overflowed")):
            if name == "max_column" and not want_mc:
                assert got[k] is None and want[k] is None
                continue
            for other in (np.asarray(want[k]), np.asarray(pallas[k])):
                np.testing.assert_array_equal(got[k].numpy(), other,
                                              err_msg=name)
            np.testing.assert_array_equal(got[k].numpy(), plain[k].numpy())
        if ref_dir == 0:
            fwd_best = np.asarray(want[0])
            # 128 matches saturate the byte mode; 64 do not
            assert np.asarray(want[4]).any() == (lq == 128)
    assert (np.asarray(want[0]) == fwd_best).any()    # terminate fired


@pytest.mark.parametrize("kind", ["random", "indel"])
def test_score_rows_equal_jax(kind):
    rng = np.random.default_rng(3)
    make = random_pairs if kind == "random" else indel_pairs
    rc, rls, fc, fls = make(rng, 96)
    masks = np.maximum(15, rls // 2).astype(np.int32)
    masks[::7] = 10                       # no second best below 15
    want = np.asarray(jsw.ssw_score_packed(rc, rls, fc, fls, masks, 128))
    got = tsw.ssw_score_packed(_t(rc), _t(rls), _t(fc), _t(fls), _t(masks),
                               128)
    assert got.dtype == torch.int32 and got.shape == (10, 96)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "indel":
        assert want[9].any() and not want[9].all()    # diag both ways
    wd = jsw.ssw_score_collect(want)
    td = tsw.ssw_score_batch(rc, rls, fc, fls, masks, "cpu")
    assert wd.keys() == td.keys()
    for k in wd:
        np.testing.assert_array_equal(td[k], wd[k], err_msg=k)


def test_barrel_shift_drops_bits_at_or_above_the_length():
    """_shift_rows_up applies only the shift bits below the array length:
    a shift of n (ref_end = -1 in the reverse pass) is a shift of 0."""
    rng = np.random.default_rng(5)
    n, p = 128, 64
    x = rng.integers(0, 5, (n, p)).astype(np.int32)
    sh = rng.integers(-1, 2 * n + 2, p).astype(np.int32)
    sh[:4] = [-1, 0, n, n + 1]
    want = np.asarray(jsw._shift_rows_up(jnp.asarray(x), jnp.asarray(sh),
                                         jnp.int32(4)))
    got = swk._shift_rows_up(_t(x), _t(sh), 4).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 2], x[:, 2])


def _interpret_pallas_pass(read_at, pre_mask, pos, seg_len, eff_read_len,
                           ref_t, ref_len, terminate, ref_dir, n_cols,
                           want_max_column):
    """swdev._run_pass through the Pallas kernel in interpret mode."""
    return pass_batched_pallas(read_at, eff_read_len, seg_len, ref_t,
                               ref_len, terminate, ref_dir, n_cols,
                               want_max_column, interpret=True)


@pytest.mark.parametrize("backend", ["xla", "pallas-interpret"])
@pytest.mark.parametrize("lq,n_cols", [(128, 128), (64, 96), (100, 120)])
def test_forward_and_reverse_plain_equal_jax(lq, n_cols, backend,
                                             monkeypatch):
    """sw_forward_plain and sw_reverse_plain against swdev._forward_t and
    _reverse_t (XLA twin of the pass, and the Pallas kernel in interpret
    mode) on the edge pairs, exact; lengths that are no powers of two, so
    the barrel shifts' masks are wider than the arrays."""
    if backend == "pallas-interpret":
        monkeypatch.setattr(jsw, "_run_pass", _interpret_pallas_pass)
    rc, rls, fc, fls, masks = sw_edge_pairs(lq + n_cols, lq, n_cols)
    read_j = jnp.asarray(rc).astype(jnp.int32).T
    ref_j = jnp.asarray(fc).astype(jnp.int32).T
    want = jsw._forward_t(read_j, jnp.asarray(rls), ref_j, jnp.asarray(fls),
                          jnp.asarray(masks), n_cols)
    want = {k: np.asarray(v) for k, v in want.items()}
    read_t, ref_t = _t(rc).T.contiguous(), _t(fc).T.contiguous()   # int8
    got = swk.sw_forward_plain(read_t, _t(rls), ref_t, _t(fls), _t(masks),
                               n_cols)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)

    # what the fixture promises
    e = SW_EDGE
    assert want["score1"][e["read_len 0"]] == 0
    assert want["ref_end"][e["ref_len 0"]] == -1
    assert want["score1"][e["read_len 1"]] == 2
    assert want["overflowed"][e["saturating"]] == (lq == 128)
    assert want["ref_end2"][e["mask_len 14"]] == -1
    hi = np.minimum(fls, want["ref_end"] + masks)
    lo = np.maximum(want["ref_end"] - masks, 0)
    assert 0 < want["ref_end2"][e["second best left"]] \
        < lo[e["second best left"]]
    assert want["ref_end2"][e["second best right"]] \
        > hi[e["second best right"]] + 1
    k = e["second best at hi + 1"]
    assert want["ref_end2"][k] == hi[k] + 1 and want["score2"][k] > 0

    # the reverse pass on the forward results, three pairs degenerate
    s1, re, qe = (want[k].copy() for k in ("score1", "ref_end",
                                             "query_end"))
    k = e["degenerate into reverse"]
    re[k], qe[k] = -1, -1
    re[k + 1], qe[k + 2] = -1, -1
    want_r = jsw._reverse_t(read_j, ref_j, jnp.asarray(s1), jnp.asarray(re),
                            jnp.asarray(qe), n_cols)
    got_r = swk.sw_reverse_plain(read_t, ref_t, _t(s1), _t(re), _t(qe),
                                 n_cols)
    assert got_r.keys() == want_r.keys()
    for key in want_r:
        np.testing.assert_array_equal(got_r[key].numpy(),
                                      np.asarray(want_r[key]), err_msg=key)
    assert np.asarray(want_r["ref_begin"])[k] == -1
    assert (np.asarray(want_r["flag2"]) == 0).any()


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_forward_and_reverse_write_their_rows_of_the_score_tensor(dtype):
    """sw_forward writes rows 0-4 and 8 of a given [10, P] tensor,
    sw_reverse rows 5-7, ors row 8 and writes the all-M certificate into
    row 9; on CPU tensors both are their plain versions and count no
    launch; _forward_t and _reverse_t name the rows."""
    rc, rls, fc, fls, masks = sw_edge_pairs(7, 128, 128)
    read_t = _t(rc).T.contiguous().to(dtype)
    ref_t = _t(fc).T.contiguous().to(dtype)
    args = (read_t, _t(rls), ref_t, _t(fls), _t(masks), 128)
    out = torch.full((10, len(rls)), -7, dtype=torch.int32)
    before = swk.sw_forward.launches, swk.sw_reverse.launches
    assert swk.sw_forward(*args, out) is out
    fwd = swk.sw_forward_plain(*args)
    for row, key in enumerate(("score1", "ref_end", "query_end", "score2",
                               "ref_end2")):
        assert torch.equal(out[row], fwd[key]), key
    assert torch.equal(out[8] != 0, fwd["overflowed"])
    assert (out[[5, 6, 7, 9]] == -7).all()
    assert swk.sw_reverse(read_t, ref_t, out[0], out[1], out[2], 128,
                          out) is out
    rev = swk.sw_reverse_plain(read_t, ref_t, fwd["score1"], fwd["ref_end"],
                               fwd["query_end"], 128)
    for row, key in ((5, "ref_begin"), (6, "query_begin")):
        assert torch.equal(out[row], rev[key]), key
    assert torch.equal(out[7] != 0, rev["flag2"])
    assert torch.equal(out[8] != 0, fwd["overflowed"] | rev["overflowed"])
    diag = swk.diag_fastpath_plain(
        read_t, ref_t, fwd["score1"], rev["ref_begin"], fwd["ref_end"],
        rev["query_begin"], fwd["query_end"], out[8] != 0, 128)
    assert torch.equal(out[9] != 0, diag) and diag.any() and not diag.all()
    assert before == (swk.sw_forward.launches, swk.sw_reverse.launches)
    named = tsw._forward_t(*args)
    for key in fwd:
        assert torch.equal(named[key], fwd[key]), key
    named = tsw._reverse_t(read_t, ref_t, fwd["score1"], fwd["ref_end"],
                           fwd["query_end"], 128)
    for key in rev:
        assert torch.equal(named[key], rev[key]), key
