"""Port parity: bit-plane packing, SHD and the coarse mapper's SHD stage
(plain PyTorch on the CPU) against the JAX package (Pallas shd_best in
interpret mode), exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hashreadmapper_tpu.ops import shd as jshd
from hashreadmapper_tpu.ops import shd_pallas
from hashreadmapper_tpu_torch.ops import shd
from hashreadmapper_tpu_torch.ops import shd_kernel as sk
from hashreadmapper_tpu_torch.ops.shd_kernel import (
    BIG, pack_bitplanes, pack_genome_planes, shd_best, shd_best_plain,
    shd_hamming_matrix, shd_hamming_matrix_plain)

from torch_helpers import shd_pairs_case


def _t(a):
    return torch.from_numpy(np.array(a))


def test_pack_bitplanes_and_genome_planes():
    rng = np.random.default_rng(3)
    bases = rng.integers(0, 4, size=(16, 70), dtype=np.int8)
    lengths = rng.integers(0, 80, size=16).astype(np.int32)
    for nwords in (2, 3, 4):
        want = shd_pallas.pack_bitplanes(jnp.asarray(bases),
                                         jnp.asarray(lengths), nwords)
        got = pack_bitplanes(_t(bases), _t(lengths), nwords)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    genome = rng.integers(0, 4, size=1000, dtype=np.int8)
    want = shd_pallas.pack_genome_planes(jnp.asarray(genome), chunk=256)
    got = pack_genome_planes(_t(genome), chunk=256)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for fn, jfn in ((shd.collapse_planes_ct, shd_pallas.collapse_planes_ct),
                    (shd.collapse_planes_ga, shd_pallas.collapse_planes_ga)):
        for g, w in zip(fn(*got), jfn(*want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _shd_inputs(seed, p=128, wr=2, n_shifts=64):
    rng = np.random.default_rng(seed)
    wa = (n_shifts - 1) // 32 + wr + 2
    full = lambda *s: rng.integers(-2**31, 2**31, size=s, dtype=np.int64
                                   ).astype(np.int32)
    a_hi, a_lo = full(p, 2, wa), full(p, 2, wa)
    r_hi, r_lo = full(p, 2, wr), full(p, 2, wr)
    mask = full(p, wr)
    lo = rng.integers(0, 40, size=p)
    bounds = np.stack([lo, lo + rng.integers(-3, n_shifts, size=p)],
                      axis=1).astype(np.int32)
    bounds[:8] = -1                         # padded pairs
    # ties: a periodic anchor (every shift by 32 repeats) and empty masks
    a_hi[8:16] = a_hi[8:16, :, :1]
    a_lo[8:16] = a_lo[8:16, :, :1]
    mask[16:24] = 0
    bounds[8:24] = [0, n_shifts - 1]
    return (a_hi, a_lo, r_hi, r_lo, mask, bounds), n_shifts, wa, wr


@pytest.mark.parametrize("seed,wr,n_shifts", [(0, 2, 64), (1, 3, 96),
                                              (2, 4, 160)])
def test_shd_best_matches_pallas_interpret(seed, wr, n_shifts):
    args, n_shifts, wa, wr = _shd_inputs(seed, wr=wr, n_shifts=n_shifts)
    want = np.asarray(shd_pallas.shd_best(
        *[jnp.asarray(a) for a in args], n_shifts, wa, wr, interpret=True))
    before = shd_best.launches
    got = shd_best(*[_t(a) for a in args], n_shifts, wa, wr)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        shd_best_plain(*[_t(a) for a in args], n_shifts, wa, wr).numpy(),
        want)
    assert shd_best.launches == before
    assert (want[:8, 0] == BIG).all()


@pytest.mark.parametrize("seed,wr,n_shifts", [(0, 2, 64), (1, 3, 96),
                                              (2, 4, 160), (3, 1, 33)])
def test_shd_hamming_matrix_matches_pallas_interpret(seed, wr, n_shifts):
    """Random full-range words (sign bits in use), every shift of every
    word offset (bit == 0 and shifts across word boundaries)."""
    (a_hi, a_lo, r_hi, r_lo, mask, _), n_shifts, wa, wr = _shd_inputs(
        seed, wr=wr, n_shifts=n_shifts)
    a_hi[:4] = -1                            # all-ones words, sign bit set
    a_lo[4:8] = np.int32(-2**31)
    args = (a_hi, a_lo, r_hi, r_lo, mask)
    want = np.asarray(shd_pallas.shd_hamming_matrix(
        *[jnp.asarray(a) for a in args], n_shifts, wa, wr, interpret=True))
    before = shd_hamming_matrix.launches
    got = shd_hamming_matrix(*[_t(a) for a in args], n_shifts, wa, wr)
    assert got.dtype == torch.int32 and got.shape == (128, 2, n_shifts)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(shd_hamming_matrix_plain(
        *[_t(a) for a in args], n_shifts, wa, wr).numpy(), want)
    assert shd_hamming_matrix.launches == before      # CPU: no launch
    # any P on the port's side
    np.testing.assert_array_equal(shd_hamming_matrix_plain(
        *[_t(a[:37]) for a in args], n_shifts, wa, wr).numpy(), want[:37])


@pytest.mark.parametrize("seed,wr,n_shifts", [(4, 2, 64), (5, 4, 160)])
def test_hamming_matrix_row_min_equals_shd_best(seed, wr, n_shifts):
    """The kernel that superseded it: the minimum of the matrix over
    [min_shift, max_shift], earliest shift on ties, is shd_best."""
    args, n_shifts, wa, wr = _shd_inputs(seed, wr=wr, n_shifts=n_shifts)
    args = [_t(a) for a in args]
    args[5] = args[5].clamp(max=n_shifts - 1)        # bounds inside S
    ham = shd_hamming_matrix(*args[:5], n_shifts, wa, wr).to(torch.int64)
    s = torch.arange(n_shifts)[None, None, :]
    lo, hi = args[5][:, 0, None, None], args[5][:, 1, None, None]
    ham = torch.where((s >= lo) & (s <= hi), ham, torch.full_like(ham, BIG))
    idx = ham.argmin(dim=2)                           # first occurrence
    best = torch.gather(ham, 2, idx[:, :, None])[:, :, 0]
    shift = torch.where(best < BIG, idx, args[5][:, :1].to(torch.int64))
    want = shd_best(*args, n_shifts, wa, wr)
    got = torch.stack([best[:, 0], shift[:, 0], best[:, 1], shift[:, 1]],
                      dim=1).to(torch.int32)
    assert torch.equal(got, want)
    assert (want[:, 0] < BIG).sum() > 64


def test_shd_hamming_matrix_rejects_a_short_anchor():
    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    with pytest.raises(ValueError, match="read past the anchor"):
        shd_hamming_matrix(z(4, 2, 3), z(4, 2, 3), z(4, 2, 2), z(4, 2, 2),
                           z(4, 2), 64, 3, 2)


@pytest.mark.parametrize("three_n,undirectional", [
    (True, False), (False, False), (True, True)],
    ids=["threeN", "parity", "undirectional"])
def test_extended_window_location_and_packed_planes(three_n, undirectional):
    rng = np.random.default_rng(11)
    ws, lr, p = 64, 40, 96
    genome = rng.integers(0, 4, size=3000, dtype=np.int8)
    chrom_len = np.full(p, 3000, np.int32)
    pos = rng.integers(0, 3000 - 10, size=p).astype(np.int32)
    pos[:3] = [0, 3, 2990]
    read_len = rng.integers(10, lr + 1, size=p).astype(np.int32)
    jl = jshd.extended_window_location(jnp.asarray(pos),
                                       jnp.asarray(chrom_len),
                                       jnp.asarray(read_len), ws)
    tl = shd.extended_window_location(_t(pos), _t(chrom_len), _t(read_len),
                                      ws)
    for g, w in zip(tl, jl):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    # reads planted at the window starts; C->T converted in 3N mode, G->A
    # (the PBAT strands) for the mirrored evaluation
    reads = np.zeros((p, lr), np.int8)
    for i in range(p):
        s = min(int(pos[i]), 3000 - lr)
        reads[i] = genome[s:s + lr]
    if undirectional:
        reads[(reads == 2) & (rng.random(reads.shape) < 0.9)] = 0
    elif three_n:
        reads[(reads == 1) & (rng.random(reads.shape) < 0.9)] = 3
    reads[::3] = 3 - reads[::3, ::-1]
    g_hi, g_lo = shd_pallas.pack_genome_planes(jnp.asarray(genome))
    params = jshd.ShdParams(ws, ws + lr, lr, 0.2)
    jplanes = jshd.pack_read_planes(jnp.asarray(reads), jnp.asarray(read_len),
                                    three_n, undirectional=undirectional)
    tplanes = shd.pack_read_planes(_t(reads), _t(read_len), three_n,
                                   undirectional)
    for g, w in zip(tplanes, jplanes):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    valid = np.arange(p) % 7 != 0
    want = jshd.shd_pairs_packed_planes(
        g_hi, g_lo, jl.start, jl.length, jl.left, *jplanes,
        jnp.asarray(read_len), jnp.asarray(valid), params, three_n=three_n,
        undirectional=undirectional)
    got = shd.shd_pairs_packed_planes(
        _t(g_hi), _t(g_lo), tl.start, tl.length, tl.left, *tplanes,
        _t(read_len), _t(valid),
        shd.ShdParams(ws, ws + lr, lr, 0.2), three_n=three_n,
        undirectional=undirectional)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (np.asarray(want.orientation) != jshd.NONE).sum() > p // 4


def _shd_pairs_jax(c, three_n, undirectional):
    """The JAX package's SHD stage on a torch_helpers.shd_pairs_case:
    pack_read_planes, the per-pair gathers, shd_pairs_packed_planes
    (Pallas shd_best in interpret mode on the CPU)."""
    width = c["reads"].shape[1]
    g_hi, g_lo = shd_pallas.pack_genome_planes(jnp.asarray(c["genome"]))
    planes = jshd.pack_read_planes(jnp.asarray(c["reads"]),
                                   jnp.asarray(c["read_len"]), three_n,
                                   undirectional=undirectional)
    ridx = jnp.asarray(c["ridx"].astype(np.int32))
    i32 = lambda k: jnp.asarray(c[k].astype(np.int32))
    return jshd.shd_pairs_packed_planes(
        g_hi, g_lo, i32("gstart"), i32("alen"), i32("aleft"),
        *[x[ridx] for x in planes], jnp.asarray(c["read_len"])[ridx],
        jnp.asarray(c["valid"]),
        jshd.ShdParams(c["ws"], c["ws"] + width, width, c["max_pct"]),
        three_n=three_n, undirectional=undirectional)


@pytest.mark.parametrize("mode", ["threeN", "parity", "undirectional"])
@pytest.mark.parametrize("shape", [
    dict(), dict(width=128, n_reads=64, p=256, ws=128, max_pct=0.05),
    dict(width=100, ws=96, p=97)], ids=["w40", "flagship", "w100"])
def test_shd_pairs_best_matches_jax(mode, shape):
    """shd_pairs_best on CPU tensors (its plain version, what the coarse
    mapper runs on the CPU) == the JAX SHD stage, exact, on
    torch_helpers.shd_pairs_case's edge cases."""
    c = shd_pairs_case(17, mode, **shape)
    three_n, und = mode != "parity", mode == "undirectional"
    want = _shd_pairs_jax(c, three_n, und)
    g_hi, g_lo = pack_genome_planes(_t(c["genome"]))
    width = c["reads"].shape[1]
    before = sk.shd_pairs_best.launches
    got = shd.shd_pairs_best(
        *[_t(c[k]) for k in ("reads", "read_len", "ridx")], g_hi, g_lo,
        *[_t(c[k]) for k in ("gstart", "alen", "aleft", "valid")],
        shd.ShdParams(c["ws"], c["ws"] + width, width, c["max_pct"]),
        three_n=three_n, undirectional=und)
    assert sk.shd_pairs_best.launches == before           # CPU: no launch
    for g, w, dtype in zip(got, want, (torch.int32, torch.int32, torch.int8)):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ori, ham = got.orientation.numpy(), got.hamming.numpy()
    rl = c["read_len"][c["ridx"]]
    too_long = rl > c["alen"]
    assert too_long.any() and (ori[too_long] == shd.NONE).all()
    assert (ham[too_long] == rl[too_long]).all()
    assert (ori[~c["valid"]] == shd.NONE).all()
    assert (ori != shd.NONE).sum() > len(ori) // 3
    # the A/T palindromes score the same in both orientations: forward
    pal = np.isin(c["ridx"], [3, 4]) & c["valid"] & (ham == 0)
    assert pal.any() and (ori[pal] == shd.FORWARD).all()


@pytest.mark.parametrize("undirectional", [False, True])
def test_coarse_step_runs_the_shd_stage_through_shd_pairs_best(
        monkeypatch, undirectional):
    """The coarse mapper evaluates its pairs with shd_pairs_best: once a
    batch, twice under --undirectional (the mirrored spaces)."""
    from hashreadmapper_tpu_torch.config import ProgramOptions
    from hashreadmapper_tpu_torch.io.genome import Genome
    from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper
    rng = np.random.default_rng(2)
    chrom = rng.integers(0, 4, size=20_000, dtype=np.int8)
    genome = Genome(["chrS"], [np.frombuffer(b"ACGT", np.uint8)[chrom]
                               .tobytes().decode()])
    starts = rng.integers(0, 20_000 - 80, size=64)
    reads = chrom[starts[:, None] + np.arange(80)[None, :]].copy()
    reads[(reads == 1) & (rng.random(reads.shape) < 0.9)] = 3
    opts = ProgramOptions(
        kmer_length=16, num_hash_functions=8, window_size=128,
        min_table_hits=2, batchsize=32, max_hamming_percent=0.2,
        probe_cap=16, candidates_per_read_cap=8, max_read_length=96,
        three_n_seeding=True, undirectional=undirectional,
        shd_pairs_per_read_budget=4)
    calls = []
    real = shd.shd_pairs_best

    def counting(*args, **kw):
        calls.append(kw["undirectional"])
        return real(*args, **kw)
    monkeypatch.setattr(shd, "shd_pairs_best", counting)
    res = CoarseMapper(genome, opts, "cpu").map_reads(
        reads, np.full(64, 80, np.int32))
    assert calls == ([False, True] * 2 if undirectional else [False] * 2)
    assert (res.orientation != shd.NONE).mean() > 0.8
