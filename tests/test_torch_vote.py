"""Port parity: the candidate vote (plain PyTorch on the CPU) against the
JAX package's Pallas kernel in interpret mode and its XLA vote, exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hashreadmapper_tpu.index import minhash_index as jmi
from hashreadmapper_tpu.ops import vote_pallas
from hashreadmapper_tpu_torch.index import minhash_index as mi
from hashreadmapper_tpu_torch.ops import vote_kernel as vk
from hashreadmapper_tpu_torch.ops.vote_kernel import (
    vote_candidates_fnc, vote_candidates_fnc_plain)

SENT = np.uint32(0xFFFFFFFF)


def _cand(seed, f, n, c, id_range=24, empty_rows=4):
    """[F, N, C] ascending SENTINEL-padded lists from a small id range so
    that ids repeat across tables; the first rows are empty."""
    rng = np.random.default_rng(seed)
    cand = np.full((f, n, c), SENT, dtype=np.uint32)
    for t in range(f):
        for r in range(empty_rows, n):
            m = rng.integers(0, c + 1)
            ids = np.sort(rng.choice(id_range, size=min(m, id_range),
                                     replace=False))
            cand[t, r, :len(ids)] = ids
    return cand


def _check(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(
            g.numpy().dtype))


@pytest.mark.parametrize("f,c,min_hits,cap", [
    (4, 8, 1, 4),      # num_kept > cap for most rows
    (5, 4, 4, 8),      # F not a power of two
    (8, 16, 4, 8),
    (3, 2, 2, 3),
])
def test_vote_matches_pallas_interpret(f, c, min_hits, cap):
    cand = _cand(f * 100 + c, f, 128, c)
    want = vote_pallas.vote_candidates_fnc(jnp.asarray(cand), min_hits, cap,
                                           interpret=True)
    got = vote_candidates_fnc_plain(torch.from_numpy(cand.astype(np.int64)),
                                    min_hits, cap)
    _check(got, want)
    assert int(want[2][0]) == 0                      # empty rows
    if min_hits == 1:
        assert (np.asarray(want[2]) > cap).any()     # overflow exercised


@pytest.mark.parametrize("c", [3, 6])
def test_vote_any_c_matches_xla_vote(c):
    """C not a power of two: the JAX XLA vote sorts; so does the port."""
    cand = _cand(c, 6, 40, c)
    want = jmi.vote_candidates(jnp.asarray(cand.transpose(1, 0, 2)), 2, 5)
    got = mi.vote_candidates(
        torch.from_numpy(cand.transpose(1, 0, 2).astype(np.int64)), 2, 5)
    _check(got, want)


def test_vote_wrapper_on_cpu_is_plain():
    cand = torch.from_numpy(_cand(9, 4, 16, 4).astype(np.int64))
    before = vote_candidates_fnc.launches
    got = mi.vote_candidates_fnc_auto(cand, 2, 4)
    _check(got, vote_candidates_fnc_plain(cand, 2, 4))
    assert vote_candidates_fnc.launches == before


@pytest.mark.parametrize("f,c", [(32, 128), (64, 128), (16, 16)])
def test_vote_tally_counts_ids_and_tiled_reads(f, c):
    """The plain vote adds to a tally what the wide kernel adds: every
    read's non-SENTINEL ids, and the reads it sorts in tiles (more than
    TILE ids left); nothing where F*C pads to WARP_MERGE or less (the warp
    kernel's).  Reads of ids seen 4 times each keep them all through the
    sift at min_table_hits 4; a read of distinct ids keeps them only at 1."""
    rng = np.random.default_rng(f + c)
    m = f * c
    fourfold = [0, 4, vk.TILE, vk.TILE + 4, m, 36]
    rows = []
    for k in fourfold:
        k = min(k, m) // 4 * 4
        rows.append(np.repeat(rng.integers(0, 2**32 - 1, size=k // 4), 4))
    distinct = rng.choice(2**32 - 1, size=min(vk.TILE + 1, m),
                          replace=False)
    rows.append(distinct)
    cand = np.full((len(rows), m), SENT, np.uint32)
    for r, ids in enumerate(rows):
        cand[r, rng.choice(m, size=len(ids), replace=False)] = ids
    cand = torch.from_numpy(cand.reshape(len(rows), f, c).transpose(
        1, 0, 2).astype(np.int64))
    wide = vk._m_pad(m) > vk.WARP_MERGE
    ks = [len(ids) for ids in rows]
    for hits, tiled in ((1, sum(k > vk.TILE for k in ks)),
                        (4, sum(len(ids) > vk.TILE for ids in rows[:-1]))):
        tally = torch.zeros(1, dtype=torch.int64)
        want = vote_candidates_fnc_plain(cand, hits, 4)
        for _ in range(2):             # a tally adds up over calls
            _check(vote_candidates_fnc_plain(cand, hits, 4, tally), want)
        assert vk.tally_counts(tally) == ((2 * sum(ks), 2 * tiled) if wide
                                          else (0, 0))


def _variant(kind, f, c, n=128):
    """[F, N, C] u32 lists of one kind, with (min_table_hits, out_cap)."""
    rng = np.random.default_rng(f * 131 + c)
    if kind == "equal":                     # one id in every slot
        return np.full((f, n, c), 77, np.uint32), 1, 4
    if kind == "distinct":                  # num_kept = F*C > out_cap
        ids = rng.permutation(f * c * 3)[:f * c].astype(np.uint32) + 2**31
        cand = np.broadcast_to(ids.reshape(f, 1, c), (f, n, c)).copy()
        return np.sort(cand, axis=2), 1, 8
    cand = _cand(f * 7 + c, f, n, c, id_range=max(c + 1, f * c // 5))
    if kind == "unsorted":
        cand = rng.permuted(cand, axis=2)   # SENTINELs anywhere in a list
    return cand, 2, (0 if kind == "out_cap 0" else 8)


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "equal", "distinct",
                                  "out_cap 0"])
@pytest.mark.parametrize("f,c", [(1, 1), (2, 16), (32, 16), (64, 16),
                                 (32, 64), (64, 64)])
def test_vote_plain_matches_jax_at_every_merge_width(f, c, kind):
    """F*C = 1, 32, 512, 1,024 (the 64 lists of --undirectional), 2,048 and
    4,096: the widths on either side of the CUDA kernel's register and
    shared-memory paths.  Sorted lists go against the Pallas kernel in
    interpret mode (C is a power of two), the others against the XLA
    vote.  Both merge ascending lists at these C, so the JAX side is
    given each list sorted: the vote depends on the ids of a read, not on
    their order, and the port sorts whatever it is given."""
    cand, min_hits, cap = _variant(kind, f, c)
    in_order = np.sort(cand, axis=2)
    if kind == "sorted":
        assert np.array_equal(cand, in_order)
        want = vote_pallas.vote_candidates_fnc(jnp.asarray(cand), min_hits,
                                               cap, interpret=True)
    else:
        if kind == "unsorted" and c > 1:
            assert not np.array_equal(cand, in_order)
        want = jmi.vote_candidates(jnp.asarray(in_order.transpose(1, 0, 2)),
                                   min_hits, cap)
    got = vote_candidates_fnc_plain(torch.from_numpy(cand.astype(np.int64)),
                                    min_hits, cap)
    _check(got, want)
    assert got[0].shape == (128, cap) and got[1].shape == (128, cap)
    if kind == "equal":
        assert (got[2].numpy() == 1).all() and (got[1][:, 0] == f * c).all()
    if kind == "distinct":
        assert (got[2].numpy() == f * c).all()
