"""Port parity for the probe and the coarse pair stage (ops/probe_kernel.py,
ops/pairs_kernel.py): their plain versions, through the wrappers the
engine calls, against the JAX package on the CPU, exact.

The probe (index/minhash_index.py::probe_tables) against JAX's
probe_tables on a 6-table index with heavy keys: cuckoo and bucketed
lookups with a tail and a head budget both exceeded in one call,
max_values_per_key with the empty dropped-key table, the plain
searchsorted with dropped keys, and probe_cap <= 4 (no tiers).  The pair
stage (pipeline/engine.py::coarse_pairs_best: pair_select, SHD,
read_best) against JAX's coarse_pairs_best and _map_batch_impl's packing
on a 20 kbp genome of two chromosomes: compacted with pairs dropped,
under --undirectional, and without compaction; the per-candidate
orientations are what collect_candidates returns.  On CPU tensors no
kernel launches; on meta tensors the wrappers take the kernels' path and
raise ValueError for what the kernels do not take (tests/test_torch_cuda.py
holds the kernels against the plain versions on the card)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hashreadmapper_tpu.config import ProgramOptions as JaxOptions
from hashreadmapper_tpu.index import minhash_index as jmi
from hashreadmapper_tpu.io.genome import Genome as JaxGenome
from hashreadmapper_tpu.pipeline import engine as jengine
from hashreadmapper_tpu_torch.config import ProgramOptions
from hashreadmapper_tpu_torch.index import minhash_index as mi
from hashreadmapper_tpu_torch.io.genome import Genome
from hashreadmapper_tpu_torch.ops import pairs_kernel as pk
from hashreadmapper_tpu_torch.ops import probe_kernel as prk
from hashreadmapper_tpu_torch.pipeline import engine

from torch_helpers import ACGT, ensure_reference_native

SENT = 0xFFFFFFFF
F, N_ITEMS, N_QUERIES = 6, 3000, 256


def _t(a):
    return torch.from_numpy(np.array(a).astype(np.int64))


@pytest.fixture(scope="module")
def indexes():
    """The same CSR index, buckets and cuckoo table in both packages: item
    signatures with keys of up to 12 values, 5% of items invalid."""
    rng = np.random.default_rng(0)
    sigs = rng.integers(0, 2**32 - 1, size=(N_ITEMS, F), dtype=np.uint32)
    for t in range(F):
        for h in range(30):
            rows = rng.choice(N_ITEMS, size=rng.integers(2, 13),
                              replace=False)
            sigs[rows, t] = np.uint32(5000 + 7 * h)
    valid = rng.random(N_ITEMS) > 0.05
    jidx = jmi.build_csr_index_device(jnp.asarray(sigs), jnp.asarray(valid),
                                      16, np.arange(F))
    jidx.build_buckets()
    tidx = mi.build_csr_index_device(_t(sigs), torch.from_numpy(valid), 16,
                                     np.arange(F))
    tidx.build_buckets()
    assert tidx.values.is_contiguous()       # the kernels' table layout
    ensure_reference_native()
    assert jidx.build_cuckoo() and tidx.build_cuckoo()
    q = sigs[rng.integers(0, N_ITEMS, size=N_QUERIES)].copy()
    miss = rng.random(q.shape) < 0.3
    q[miss] = rng.integers(0, 2**32 - 1, size=int(miss.sum()),
                           dtype=np.uint32)
    q[:4, 0] = SENT
    q[4:40] = np.uint32(5000)                       # heavy keys, all tables
    q_valid = rng.random(N_QUERIES) > 0.05
    return sigs, jidx, tidx, q, q_valid


# (lookup, probe_cap, tail_budget, head_budget, dropped keys,
#  max_values_per_key)
PROBE_CASES = {
    "cuckoo, both budgets exceeded": ("cuckoo", 8, 6, 40, "some", 0),
    "bucketed, both budgets exceeded": ("bucketed", 8, 6, 40, "some", 0),
    "bucketed, max_values_per_key, empty drops": ("bucketed", 6, 64, 700,
                                                  "empty", 10),
    "searchsorted, dropped keys, no budgets": ("searchsorted", 8, 0, 0,
                                               "some", 0),
    "cuckoo, probe_cap 4 (no tiers)": ("cuckoo", 4, 6, 40, "empty", 0),
}


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_probe_tables_matches_jax(indexes, case):
    lookup, cap, tail, head, drops, mvpk = PROBE_CASES[case]
    sigs, jidx, tidx, q, q_valid = indexes
    if drops == "empty":       # CoarseMapper.ensure_empty_drops' table
        dk = np.full((F, 1), SENT, np.uint32)
        dn = np.zeros(F, np.int32)
    else:
        dk, dn = jmi.build_dropped_keys(sigs[:200], np.ones(200, bool), 1)
    jkw = dict(dropped_keys=(jnp.asarray(dk), jnp.asarray(dn)),
               max_values_per_key=mvpk)
    tkw = dict(dropped_keys=(_t(dk), _t(dn)), max_values_per_key=mvpk)
    if lookup == "cuckoo":
        jkw.update(cuckoo=(jidx.cuckoo_keys, jidx.cuckoo_payload),
                   cuckoo_bits=jidx.cuckoo_bits,
                   cuckoo_seeds=jidx.cuckoo_seeds)
        tkw.update(cuckoo=(tidx.cuckoo_keys, tidx.cuckoo_payload),
                   cuckoo_bits=tidx.cuckoo_bits,
                   cuckoo_seeds=tidx.cuckoo_seeds)
    if lookup == "bucketed":
        jkw.update(bucket_start=jidx.bucket_start,
                   probe_steps=jidx.probe_steps)
        tkw.update(bucket_start=tidx.bucket_start,
                   probe_steps=tidx.probe_steps)
    want = jmi.probe_tables(jidx.keys, jidx.offsets, jidx.values,
                            jidx.num_keys, jnp.asarray(q),
                            jnp.asarray(q_valid), cap, fnc_layout=True,
                            tail_budget=tail, head_budget=head, **jkw)
    if tail == 0:
        want = tuple(want) + (0, 0)
    got = mi.probe_tables(tidx.keys, tidx.offsets, tidx.values,
                          tidx.num_keys, _t(q), torch.from_numpy(q_valid),
                          cap, tail_budget=tail, head_budget=head, **tkw)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w).astype(
            np.int64), err_msg=f"output {i}")
    counts = np.asarray(want[1]).astype(np.int64)
    if "exceeded" in case:
        assert int(want[2]) > 0 and int(want[3]) > 0
    # the stats vector read_best sums, and the tallies the kernel's gather
    # ranks from (per block of THREADS probes in flat order)
    _, _, stats = mi.probe_tables_stats(
        tidx.keys, tidx.offsets, tidx.values, tidx.num_keys, _t(q),
        torch.from_numpy(q_valid), cap, tail_budget=tail, head_budget=head,
        **tkw)
    assert stats.tolist() == [int((counts > cap).sum()), int(want[2]),
                              int(want[3])]
    assert stats[0] > 0
    c1 = 4 if tail > 0 and cap > 4 else cap
    flat = np.concatenate([counts.reshape(-1),
                           np.zeros((-counts.size) % prk.THREADS, np.int64)])
    blocks = flat.reshape(-1, prk.THREADS)
    np.testing.assert_array_equal(
        prk.tallies_of(torch.from_numpy(counts), c1, cap).numpy(),
        np.stack([(blocks > t).sum(1) for t in (0, c1, cap)]))


G_LENS, WS, K_MER, B, KCAP, READ_LEN = (12_000, 8_000), 64, 12, 48, 8, 56
# (mode, shd_pairs_per_read_budget)
PAIR_CASES = {"threeN, pairs dropped": ("threeN", 2),
              "undirectional, pairs dropped": ("undirectional", 3),
              "parity, no compaction": ("parity", 0)}


def _pair_case(mode, budget):
    """Both packages' window tables of a two-chromosome genome, reads
    planted in it (converted C->T, or G->A for every other read under
    --undirectional; half reverse-complemented) and voted ids [B, K]: each
    read's own window among random ones, ascending, SENTINEL-padded to a
    random length (a few rows empty)."""
    rng = np.random.default_rng(
        {"threeN": 41, "undirectional": 42, "parity": 43}[mode])
    seqs = [rng.integers(0, 4, size=n, dtype=np.int8) for n in G_LENS]
    cfg = dict(kmer_length=K_MER, num_hash_functions=4, window_size=WS,
               max_read_length=64, max_hamming_percent=0.1,
               candidates_per_read_cap=KCAP,
               shd_pairs_per_read_budget=budget,
               three_n_seeding=mode != "parity",
               undirectional=mode == "undirectional")
    opts, jopts = ProgramOptions(**cfg), JaxOptions(**cfg)
    names = ["c1 x", "c2 y"]
    text = ["".join(ACGT[s]) for s in seqs]
    stride = opts.window_stride
    n_win = [(n - K_MER) // stride + 1 for n in G_LENS]
    win_pos = np.concatenate([np.arange(w) * stride for w in n_win])
    win_chrom = np.concatenate([np.full(w, c) for c, w in enumerate(n_win)])
    chrom = rng.integers(0, 2, size=B)
    start = np.array([rng.integers(0, G_LENS[c] - READ_LEN) for c in chrom])
    lens = np.full(B, READ_LEN, np.int32)
    lens[::5] = rng.integers(20, READ_LEN, size=len(lens[::5]))
    reads = np.zeros((B, 64), np.int8)
    own = np.zeros(B, np.int64)
    for i in range(B):
        r = seqs[chrom[i]][start[i]:start[i] + lens[i]].copy()
        ga = mode == "undirectional" and i % 2 == 1
        if mode != "parity":
            conv = rng.random(len(r)) < 0.9
            r[(r == (2 if ga else 1)) & conv] = 0 if ga else 3
        if i % 4 >= 2:
            r = 3 - r[::-1]
        reads[i, :lens[i]] = r
        # the window whose extension (read_len // 2 a side) holds the read
        own[i] = (sum(n_win[:chrom[i]])
                  + min(int(round(start[i] / stride)), n_win[chrom[i]] - 1))
    ids = np.full((B, KCAP), SENT, np.int64)
    for i in range(B):
        n = int(rng.integers(0, KCAP + 1)) if i % 7 else KCAP
        pick = rng.choice(len(win_pos), size=n, replace=False)
        if n and i % 6:
            pick[0] = own[i]
        ids[i, :n] = np.sort(np.unique(pick))[:n] if n else []
    ids[np.arange(B) % 11 == 10] = SENT
    jt = jengine.build_window_table(JaxGenome(names, text))
    tt = engine.build_window_table(Genome(names, text), "cpu")
    return dict(opts=opts, jopts=jopts, jt=jt, tt=tt, reads=reads, lens=lens,
                ids=ids, win_pos=win_pos, win_chrom=win_chrom)


@pytest.mark.parametrize("case", sorted(PAIR_CASES))
def test_coarse_pairs_best_and_packing_match_jax(case):
    mode, budget = PAIR_CASES[case]
    c = _pair_case(mode, budget)
    jt, tt = c["jt"], c["tt"]
    want = jengine.coarse_pairs_best(
        jnp.asarray(c["ids"].astype(np.uint32)), jnp.asarray(c["reads"]),
        jnp.asarray(c["lens"]), c["jopts"], c["reads"].shape[1],
        jt.genome_hi, jt.genome_lo, jnp.asarray(c["win_pos"], jnp.int32),
        jnp.asarray(c["win_chrom"], jnp.int32), jt.chrom_offset,
        jt.chrom_len)
    (j_ori, j_ham, j_shift, j_chrom, j_pos, j_gwin, j_has, j_ori_k,
     j_strand, j_drops) = [np.asarray(x) for x in want]
    # _map_batch_impl's packing
    j_packed = np.stack([j_ori, j_ham, j_shift, j_chrom, j_pos,
                         np.where(j_has, j_gwin, -1), j_strand], axis=1)
    stats = torch.tensor([[3, 1, 0], [2, 0, 5]])
    num_kept = torch.from_numpy(
        np.random.default_rng(7).integers(0, 2 * KCAP, size=B)
        .astype(np.int32))
    packed, ori, overflow = engine.coarse_pairs_best(
        _t(c["ids"]), torch.from_numpy(c["reads"]),
        torch.from_numpy(c["lens"]), c["opts"], tt.genome_hi, tt.genome_lo,
        _t(c["win_pos"]), _t(c["win_chrom"]), tt.chrom_offset, tt.chrom_len,
        stats, num_kept)
    assert packed.dtype == torch.int32 and ori.dtype == torch.int8
    np.testing.assert_array_equal(packed.numpy(), j_packed)
    np.testing.assert_array_equal(ori.numpy(), j_ori_k.astype(np.int8))
    assert overflow.tolist() == [5, int((num_kept > KCAP).sum()),
                                 int(j_drops), 1, 5]
    assert (j_ori != 3).mean() > 0.1           # reads mapped on both sides
    if budget:
        assert int(j_drops) > 0
    if mode == "undirectional":
        assert (j_strand[j_has] == 1).any() and (j_strand[j_has] == 0).any()


def test_pair_select_slots_past_the_valid_pairs_take_pair_zero():
    """With fewer valid pairs than slots, the extra slots hold pair 0 (the
    plain compaction's zero fill), invalid; without compaction every pair
    has its own slot."""
    c = _pair_case("threeN", 4)
    ids = torch.full((B, KCAP), SENT, dtype=torch.int64)
    ids[0, :3] = torch.tensor([5, 9, 30])
    ids[2, 0] = 17
    args = (torch.from_numpy(c["lens"]), _t(c["win_pos"]),
            _t(c["win_chrom"]), c["tt"].chrom_offset, c["tt"].chrom_len, WS)
    sel, ridx, gstart, length, left, valid, drops = pk.pair_select(
        ids, *args, 4)
    assert sel.shape == (B * 4,) and int(drops) == 0
    assert sel[:4].tolist() == [0, 1, 2, 2 * KCAP]
    assert valid.tolist() == [True] * 4 + [False] * (B * 4 - 4)
    assert (sel[4:] == 0).all() and (ridx[4:] == 0).all()
    assert (gstart[4:] == gstart[0]).all()
    sel, _, _, _, _, valid, drops = pk.pair_select(ids, *args, KCAP)
    assert torch.equal(sel, torch.arange(B * KCAP))
    assert torch.equal(valid, ids.reshape(-1) != SENT) and int(drops) == 0


def _meta(*shape, dtype=torch.int64):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_wrappers_raise_for_what_the_kernels_do_not_take():
    """Tensors off the CPU take the kernels' path: a bad shape or rank
    raises ValueError with the reason before any launch, and so does a
    tensor that is not on a CUDA card (no fallback to the plain
    version)."""
    f, n, u, v = 4, 10, 32, 50
    lookup = dict(sigs=_meta(n, f), sig_valid=_meta(n, dtype=torch.bool),
                  index_keys=_meta(f, u), index_offsets=_meta(f, u + 1),
                  index_num_keys=_meta(f), probe_cap=8, c1=4)
    bad = {"sigs": _meta(n * f), "sig_valid": _meta(n + 1, dtype=torch.bool),
           "index_offsets": _meta(f, u), "index_num_keys": _meta(f + 1)}
    for name, t in bad.items():
        with pytest.raises(ValueError, match="probe_lookup"):
            prk.probe_lookup(**dict(lookup, **{name: t}))
    with pytest.raises(ValueError, match="bucket_start"):
        prk.probe_lookup(**lookup, bucket_start=_meta(f, 100))
    with pytest.raises(ValueError, match="c1"):
        prk.probe_lookup(**dict(lookup, c1=9))
    with pytest.raises(ValueError, match="one wide"):
        prk.probe_lookup(**lookup, dropped_keys=(_meta(f, 0), _meta(f)))
    with pytest.raises(ValueError, match="CUDA device"):
        prk.probe_lookup(**lookup)
    gather = dict(counts=_meta(f, n), off0=_meta(f, n),
                  tallies=_meta(3, 1, dtype=torch.int32),
                  index_values=_meta(f, v), probe_cap=8, c1=4,
                  tail_budget=4, head_budget=0)
    for name, t in {"counts": _meta(f * n), "off0": _meta(f, n + 1),
                    "tallies": _meta(3, 2, dtype=torch.int32),
                    "index_values": _meta(f + 1, v)}.items():
        with pytest.raises(ValueError, match="probe_gather"):
            prk.probe_gather(**dict(gather, **{name: t}))
    with pytest.raises(ValueError, match="contiguous int64 table"):
        prk.probe_gather(**dict(gather, index_values=_meta(v, f).T))
    with pytest.raises(ValueError, match="contiguous int64 table"):
        prk.probe_lookup(**dict(lookup, index_keys=_meta(f, u,
                                                         dtype=torch.int32)))
    with pytest.raises(ValueError, match="CUDA device"):
        prk.probe_gather(**gather)

    b, k, w, p = 6, 4, 20, 12
    select = dict(ids=_meta(b, k), read_len=_meta(b, dtype=torch.int32),
                  win_pos=_meta(w), win_chrom=_meta(w), chrom_offset=_meta(2),
                  chrom_len=_meta(2), window_size=64, per_row_budget=2)
    for name, t in {"ids": _meta(b * k), "read_len": _meta(b + 1),
                    "win_chrom": _meta(w + 1), "chrom_len": _meta(3)}.items():
        with pytest.raises(ValueError, match="pair_select"):
            pk.pair_select(**dict(select, **{name: t}))
    with pytest.raises(ValueError, match="CUDA device"):
        pk.pair_select(**select)
    shd3 = (_meta(p, dtype=torch.int32), _meta(p, dtype=torch.int32),
            _meta(p, dtype=torch.int8))
    best = dict(res=shd3, res_u=None, pair_sel=_meta(p),
                sel_valid=_meta(p, dtype=torch.bool), ids=_meta(b, k),
                win_pos=_meta(w), win_chrom=_meta(w),
                probe_stats=_meta(2, 3), num_kept=_meta(b, dtype=torch.int32),
                pair_drops=_meta())
    for name, t in {"ids": _meta(b, k, 1), "res": shd3[:2] + (_meta(p + 1),),
                    "res_u": (_meta(p - 1),) * 3, "sel_valid": _meta(p + 1),
                    "probe_stats": _meta(2, 4), "num_kept": _meta(b - 1),
                    "win_chrom": _meta(w - 1)}.items():
        with pytest.raises(ValueError, match="read_best"):
            pk.read_best(**dict(best, **{name: t}))
    with pytest.raises(ValueError, match="CUDA device"):
        pk.read_best(**best)
