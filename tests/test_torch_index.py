"""Port parity: CSR build, probe directories, cuckoo table, probe and
.npz artifact (plain PyTorch on the CPU) against the JAX package, exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hashreadmapper_tpu.index import minhash_index as jmi
from hashreadmapper_tpu_torch.index import minhash_index as mi

from torch_helpers import ensure_reference_native

SENT = np.uint32(0xFFFFFFFF)
F, N_ITEMS = 6, 3000


def _t(a):
    return torch.from_numpy(np.array(a).astype(np.int64))


def _sigs(seed):
    """[N, F] item signatures with heavy keys (up to 12 values) and a few
    invalid items."""
    rng = np.random.default_rng(seed)
    sigs = rng.integers(0, 2**32 - 1, size=(N_ITEMS, F), dtype=np.uint32)
    for t in range(F):
        for h in range(30):
            rows = rng.choice(N_ITEMS, size=rng.integers(2, 13),
                              replace=False)
            sigs[rows, t] = np.uint32(5000 + 7 * h)
    valid = rng.random(N_ITEMS) > 0.05
    return sigs, valid


@pytest.fixture(scope="module")
def indexes():
    sigs, valid = _sigs(0)
    jidx = jmi.build_csr_index_device(jnp.asarray(sigs), jnp.asarray(valid),
                                      16, np.arange(F))
    jidx.build_buckets()
    tidx = mi.build_csr_index_device(_t(sigs), torch.from_numpy(valid), 16,
                                     np.arange(F))
    tidx.build_buckets()
    ensure_reference_native()        # the JAX side's cuckoo table build
    assert jidx.build_cuckoo() and tidx.build_cuckoo()
    return sigs, valid, jidx, tidx


def _queries(sigs, seed, n=256):
    rng = np.random.default_rng(seed)
    q = sigs[rng.integers(0, N_ITEMS, size=n)].copy()       # hits
    miss = rng.random(q.shape) < 0.4
    q[miss] = rng.integers(0, 2**32 - 1, size=int(miss.sum()),
                           dtype=np.uint32)
    q[:4, 0] = SENT
    q[4:12] = np.uint32(5000)                                 # heavy keys
    q_valid = rng.random(n) > 0.05
    return q, q_valid


def test_csr_buckets_and_cuckoo_arrays_match(indexes):
    _, _, jidx, tidx = indexes
    for name in ("keys", "offsets", "values", "num_keys", "bucket_start",
                 "cuckoo_keys", "cuckoo_payload"):
        np.testing.assert_array_equal(
            getattr(tidx, name).numpy(),
            np.asarray(getattr(jidx, name)).astype(np.int64), err_msg=name)
    assert (tidx.bucket_bits, tidx.probe_steps, tidx.cuckoo_bits,
            tidx.cuckoo_seeds) == (jidx.bucket_bits, jidx.probe_steps,
                                   jidx.cuckoo_bits, jidx.cuckoo_seeds)


@pytest.mark.parametrize("cuckoo", [False, True])
@pytest.mark.parametrize("tail,head", [(0, 0), (64, 0), (6, 0), (64, 700),
                                       (64, 40)])
def test_probe_tables_matches_jax(indexes, cuckoo, tail, head):
    sigs, _, jidx, tidx = indexes
    q, q_valid = _queries(sigs, 1)
    dk, dn = jmi.build_dropped_keys(sigs[:200], np.ones(200, bool), 1)
    jkw = dict(bucket_start=jidx.bucket_start, probe_steps=jidx.probe_steps,
               dropped_keys=(jnp.asarray(dk), jnp.asarray(dn)))
    tkw = dict(bucket_start=tidx.bucket_start, probe_steps=tidx.probe_steps,
               dropped_keys=(_t(dk), _t(dn)))
    if cuckoo:
        jkw.update(cuckoo=(jidx.cuckoo_keys, jidx.cuckoo_payload),
                   cuckoo_bits=jidx.cuckoo_bits,
                   cuckoo_seeds=jidx.cuckoo_seeds)
        tkw.update(cuckoo=(tidx.cuckoo_keys, tidx.cuckoo_payload),
                   cuckoo_bits=tidx.cuckoo_bits,
                   cuckoo_seeds=tidx.cuckoo_seeds)
    want = jmi.probe_tables(jidx.keys, jidx.offsets, jidx.values,
                            jidx.num_keys, jnp.asarray(q),
                            jnp.asarray(q_valid), 12, fnc_layout=True,
                            tail_budget=tail, head_budget=head, **jkw)
    got = mi.probe_tables(tidx.keys, tidx.offsets, tidx.values,
                          tidx.num_keys, _t(q), torch.from_numpy(q_valid),
                          12, tail_budget=tail, head_budget=head, **tkw)
    if tail == 0:
        want = tuple(want) + (0, 0)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w).astype(
            np.int64), err_msg=f"output {i}")
    if tail == 6:
        assert int(want[2]) > 0                     # tail drops counted
    if head == 40:
        assert int(want[3]) > 0                     # head drops counted


def test_plain_searchsorted_probe_matches_jax(indexes):
    sigs, _, jidx, tidx = indexes
    q, q_valid = _queries(sigs, 2)
    want = jmi.probe_tables(jidx.keys, jidx.offsets, jidx.values,
                            jidx.num_keys, jnp.asarray(q),
                            jnp.asarray(q_valid), 8, fnc_layout=True)
    got = mi.probe_tables(tidx.keys, tidx.offsets, tidx.values,
                          tidx.num_keys, _t(q), torch.from_numpy(q_valid), 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g),
                                      np.asarray(w).astype(np.int64))


def test_jax_saved_index_loads_and_probes_identically(indexes, tmp_path):
    sigs, _, jidx, _ = indexes
    path = str(tmp_path / "idx.npz")
    jidx.save(path)
    loaded = mi.CsrIndex.load(path, "cpu")
    loaded.build_buckets()
    q, q_valid = _queries(sigs, 3)
    want = jmi.probe_tables(jidx.keys, jidx.offsets, jidx.values,
                            jidx.num_keys, jnp.asarray(q),
                            jnp.asarray(q_valid), 12, fnc_layout=True,
                            bucket_start=jidx.bucket_start,
                            probe_steps=jidx.probe_steps)
    got = mi.probe_tables(loaded.keys, loaded.offsets, loaded.values,
                          loaded.num_keys, _t(q), torch.from_numpy(q_valid),
                          12, bucket_start=loaded.bucket_start,
                          probe_steps=loaded.probe_steps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g),
                                      np.asarray(w).astype(np.int64))
    # and the port's artifact loads back into the JAX package unchanged
    path2 = str(tmp_path / "idx2.npz")
    loaded.save(path2)
    back = jmi.CsrIndex.load(path2)
    for name in ("keys", "offsets", "values", "num_keys"):
        a, b = np.asarray(getattr(back, name)), np.asarray(getattr(jidx, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("three_n", [True, False], ids=["3n", "parity"])
def test_window_signatures_match_the_jax_engine(three_n):
    """The index build's signatures (the port's engine on the CPU: the
    plain composition in sig_batch chunks, written into one output)
    against what the JAX engine's _build_window_index computes from its
    own window superbatches, on a small genome; tail windows shorter than
    k included."""
    from hashreadmapper_tpu.config import ProgramOptions as JaxOptions
    from hashreadmapper_tpu.io.genome import Genome as JaxGenome
    from hashreadmapper_tpu.ops import minhash as jminhash
    from hashreadmapper_tpu.pipeline.engine import CoarseMapper as JaxMapper
    from hashreadmapper_tpu_torch.config import ProgramOptions
    from hashreadmapper_tpu_torch.io.genome import Genome
    from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper

    rng = np.random.default_rng(31)
    seqs = ["".join(rng.choice(list("ACGT"), size=n)) for n in (3000, 1217)]
    cfg = dict(kmer_length=16, num_hash_functions=4, window_size=64,
               min_table_hits=1, batchsize=64, max_read_length=64,
               three_n_seeding=three_n)
    ensure_reference_native()
    jm = JaxMapper(JaxGenome(["c1", "c2"], seqs), JaxOptions(**cfg),
                   sig_batch=32)
    tm = CoarseMapper(Genome(["c1", "c2"], seqs), ProgramOptions(**cfg),
                      "cpu", sig_batch=32)
    hid = jnp.asarray(jm.hash_ids)
    want_s, want_v = [], []
    for bases, lens, n in jm.iter_window_superbatches(32):
        jb, jl = jnp.asarray(bases), jnp.asarray(lens)
        if three_n:
            s_ct, v = jminhash.minhash_signatures_chunked(
                jnp.where(jb == 1, jnp.int8(3), jb), jl, 16, hid, 32,
                canonical=False)
            s_ga, _ = jminhash.minhash_signatures_chunked(
                jnp.where(jb == 2, jnp.int8(0), jb), jl, 16, hid, 32,
                canonical=False)
            s = jnp.concatenate([s_ct, s_ga], axis=1)
        else:
            s, v = jminhash.minhash_signatures_chunked(jb, jl, 16, hid, 32)
        want_s.append(np.asarray(s)[:n])
        want_v.append(np.asarray(v)[:n])
    got_s, got_v = tm.window_signatures(sig_batch=32)
    np.testing.assert_array_equal(got_s.numpy(),
                                  np.concatenate(want_s).astype(np.int64))
    np.testing.assert_array_equal(got_v.numpy(), np.concatenate(want_v))
    assert not got_v.all() and got_v.any()      # short tail windows
    # the same signatures in one chunk
    one_s, one_v = tm.window_signatures(sig_batch=4096)
    assert torch.equal(one_s, got_s) and torch.equal(one_v, got_v)
