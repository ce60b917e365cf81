"""Port parity: murmur64, encode and minhash signatures (PyTorch plain
versions on the CPU) against the JAX package, exact equality."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hashreadmapper_tpu.ops import encode as jencode
from hashreadmapper_tpu.ops import minhash as jminhash
from hashreadmapper_tpu.ops import minhash_pallas
from hashreadmapper_tpu.ops import u64 as ju64
from hashreadmapper_tpu_torch.ops import encode, minhash, u64
from hashreadmapper_tpu_torch.ops.minhash_kernel import (
    sig_min_murmur, sig_min_murmur_plain, signature_stage,
    signature_stage_plain, sigs_from_bases, sigs_from_bases_plain)


def _reads(seed, n=128, maxlen=40, k=16):
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=(n, maxlen), dtype=np.int8)
    # lengths below k, exactly k, full, and past the padded width (clamped)
    lengths = rng.integers(0, maxlen + 1, size=n).astype(np.int32)
    lengths[:4] = [0, k - 1, k, maxlen + 7]
    return bases, lengths


def test_murmur64_edge_values():
    vals = [0, 1, 2**32 - 1, 2**32, 2**33 + 5, 2**63, 2**63 - 1, 2**64 - 1,
            0xDEADBEEFCAFEBABE, 0x00000001FFFFFFFF]
    rng = np.random.default_rng(0)
    vals += [int(v) for v in rng.integers(0, 2**63, size=64,
                                          dtype=np.int64)]
    vals += [v | (1 << 63) for v in vals[-8:]]
    hi = torch.tensor([v >> 32 for v in vals], dtype=torch.int64)
    lo = torch.tensor([v & 0xFFFFFFFF for v in vals], dtype=torch.int64)
    h_hi, h_lo = u64.murmur64(hi, lo)
    got = [(int(a) << 32) | int(b) for a, b in zip(h_hi, h_lo)]
    assert got == [ju64.murmur64_py(v) for v in vals]


def test_encode_matches_jax():
    bases, lengths = _reads(1)
    tb, tl = torch.from_numpy(bases), torch.from_numpy(lengths)
    np.testing.assert_array_equal(
        encode.revcomp_bases(tb, tl).numpy(),
        np.asarray(jencode.revcomp_bases(jnp.asarray(bases),
                                         jnp.asarray(lengths))))
    np.testing.assert_array_equal(
        encode.three_n_c_to_t(tb).numpy(),
        np.asarray(jencode.three_n_c_to_t(jnp.asarray(bases))))
    np.testing.assert_array_equal(
        encode.three_n_g_to_a(tb).numpy(),
        np.asarray(jencode.three_n_g_to_a(jnp.asarray(bases))))


@pytest.mark.parametrize("k,mode", [(8, "fwd"), (12, "both"), (16, "canon"),
                                    (16, "both"), (12, "fwd")])
def test_sigs_from_bases_matches_pallas_interpret(k, mode):
    bases, lengths = _reads(k, k=k)
    hash_ids = np.array([0, 1, 7, 31, 63], dtype=np.uint32)
    want = np.asarray(minhash_pallas.sigs_from_bases(
        jnp.asarray(bases), jnp.asarray(lengths), k, jnp.asarray(hash_ids),
        mode=mode, interpret=True))
    got = sigs_from_bases_plain(torch.from_numpy(bases),
                                torch.from_numpy(lengths), k,
                                torch.from_numpy(hash_ids.astype(np.int64)),
                                mode=mode)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("k,canonical", [(8, True), (12, False),
                                         (16, True), (16, False)])
def test_minhash_signatures_matches_jax(k, canonical):
    bases, lengths = _reads(100 + k, n=64, k=k)
    hash_ids = np.arange(8, dtype=np.uint32)
    want_s, want_v = jminhash.minhash_signatures(
        jnp.asarray(bases), jnp.asarray(lengths), k, jnp.asarray(hash_ids),
        canonical=canonical)
    got_s, got_v = minhash.minhash_signatures(
        torch.from_numpy(bases), torch.from_numpy(lengths), k,
        torch.from_numpy(hash_ids.astype(np.int64)), canonical=canonical)
    np.testing.assert_array_equal(got_s.numpy(),
                                  np.asarray(want_s).astype(np.int64))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("mirror", [False, True], ids=["dir", "mirror"])
@pytest.mark.parametrize("k", [8, 12, 16])
def test_signatures_3n_pair_matches_jax(k, mirror):
    bases, lengths = _reads(200 + k, n=64, k=k)
    # the JAX package's CPU path reverse-complements over the raw length;
    # only its TPU path clamps it to the padded width, so stay inside it
    lengths = np.minimum(lengths, bases.shape[1])
    hash_ids = np.arange(6, dtype=np.uint32)
    want_s, want_v = jminhash.signatures_3n_pair(
        jnp.asarray(bases), jnp.asarray(lengths), k, jnp.asarray(hash_ids),
        mirror=mirror)
    got_s, got_v = minhash.signatures_3n_pair(
        torch.from_numpy(bases), torch.from_numpy(lengths), k,
        torch.from_numpy(hash_ids.astype(np.int64)), mirror=mirror)
    np.testing.assert_array_equal(got_s.numpy(),
                                  np.asarray(want_s).astype(np.int64))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    if mirror:
        # the mirrored layout by its definition: [CT(RC(x)) | GA(x)]
        tb, tl = torch.from_numpy(bases), torch.from_numpy(lengths)
        hid = torch.from_numpy(hash_ids.astype(np.int64))
        first, _ = minhash.minhash_signatures(
            encode.three_n_c_to_t(encode.revcomp_bases(tb, tl)), tl, k, hid,
            canonical=False)
        second, _ = minhash.minhash_signatures(
            encode.three_n_g_to_a(tb), tl, k, hid, canonical=False)
        assert torch.equal(got_s, torch.cat([first, second], dim=1))


def test_chunked_matches_jax_and_cpu_wrapper_launches_nothing():
    """The index build's signatures on the CPU, in row chunks written into
    one output, equal the JAX package's chunked signatures; no kernel
    launches for CPU tensors."""
    bases, lengths = _reads(7, n=96)
    hash_ids = np.arange(4, dtype=np.uint32)
    want_s, want_v = jminhash.minhash_signatures_chunked(
        jnp.asarray(bases), jnp.asarray(lengths), 16, jnp.asarray(hash_ids),
        32, canonical=True)
    before = (sigs_from_bases.launches, signature_stage.launches)
    got_s, got_v = minhash.window_signatures(
        torch.from_numpy(bases), torch.from_numpy(lengths), 16,
        torch.from_numpy(hash_ids.astype(np.int64)), False, 32)
    np.testing.assert_array_equal(got_s.numpy(),
                                  np.asarray(want_s).astype(np.int64))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert (sigs_from_bases.launches, signature_stage.launches) == before


def _kmer_lows(bases, k):
    """[N, L - k + 1] uint32 forward k-mers of padded base rows."""
    n, maxlen = bases.shape
    npos = maxlen - k + 1
    lo = np.zeros((n, npos), np.uint64)
    for i in range(k):
        lo |= bases[:, i:i + npos].astype(np.uint64) << np.uint64(
            2 * (k - 1 - i))
    return lo.astype(np.uint32)


@pytest.mark.parametrize("k", [5, 11, 16])
def test_sig_min_murmur_matches_pallas_interpret(k):
    """N = 128 for the Pallas kernel; rows with no valid position, a
    length past the clamp, and random full-range k-mer words (the add of
    the hash id carries into the high word)."""
    bases, lengths = _reads(300 + k, n=128, maxlen=40, k=k)
    kmers = _kmer_lows(bases, k)
    rng = np.random.default_rng(k)
    kmers[8:16] = rng.integers(2**32 - 70, 2**32, size=kmers[8:16].shape,
                               dtype=np.uint64).astype(np.uint32)
    hash_ids = np.array([0, 1, 7, 31, 63], dtype=np.uint32)
    want = np.asarray(minhash_pallas.sig_min_murmur(
        jnp.asarray(kmers), jnp.asarray(lengths), k, jnp.asarray(hash_ids),
        interpret=True)).astype(np.int64)
    tk = torch.from_numpy(kmers.astype(np.int64))
    tl = torch.from_numpy(lengths)
    hid = torch.from_numpy(hash_ids.astype(np.int64))
    before = sig_min_murmur.launches
    got = sig_min_murmur(tk, tl, k, hid)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        sig_min_murmur_plain(tk, tl, k, hid).numpy(), want)
    assert sig_min_murmur.launches == before      # CPU: no launch
    assert (want[lengths < k] == 0xFFFFFFFF).all() and (lengths < k).any()
    # the port takes any N, and the k-mers as int32 bits too
    odd = sig_min_murmur_plain(tk[:77], tl[:77], k, hid)
    np.testing.assert_array_equal(odd.numpy(), want[:77])
    bits = torch.from_numpy(kmers.view(np.int32).copy())
    np.testing.assert_array_equal(
        sig_min_murmur_plain(bits, tl, k, hid).numpy(), want)


@pytest.mark.parametrize("k", [5, 11, 16])
def test_sig_min_murmur_equals_sigs_from_bases_fwd(k):
    """The kernel that superseded it: the forward k-mer lows of a batch
    give sigs_from_bases(mode='fwd') on its bases."""
    bases, lengths = _reads(400 + k, n=50, maxlen=33, k=k)
    hid = torch.arange(7, dtype=torch.int64)
    tl = torch.from_numpy(lengths)
    got = sig_min_murmur(torch.from_numpy(
        _kmer_lows(bases, k).astype(np.int64)), tl, k, hid)
    want = sigs_from_bases(torch.from_numpy(bases), tl, k, hid, mode="fwd")
    assert torch.equal(got, want)


def test_sig_min_murmur_rejects_bad_shapes():
    with pytest.raises(ValueError, match="k must be"):
        sig_min_murmur(torch.zeros((2, 3), dtype=torch.int64),
                       torch.zeros(2, dtype=torch.int32), 17,
                       torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError, match="kmer_lo"):
        sig_min_murmur(torch.zeros((2, 3), dtype=torch.int64),
                       torch.zeros(3, dtype=torch.int32), 16,
                       torch.zeros(1, dtype=torch.int64))


@pytest.mark.parametrize("k", [12, 15, 16])
@pytest.mark.parametrize("space", ["3n", "3n_mirror", "canon", "fwd"])
def test_signature_stage_plain_matches_jax(space, k):
    """The fused stage's plain composition (what the CPU runs) against the
    JAX functions it replaces: signatures_3n_pair (both mirrors) and
    minhash_signatures (canonical and forward), lengths 0, k - 1, k, 100
    and past the row."""
    rng = np.random.default_rng(500 + k)
    n, maxlen = 48, 112
    bases = rng.integers(0, 4, size=(n, maxlen), dtype=np.int8)
    lengths = rng.integers(0, maxlen + 1, size=n).astype(np.int32)
    lengths[:5] = [0, k - 1, k, 100, maxlen + 9]
    if space.startswith("3n"):
        # the JAX CPU path reverse-complements over the raw length (only
        # its TPU path clamps it): stay inside the row there
        lengths = np.minimum(lengths, maxlen)
    hash_ids = np.array([0, 1, 5, 2**32 - 1], dtype=np.uint32)
    jb, jl, jh = (jnp.asarray(x) for x in (bases, lengths, hash_ids))
    tb, tl = torch.from_numpy(bases), torch.from_numpy(lengths)
    th = torch.from_numpy(hash_ids.astype(np.int64))
    if space.startswith("3n"):
        mirror = space == "3n_mirror"
        want = jminhash.signatures_3n_pair(jb, jl, k, jh, mirror=mirror)
        got = signature_stage_plain(tb, tl, k, th, "both",
                                    "ga" if mirror else "ct", mirror)
    else:
        want = jminhash.minhash_signatures(jb, jl, k, jh,
                                           canonical=space == "canon")
        got = signature_stage_plain(tb, tl, k, th, space)
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(want[0]).astype(np.int64))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # the CPU wrapper is that composition, and launches nothing
    before = signature_stage.launches
    again = signature_stage(tb, tl, k, th, *(
        ("both", "ga" if space == "3n_mirror" else "ct",
         space == "3n_mirror") if space.startswith("3n") else (space,)))
    assert signature_stage.launches == before
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


def test_signature_stage_pair_is_both_collapsed_forward_spaces():
    """'pair' (the 3N index build's mode) is [fwd(CT(x)) | fwd(GA(x))],
    halves swapped under mirror; `out` receives the result in place."""
    bases, lengths = _reads(9, n=40, maxlen=50, k=12)
    tb, tl = torch.from_numpy(bases), torch.from_numpy(lengths)
    hid = torch.arange(5, dtype=torch.int64)
    ct = minhash.minhash_signatures(encode.three_n_c_to_t(tb), tl, 12, hid,
                                    canonical=False)
    ga = minhash.minhash_signatures(encode.three_n_g_to_a(tb), tl, 12, hid,
                                    canonical=False)
    sig, valid = signature_stage(tb, tl, 12, hid, "pair")
    assert torch.equal(sig, torch.cat([ct[0], ga[0]], dim=1))
    assert torch.equal(valid, ct[1])
    out = (torch.zeros((40, 10), dtype=torch.int64),
           torch.zeros(40, dtype=torch.bool))
    res = signature_stage(tb, tl, 12, hid, "pair", mirror=True, out=out)
    assert res[0] is out[0]
    assert torch.equal(out[0], torch.cat([ga[0], ct[0]], dim=1))


@pytest.mark.parametrize("dtype", ["int64", "int32", "uint32"])
def test_sig_min_murmur_plain_takes_each_word_type(dtype):
    """The same k-mer words as int64 values, int32 bits or uint32 give the
    JAX kernel's minima; a row near 0xFFFFFFFF against hash ids near
    2**32 - 1 carries into the high word."""
    k = 16
    bases, lengths = _reads(600, n=128, maxlen=30, k=k)
    kmers = _kmer_lows(bases, k)
    kmers[5] = np.uint32(2**32 - 1) - np.arange(kmers.shape[1],
                                                dtype=np.uint32)
    hash_ids = np.array([0, 3, 2**32 - 2, 2**32 - 1], dtype=np.uint32)
    want = np.asarray(minhash_pallas.sig_min_murmur(
        jnp.asarray(kmers), jnp.asarray(lengths), k, jnp.asarray(hash_ids),
        interpret=True)).astype(np.int64)
    words = {"int64": lambda: torch.from_numpy(kmers.astype(np.int64)),
             "int32": lambda: torch.from_numpy(kmers.view(np.int32).copy()),
             "uint32": lambda: torch.from_numpy(kmers.copy())}[dtype]()
    got = sig_min_murmur(words, torch.from_numpy(lengths), k,
                         torch.from_numpy(hash_ids.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", [2**32, -1, 2**40])
@pytest.mark.parametrize("wrapper", ["sigs_from_bases", "sig_min_murmur",
                                     "signature_stage"])
def test_wrappers_raise_on_a_hash_id_outside_u32(wrapper, bad):
    """The hash relies on kmer + hash id < 2**33: an id outside
    [0, 2**32) raises (on the card too: tests/test_torch_cuda.py)."""
    hid = torch.tensor([0, bad], dtype=torch.int64)
    lens = torch.full((2,), 20, dtype=torch.int32)
    call = {"sigs_from_bases": lambda: sigs_from_bases(
                torch.zeros((2, 20), dtype=torch.int8), lens, 16, hid),
            "sig_min_murmur": lambda: sig_min_murmur(
                torch.zeros((2, 5), dtype=torch.int64), lens, 16, hid),
            "signature_stage": lambda: signature_stage(
                torch.zeros((2, 20), dtype=torch.int8), lens, 16, hid)}
    with pytest.raises(ValueError, match="hash ids must lie"):
        call[wrapper]()
    hid[1] = 2**32 - 1
    call[wrapper]()
