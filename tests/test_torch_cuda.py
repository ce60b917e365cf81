"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at small edge shapes (production shapes run in chip_smoke.py), and
the STEP-2 score rows and traceback on the card against the CPU.

Needs a CUDA card and nvcc; skipped without a card.  Imports no jax, so
it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from hashreadmapper_tpu_torch.ops import bandtb
from hashreadmapper_tpu_torch.ops import bandtb_kernel as bk
from hashreadmapper_tpu_torch.ops import minhash_kernel as mk
from hashreadmapper_tpu_torch.ops import shd
from hashreadmapper_tpu_torch.ops import shd_kernel as sk
from hashreadmapper_tpu_torch.ops import swdev
from hashreadmapper_tpu_torch.ops import swdev_kernel as swk
from hashreadmapper_tpu_torch.ops import vote_kernel as vk

from torch_helpers import shd_pairs_case

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _launched_once(wrapper, fn):
    before = wrapper.launches
    out = fn()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    return out


def _rows(rng, n, maxlen, k, dev):
    """n rows of codes 0..3 and lengths: 0, k - 1, k, the row, past it."""
    bases = torch.from_numpy(rng.integers(0, 4, size=(n, maxlen),
                                          dtype=np.int8)).to(dev)
    lens = rng.integers(0, maxlen + 15, size=n).astype(np.int32)
    lens[:5] = [0, k - 1, k, maxlen, maxlen + 9]
    return bases, torch.from_numpy(lens).to(dev)


def _hash_ids(rng, f, dev):
    """F ids, the first near 2**32 (the hash's carry into the high word)."""
    hid = rng.integers(0, 2**32, size=f, dtype=np.int64)
    hid[0] = 2**32 - 1 - (f - 1) % 3
    return torch.from_numpy(hid).to(dev)


@pytest.mark.parametrize("f", [1, 16, 32])
@pytest.mark.parametrize("k", [1, 8, 15, 16])
@pytest.mark.parametrize("mode", ["fwd", "both", "canon"])
def test_minhash_kernel_equals_plain(dev, mode, k, f):
    """N = 300 (no multiple of a block's rows), rows of 45 bases (byte
    loads) and of 128 (16-byte loads)."""
    rng = np.random.default_rng(100 * k + f)
    hid = _hash_ids(rng, f, dev)
    for n, maxlen in ((300, 45), (77, 128)):
        bases, lens = _rows(rng, n, maxlen, k, dev)
        got = _launched_once(mk.sigs_from_bases, lambda: mk.sigs_from_bases(
            bases, lens, k, hid, mode))
        want = mk.sigs_from_bases_plain(bases, lens, k, hid, mode)
        assert torch.equal(got, want)


@pytest.mark.parametrize("k", [12, 16])
@pytest.mark.parametrize("mode,collapse,mirror", [
    ("both", "ct", False), ("both", "ga", True), ("both", None, False),
    ("canon", None, False), ("fwd", "ct", False), ("canon", "ga", False),
    ("pair", None, False), ("pair", None, True)])
def test_signature_stage_kernel_equals_plain(dev, mode, collapse, mirror, k):
    """The fused stage (collapse, hash, mask, SENTINEL rows, mirror) in
    every collapse mode, also written into rows of a larger output."""
    rng = np.random.default_rng(k)
    hid = _hash_ids(rng, 16, dev)
    bases, lens = _rows(rng, 301, 128, k, dev)
    got = _launched_once(mk.signature_stage, lambda: mk.signature_stage(
        bases, lens, k, hid, mode, collapse, mirror))
    want = mk.signature_stage_plain(bases, lens, k, hid, mode, collapse,
                                    mirror)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[0][0] == 0xFFFFFFFF).all() and not got[1][0]
    sig = torch.full((400, want[0].shape[1]), -1, dtype=torch.int64,
                     device=dev)
    valid = torch.zeros(400, dtype=torch.bool, device=dev)
    mk.signature_stage(bases, lens, k, hid, mode, collapse, mirror,
                       out=(sig[50:351], valid[50:351]))
    assert torch.equal(sig[50:351], want[0]) and (sig[:50] == -1).all()
    assert torch.equal(valid[50:351], want[1]) and not valid[351:].any()


@pytest.mark.parametrize("f,c,min_hits,cap", [(4, 8, 1, 4), (5, 3, 2, 8),
                                              (32, 16, 4, 8), (7, 1, 1, 2)])
def test_vote_kernel_equals_plain(dev, f, c, min_hits, cap):
    rng = np.random.default_rng(f * 10 + c)
    n = 257
    ids = rng.integers(0, 20, size=(f, n, c)).astype(np.int64)
    fill = rng.integers(0, c + 1, size=(f, n, 1))
    ids = np.where(np.arange(c)[None, None, :] < fill, ids, 0xFFFFFFFF)
    ids[:, :3] = 0xFFFFFFFF                                  # empty rows
    cand = torch.from_numpy(np.sort(ids, axis=2)).to(dev)
    got = _launched_once(vk.vote_candidates_fnc,
                         lambda: vk.vote_candidates_fnc(cand, min_hits, cap))
    want = vk.vote_candidates_fnc_plain(cand, min_hits, cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("f,c,n", [
    (1, 1, 5), (2, 16, 33), (4, 16, 1), (8, 16, 257), (16, 16, 31),
    (32, 16, 257), (64, 16, 129), (32, 32, 65), (32, 64, 33),   # E 1 .. 64
    (3, 5, 77), (32, 17, 9), (6, 6, 40), (5, 100, 21),          # padded m
    (33, 64, 17), (64, 64, 9), (16, 1024, 3)])                  # shared mem
def test_vote_kernel_every_width(dev, f, c, n, order):
    """Every register width E = m_pad / 32 of the warp kernel, F*C that is
    no power of two, both sides of the 2,048-id switch to the
    shared-memory kernel, odd N and N = 1, lists sorted and not; a row of
    equal ids, a row of distinct ids with the top bit set, empty rows."""
    rng = np.random.default_rng(f * 1000 + c)
    ids = rng.integers(0, max(8, f * c // 6), size=(f, n, c)).astype(np.int64)
    fill = rng.integers(0, c + 1, size=(f, n, 1))
    ids = np.where(np.arange(c)[None, None, :] < fill, ids, 0xFFFFFFFF)
    ids[:, 0] = 0xFFFFFFFF
    if n > 2:
        ids[:, 1] = 7
        ids[:, 2] = np.arange(f * c).reshape(f, c) + 2**31
    if order == "sorted":
        ids = np.sort(ids, axis=2)
    cand = torch.from_numpy(ids).to(dev)
    for min_hits, cap in ((1, 8), (3, 5), (2, 0)):
        got = _launched_once(vk.vote_candidates_fnc,
                             lambda: vk.vote_candidates_fnc(cand, min_hits,
                                                            cap))
        want = vk.vote_candidates_fnc_plain(cand, min_hits, cap)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    if n > 2:
        kept = vk.vote_candidates_fnc_plain(cand, 1, 8)[2]
        assert kept[:3].tolist() == [0, 1, f * c]


@pytest.mark.parametrize("wr,n_shifts", [(1, 32), (2, 64), (4, 160),
                                         (3, 50)])
def test_shd_best_kernel_equals_plain(dev, wr, n_shifts):
    rng = np.random.default_rng(wr)
    p = 300
    wa = (n_shifts + 31) // 32 + wr + 1
    r32 = lambda *s: torch.from_numpy(rng.integers(
        -2**31, 2**31, size=s, dtype=np.int64).astype(np.int32)).to(dev)
    a_hi, a_lo = r32(p, 2, wa), r32(p, 2, wa)
    lo = rng.integers(-2, 40, size=p)
    bounds = np.stack([lo, lo + rng.integers(-3, n_shifts + 40, size=p)],
                      axis=1)
    bounds[:5] = -1                                          # padded pairs
    a_hi[5:10] = a_hi[5:10, :, :1]                           # tied shifts
    args = (a_hi, a_lo, r32(p, 2, wr), r32(p, 2, wr), r32(p, wr),
            torch.from_numpy(bounds.astype(np.int32)).to(dev), n_shifts,
            wa, wr)
    got = _launched_once(sk.shd_best, lambda: sk.shd_best(*args))
    assert torch.equal(got, sk.shd_best_plain(*args))


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("k,n,npos,f", [(5, 300, 36, 4), (11, 77, 30, 1),
                                        (16, 129, 113, 16), (16, 1, 1, 4),
                                        (1, 40, 300, 32)])
def test_sig_min_murmur_kernel_equals_plain(dev, k, n, npos, f, dtype):
    """Full-range k-mer words with a row near 0xFFFFFFFF against hash ids
    near 2**32 - 1 (the add carries into the high word), rows with no
    valid position, lengths past the clamp, N not a multiple of a block's
    rows, positions over more than one chunk; int64 k-mers (low words
    read) and int32 words, each read as it comes."""
    rng = np.random.default_rng(k + n)
    kmers = rng.integers(0, 2**32, size=(n, npos), dtype=np.int64)
    kmers[0] = 2**32 - 1 - rng.integers(0, 64, size=npos)
    lens = rng.integers(0, npos + k + 9, size=n).astype(np.int32)
    lens[:3] = [npos + k + 8, 0, k - 1][:min(3, n)]
    if dtype == torch.int32:
        kmers = kmers.astype(np.uint32).view(np.int32)
    kmers, lens = torch.from_numpy(kmers).to(dev), torch.from_numpy(lens).to(dev)
    hid = _hash_ids(rng, f, dev)
    got = _launched_once(mk.sig_min_murmur,
                         lambda: mk.sig_min_murmur(kmers, lens, k, hid))
    assert torch.equal(got, mk.sig_min_murmur_plain(kmers, lens, k, hid))


def test_sig_min_murmur_kernel_equals_sigs_from_bases_fwd(dev):
    rng = np.random.default_rng(3)
    k, n, maxlen = 16, 300, 60
    bases = rng.integers(0, 4, size=(n, maxlen), dtype=np.int8)
    lens = rng.integers(0, maxlen + 5, size=n).astype(np.int32)
    npos = maxlen - k + 1
    lo = np.zeros((n, npos), np.int64)
    for i in range(k):
        lo |= bases[:, i:i + npos].astype(np.int64) << (2 * (k - 1 - i))
    hid = torch.arange(16, dtype=torch.int64, device=dev)
    tl = torch.from_numpy(lens).to(dev)
    got = mk.sig_min_murmur(torch.from_numpy(lo).to(dev), tl, k, hid)
    want = mk.sigs_from_bases(torch.from_numpy(bases).to(dev), tl, k, hid,
                              "fwd")
    assert torch.equal(got, want)


@pytest.mark.parametrize("wr,n_shifts,p", [(1, 32, 300), (2, 64, 129),
                                           (4, 160, 300), (3, 50, 1),
                                           (16, 96, 40)])
def test_shd_hamming_matrix_kernel_equals_plain(dev, wr, n_shifts, p):
    rng = np.random.default_rng(wr + p)
    wa = (n_shifts + 31) // 32 + wr
    r32 = lambda *s: torch.from_numpy(rng.integers(
        -2**31, 2**31, size=s, dtype=np.int64).astype(np.int32)).to(dev)
    a_hi, a_lo = r32(p, 2, wa), r32(p, 2, wa)
    a_hi[:1] = -1
    args = (a_hi, a_lo, r32(p, 2, wr), r32(p, 2, wr), r32(p, wr), n_shifts,
            wa, wr)
    got = _launched_once(sk.shd_hamming_matrix,
                         lambda: sk.shd_hamming_matrix(*args))
    assert got.is_contiguous() and got.shape == (p, 2, n_shifts)
    assert torch.equal(got, sk.shd_hamming_matrix_plain(*args))


def test_hamming_matrix_kernel_row_min_equals_shd_best_kernel(dev):
    rng = np.random.default_rng(8)
    p, wr, n_shifts = 500, 4, 160
    wa = n_shifts // 32 + wr + 1
    r32 = lambda *s: torch.from_numpy(rng.integers(
        -2**31, 2**31, size=s, dtype=np.int64).astype(np.int32)).to(dev)
    a_hi, a_lo = r32(p, 2, wa), r32(p, 2, wa)
    a_hi[5:10] = a_hi[5:10, :, :1]                           # tied shifts
    lo = rng.integers(0, 40, size=p)
    bounds = np.stack([lo, np.minimum(lo + rng.integers(-3, 130, size=p),
                                      n_shifts - 1)], axis=1)
    bounds = torch.from_numpy(bounds.astype(np.int32)).to(dev)
    planes = (a_hi, a_lo, r32(p, 2, wr), r32(p, 2, wr), r32(p, wr))
    ham = sk.shd_hamming_matrix(*planes, n_shifts, wa, wr).to(torch.int64)
    s = torch.arange(n_shifts, device=dev)[None, None, :]
    inside = (s >= bounds[:, 0, None, None]) & (s <= bounds[:, 1, None, None])
    ham = torch.where(inside, ham, torch.full_like(ham, sk.BIG))
    best, idx = ham.min(dim=2)
    first = (ham == best[:, :, None]).to(torch.int64).argmax(dim=2)
    shift = torch.where(best < sk.BIG, first,
                        bounds[:, :1].to(torch.int64))
    want = sk.shd_best(*planes, bounds, n_shifts, wa, wr)
    got = torch.stack([best[:, 0], shift[:, 0], best[:, 1], shift[:, 1]],
                      dim=1).to(torch.int32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("p", [1, 31, 33])
@pytest.mark.parametrize("wr", list(range(5, 17)))
def test_shd_kernels_every_width(dev, wr, p):
    """Every register width of the two warp kernels above the main path's
    wr 4, P of one warp, one short of and one past a 32-pair multiple;
    full-range words, empty and reversed bounds, tied shifts, zero masks."""
    rng = np.random.default_rng(100 * wr + p)
    n_shifts = 160 if wr % 2 else 70
    wa = (n_shifts + 31) // 32 + wr + (wr % 3)
    r32 = lambda *s: torch.from_numpy(rng.integers(
        -2**31, 2**31, size=s, dtype=np.int64).astype(np.int32)).to(dev)
    a_hi, a_lo = r32(p, 2, wa), r32(p, 2, wa)
    a_hi[-1:] = a_hi[-1:, :, :1]                             # tied shifts
    mask = r32(p, wr)
    mask[:1] = 0
    lo = rng.integers(-3, 40, size=p)
    bounds = np.stack([lo, lo + rng.integers(-3, n_shifts + 40, size=p)],
                      axis=1)
    if p > 2:
        bounds[1:3] = [[-1, -1], [50, 20]]                   # empty ranges
    args = (a_hi, a_lo, r32(p, 2, wr), r32(p, 2, wr), mask,
            torch.from_numpy(bounds.astype(np.int32)).to(dev), n_shifts,
            wa, wr)
    got = _launched_once(sk.shd_best, lambda: sk.shd_best(*args))
    assert torch.equal(got, sk.shd_best_plain(*args))
    m_args = args[:5] + args[6:]
    got = _launched_once(sk.shd_hamming_matrix,
                         lambda: sk.shd_hamming_matrix(*m_args))
    assert torch.equal(got, sk.shd_hamming_matrix_plain(*m_args))


def test_shd_best_kernel_on_the_main_path_bounds(dev):
    """The coarse mapper's bounds: [bit0, bit0 + 128] at 160 shifts
    (wa 10, wr 4), a few shorter, 300 padded pairs."""
    rng = np.random.default_rng(31)
    p, wr, wa, n_shifts = 4096, 4, 10, 160
    r32 = lambda *s: torch.from_numpy(rng.integers(
        -2**31, 2**31, size=s, dtype=np.int64).astype(np.int32)).to(dev)
    bit0 = rng.integers(0, 32, size=p)
    bounds = np.stack([bit0, bit0 + 128], axis=1)
    bounds[:40, 1] -= rng.integers(1, 129, size=40)
    bounds[-300:] = -1
    args = (r32(p, 2, wa), r32(p, 2, wa), r32(p, 2, wr), r32(p, 2, wr),
            r32(p, wr), torch.from_numpy(bounds.astype(np.int32)).to(dev),
            n_shifts, wa, wr)
    got = _launched_once(sk.shd_best, lambda: sk.shd_best(*args))
    assert torch.equal(got, sk.shd_best_plain(*args))


@pytest.mark.parametrize("mode", ["threeN", "parity", "undirectional"])
@pytest.mark.parametrize("shape", [
    dict(), dict(width=128, n_reads=64, p=256, ws=128, max_pct=0.05),
    dict(width=100, ws=96, p=97), dict(width=300, ws=200, p=65)],
    ids=["w40", "flagship", "w100", "w300"])
def test_shd_pairs_best_kernel_equals_plain(dev, mode, shape):
    """The fused SHD stage (one launch) == its plain composition on the
    card and on the CPU, on torch_helpers.shd_pairs_case's edge cases."""
    c = shd_pairs_case(23, mode, **shape)
    width = c["reads"].shape[1]
    g_hi, g_lo = sk.pack_genome_planes(torch.from_numpy(c["genome"]))
    params = shd.ShdParams(c["ws"], c["ws"] + width, width, c["max_pct"])
    flags = dict(three_n=mode != "parity",
                 undirectional=mode == "undirectional")
    host = [torch.from_numpy(np.asarray(c[k])) for k in
            ("reads", "read_len", "ridx")] + [g_hi, g_lo] + [
        torch.from_numpy(np.asarray(c[k])) for k in
        ("gstart", "alen", "aleft", "valid")]
    card = [t.to(dev) for t in host]
    got = _launched_once(sk.shd_pairs_best, lambda: shd.shd_pairs_best(
        *card, params, **flags))
    for want in (shd.shd_pairs_best_plain(*card, params, **flags),
                 shd.shd_pairs_best_plain(*host, params, **flags)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu())
    assert (got.orientation != shd.NONE).sum() > len(c["ridx"]) // 3


def test_shd_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros((4, 2, 2060), dtype=torch.int32, device=dev)
    b = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="n_shifts=65537"):
        sk.shd_best(x, x, x[:, :, :2], x[:, :, :2], x[:, 0, :2], b, 65537,
                    2060, 2)
    x = x[:, :, :40].contiguous()
    with pytest.raises(ValueError, match="wr=17"):
        sk.shd_hamming_matrix(x, x, x[:, :, :17], x[:, :, :17],
                              x[:, 0, :17], 32, 40, 17)
    z64 = torch.zeros(4, dtype=torch.int64, device=dev)
    g = torch.zeros(8, dtype=torch.int32, device=dev)
    args = (torch.zeros(4, dtype=torch.int32, device=dev), z64, g, g, z64,
            z64, z64, torch.ones(4, dtype=torch.bool, device=dev))
    with pytest.raises(ValueError, match="L=513"):
        shd.shd_pairs_best(torch.zeros((4, 513), dtype=torch.int8,
                                       device=dev), *args,
                           shd.ShdParams(128, 641, 513, 0.05))
    with pytest.raises(ValueError, match="65536"):
        shd.shd_pairs_best(torch.zeros((4, 100), dtype=torch.int8,
                                       device=dev), *args,
                           shd.ShdParams(65536, 65636, 100, 0.05))


def _four_strand_case(seed=5, g_len=60_000, n_per=64, read_len=80,
                      conv=0.9):
    """tests/test_undirectional.py's four-strand reads (its own copy: this
    file must import without jax, so not from torch_helpers)."""
    from hashreadmapper_tpu_torch.io.genome import Genome
    rng = np.random.default_rng(seed)
    chrom = rng.integers(0, 4, size=g_len, dtype=np.int8)
    genome = Genome(["chrU"], [np.frombuffer(b"ACGT", np.uint8)[chrom]
                               .tobytes().decode()])
    starts = rng.integers(0, g_len - read_len, size=4 * n_per)
    reads = chrom[starts[:, None] + np.arange(read_len)[None, :]].copy()
    kind = np.repeat(np.arange(4), n_per)
    rc = (kind == 1) | (kind == 3)
    reads[rc] = 3 - reads[rc][:, ::-1]
    ct = (kind < 2)[:, None]
    c_conv = (reads == 1) & (rng.random(reads.shape) < conv) & ct
    g_conv = (reads == 2) & (rng.random(reads.shape) < conv) & ~ct
    reads[c_conv] = 3
    reads[g_conv] = 0
    return genome, reads.astype(np.int8), np.full(4 * n_per, read_len,
                                                  np.int32), kind


@pytest.mark.parametrize("mode", ["parity", "undirectional"])
def test_coarse_and_fused_step2_card_equals_cpu_in_the_new_modes(dev, mode):
    """Parity (canonical signatures, F tables, un-collapsed planes) and
    --undirectional (mirrored signatures, 4F vote, mirrored planes, G->A
    STEP-2 pairs): packed rows, overflow and the fused bundle, card == CPU."""
    from hashreadmapper_tpu_torch.config import ProgramOptions
    from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper
    genome, reads, lengths, kind = _four_strand_case(
        conv=0.0 if mode == "parity" else 0.9)
    if mode == "parity":
        rng = np.random.default_rng(6)
        reads[kind == 3] = reads[kind == 3][:, ::-1].copy()   # junk
        sub = rng.random(reads.shape) < 0.02
        reads[sub] = rng.integers(0, 4, size=int(sub.sum()))
    outs = []
    for d in (dev, "cpu"):
        opts = ProgramOptions(
            kmer_length=16, num_hash_functions=8, window_size=128,
            min_table_hits=2, batchsize=128, max_hamming_percent=0.6,
            probe_cap=16, candidates_per_read_cap=16, max_read_length=96,
            three_n_seeding=mode != "parity",
            undirectional=mode == "undirectional",
            shd_pairs_per_read_budget=4, probe_tail_budget_per_read=4)
        res, bundle = CoarseMapper(genome, opts, d).map_reads(
            reads, lengths, with_scores=True)
        outs.append((res, bundle))
    (rc_, bc), (rh, bh) = outs
    for f in ("orientation", "hamming", "shift", "chromosome_id", "position",
              "global_window_id", "bs_strand"):
        np.testing.assert_array_equal(getattr(rc_, f), getattr(rh, f), f)
    assert rc_.stats == rh.stats
    for c, h in zip(bc, bh):
        np.testing.assert_array_equal(c, h)
    assert (rh.orientation != 3).mean() > 0.4
    if mode == "undirectional":
        assert (rh.bs_strand[kind >= 2] == 1).mean() > 0.5


def _small_case_opts(mode, **kw):
    from hashreadmapper_tpu_torch.config import ProgramOptions
    return ProgramOptions(**dict(dict(
        kmer_length=16, num_hash_functions=8, window_size=128,
        min_table_hits=2, batchsize=128, max_hamming_percent=0.6,
        probe_cap=16, candidates_per_read_cap=16, max_read_length=96,
        three_n_seeding=mode != "parity",
        undirectional=mode == "undirectional",
        shd_pairs_per_read_budget=4, probe_tail_budget_per_read=4), **kw))


RESULT_FIELDS = ("orientation", "hamming", "shift", "chromosome_id",
                 "position", "global_window_id", "bs_strand")


@pytest.mark.parametrize("mode", ["parity", "threeN", "undirectional"])
def test_window_stream_card_equals_cpu(dev, mode):
    """The window stream (read index, window signatures, the probe over
    2F or 4F read tables, the vote, the fused SHD stage with read ids
    into the whole read set, the host merge): every field and stat, card
    == CPU."""
    from hashreadmapper_tpu_torch.pipeline.window_stream import \
        WindowStreamMapper
    genome, reads, lengths, kind = _four_strand_case(
        conv=0.0 if mode == "parity" else 0.9)
    outs = [WindowStreamMapper(reads, lengths, _small_case_opts(
        mode, batchsize=64, probe_head_budget_per_read=8,
        max_results_per_map=40), d).map_genome(genome)
        for d in (dev, "cpu")]
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(outs[0], f),
                                      getattr(outs[1], f), f)
    assert outs[0].stats == outs[1].stats
    mapped = outs[1].orientation != 3
    assert mapped[kind < 2].mean() > 0.8
    if mode == "undirectional":
        assert (outs[1].bs_strand[kind >= 2] == 1).mean() > 0.5


def test_regions_with_scores_card_equals_cpu(dev):
    """Three window regions of one chromosome (segments with virtual
    offsets, no cuckoo table), with the fused STEP 2 in each: the merged
    rows and the bundle, card == CPU, and the rows equal the single
    mapper's on the card."""
    from hashreadmapper_tpu_torch.parallel.region_sharded import \
        RegionShardedMapper
    from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper
    genome, reads, lengths, _ = _four_strand_case()
    opts = _small_case_opts("threeN")
    outs = [RegionShardedMapper(genome, opts, 3, devices=[d],
                                partition="window").map_reads(
        reads, lengths, with_scores=True) for d in (dev, "cpu")]
    (rc_, bc), (rh, bh) = outs
    for f in RESULT_FIELDS + ("global_window_id64",):
        np.testing.assert_array_equal(getattr(rc_, f), getattr(rh, f), f)
    assert rc_.stats == rh.stats and rc_.stats["cuckoo_direct_probe"] == 0
    for c, h in zip(bc, bh):
        np.testing.assert_array_equal(c, h)
    single = CoarseMapper(genome, opts, dev).map_reads(reads, lengths)
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(rc_, f), getattr(single, f), f)
    assert (rh.orientation != 3).mean() > 0.4


@pytest.mark.parametrize("mode", ["threeN", "undirectional"])
def test_mesh_with_scores_card_equals_cpu(dev, mode):
    """A logical 2 x 2 mesh with every position the card (the table
    shards' probes, the gathers in table order, the per-data-shard vote,
    SHD and fused STEP 2) against the same mesh on the CPU: rows, stats
    and bundle equal; and, no counter being over, the single mapper's
    rows on the card."""
    from hashreadmapper_tpu_torch.parallel.sharded import (
        ShardedCoarseMapper, make_mesh)
    from hashreadmapper_tpu_torch.pipeline.engine import (OVERFLOW_KEYS,
                                                          CoarseMapper)
    genome, reads, lengths, _ = _four_strand_case()
    opts = _small_case_opts(mode)
    outs = [ShardedCoarseMapper(genome, opts, make_mesh(2, 2, [d] * 4))
            .map_reads(reads, lengths, with_scores=True)
            for d in (dev, "cpu")]
    (rc_, bc), (rh, bh) = outs
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(rc_, f), getattr(rh, f), f)
    assert rc_.stats == rh.stats
    assert not any(rc_.stats[k] for k in OVERFLOW_KEYS)
    for c, h in zip(bc, bh):
        np.testing.assert_array_equal(c, h)
    single = CoarseMapper(genome, opts, dev).map_reads(reads, lengths)
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(rc_, f), getattr(single, f), f)
    assert (rh.orientation != 3).mean() > 0.4


def _eager_pool(mapper, staged, with_scores):
    """The eager batch step over a staged pool, batch by batch: the
    outputs of _map_reads_device(_scored) without a graph."""
    bases, lens, valid, n_pad = staged
    bsz = mapper.opts.batchsize
    parts = [mapper._batch_step(bases[s:s + bsz], lens[s:s + bsz],
                                valid[s:s + bsz], with_scores=with_scores)
             for s in range(0, n_pad, bsz)]
    out = [torch.cat([p[0] for p in parts]),
           torch.stack([p[1] for p in parts]).sum(dim=0)]
    if with_scores:
        out += [torch.cat([p[2] for p in parts], dim=1),
                torch.cat([p[3] for p in parts]),
                torch.cat([p[4] for p in parts])]
    return out


@pytest.mark.parametrize("mode", ["parity", "threeN", "undirectional"])
def test_graph_steps_equal_eager(dev, mode):
    """Each read batch one replay of a captured CUDA graph: the packed rows,
    overflow, 10 score rows, traceback entries and status of
    _map_reads_device_scored and map_pool_scanned equal the eager step's,
    bit for bit; a replay counts the capture's launches (one signature
    stage a batch, two under --undirectional) and the capture none."""
    from hashreadmapper_tpu_torch.ops import minhash_kernel as mk_
    from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper
    genome, reads, lengths, _ = _four_strand_case(
        conv=0.0 if mode == "parity" else 0.9)
    m = CoarseMapper(genome, _small_case_opts(mode), dev)
    m.ensure_read_drops(reads, lengths)
    staged = m.stage_reads_device(reads, lengths)
    n_batches = staged[3] // m.opts.batchsize
    eager = _eager_pool(m, staged, True)
    before = mk_.signature_stage.launches
    graph = m._map_reads_device_scored(*staged, m.opts.batchsize)
    torch.cuda.synchronize()
    per = 2 if mode == "undirectional" else 1
    # the warm-up launched the first batch's kernels once; the capture none
    assert mk_.signature_stage.launches - before == per * (n_batches + 1)
    assert all(s.graph is not None for s in m._steps.values())
    for g, e in zip(graph, eager):
        assert g.dtype == e.dtype and torch.equal(g, e)
    coarse = m.map_pool_scanned(*staged, m.opts.batchsize)
    for g, e in zip(coarse, eager[:2]):
        assert torch.equal(g, e)
    assert (eager[0][:, 0] != 3).float().mean() > 0.4


def _mesh_eager_pool(mapper, staged):
    """The eager step (_map_shard_batch) of every data shard's batch of a
    staged mesh pool, in read order: the outputs of
    _map_reads_device_scored without a graph."""
    bases, lens, valid, _ = staged
    parts = [mapper._map_shard_batch(d, bases[d][i], lens[d][i], valid[d][i],
                                     with_scores=True)
             for i in range(bases[0].shape[0]) for d in range(len(bases))]
    return [torch.cat([p[0] for p in parts]),
            torch.stack([p[1] for p in parts]).sum(dim=0),
            torch.cat([p[2] for p in parts], dim=1),
            torch.cat([p[3] for p in parts]), torch.cat([p[4] for p in parts])]


@pytest.mark.parametrize("mode", ["parity", "threeN", "undirectional"])
def test_mesh_graph_steps_equal_eager(dev, mode):
    """A logical 2 x 4 mesh on the card, each data shard's batch one replay
    (the whole-row step), and the same mesh split at the cards (a head, a
    probe step a table shard, a tail: three kinds of graph in the card's
    pool): packed rows, overflow, score rows, traceback entries and status
    equal the eager step's, bit for bit; a second run replays every step
    and adds the captures' launch counts, one signature stage a data
    shard's batch (two under --undirectional)."""
    from hashreadmapper_tpu_torch.parallel.sharded import (
        ShardedCoarseMapper, make_mesh)
    genome, reads, lengths, _ = _four_strand_case(
        conv=0.0 if mode == "parity" else 0.9)
    opts = _small_case_opts(mode, batchsize=64)
    mesh = make_mesh(2, 4, [dev] * 8)
    per = 2 if mode == "undirectional" else 1
    for plan in (None, [[(dev, (t,)) for t in range(4)]] * 2):
        m = ShardedCoarseMapper(genome, opts, mesh, plan=plan)
        m.ensure_read_drops(reads, lengths)
        m.ensure_empty_drops()
        staged = m.stage_reads_device(reads, lengths)
        eager = _mesh_eager_pool(m, staged)
        m._map_reads_device_scored(*staged, opts.batchsize)
        before = mk.signature_stage.launches
        graph = m._map_reads_device_scored(*staged, opts.batchsize)
        torch.cuda.synchronize()
        assert all(s.graph is not None for s in m._steps.values())
        assert {k[0] for k in m._steps} == (
            {"row"} if plan is None else {"head", "probe", "tail"})
        assert mk.signature_stage.launches - before == \
            per * staged[0][0].shape[0] * 2
        for g, e in zip(graph, eager):
            assert g.dtype == e.dtype and torch.equal(g, e)
        assert (eager[0][:, 0] != 3).float().mean() > 0.4


def test_two_regions_on_one_card_graph_equals_eager(dev, monkeypatch):
    """Two window regions on the card, every region's batches enqueued
    (one replay each, one graph pool for the card) before the first copy
    to the host: merged rows, stats and bundle equal the same mapper's
    with every step eager, and the CPU's."""
    from hashreadmapper_tpu_torch.parallel.region_sharded import \
        RegionShardedMapper
    from hashreadmapper_tpu_torch.pipeline import graphs
    genome, reads, lengths, _ = _four_strand_case()
    opts = _small_case_opts("threeN")
    rm = RegionShardedMapper(genome, opts, 2, devices=[dev],
                             partition="window")
    got = rm.map_reads(reads, lengths, with_scores=True)
    assert all(s.graph is not None for m in rm.mappers
               for s in m._steps.values())
    assert graphs.pool_bytes(dev) > 0
    with monkeypatch.context() as mp:
        mp.setattr(graphs.CapturedStep, "run", graphs.CapturedStep.run_eager)
        eager = rm.map_reads(reads, lengths, with_scores=True)
    cpu = RegionShardedMapper(genome, opts, 2, devices=["cpu"],
                              partition="window").map_reads(
        reads, lengths, with_scores=True)
    for other in (eager, cpu):
        for f in RESULT_FIELDS + ("global_window_id64",):
            np.testing.assert_array_equal(getattr(got[0], f),
                                          getattr(other[0], f), f)
        assert got[0].stats == other[0].stats
        for g, o in zip(got[1], other[1]):
            np.testing.assert_array_equal(g, o)


@pytest.mark.parametrize("mode", ["parity", "undirectional"])
def test_window_stream_graph_equals_eager(dev, mode, monkeypatch):
    """map_genome with one replay a window batch (one capture for both
    chromosomes) against the same with the eager step: every field and
    stat."""
    from hashreadmapper_tpu_torch.io.genome import Genome
    from hashreadmapper_tpu_torch.pipeline import graphs
    from hashreadmapper_tpu_torch.pipeline.window_stream import \
        WindowStreamMapper
    g1, reads, lengths, _ = _four_strand_case(
        conv=0.0 if mode == "parity" else 0.9)
    seq = g1.seqs_ascii[0].tobytes().decode()
    genome = Genome(["a", "b"], [seq[:35_000], seq[35_000:]])
    ws = WindowStreamMapper(reads, lengths, _small_case_opts(
        mode, batchsize=64, probe_head_budget_per_read=8,
        max_results_per_map=40), dev)
    got = ws.map_genome(genome)
    assert len(ws._steps) == 1
    with monkeypatch.context() as mp:
        mp.setattr(graphs.CapturedStep, "run", graphs.CapturedStep.run_eager)
        eager = ws.map_genome(genome)
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(eager, f), f)
    assert got.stats == eager.stats
    assert set(np.unique(got.chromosome_id[got.orientation != 3])) == {0, 1}


def test_kernels_launch_on_the_card_of_their_inputs(dev, monkeypatch):
    """cuda:0 current, every kernel's inputs on cuda:1: each kernel's card
    test above at one shape runs there and equals its plain version, and
    the current device is still cuda:0; then a 1 x 2 mesh over both cards
    (a graph a step on each card's own stream, peer copies of the table
    shards' lists between them) equals the CPU's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    other = torch.device("cuda", 1)
    with torch.cuda.device(0):
        test_minhash_kernel_equals_plain(other, "both", 16, 16)
        test_signature_stage_kernel_equals_plain(other, "both", "ct", False,
                                                 16)
        test_sig_min_murmur_kernel_equals_plain(other, 16, 129, 113, 16,
                                                torch.int64)
        test_vote_kernel_equals_plain(other, 32, 16, 4, 8)
        test_shd_best_kernel_equals_plain(other, 4, 160)
        test_shd_hamming_matrix_kernel_equals_plain(other, 4, 160, 300)
        test_shd_pairs_best_kernel_equals_plain(other, "threeN", dict())
        test_sw_pass_kernel_equals_plain(other, 300, 128, 128)
        test_sw_forward_and_reverse_kernels_equal_plain(other, 128, 128, 64,
                                                        torch.int8)
        test_shift_sub_kernel_equals_plain(other, 128, 128, 300)
        test_fill_kernel_equals_plain(other, 128, True, "int8")
        test_traceback_kernel_equals_plain(other, 301, 128, 128, "fused",
                                           monkeypatch)
        assert torch.cuda.current_device() == 0
        from hashreadmapper_tpu_torch.parallel.sharded import (
            ShardedCoarseMapper, make_mesh)
        genome, reads, lengths, _ = _four_strand_case()
        opts = _small_case_opts("threeN")
        mappers = [ShardedCoarseMapper(genome, opts, make_mesh(1, 2, devs))
                   for devs in (None, ["cpu"] * 2)]
        outs = [m.map_reads(reads, lengths, with_scores=True)
                for m in mappers]
    # over two cards the row is split: a head, a probe step a card, a tail
    assert {k[0] for k in mappers[0]._steps} == {"head", "probe", "tail"}
    (rc_, bc), (rh, bh) = outs
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(rc_, f), getattr(rh, f), f)
    for c, h in zip(bc, bh):
        np.testing.assert_array_equal(c, h)


def _pairs(rng, p, lq, lr):
    """Reads cut from their ref with substitutions and a 0-3 base indel,
    every third pair random; every seventh a full-length exact copy, which
    saturates the byte mode at 128.  Codes 0..4, 4-padded, int32 [L, P]."""
    rc = np.full((p, lq), 4, np.int32)
    fc = np.full((p, lr), 4, np.int32)
    rls = rng.integers(1, lq + 1, p).astype(np.int32)
    fls = rng.integers(1, lr + 1, p).astype(np.int32)
    for i in range(p):
        ref = rng.integers(0, 5, fls[i])
        read = rng.integers(0, 5, rls[i])
        if i % 3:
            read = np.resize(ref, rls[i])
            sub = rng.random(rls[i]) < 0.05
            read[sub] = rng.integers(0, 4, int(sub.sum()))
            cut, d = int(rng.integers(0, rls[i])), int(rng.integers(0, 4))
            read = np.concatenate([read[:cut], read[cut + d:],
                                   rng.integers(0, 4, d)])[:rls[i]]
        if i % 7 == 0:
            rls[i], fls[i] = min(lq, lr), lr
            ref = rng.integers(0, 4, lr)
            read = ref[:rls[i]]
        rc[i, :rls[i]] = read
        fc[i, :fls[i]] = ref
    return (torch.from_numpy(rc.T.copy()), torch.from_numpy(rls),
            torch.from_numpy(fc.T.copy()), torch.from_numpy(fls))


def _equal(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("p,lq,lr", [(1, 16, 16), (37, 64, 96),
                                     (130, 112, 128), (300, 128, 128)])
def test_sw_pass_kernel_equals_plain(dev, p, lq, lr):
    """S = 1, 4, 7 and 8; forward with max_column, then reverse-ordered
    columns with terminate = the forward best."""
    rng = np.random.default_rng(p)
    read_t, rl, ref_t, fl = (x.to(dev) for x in _pairs(rng, p, lq, lr))
    read_at, seg = swk._striped_layout_t(read_t, rl, lq)
    sat = torch.full((p,), swk.SAT, dtype=torch.int32, device=dev)
    fwd = (read_at, rl, seg, ref_t, fl, sat, 0, lr, True)
    got = _launched_once(swk.pass_batched, lambda: swk.pass_batched(*fwd))
    _equal(got, swk.pass_batched_plain(*fwd))
    rev = (read_at, rl, seg, ref_t.flip(0).contiguous(), fl, got[0], 1, lr,
           False)
    _equal(_launched_once(swk.pass_batched, lambda: swk.pass_batched(*rev)),
           swk.pass_batched_plain(*rev))


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
@pytest.mark.parametrize("p,lq,lr", [(1, 16, 16), (35, 32, 40), (77, 48, 64),
                                     (50, 64, 96), (21, 80, 128),
                                     (131, 96, 100), (30, 112, 128),
                                     (257, 128, 128), (64, 128, 128),
                                     (48, 128, 128)])
def test_sw_pass_kernel_codes_rows_and_early_exits(dev, p, lq, lr, dtype):
    """S = 1 .. 8; odd P, P that is and is not a multiple of a block's 32
    pairs; int8 and int32 codes as they come; with and without max_column;
    terminate = 0 (pairs stop at their first column of maximum 0) and
    ref_len = 0 (no pair runs a column: max_column is all 0)."""
    rng = np.random.default_rng(p + lq)
    read_t, rl, ref_t, fl = (x.to(dev) for x in _pairs(rng, p, lq, lr))
    rl[:3] = torch.tensor([0, 1, min(17, lq)])[:min(3, p)].to(dev)
    read_at, seg = swk._striped_layout_t(read_t, rl, lq)
    read_at, ref_t = read_at.to(dtype), ref_t.to(dtype)
    sat = torch.full((p,), swk.SAT, dtype=torch.int32, device=dev)
    zero = torch.zeros_like(sat)
    for want_mc in (True, False):
        for ref_len, term in ((fl, sat), (fl, zero), (zero, sat)):
            args = (read_at, rl, seg, ref_t, ref_len, term, 0, lr, want_mc)
            got = _launched_once(swk.pass_batched,
                                 lambda: swk.pass_batched(*args))
            _equal(got, swk.pass_batched_plain(*args))
        score1 = swk.pass_batched_plain(read_at, rl, seg, ref_t, fl, sat, 0,
                                        lr, False)[0]
        rev = (read_at, rl, seg, ref_t.flip(0).contiguous(), fl, score1, 1,
               lr, want_mc)
        _equal(_launched_once(swk.pass_batched,
                              lambda: swk.pass_batched(*rev)),
               swk.pass_batched_plain(*rev))
    mc = swk.pass_batched(read_at, rl, seg, ref_t, zero, sat, 0, lr, True)[3]
    assert mc.shape == (lr, p) and not mc.any()


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
@pytest.mark.parametrize("lq,n_cols,n", [(128, 128, 40), (64, 96, 40),
                                         (100, 120, 40), (128, 128, 48),
                                         (128, 128, 64), (128, 128, 333)])
def test_sw_forward_and_reverse_kernels_equal_plain(dev, lq, n_cols, n,
                                                    dtype):
    """The fused entries on the CPU tests' edge pairs (read_len 0, 1, 16,
    17, LQ; ref_len 0; saturating; mask_len 14 and 15; second best on
    either side of the window and at hi + 1; degenerate forward results
    into the reverse pass): one launch each, rows written in place, every
    row equal to the plain versions', the all-M certificate in row 9
    included.  P 64 takes the 16-byte loads, P 48 half fills a block."""
    from torch_helpers import SW_EDGE, sw_edge_pairs
    rc, rls, fc, fls, masks = sw_edge_pairs(lq + n_cols, lq, n_cols, n)
    t = lambda a: torch.from_numpy(a).to(dev)
    read_t = t(rc).T.contiguous().to(dtype)
    ref_t = t(fc).T.contiguous().to(dtype)
    args = (read_t, t(rls), ref_t, t(fls), t(masks), n_cols)
    out = torch.full((10, n), -7, dtype=torch.int32, device=dev)
    assert _launched_once(swk.sw_forward,
                          lambda: swk.sw_forward(*args, out)) is out
    fwd = swk.sw_forward_plain(*args)
    for row, key in ((0, "score1"), (1, "ref_end"), (2, "query_end"),
                     (3, "score2"), (4, "ref_end2"), (8, "overflowed")):
        assert torch.equal(out[row], fwd[key].to(torch.int32)), key
    assert (out[[5, 6, 7, 9]] == -7).all()
    k = SW_EDGE["degenerate into reverse"]
    out[1, k] = out[2, k] = out[1, k + 1] = out[2, k + 2] = -1
    s1, re, qe = out[0].clone(), out[1].clone(), out[2].clone()
    _launched_once(swk.sw_reverse,
                   lambda: swk.sw_reverse(read_t, ref_t, out[0], out[1],
                                          out[2], n_cols, out))
    rev = swk.sw_reverse_plain(read_t, ref_t, s1, re, qe, n_cols)
    for row, key in ((5, "ref_begin"), (6, "query_begin"), (7, "flag2")):
        assert torch.equal(out[row], rev[key].to(torch.int32)), key
    assert torch.equal(out[8] != 0, fwd["overflowed"] | rev["overflowed"])
    diag = swk.diag_fastpath_plain(read_t, ref_t, s1, rev["ref_begin"], re,
                                   rev["query_begin"], qe, out[8] != 0,
                                   n_cols)
    assert torch.equal(out[9] != 0, diag) and diag.any()
    assert torch.equal(out[0], s1) and torch.equal(out[1], re)
    # without a tensor to write into: a new one, rows 0-4 and 8 / 5-8
    fresh = swk.sw_forward(*args)
    assert torch.equal(fresh[:5], torch.stack([fwd[key] for key in (
        "score1", "ref_end", "query_end", "score2", "ref_end2")]))
    fresh = swk.sw_reverse(read_t, ref_t, s1, re, qe, n_cols)
    assert torch.equal(fresh[8] != 0, rev["overflowed"])
    assert torch.equal(fresh[5], rev["ref_begin"])


@pytest.mark.parametrize("read_len", [1, 16, 32, 100, 128])
def test_sw_kernels_on_reads_of_one_length(dev, read_len):
    """Every pair of a warp with the same segLen (the flagship's reads of
    one length): the column loop without the row masks.  Reads planted in
    their 128-base windows with substitutions, a third unrelated."""
    rng = np.random.default_rng(read_len)
    p, lq = 203, 128
    fc = rng.integers(0, 4, (p, lq)).astype(np.int8)
    start = rng.integers(0, lq - read_len + 1, p)
    reads = fc[np.arange(p)[:, None], start[:, None] + np.arange(read_len)]
    sub = rng.random(reads.shape) < 0.03
    reads[sub] = rng.integers(0, 4, int(sub.sum()))
    reads[::3] = rng.integers(0, 4, reads[::3].shape)
    rc = np.full((p, lq), 4, np.int8)
    rc[:, :read_len] = reads
    t = lambda a: torch.from_numpy(a).to(dev)
    read_t, ref_t = t(rc).T.contiguous(), t(fc).T.contiguous()
    rl = torch.full((p,), read_len, dtype=torch.int32, device=dev)
    fl = t(rng.integers(read_len, lq + 1, p).astype(np.int32))
    ml = (rl // 2).clamp(min=15)
    read_at, seg = swk._striped_layout_t(read_t, rl, lq)
    sat = torch.full((p,), swk.SAT, dtype=torch.int32, device=dev)
    args = (read_at.to(torch.int8), rl, seg, ref_t, fl, sat, 0, lq, True)
    _equal(swk.pass_batched(*args), swk.pass_batched_plain(*args))
    out = swk.sw_forward(read_t, rl, ref_t, fl, ml, lq)
    fwd = swk.sw_forward_plain(read_t, rl, ref_t, fl, ml, lq)
    swk.sw_reverse(read_t, ref_t, out[0], out[1], out[2], lq, out)
    rev = swk.sw_reverse_plain(read_t, ref_t, fwd["score1"], fwd["ref_end"],
                               fwd["query_end"], lq)
    ovf = fwd["overflowed"] | rev["overflowed"]
    diag = swk.diag_fastpath_plain(
        read_t, ref_t, fwd["score1"], rev["ref_begin"], fwd["ref_end"],
        rev["query_begin"], fwd["query_end"], ovf, lq)
    want = (fwd["score1"], fwd["ref_end"], fwd["query_end"], fwd["score2"],
            fwd["ref_end2"], rev["ref_begin"], rev["query_begin"],
            rev["flag2"], ovf, diag)
    assert torch.equal(out, torch.stack([x.to(torch.int32) for x in want]))
    assert diag.any() and (read_len < 127 or ovf.any())


@pytest.mark.parametrize("L,size,p", [(128, 128, 300), (96, 128, 33),
                                      (7, 5, 1)])
def test_shift_sub_kernel_equals_plain(dev, L, size, p):
    rng = np.random.default_rng(L)
    x = torch.from_numpy(rng.integers(0, 5, (L, p)).astype(np.int32)).to(dev)
    sh = rng.integers(-1, L + size + 1, p).astype(np.int32)
    sh[0], sh[-1] = -1, L + size
    sh = torch.from_numpy(sh).to(dev)
    got = _launched_once(bk.shift_sub, lambda: bk.shift_sub(x, sh, size))
    assert torch.equal(got, bk.shift_sub_plain(x, sh, size))


@pytest.mark.parametrize("pair_major", [False, True])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
@pytest.mark.parametrize("L,p", [(128, 8192), (96, 1000), (128, 333)])
def test_shift_sub_kernel_takes_both_code_types_and_layouts(dev, L, p, dtype,
                                                            pair_major):
    """int8 and int32 codes as they come (no copy before the launch), the
    [size, P] int32 and the pair-major [P, size] uint8 layouts; P a
    multiple of the 16-byte loads' pairs, and not (the scalar loads)."""
    rng = np.random.default_rng(L + p)
    size = 128
    x = torch.from_numpy(rng.integers(0, 5, (L, p)).astype(np.int32))
    if dtype == torch.int32 and not pair_major:
        x = torch.from_numpy(rng.integers(-2**31, 2**31, (L, p))
                             .astype(np.int32))              # any value
    x = x.to(dtype).to(dev)
    sh = rng.integers(-1, L + size + 1, p).astype(np.int32)
    sh[0], sh[-1] = -1, L + size
    sh = torch.from_numpy(sh).to(dev)
    got = _launched_once(bk.shift_sub,
                         lambda: bk.shift_sub(x, sh, size, pair_major))
    want = bk.shift_sub_plain(x, sh, size, pair_major)
    assert got.dtype == want.dtype and got.is_contiguous()
    assert torch.equal(got, want)
    # a view whose first byte is not 16-byte aligned
    y = torch.cat([x.flatten()[:1], x.flatten()])[1:].view(L, p)
    assert torch.equal(bk.shift_sub(y, sh, size, pair_major), want)


@pytest.mark.parametrize("codes", ["int32", "int8", "int8 rows of a wider "
                                   "tensor", "int32 transposed view"])
@pytest.mark.parametrize("nl,emit", [(128, False), (128, True), (100, True),
                                     (32, True), (200, True)])
def test_fill_kernel_equals_plain(dev, nl, emit, codes):
    """Subregions of scored pairs at first and widened bands, a third of
    the pairs done (their directions are never written).  P = 150, not a
    multiple of the kernel's 32-pair tile.  The first two tiles' pairs
    cycle through band widths on both sides of each lane-count edge
    (2 bw + 1 cells of 3, 7 | 9, 15 | 17, 31 | 33, 63 | 65, 127 | 129 and
    401: 8- and 16-lane segments, band-relative lanes of 1, 2 and 4 cells
    and absolute lanes in one tile), so 8- and 16-lane segments share a
    warp with pairs of other m; some pairs get m = 0 or m = m_max.  Codes
    int8 or int32 as they come, rows of a wider tensor (a row stride of
    their own, no copy) or a transposed view (copied).  Directions of
    rows >= m are 0."""
    rng = np.random.default_rng(nl)
    p, lq = 150, 96
    read_t, rl, ref_t, fl = (x.to(dev) for x in _pairs(rng, p, lq, nl))
    s10 = swdev.ssw_score_packed_t(read_t, rl, ref_t, fl,
                                   (rl // 2).clamp(min=15), nl)
    qb, qe, rb, re = s10[6], s10[2], s10[5], s10[1]
    ok = (s10[0] > 0) & (re >= 0) & (s10[8] == 0)
    qb, rb = torch.where(ok, qb, 0), torch.where(ok, rb, 0)
    m = torch.where(ok, qe - qb + 1, 0)
    r = torch.where(ok, re - rb + 1, 0)
    widen = torch.from_numpy(rng.choice([1, 2, 8], p).astype(np.int32))
    bw = ((r - m).abs() + 1) * widen.to(dev)
    k = torch.arange(p, device=dev)
    edges = torch.tensor([1, 3, 4, 7, 8, 15, 16, 31, 32, 63, 64, 200],
                         dtype=torch.int32, device=dev)
    bw = torch.where(k < 64, edges[k % len(edges)], bw)
    m = torch.where(k % 17 == 5, 0, torch.where(k % 17 == 9, lq, m))
    done = torch.from_numpy((rng.random(p) < 0.33).astype(np.int32)).to(dev)
    live = done == 0
    narrow = live & (k < 32) & (bw <= 3)
    assert len(set(m[narrow].tolist())) > 1           # segments of other m
    sub = [bk.shift_sub(read_t, qb, lq), bk.shift_sub(ref_t, rb, nl)]
    if "int8" in codes:
        sub = [x.to(torch.int8) for x in sub]
    if "wider" in codes:
        wide = [torch.full((x.shape[0], p + 10), 4, dtype=x.dtype,
                           device=dev) for x in sub]
        for w, x in zip(wide, sub):
            w[:, :p] = x
        sub = [w[:, :p] for w in wide]
        assert not sub[0].is_contiguous()
    if "transposed" in codes:
        sub = [x.T.contiguous().T for x in sub]
    args = (*sub, m, r, bw, done, lq, emit)
    best, dirs = _launched_once(bk.fill_pass, lambda: bk.fill_pass(*args))
    best_p, dirs_p = bk.fill_pass_plain(*args)
    assert torch.equal(best, best_p)
    if emit:
        assert torch.equal(dirs[live], dirs_p[live])
        rows = torch.arange(lq, device=dev)[None, :, None]
        assert not torch.where(rows >= m[live][:, None, None], dirs[live],
                               0).any()
    else:
        assert dirs is None and dirs_p is None


@pytest.mark.parametrize("dtype,planted,raises", [
    (torch.int32, 256, True), (torch.int32, -129, True),
    (torch.uint8, 200, True), (torch.int32, 127, False),
    (torch.int32, -128, False)])
def test_fill_kernel_codes_outside_int8(dev, dtype, planted, raises):
    """The kernel keeps codes in int8, where the plain version compares
    them whole: codes outside the int8 range raise on the card, and codes
    inside it other than 0..4 (planted in read and ref alike) equal the
    plain version."""
    rng = np.random.default_rng(3)
    p, lq, nl = 40, 24, 32
    read_t = torch.from_numpy(rng.integers(0, 5, (lq, p))).to(dtype)
    ref_t = torch.from_numpy(rng.integers(0, 5, (nl, p))).to(dtype)
    read_t[::3, ::2] = planted
    ref_t[::3, ::2] = planted
    m = torch.from_numpy(rng.integers(0, lq + 1, p).astype(np.int32))
    r = torch.from_numpy(rng.integers(1, nl + 1, p).astype(np.int32))
    bw = torch.from_numpy(rng.integers(1, 12, p).astype(np.int32))
    done = torch.from_numpy((rng.random(p) < 0.2).astype(np.int32))
    cpu = (read_t, ref_t, m, r, bw, done, lq, True)
    best_p, dirs_p = bk.fill_pass_plain(*cpu)
    args = tuple(x.to(dev) if torch.is_tensor(x) else x for x in cpu)
    if raises:
        with pytest.raises(ValueError, match="must lie in"):
            bk.fill_pass(*args)
        return
    best, dirs = bk.fill_pass(*args)
    live = done == 0
    assert torch.equal(best.cpu(), best_p)
    assert torch.equal(dirs.cpu()[live], dirs_p[live])


def _traceback_case(dev, p, lq, nl, seed):
    rng = np.random.default_rng(seed)
    read_t, rl, ref_t, fl = (x.to(dev) for x in _pairs(rng, p, lq, nl))
    s10 = swdev.ssw_score_packed_t(read_t, rl, ref_t, fl,
                                   (rl // 2).clamp(min=15), nl)
    qb, qe, rb, re = s10[6], s10[2], s10[5], s10[1]
    need = ~((s10[9] != 0) | (s10[8] != 0) | (s10[0] == 0) | (re < 0))
    # every fourth pair: bounds of its own (m from -1, r from 0), failed
    # walks among them; every fifth: a score out of reach, so the band
    # doubles to the end
    k = torch.arange(p, device=dev)
    rnd = lambda lo, hi: torch.from_numpy(rng.integers(lo, hi, p).astype(
        np.int32)).to(dev)
    odd = k % 4 == 3
    qb = torch.where(odd, rnd(0, lq // 2), qb)
    qe = torch.where(odd, qb + rnd(-2, lq // 2), qe)
    rb = torch.where(odd, rnd(0, nl // 2), rb)
    re = torch.where(odd, rb + rnd(-1, nl // 2), re)
    score1 = torch.where(k % 5 == 4, s10[0] + 1000, s10[0])
    read_s = bk.shift_sub(read_t.to(torch.int8), qb, lq, True)
    ref_s = bk.shift_sub(ref_t, rb, nl, True)
    return read_s, ref_s, qe - qb + 1, re - rb + 1, score1, need | odd


@pytest.mark.parametrize("mode", ["fused", "staged", "nothing needed"])
@pytest.mark.parametrize("p,lq,nl", [(301, 128, 128), (150, 96, 32),
                                     (77, 64, 64), (130, 96, 200),
                                     (64, 128, 256), (1, 40, 100)])
def test_traceback_kernel_equals_plain(dev, p, lq, nl, mode, monkeypatch):
    """One launch per traceback: entries, status and final widths of the
    fused kernel == traceback_plain, NL of every lane count, m_max != NL,
    odd P, an empty need mask, bands in shared memory and (with a small
    share) in the scratch buffer."""
    read_s, ref_s, m, r, score1, need = _traceback_case(dev, p, lq, nl,
                                                        p + nl)
    kw = {"fused": dict(n_entries=48, need=need, run_cap=63,
                        entry_dtype=torch.uint8),
          "staged": dict(n_entries=64),
          "nothing needed": dict(n_entries=48, need=torch.zeros_like(need),
                                 run_cap=63)}[mode]
    want = bk.traceback_plain(read_s, ref_s, m, r, score1, **kw)
    spilled = []
    for cells in (bk.TB_SMEM_CELLS, 256, 0):
        monkeypatch.setattr(bk, "TB_SMEM_CELLS", cells)
        *got, n_spilled = _launched_once(bk.traceback, lambda: bk.traceback(
            read_s, ref_s, m, r, score1, return_spilled=True, **kw))
        _equal(got, want)
        spilled.append(int(n_spilled))
    if mode == "nothing needed":
        assert spilled == [0, 0, 0] and not want[0].any()
    else:
        assert spilled[0] <= spilled[1] <= spilled[2]
        assert spilled[2] > 0 or p == 1
    if mode == "staged" and p > 100:
        assert (want[1] == 1).any() and (want[2] > (r - m).abs() + 1).any()


def test_numpy_entry_points_default_to_the_card(dev):
    """ssw_score_batch and banded_traceback_batch run on the card when no
    device is named, and give what the CPU gives."""
    rng = np.random.default_rng(12)
    read_t, rl, ref_t, fl = _pairs(rng, 90, 128, 128)
    rc = read_t.T.contiguous().numpy().astype(np.int8)
    fc = ref_t.T.contiguous().numpy().astype(np.int8)
    args = (rc, rl.numpy(), fc, fl.numpy(), np.maximum(15, rl.numpy() // 2))
    before = swk.sw_forward.launches, swk.sw_reverse.launches
    card = swdev.ssw_score_batch(*args)
    assert (swk.sw_forward.launches, swk.sw_reverse.launches) == (
        before[0] + 1, before[1] + 1)
    host = swdev.ssw_score_batch(*args, "cpu")
    for key in host:
        np.testing.assert_array_equal(card[key], host[key], key)
    tb = (rc, host["query_begin"], host["query_end"], fc, host["ref_begin"],
          host["ref_end"], host["score1"])
    before = bk.traceback.launches
    ops, status = bandtb.banded_traceback_batch(*tb)
    assert bk.traceback.launches == before + 1
    ops_h, status_h = bandtb.banded_traceback_batch(*tb, "cpu")
    np.testing.assert_array_equal(ops, ops_h)
    np.testing.assert_array_equal(status, status_h)


def test_score_rows_and_traceback_card_equals_cpu(dev):
    """ssw_score_packed_t and fused_traceback_t, every kernel on the
    card, against the same functions on the CPU (plain versions)."""
    rng = np.random.default_rng(9)
    pairs = _pairs(rng, 260, 128, 128)
    outs = []
    for d in (dev, torch.device("cpu")):
        read_t, rl, ref_t, fl = (x.to(d) for x in pairs)
        s10 = swdev.ssw_score_packed_t(read_t, rl, ref_t, fl,
                                       (rl // 2).clamp(min=15), 128)
        outs.append([s10, *bandtb.fused_traceback_t(read_t, ref_t, s10)])
    for c, h in zip(*outs):
        assert c.dtype == h.dtype and torch.equal(c.cpu(), h)
    assert (outs[1][2] == 0).any() and (outs[1][0][9] == 0).any()


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros((4, 2, 40), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="wr=17"):
        sk.shd_best(x, x, x[:, :, :17], x[:, :, :17], x[:, 0, :17],
                    torch.zeros((4, 2), dtype=torch.int32, device=dev),
                    32, 40, 17)
    with pytest.raises(ValueError, match="F\\*C"):
        vk.vote_candidates_fnc(torch.zeros((64, 2, 512), dtype=torch.int64,
                                           device=dev), 1, 4)
    with pytest.raises(ValueError, match="one CUDA device"):
        mk.sigs_from_bases(torch.zeros((2, 20), dtype=torch.int8,
                                       device=dev),
                           torch.zeros(2, dtype=torch.int32), 16,
                           torch.zeros(1, dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="read past the anchor"):
        sk.shd_hamming_matrix(x[:, :, :3], x[:, :, :3], x[:, :, :2],
                              x[:, :, :2], x[:, 0, :2], 64, 3, 2)
    with pytest.raises(ValueError, match="one CUDA device"):
        mk.sig_min_murmur(torch.zeros((2, 5), dtype=torch.int64, device=dev),
                          torch.zeros(2, dtype=torch.int32), 16,
                          torch.zeros(1, dtype=torch.int64, device=dev))
    big = torch.tensor([0, 2**32], dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="hash ids must lie"):
        mk.sigs_from_bases(torch.zeros((2, 20), dtype=torch.int8,
                                       device=dev),
                           torch.zeros(2, dtype=torch.int32, device=dev), 16,
                           big)
    with pytest.raises(ValueError, match="hash ids must lie"):
        mk.sig_min_murmur(torch.zeros((2, 5), dtype=torch.int64, device=dev),
                          torch.zeros(2, dtype=torch.int32, device=dev), 16,
                          big)
    ok = torch.tensor([0, 2**32 - 1], dtype=torch.int64, device=dev)
    mk.signature_stage(torch.zeros((2, 20), dtype=torch.int8, device=dev),
                       torch.zeros(2, dtype=torch.int32, device=dev), 16, ok)
    ok[1] = 2**32                    # a new version of a checked tensor
    with pytest.raises(ValueError, match="hash ids must lie"):
        mk.signature_stage(torch.zeros((2, 20), dtype=torch.int8,
                                       device=dev),
                           torch.zeros(2, dtype=torch.int32, device=dev), 16,
                           ok)
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="S=9"):
        swk.pass_batched(z(9, 16, 4), z(4), z(4), z(8, 4), z(4), z(4), 0, 8,
                         False)
    with pytest.raises(ValueError, match="LQ=129"):
        swk.sw_forward(z(129, 4), z(4), z(8, 4), z(4), z(4), 8)
    with pytest.raises(ValueError, match=r"out must be \[10, P\] int32"):
        swk.sw_reverse(z(16, 4), z(8, 4), z(4), z(4), z(4), 8, z(4, 4))
    with pytest.raises(ValueError, match="NL=300"):
        bk.fill_pass(z(8, 4), z(300, 4), z(4), z(4), z(4), z(4), 8, False)
    u8 = lambda *shape: torch.zeros(shape, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="NL=300"):
        bk.traceback(u8(4, 8), u8(4, 300), z(4), z(4), z(4), 48)
    with pytest.raises(ValueError, match="uint8 read_s"):
        bk.traceback(z(4, 8), z(4, 8), z(4), z(4), z(4), 48)
    with pytest.raises(ValueError, match="run_cap"):
        bk.traceback(u8(4, 8), u8(4, 8), z(4), z(4), z(4), 48,
                     entry_dtype=torch.uint8)


def test_a_capture_that_reads_back_raises(dev):
    """A step that reads a value back to the host cannot be captured: the
    capture raises, and nothing runs the step eagerly instead.  (Last in
    the file: a failed capture may leave the card's capture stream
    unusable for the rest of the process.)"""
    from hashreadmapper_tpu_torch.pipeline import graphs
    step = graphs.CapturedStep((torch.zeros(8, device=dev),))
    with pytest.raises(RuntimeError):
        step.run(lambda x: (x * int(x.sum().item() + 1),),
                 torch.ones(8, device=dev))
    assert step.graph is None
