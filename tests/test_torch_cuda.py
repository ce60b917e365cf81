"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at small edge shapes (production shapes run in chip_smoke.py).

Needs a CUDA card and nvcc; skipped without a card.  Imports no jax, so
it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from hashreadmapper_tpu_torch.ops import minhash_kernel as mk
from hashreadmapper_tpu_torch.ops import shd_kernel as sk
from hashreadmapper_tpu_torch.ops import vote_kernel as vk

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


@pytest.mark.parametrize("k,mode", [(8, "fwd"), (12, "both"), (16, "canon"),
                                    (16, "both"), (5, "fwd")])
def test_minhash_kernel_equals_plain(dev, k, mode):
    rng = np.random.default_rng(k)
    bases = torch.from_numpy(rng.integers(0, 4, size=(300, 45),
                                          dtype=np.int8)).to(dev)
    lens = rng.integers(0, 60, size=300).astype(np.int32)
    lens[:4] = [0, k - 1, k, 45]
    lens = torch.from_numpy(lens).to(dev)
    hid = torch.tensor([0, 1, 9, 2**32 - 1], dtype=torch.int64, device=dev)
    got = _launched_once(mk.sigs_from_bases, lambda: mk.sigs_from_bases(
        bases, lens, k, hid, mode))
    want = mk.sigs_from_bases_plain(bases, lens, k, hid, mode)
    assert torch.equal(got, want)


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
