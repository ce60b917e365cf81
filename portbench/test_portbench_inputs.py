"""The read and genome generators: the same seed gives the same inputs,
and the recipe is what the traffic file says."""

import numpy as np
import pytest
import torch

from portbench import inputs

CONFIG = {"genome": {"chromosomes": [["a", 50_000], ["b", 20_000]]}}
MIX = {"pool": 4000, "length": 101, "variants": 0.002, "errors": 0.01,
       "strands": [["fwd", "ct"], ["rc", "ct"], ["fwd", "ga"], ["rc", "ga"]],
       "assign": "cycle", "conversion": 0.9, "junk": 0.1}


def _make(seed):
    names, chroms = inputs.make_genome(CONFIG, seed, torch.device("cpu"))
    return names, chroms, inputs.make_reads(MIX, chroms, seed,
                                            torch.device("cpu"))


def test_same_seed_same_inputs_and_large_seeds():
    seed = 2**31 + 17
    _, c1, (b1, l1, t1) = _make(seed)
    _, c2, (b2, l2, t2) = _make(seed)
    assert all(np.array_equal(x, y) for x, y in zip(c1, c2))
    assert np.array_equal(b1, b2) and np.array_equal(l1, l2)
    assert all(np.array_equal(t1[k], t2[k]) for k in t1)
    _, c3, (b3, _, _) = _make(seed + 1)
    assert not np.array_equal(b1, b3)
    assert [len(c) for c in c1] == [50_000, 20_000]


def test_recipe():
    _, chroms, (bases, lengths, truth) = _make(5)
    assert bases.shape == (4000, 101) and bases.dtype == np.int8
    assert (lengths == 101).all() and bases.min() >= 0 and bases.max() <= 3
    assert np.array_equal(truth["strand"], np.arange(4000) % 4)
    assert 0.05 < truth["junk"].mean() < 0.15
    ok = ~truth["junk"]
    # C->T strands keep few C, G->A strands few G
    ct = ok & (truth["strand"] < 2)
    ga = ok & (truth["strand"] >= 2)
    assert (bases[ct] == 1).mean() < 0.05 < (bases[ct] == 2).mean()
    assert (bases[ga] == 2).mean() < 0.05 < (bases[ga] == 1).mean()
    # a forward read is its genome slice up to variants, errors and
    # conversion
    i = int(np.flatnonzero(ok & (truth["strand"] == 0))[0])
    c, s = int(truth["chromosome"][i]), int(truth["start"][i])
    ref = chroms[c][s:s + 101].copy()
    ref[ref == 1] = 3
    read = bases[i].copy()
    read[read == 1] = 3
    assert (read != ref).mean() < 0.06


def test_variants_and_errors_are_at_their_rates():
    cpu = torch.device("cpu")
    _, chroms = inputs.make_genome(CONFIG, 9, cpu)
    ref = np.concatenate(chroms).view(np.uint8)
    sample = inputs.sample_genome(chroms, 0.01, 9, cpu).numpy()
    assert (sample != ref).sum() == pytest.approx(700, abs=10)
    mix = dict(MIX, strands=[["fwd", "none"]], assign="random",
               conversion=0.0, junk=0.0, variants=0.0, errors=0.01)
    bases, _, truth = inputs.make_reads(mix, chroms, 9, cpu)
    off = np.concatenate([[0], np.cumsum([len(c) for c in chroms])[:-1]])
    at = (off[truth["chromosome"]] + truth["start"])[:, None] + np.arange(101)
    # every error is another base: the share is the rate itself
    assert (bases != ref[at]).mean() == pytest.approx(0.01, rel=0.1)
    # with variants only, a read differs exactly at the sample's sites
    mix.update(variants=0.01, errors=0.0)
    bases, _, truth = inputs.make_reads(mix, chroms, 9, cpu)
    at = (off[truth["chromosome"]] + truth["start"])[:, None] + np.arange(101)
    assert np.array_equal(bases, sample[at].astype(np.int8))
