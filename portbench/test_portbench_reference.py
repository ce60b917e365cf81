"""The plain reference: batches mapped several at a time give what one
at a time gives, the pair budget counted per batch."""

import numpy as np
import torch

from portbench import inputs
from portbench.check import reference_options
from portbench.reference import coarse, sw


def test_grouped_compaction_is_the_per_batch_compaction():
    g = torch.Generator().manual_seed(3)
    seg_len, slots, segs = 96, 20, 5
    valid = torch.rand(seg_len * segs, generator=g) < 0.3
    sel, sv, drops = coarse.compact_pairs(valid, seg_len, slots)
    want_sel, want_sv, want_drops = [], [], 0
    for k in range(segs):
        s, v, d = coarse.compact_pairs(valid[k * seg_len:(k + 1) * seg_len],
                                       seg_len, slots)
        want_sel.append(s + k * seg_len)
        want_sv.append(v)
        want_drops += int(d)
    assert want_drops > 0
    assert int(drops) == want_drops
    assert torch.equal(sv, torch.cat(want_sv))
    assert torch.equal(sel[sv], torch.cat(want_sel)[torch.cat(want_sv)])
    # every kept slot is a valid pair, each once, in grid order per batch
    kept = sel[sv]
    assert bool(valid[kept].all()) and len(set(kept.tolist())) == len(kept)


def test_grouped_batches_map_as_single_batches():
    cfg = {"genome": {"chromosomes": [["c", 200_000]]}}
    mix = {"pool": 3000, "length": 101, "variants": 0.002, "errors": 0.01,
           "strands": [["fwd", "ct"], ["rc", "ct"], ["fwd", "ga"],
                       ["rc", "ga"]], "assign": "cycle", "conversion": 0.9,
           "junk": 0.1}
    flags = ["--threeN", "--undirectional", "-k", "16", "-m", "16",
             "--windowSize", "128", "--minTableHits", "4",
             "--maxHammingPercent", "0.05", "--maxReadLength", "128",
             "--probeCap", "8", "--candidatesPerRead", "32",
             "--shdPairBudget", "1"]
    cpu = torch.device("cpu")
    _, chroms = inputs.make_genome(cfg, 11, cpu)
    bases, lengths, _ = inputs.make_reads(mix, chroms, 11, cpu)
    m = coarse.ReferenceMapper(chroms, reference_options(
        flags, batchsize=256), cpu)
    p1, o1 = m.map_reads(bases, lengths, group=1)
    p4, o4 = m.map_reads(bases, lengths, group=4)
    assert np.array_equal(p1, p4) and np.array_equal(o1, o4)
    assert (p1[:, 0] != coarse.NONE).mean() > 0.5


def test_alignments_together_are_the_alignments_one_by_one():
    # pairs of every kind the SAM rows meet: planted with substitutions
    # and indels, unrelated, short windows, 3N strings, an N, and a read
    # long enough for the word pass
    rng = np.random.default_rng(4)

    def seq(n):
        return "".join("ACGT"[b] for b in rng.integers(0, 4, n))
    pairs, masks = [], []
    for k in range(48):
        ref = seq(int(rng.choice([128, 128, 90, 200, 3])))
        if k % 3 and len(ref) > 101:
            o = int(rng.integers(0, len(ref) - 100))
            q = list(ref[o:o + 101])
            for i in rng.choice(101, size=int(rng.integers(0, 5)),
                                replace=False):
                q[i] = "ACGT"[(("ACGT".index(q[i])) + 1) % 4]
            if k % 4 == 1:
                del q[40:42]
            if k % 5 == 2:
                q[60:60] = ["A", "C", "G"]
            q = "".join(q)
        else:
            q = seq(int(rng.choice([101, 64, 17, 1])))
        if k % 6 == 0:
            q, ref = q.replace("C", "T"), ref.replace("C", "T")
        if k % 11 == 0:
            q = "N" + q[1:]
        pairs.append((q, ref))
        masks.append(int(rng.choice([50, 15, 10])))
    ref = seq(200)
    pairs.append((ref[20:170], ref))
    masks.append(75)
    together = sw.ssw_align_many(pairs, masks)
    assert any(a.sw_score > 255 for a in together)
    for (q, r), m, a in zip(pairs, masks, together):
        assert a == sw.ssw_align(q, r, m), (q, r, m)
