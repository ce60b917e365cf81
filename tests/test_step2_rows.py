"""STEP 2's rows (ops/step2rows_kernel.py::step2_rows) on the CPU: the plain
version against the numpy code that pipeline/mapping.py ran on the host
before the rows came from the coarse step (kept here as the oracle); the
rows of the three mappers' bundles against it and against each other; and
the records run_cssw builds from the rows against the serial host path."""

import numpy as np
import pytest
import torch

from hashreadmapper_tpu_torch.align import sw
from hashreadmapper_tpu_torch.config import ProgramOptions
from hashreadmapper_tpu_torch.io.genome import Genome
from hashreadmapper_tpu_torch.io.readstore import ReadStorage, pack_rows
from hashreadmapper_tpu_torch.ops import step2rows_kernel as s2k
from hashreadmapper_tpu_torch.parallel.region_sharded import \
    RegionShardedMapper
from hashreadmapper_tpu_torch.parallel.sharded import (ShardedCoarseMapper,
                                                       make_mesh)
from hashreadmapper_tpu_torch.pipeline import mapping
from hashreadmapper_tpu_torch.pipeline.engine import (CoarseMapper,
                                                     Step2Rows,
                                                     build_step2_genome)
from hashreadmapper_tpu_torch.pipeline.records import emit_sam

from torch_helpers import ACGT, four_strand_reads, step2_rows_case

_B4 = np.frombuffer(b"ACGT", dtype=np.uint8)
FORWARD, REVERSE_COMPLEMENT, NONE = 1, 2, 3


def _windows(genome, genome_rc, position, chromosome_id, ws):
    """The window and RC-window slices of every read (the host's code,
    mapping._window_views batched): (win [n, ws] uint8, win_rc, wlens)."""
    n = len(position)
    win = np.zeros((n, ws), np.uint8)
    win_rc = np.zeros((n, ws), np.uint8)
    wlens = np.zeros(n, np.int64)
    iw = np.arange(ws, dtype=np.int32)
    for c in np.unique(chromosome_id):
        rows = np.nonzero(chromosome_id == c)[0]
        seq = genome.seqs_ascii[int(c)]
        seq_rc = genome_rc.seqs_ascii[int(c)]
        size = len(seq)
        p = position[rows].astype(np.int32)
        wl = np.where(p + ws < size, ws, size - p)
        g = p[:, None] + iw[None, :]
        v = iw[None, :] < wl[:, None]
        win[rows] = np.where(v, seq[np.minimum(g, size - 1)], 0)
        g2 = (size - p - 1).astype(np.int32)[:, None] + iw[None, :]
        win_rc[rows] = np.where(v & (g2 < size),
                                seq_rc[np.minimum(g2, size - 1)], 0)
        wlens[rows] = wl
    return win, win_rc, wlens


def numpy_rows(genome, mat, lens, orientation, position, chromosome_id,
               bs_strand, ws) -> Step2Rows:
    """The rows as the host built them from the read codes mat [n, lq]:
    bs_strand is run_cssw's mask (strand 1 in FORWARD orientation)."""
    lq = mat.shape[1]
    lens32 = lens.astype(np.int32)
    idx = np.arange(lq, dtype=np.int32)
    valid = idx[None, :] < lens32[:, None]
    rev_idx = np.maximum(lens32[:, None] - 1 - idx[None, :], 0)
    rc_of = lambda a: np.where(
        valid, 3 - np.take_along_axis(a, rev_idx, 1), 0)
    fwd_mat = np.where((orientation == REVERSE_COMPLEMENT)[:, None],
                       rc_of(mat), mat)
    rcq_mat = rc_of(fwd_mat)
    win, win_rc, wlens = _windows(genome, genome.reverse_complement(),
                                  position, chromosome_id, ws)
    und = bool(bs_strand.any())
    sc = (bs_strand != 0)[:, None]

    def collapse(a):
        ct = np.where(a == 1, 3, a)
        if not und:
            return ct.astype(np.int8)
        return np.where(sc, np.where(a == 2, 0, a), ct).astype(np.int8)
    q3 = np.empty((2 * len(lens), lq), np.int8)
    q3[0::2] = collapse(fwd_mat)
    q3[1::2] = collapse(rcq_mat)
    return Step2Rows(q=_B4[fwd_mat], rcq=_B4[rcq_mat], win=win,
                     win_rc=win_rc, wlen=wlens.astype(np.int32), q3=q3,
                     win3=collapse(sw.TRANSLATE[win]))


def _assert_rows_equal(got: Step2Rows, want: Step2Rows, label=""):
    for name, g, w in zip(Step2Rows._fields, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == w.dtype, (label, name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{label} {name}")


@pytest.mark.parametrize("undirectional", [False, True],
                         ids=["directional", "undirectional"])
@pytest.mark.parametrize("lq,ws", [(72, 64), (33, 128)])
def test_plain_rows_equal_the_numpy_rows(undirectional, lq, ws):
    """Every edge case of torch_helpers.step2_rows_case, and the score
    passes' transposed pairs are the 3N rows."""
    genome, bases, lens, packed = step2_rows_case(lq + ws, lq, ws)
    opts = ProgramOptions(window_size=ws, max_read_length=lq)
    s2 = build_step2_genome(genome, opts, "cpu")
    chrom_len = torch.tensor([genome.chromosome_length(c) for c in (0, 1)])
    out = s2k.step2_rows(torch.from_numpy(bases), torch.from_numpy(lens),
                         torch.from_numpy(packed), s2.offset, chrom_len,
                         s2.letters, s2.translate, s2.complement, ws,
                         undirectional)
    pair_q_t, pair_ref_t, rows = out[0], out[1], Step2Rows(*out[2:])
    ori = packed[:, 0]
    strand = ((packed[:, 6] != 0) & (ori == FORWARD) if undirectional
              else np.zeros(len(ori), bool)).astype(np.int8)
    want = numpy_rows(genome, bases, lens, ori, packed[:, 4], packed[:, 3],
                      strand, ws)
    _assert_rows_equal(rows, want)
    assert torch.equal(pair_q_t, rows.q3.T)
    assert torch.equal(pair_ref_t, rows.win3.repeat_interleave(2, dim=0).T)
    # the cases are there: a cut window, a clipped RC window, N and IUPAC
    # letters, the G->A collapse of the mirrored read only
    assert want.wlen[0] == 50 and not want.win[0, 50:].any()
    assert (want.win_rc[1, :6] != 0).all() and not want.win_rc[1, 6:].any()
    assert {ord("N"), ord("R"), ord("Y")} <= set(want.win[2].tolist())
    assert (want.win3[2] == 4).sum() >= 4
    if undirectional:     # row 4 mirrored (its pairs 8, 9), row 5 not
        assert not (want.q3[8:10] == 2).any()
        assert not (want.win3[4] == 2).any() and (want.win3[5] == 2).any()


def _dataset(und, seed=5):
    """(genome, opts, store, padded, lengths): 3N reads of 72 bp (C->T, or
    the four strands under --undirectional) against a 20 kbp chromosome
    with Ns, and 12 junk reads."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=20_000, dtype=np.int8)
    reads, lengths, _, _ = four_strand_reads(rng, codes, 20, read_len=72,
                                             conv=0.8)
    if not und:
        keep = np.isin(np.arange(len(lengths)) // 20, [0, 1])
        reads, lengths = reads[keep], lengths[keep]
    junk = rng.integers(0, 4, size=(12, 72), dtype=np.int8)
    reads = np.concatenate([reads, junk])
    lengths = np.concatenate([lengths, np.full(12, 72, lengths.dtype)])
    lengths[::7] -= 9
    chrom = ACGT[codes]
    chrom[rng.integers(0, len(chrom), size=40)] = "N"
    genome = Genome(["chrF"], ["".join(chrom)])
    opts = ProgramOptions(
        kmer_length=16, num_hash_functions=8, window_size=128,
        min_table_hits=2, batchsize=32, max_hamming_percent=0.5,
        probe_cap=16, candidates_per_read_cap=8, max_read_length=96,
        threads=2, three_n_seeding=True, undirectional=und)
    padded = np.zeros((len(lengths), 96), np.int8)
    for i, n in enumerate(lengths):
        padded[i, :n] = reads[i, :n]
    store = ReadStorage(pack_rows(padded[:, :72], lengths, (72 + 15) // 16),
                        lengths, np.zeros(len(lengths), bool))
    return genome, opts, store, padded, lengths


@pytest.fixture(scope="module", params=[False, True],
                ids=["directional", "undirectional"])
def mapped(request):
    genome, opts, store, padded, lengths = _dataset(request.param)
    mapper = CoarseMapper(genome, opts, "cpu")
    res, bundle = mapper.map_reads(padded, lengths, with_scores=True)
    return genome, opts, store, padded, lengths, res, bundle


def test_bundle_rows_equal_the_numpy_rows(mapped):
    """map_reads' bundle carries every read's rows, trimmed to the reads,
    as the host built them from the reads' codes at the staged width and
    the coarse rows."""
    genome, opts, store, padded, lengths, res, bundle = mapped
    strand = ((res.bs_strand != 0)
              & (res.orientation == FORWARD)).astype(np.int8)
    mat = store.bases_matrix()
    np.testing.assert_array_equal(padded[:, :mat.shape[1]], mat)
    want = numpy_rows(genome, padded, lengths, res.orientation, res.position,
                      res.chromosome_id, strand, opts.window_size)
    _assert_rows_equal(bundle.rows, want)
    assert len(bundle) == 3 and bundle[0].shape == (10, 2 * len(lengths))
    assert (res.orientation == NONE).any() and (res.orientation == 2).any()
    assert not opts.undirectional or strand.any()


def test_records_equal_the_host_oracle(mapped, tmp_path):
    """run_cssw on the bundle: the records' rows are the bundle's, and the
    alignments, query and window of every read and the SAM bytes are the
    serial host path's."""
    genome, opts, store, _, _, res, bundle = mapped
    genome_rc = genome.reverse_complement()
    args = (genome, genome_rc, res.orientation, res.position,
            res.chromosome_id, store, opts)
    rec = mapping.run_cssw(*args, res.bs_strand, bundle)
    assert rec.q is bundle.rows.q and rec.win is bundle.rows.win
    strand = ((res.bs_strand != 0)
              & (res.orientation == FORWARD)).astype(np.int8)
    host = mapping._run_cssw_host(*args, strand)
    got = rec.to_aas()
    for a, h in zip(got, host):
        assert (a.query, a.ref, a.window_length, a.flag, a.flag_rc,
                list(a.num_conversions)) == (
            h.query, h.ref, h.window_length, h.flag, h.flag_rc,
            list(h.num_conversions)), h.read_id
        for x, y in zip(a.alignments, h.alignments):
            assert (x.sw_score, x.sw_score_next_best, x.query_begin,
                    x.cigar_string) == (y.sw_score, y.sw_score_next_best,
                                        y.query_begin, y.cigar_string)
    emit_sam(rec, genome, str(tmp_path / "dev.SAM"))
    mapping.print_to_sam(host, genome, str(tmp_path / "host.SAM"))
    assert (tmp_path / "dev.SAM").read_bytes() == \
        (tmp_path / "host.SAM").read_bytes()


def _two_chromosomes():
    """chrA (2,500 bases) before the longer chrB (4,000): binning whole
    chromosomes puts chrB in the first region, chrA (chromosome 0) in the
    second.  3N reads of 72 bp from both, 10 junk."""
    rng = np.random.default_rng(11)
    seqs = [rng.integers(0, 4, size=n, dtype=np.int8) for n in (2500, 4000)]
    reads = []
    for codes in seqs:
        starts = rng.integers(0, len(codes) - 72, size=24)
        reads.append(np.stack([codes[s:s + 72] for s in starts]))
    reads = np.concatenate(reads + [rng.integers(0, 4, size=(10, 72),
                                                 dtype=np.int8)])
    rc = rng.random(len(reads)) < 0.5
    reads[rc] = 3 - reads[rc, ::-1]
    conv = (reads == 1) & (rng.random(reads.shape) < 0.8)
    reads[conv] = 3
    lengths = np.full(len(reads), 72, np.int32)
    padded = np.pad(reads, ((0, 0), (0, 24))).astype(np.int8)
    genome = Genome(["chrA", "chrB"],
                    ["".join(ACGT[c]) for c in seqs])
    opts = ProgramOptions(
        kmer_length=16, num_hash_functions=8, window_size=128,
        min_table_hits=2, batchsize=32, max_hamming_percent=0.5,
        probe_cap=16, candidates_per_read_cap=8, max_read_length=96,
        threads=2, three_n_seeding=True)
    return genome, opts, padded, lengths


@pytest.mark.parametrize("n_regions,partition", [(3, "window"),
                                                 (2, "chromosome")])
def test_region_rows_equal_the_single_mapper(n_regions, partition):
    """RegionShardedMapper's merged bundle: a read mapped at the single
    mapper's position has its rows from the region that won it, an
    unmapped read those of chromosome 0 at position 0 (the chromosome
    partition stages chromosome 0 in its second region), both equal to the
    single mapper's rows."""
    genome, opts, padded, lengths = _two_chromosomes()
    single, s_bundle = CoarseMapper(genome, opts, "cpu").map_reads(
        padded.copy(), lengths.copy(), with_scores=True)
    mapper = RegionShardedMapper(genome, opts, n_regions, devices=["cpu"],
                                 partition=partition)
    if partition == "chromosome":
        assert mapper.regions[0][0].chrom_id == 1
    got, bundle = mapper.map_reads(padded.copy(), lengths.copy(),
                                   with_scores=True)
    same = ((got.orientation == single.orientation)
            & (got.chromosome_id == single.chromosome_id)
            & (got.position == single.position))
    assert same.sum() > 0.9 * len(lengths)
    assert (single.orientation[same] == NONE).sum() >= 5
    assert (single.orientation[same] != NONE).sum() >= 30
    reads = np.nonzero(same)[0]
    pairs = np.sort(np.concatenate([2 * reads, 2 * reads + 1]))
    for name, g, w in zip(Step2Rows._fields, bundle.rows, s_bundle.rows):
        sel = pairs if name == "q3" else reads
        np.testing.assert_array_equal(g[sel], w[sel], err_msg=name)


def test_mesh_rows_equal_the_single_mapper():
    """ShardedCoarseMapper's bundle over a 2 x 2 CPU mesh carries the
    single mapper's rows, in read order."""
    genome, opts, padded, lengths = _two_chromosomes()
    _, want = CoarseMapper(genome, opts, "cpu").map_reads(
        padded.copy(), lengths.copy(), with_scores=True)
    _, got = ShardedCoarseMapper(genome, opts, make_mesh(
        2, 2, ["cpu"] * 4)).map_reads(padded.copy(), lengths.copy(),
                                      with_scores=True)
    for name, g, w in zip(Step2Rows._fields, got.rows, want.rows):
        np.testing.assert_array_equal(g, w, err_msg=name)
