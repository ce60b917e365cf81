"""Struct-of-arrays STEP-2 result + bulk SAM/VCF emit (records mode).

The reference emits SAM/VCF with serial per-read writers
(reference: src/gpu/mappinghandler.cu:196-293 printtoSAM,
src/varianthandler.cpp:124-158 VariantHandler flush).  The AlignerArguments
object list in pipeline/mapping.py replicates that faithfully and stays the
oracle; this module is the production path: the device STEP-2 results stay
as flat numpy arrays end-to-end and the writers are native batch emitters
(native/emit.cpp), byte-identical to the oracle writers
(tests/test_records_emit.py).

Per-read layout (n reads, pair p = 2*r + h with h=0 the query alignment and
h=1 the RC-query alignment, mirroring AlignerArguments.alignments):
  q        [n, lq] uint8   query ASCII (read, RC'd in place when the coarse
                           orientation was ReverseComplement)
  win      [n, ws] uint8   the 128-base genome window ASCII
  sw/nb/qb/conv [2n] int32 post-rescore scores, next-best, query_begin,
                           bisulfite conversion counts
  cig_pool/off/len         pooled CIGAR bytes per pair
  flag0/flag1 [n]          s_align flags (flag0 carries 0x4 for unmapped)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .. import native


@dataclass
class MappingRecords:
    n: int
    lq: int
    ws: int
    q: np.ndarray          # [n, lq] uint8 ascii
    q_len: np.ndarray      # [n] int32
    win: np.ndarray        # [n, ws] uint8 ascii
    win_len: np.ndarray    # [n] int32
    position: np.ndarray   # [n] int64
    chrom: np.ndarray      # [n] int32
    flag0: np.ndarray      # [n] int32
    flag1: np.ndarray      # [n] int32
    sw: np.ndarray         # [2n] int32
    nb: np.ndarray         # [2n] int32
    qb: np.ndarray         # [2n] int32
    conv: np.ndarray       # [2n] int32
    cig_pool: np.ndarray   # [sum cig_len] uint8
    cig_off: np.ndarray    # [2n] int64
    cig_len: np.ndarray    # [2n] int32
    qual: Optional[np.ndarray] = None  # [n, lq] uint8 ascii or None

    @staticmethod
    def concat(parts: List["MappingRecords"]) -> "MappingRecords":
        if len(parts) == 1:
            return parts[0]
        lq = max(p.lq for p in parts)
        ws = max(p.ws for p in parts)

        def padded(name, stride_attr, stride):
            rows = []
            for p in parts:
                a = getattr(p, name)
                s = getattr(p, stride_attr)
                if s < stride:
                    a = np.pad(a, ((0, 0), (0, stride - s)))
                rows.append(a)
            return np.concatenate(rows, axis=0)

        has_qual = all(p.qual is not None for p in parts)
        cig_lens = [int(p.cig_len.sum()) for p in parts]
        off_base = np.cumsum([0] + cig_lens[:-1])
        return MappingRecords(
            n=sum(p.n for p in parts), lq=lq, ws=ws,
            q=padded("q", "lq", lq),
            q_len=np.concatenate([p.q_len for p in parts]),
            win=padded("win", "ws", ws),
            win_len=np.concatenate([p.win_len for p in parts]),
            position=np.concatenate([p.position for p in parts]),
            chrom=np.concatenate([p.chrom for p in parts]),
            flag0=np.concatenate([p.flag0 for p in parts]),
            flag1=np.concatenate([p.flag1 for p in parts]),
            sw=np.concatenate([p.sw for p in parts]),
            nb=np.concatenate([p.nb for p in parts]),
            qb=np.concatenate([p.qb for p in parts]),
            conv=np.concatenate([p.conv for p in parts]),
            cig_pool=np.concatenate([p.cig_pool for p in parts]),
            cig_off=np.concatenate(
                [p.cig_off + b for p, b in zip(parts, off_base)]),
            cig_len=np.concatenate([p.cig_len for p in parts]),
            qual=(padded("qual", "lq", lq) if has_qual else None))

    def to_aas(self):
        """Oracle converter: rebuild the AlignerArguments list the serial
        writers consume (host fallback for environments without the native
        emitters; also the byte-identity test bridge)."""
        from ..align.sw import Alignment
        from .mapping import AlignerArguments

        q_all = self.q.tobytes().decode("latin1")
        win_all = self.win.tobytes().decode("latin1")
        cig_all = self.cig_pool.tobytes().decode("latin1")
        out = []
        for r in range(self.n):
            aa = AlignerArguments()
            aa.read_id = r
            aa.query = q_all[r * self.lq:r * self.lq + int(self.q_len[r])]
            aa.ref = win_all[r * self.ws:r * self.ws + int(self.win_len[r])]
            aa.window_length = int(self.win_len[r])
            aa.position = int(self.position[r])
            aa.chromosome_id = int(self.chrom[r])
            aa.flag = int(self.flag0[r])
            aa.flag_rc = int(self.flag1[r])
            als = []
            for h in (0, 1):
                p = 2 * r + h
                o = int(self.cig_off[p])
                als.append(Alignment(
                    sw_score=int(self.sw[p]),
                    sw_score_next_best=int(self.nb[p]),
                    query_begin=int(self.qb[p]),
                    cigar_string=cig_all[o:o + int(self.cig_len[p])],
                    flag=(int(self.flag0[r]) if h == 0
                          else int(self.flag1[r]))))
            aa.alignments = als
            aa.num_conversions = [int(self.conv[2 * r]),
                                  int(self.conv[2 * r + 1])]
            if self.qual is not None:
                ql = int(self.q_len[r])
                row = self.qual[r, :ql]
                aa.qual = ("" if ql == 0 or row[0] == 0
                           else row.tobytes().decode("latin1"))
            out.append(aa)
        return out


def _names_arrays(genome):
    names = [genome.names[c].encode("latin1")
             for c in range(genome.num_chromosomes)]
    pool = b"".join(names)
    lens = np.array([len(x) for x in names], np.int32)
    off = np.zeros(len(names), np.int64)
    np.cumsum(lens[:-1], out=off[1:])
    return pool, off, lens


def emit_sam(rec: MappingRecords, genome, path: str, threads: int = 0):
    """print_to_sam over records: native bulk writer, oracle fallback."""
    if native.emit_available():
        pool, off, lens = _names_arrays(genome)
        return native.sam_emit(path, rec, pool, off, lens, threads=threads)
    from .mapping import print_to_sam
    return print_to_sam(rec.to_aas(), genome, path)


def emit_vcf(rec: MappingRecords, genome, outputfile: str) -> str:
    """do_vc over records: native bulk writer, oracle fallback."""
    path = outputfile + ".VCF"
    if native.emit_available():
        pool, off, lens = _names_arrays(genome)
        if native.vc_emit(path, rec, pool, off, lens):
            return path
    from .mapping import do_vc
    return do_vc(rec.to_aas(), genome, outputfile)
