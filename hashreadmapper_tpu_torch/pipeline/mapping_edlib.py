"""Edlib mapper mode: NW edit-distance fine alignment -> SAM.

Structural counterpart of the reference's edlibAligner + printtoedlibSAM
(reference: src/gpu/mappinghandler.cu:841-1176, :295-379).

IMPORTANT DIVERGENCE (documented, deliberate): the reference's edlib mode
cannot run to completion —
  * printtoedlibSAM calls mapqfkt(i, ...) which indexes the CSSW result
    vector `mappingout`, empty in edlib mode -> std::vector::at throws
    (mappinghandler.cu:314,326 with :184-193);
  * the RC score is read from the already-freed first result
    (`edlibout.at(i).score_rc = result.editDistance` after
    edlibFreeAlignResult(result), :991);
  * readId / queryStart / num_conversions are never assigned (uninitialized,
    mappinghandler.cuh:108-131);
  * its orientation pick `score >= score_rc` treats the edit DISTANCE as a
    score (higher = better), inverting the choice.
This implementation keeps the reference's record layout and tags but fixes
those defects: readId is the read index, queryStart is 0 (NW alignments are
global), the smaller edit distance wins, conversions are counted like the
CSSW rescoring, and MAPQ uses the CSSW formula on (len - distance) scores.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..align import sw
from ..align.edit import nw_align
from ..config import ProgramOptions
from ..io.genome import Genome
from ..io.readstore import ReadStorage
from ..io.vcf import parse_cigar
from ..cpu import oracle
from .mapping import _three_n, _window_views

FORWARD, REVERSE_COMPLEMENT, NONE = 1, 2, 3


@dataclasses.dataclass
class EdlibHelper:
    """Mirror of the reference's Edlibhelper (mappinghandler.cuh:103-132)."""
    read_id: int = 0
    query_original: str = ""
    query_threen: str = ""
    query_rc: str = ""
    query_rc_threen: str = ""
    query_length: int = 0
    query_start: int = 0
    query_start_rc: int = 0
    target_original: str = ""
    target_threen: str = ""
    target_rc: str = ""
    target_rc_threen: str = ""
    target_length: int = 0
    flag: int = 0
    flag_rc: int = 0
    cigar: str = ""
    cigar_rc: str = ""
    score: int = 0
    score_rc: int = 0
    num_conversions: int = 0
    num_conversions_rc: int = 0
    position: int = 0
    chromosome_id: int = 0
    # stored quality aligned with query_original (reversed when RC);
    # empty = reference parity ('*' in SAM)
    qual: str = ""


def _count_conversions(query: str, ref: str, rc_ref: str, cigar: str) -> int:
    """Conversion counting along the CIGAR (the reference's edlib rescore
    lambda only counts; score adjustments are commented out,
    mappinghandler.cu:1008-1146)."""
    n = 0
    ref_pos, alt_pos = 0, 0
    for op, length in parse_cigar(cigar):
        bases_left = min(82 - max(ref_pos, alt_pos), length)
        if op in ("M", "="):
            for i in range(max(0, bases_left)):
                if alt_pos + i >= len(query) or ref_pos + i >= len(ref) \
                        or ref_pos + i >= len(rc_ref):
                    continue
                q, r = query[alt_pos + i], ref[ref_pos + i]
                if q == r or r == "N" or q == "N":
                    continue
                if q == "T" and ((r == "C" and rc_ref[ref_pos + i] == "G")
                                 or (r == "G" and rc_ref[ref_pos + i] == "C")):
                    n += 1
            ref_pos += bases_left
            alt_pos += bases_left
        elif op in ("I", "S"):
            alt_pos += bases_left
        elif op in ("D", "N"):
            ref_pos += bases_left
        elif op == "X":
            ref_pos += bases_left
            alt_pos += bases_left
    return n


def run_edlib(genome: Genome, genome_rc: Genome,
              orientation: np.ndarray, position: np.ndarray,
              chromosome_id: np.ndarray, reads: ReadStorage,
              opts: ProgramOptions) -> List[EdlibHelper]:
    out: List[EdlibHelper] = []
    for r in range(reads.num_reads):
        read_len = int(reads.lengths[r])
        bases = list(reads.gather_bases([r], read_len)[0])
        if orientation[r] == REVERSE_COMPLEMENT:
            bases = oracle.revcomp_bases(bases)
        query = oracle.decode_bases(bases)
        pos = int(position[r])
        chrom = int(chromosome_id[r])
        window, window_rc, wlen = _window_views(
            genome, genome_rc, chrom, pos, opts.window_size)

        eh = EdlibHelper()
        eh.read_id = r
        eh.query_original = query
        eh.query_threen = _three_n(query)
        eh.query_rc = oracle.revcomp_str(query)
        eh.query_rc_threen = _three_n(eh.query_rc)
        eh.query_length = read_len
        eh.target_original = window
        eh.target_threen = _three_n(window)
        eh.target_rc = window_rc
        eh.target_rc_threen = _three_n(window_rc)
        eh.target_length = wlen
        eh.position = pos
        eh.chromosome_id = chrom
        if orientation[r] == NONE:
            eh.flag |= 0x4
        out.append(eh)

    from .. import native
    if native.available():
        nw_fn = native.nw_align_native
    else:
        nw_fn = nw_align
    for eh in out:
        if eh.flag & 0x4:
            continue
        eh.score, eh.cigar = nw_fn(eh.query_threen, eh.target_threen)
        eh.score_rc, eh.cigar_rc = nw_fn(eh.query_rc_threen,
                                         eh.target_rc_threen)
        eh.num_conversions = _count_conversions(
            eh.query_original, eh.target_original, eh.target_rc, eh.cigar)
        eh.num_conversions_rc = _count_conversions(
            eh.query_rc, eh.target_original, eh.target_rc, eh.cigar_rc)
    if opts.use_quality_scores and reads.qualities is not None:
        for eh in out:
            q = reads.get_quality_str(eh.read_id)
            eh.qual = (q[::-1]
                       if orientation[eh.read_id] == REVERSE_COMPLEMENT
                       else q)
    return out


def print_to_edlib_sam(edlibout: List[EdlibHelper], genome: Genome,
                       path: str) -> dict:
    """printtoedlibSAM layout (mappinghandler.cu:295-379), with the
    documented fixes (readId, orientation pick by smaller distance)."""
    mapped = 0
    unmapped = 0
    with open(path, "w") as fh:
        fh.write("@HD\tVN:1.4\n")
        for eh in edlibout:
            fh.write(f"@SQ\tSN:{eh.read_id}\tLN:{eh.target_length}\n")
        fh.write("@PG\tHashreadmapper\tID:1.0")
        fh.write("@CO: QNAME\tFLAG\tRNAME\tPOS\tMAPQ\tCIGAR\tRNEXT\tPNEXT\t"
                 "TLEN\tSEQ\tQUAL\tTAG\n")
        for eh in edlibout:
            # smaller edit distance wins (the reference's >= on distances
            # inverts this; divergence documented in the module docstring)
            if eh.score <= eh.score_rc:
                samtag = f"Yf:i:<{eh.num_conversions}>YZ:A:<+>"
                samflag = eh.flag
                pos = eh.position + eh.query_start
                cig = eh.cigar
                s1 = eh.query_length - eh.score
                s2 = eh.query_length - eh.score_rc
            else:
                samtag = f"Yf:i:<{eh.num_conversions_rc}>YZ:A:<->"
                samflag = eh.flag_rc
                pos = eh.position + eh.query_start_rc
                cig = eh.cigar_rc
                s1 = eh.query_length - eh.score_rc
                s2 = eh.query_length - eh.score
            mapq = sw.mapq_cssw(max(s1, 0), max(s2, 0))
            rname = genome.names[eh.chromosome_id]
            if (eh.flag & 0x4) == 0:
                mapped += 1
                tag = samtag
            else:
                unmapped += 1
                tag = str(eh.flag)
            fh.write(f"{eh.read_id}\t{samflag}\t{rname}\t{pos}\t{mapq}\t"
                     f"{cig}\t=\t\t0\t{eh.query_original}\t"
                     f"{eh.qual or '*'}\t{tag}\t\n")
    return {"mapped": mapped, "unmapped": unmapped}
