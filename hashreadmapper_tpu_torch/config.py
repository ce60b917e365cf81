"""Program options for the TPU bisulfite read mapper.

Mirrors the reference CLI surface (reference: include/options.hpp:25-66,
src/options.cpp:263-334) while adding TPU-specific capacity knobs that replace
the reference's dynamic-shape flows (reference: src/gpu/main_gpu.cu:198-277)
with fixed-capacity padded tensors.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional


class SequencePairType(enum.Enum):
    SINGLE_END = "SingleEnd"
    PAIRED_END = "PairedEnd"


class MapperType(enum.Enum):
    EDLIB = "edlib"
    SW = "SW"
    STHELSE = "sthelse"


def parse_memory_string(s: str) -> int:
    """Parse '1024', '512M', '4G', '100K' into bytes.

    Reference: src/options.cpp:113-140 (K/M/G suffix each multiply by 1024).
    """
    s = s.strip()
    if not s:
        return 0
    suffix = s[-1].upper()
    multipliers = {"K": 1024, "M": 1024**2, "G": 1024**3}
    if suffix in multipliers:
        return int(s[:-1]) * multipliers[suffix]
    return int(s)


@dataclasses.dataclass
class ProgramOptions:
    """Flat options struct passed by reference everywhere.

    Defaults mirror reference include/options.hpp:30-42.
    """

    # --- reference-equivalent options ---
    replicate_index: bool = False          # replicateGpuData
    use_quality_scores: bool = False
    show_progress: bool = False
    must_use_all_hash_functions: bool = False
    batchsize: int = 2048                  # window/read batch size
    kmer_length: int = 16
    num_hash_functions: int = 16
    max_results_per_map: int = 65535       # keys with more values are dropped
    window_size: int = 128
    min_table_hits: int = 4
    threads: int = 1
    quality_score_bits: int = 8
    min_insert_size: int = -1
    max_insert_size: int = -1
    hashtable_load_factor: float = 0.8
    max_hamming_percent: float = 0.05
    pair_type: SequencePairType = SequencePairType.SINGLE_END
    mapper_type: MapperType = MapperType.SW
    memory_for_hashtables: int = 0
    memory_total_limit: int = 0
    save_binary_reads_to: str = ""
    load_binary_reads_from: str = ""
    save_hashtables_to: str = ""
    load_hashtables_from: str = ""
    tempdirectory: str = "."
    genomefile: str = "genome.fasta"
    outputfile: str = "output.txt"
    outputdirectory: str = "."
    device_ids: List[int] = dataclasses.field(default_factory=list)
    inputfiles: List[str] = dataclasses.field(default_factory=list)

    # --- TPU-specific fixed-capacity knobs (replace dynamic shapes) ---
    # Bisulfite-aware seeding (BASELINE config 2): index genome windows in
    # both collapsed spaces (C->T and G->A) with forward k-mers and compare
    # SHD orientations in their matching spaces.  Off = reference-parity
    # seeding on raw canonical k-mers (the reference's 3N seeding is
    # commented out, hammingdistancekernels.cu:204).
    three_n_seeding: bool = False
    # Undirectional (PBAT) bisulfite support: ALSO probe/evaluate the two
    # complementary-strand spaces (GA(read) vs the GA window tables,
    # CT(RC read) vs the CT tables, mirrored SHD collapses), so
    # G->A-in-read-space reads map too.  Requires three_n_seeding.  Exceeds
    # the reference (whose commented-out 3N seeding was directional-only).
    undirectional: bool = False
    # Max candidate window ids returned per (read, table) probe.
    probe_cap: int = 64
    # Max candidate windows kept per read after the min-table-hits vote.
    candidates_per_read_cap: int = 32
    # Upper bound on read length (reference: getSequenceLengthUpperBound()).
    max_read_length: int = 160
    # Mesh axis sizes; None => single device.
    mesh_data: Optional[int] = None
    mesh_table: Optional[int] = None
    # Genome-region sharding (parallel/region_sharded.py): 0 = auto (one
    # region per device when the genome needs partitioning, else a single
    # mapper); N>0 forces N regions.  Genomes >2 Gbp always route through
    # regions (the int32 staged-gather limit of one mapper).
    num_regions: int = 0
    # SHD pair compaction: average (read, candidate) pairs per read budgeted
    # for the SHD stage.  At real candidate densities most of the
    # [B, candidates_per_read_cap] grid is padding; compacting valid pairs
    # before SHD cuts its gathers ~kcap/budget x.  0 = off (every slot
    # evaluated, the reference-parity guarantee); >0 trades a
    # pair_budget_overflow counter for speed when a batch exceeds
    # batchsize * budget valid pairs (dropped pairs rank after kept ones in
    # vote order, mirroring the candidates_per_read_cap overflow rule).
    shd_pairs_per_read_budget: int = 0
    # Two-tier probe value gather: heavy (count>4) probes budgeted per read
    # (see minhash_index.probe_tables tail_budget).  0 = off (single full
    # probe_cap gather).  Bit-identical while probe_tail_overflow stays 0.
    probe_tail_budget_per_read: int = 0
    # Found-compacted head gather: found (count>0) probes budgeted per read
    # before the head value gather (see probe_tables head_budget; requires
    # the two-tier mode).  0 = off (dense head gather for every probe).
    # Bit-identical while probe_head_overflow stays 0; a read has at most
    # 2F found probes, so 2F is always overflow-free.
    probe_head_budget_per_read: int = 0
    # STEP1/STEP2 pipelining: reads are coarse-mapped, with the fused
    # device STEP 2, and finished on the host in chunks of this many
    # reads, so STEP 2's host work (CIGAR finish, rescore, record build)
    # overlaps the next chunk's device step.  0 = one chunk of all reads
    # (phases strictly sequential, the reference's structure); a chunk's
    # STEP-2 bundle is about 138 B a read on the device (1.4 GB at 10 M
    # reads).  Results are identical at any chunk (the dropped-keys mask
    # is still computed from the full read set).
    step2_pipeline_chunk: int = 65536

    @property
    def window_stride(self) -> int:
        """Windows overlap by k-1 bases (reference: include/genome.hpp:177)."""
        return self.window_size - self.kmer_length + 1

    def validate(self) -> None:
        assert 1 <= self.kmer_length <= 32, "k must be in [1, 32]"
        assert self.num_hash_functions <= 64, (
            "reference asserts hashFuncId < 64 (gpusequencehasher.cuh:138)")
        assert self.window_size > self.kmer_length
        assert self.batchsize > 0
        assert not self.undirectional or self.three_n_seeding, (
            "--undirectional extends the 3N mode; enable --threeN")
