"""Command line of the PyTorch/CUDA port: the JAX package's flags (its
parser, copied) plus --device.

    python -m hashreadmapper_tpu_torch [--threeN [--undirectional]] \\
        --genomefile g.fa -i reads.fq.gz -o out [--device cuda|cpu] ...

--device cuda (the default) runs the hand-written CUDA kernels and raises
when no CUDA device is available; --device cpu runs their plain PyTorch
versions.  --mesh D T runs the coarse stage over D x T distinct cards
with --device cuda (raising when there are fewer), over D x T positions
that are all the CPU with --device cpu.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import torch

from .config import MapperType, ProgramOptions, SequencePairType, \
    parse_memory_string


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is "
                           "False; pass --device cpu to run the plain "
                           "PyTorch versions")
    return dev


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hashreadmapper-tpu-torch",
        description="bisulfite (3N) hash read mapper, PyTorch/CUDA port "
                    "of hashreadmapper_tpu")
    p.add_argument("-i", "--inputfiles", nargs="+", default=[],
                   help="read files (FASTA/FASTQ, optionally .gz)")
    p.add_argument("--genomefile", default="genome.fasta")
    p.add_argument("-o", "--outputfile", "--outputfilename",
                   dest="outputfile", default="output.txt")
    p.add_argument("--outputdirectory", "--outdir", dest="outputdirectory",
                   default=".")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-k", "--kmerlength", type=int, default=16)
    p.add_argument("-m", "--hashmaps", type=int, default=16,
                   help="number of hash tables (hash functions)")
    p.add_argument("--windowSize", type=int, default=128)
    p.add_argument("--minTableHits", type=int, default=4)
    p.add_argument("--batchsize", type=int, default=2048)
    p.add_argument("--maxResultsPerMap", type=int, default=65535)
    p.add_argument("--maxHammingPercent", type=float, default=0.05)
    p.add_argument("--hashtableLoadfactor", type=float, default=0.8)
    p.add_argument("--mappertype", choices=["SW", "edlib", "sthelse"],
                   default="SW")
    p.add_argument("--pairmode", choices=["SE", "PE"], default="SE")
    p.add_argument("--minInsertSize", type=int, default=-1,
                   help="PE insert-size bound (parsed for parity; the "
                        "reference parses and never consumes it, "
                        "options.cpp:219-226)")
    p.add_argument("--maxInsertSize", type=int, default=-1)
    p.add_argument("--enforceHashmapCount", action="store_true",
                   help="error out instead of shrinking the table count "
                        "under --memHashtables (mustUseAllHashfunctions)")
    p.add_argument("--gpu", nargs="*", type=int, default=[],
                   help="device ids (reference -g/--gpu; devices are "
                        "chosen by --device here, accepted for CLI parity)")
    p.add_argument("--warpcore", type=int, default=1,
                   help="reference hash-table backend toggle; accepted "
                        "for CLI parity (the index has one backend)")
    p.add_argument("--memHashtables", default="0",
                   help="memory limit for hash tables (K/M/G suffixes)")
    p.add_argument("--memTotal", default="0")
    p.add_argument("--save-preprocessedreads-to", default="")
    p.add_argument("--load-preprocessedreads-from", default="")
    p.add_argument("--save-hashtables-to", default="")
    p.add_argument("--load-hashtables-from", default="")
    p.add_argument("--tempdir", default=".")
    p.add_argument("-p", "--showProgress", action="store_true")
    p.add_argument("-q", "--useQualityScores", action="store_true")
    p.add_argument("--qualityScoreBits", type=int, default=8,
                   choices=[1, 2, 8],
                   help="stored bits per quality score (reference: "
                        "options.hpp:37)")
    p.add_argument("--replicateGpuData", action="store_true")
    p.add_argument("--threeN", action="store_true",
                   help="bisulfite-aware 3N seeding (dual CT/GA indexes)")
    p.add_argument("--undirectional", action="store_true",
                   help="PBAT/undirectional BS protocol: also probe and "
                        "align the complementary strand spaces (requires "
                        "--threeN)")
    # capacity knobs
    p.add_argument("--probeCap", type=int, default=64)
    p.add_argument("--candidatesPerRead", type=int, default=32)
    p.add_argument("--shdPairBudget", type=int, default=0,
                   help="avg SHD pairs/read after compaction (0=off: every "
                        "candidate slot evaluated)")
    p.add_argument("--probeTailBudget", type=int, default=0,
                   help="heavy (count>4) probes budgeted per read for the "
                        "two-tier value gather (0=off)")
    p.add_argument("--probeHeadBudget", type=int, default=0,
                   help="found probes budgeted per read for the compacted "
                        "head gather (0=off; needs --probeTailBudget)")
    p.add_argument("--pipelineChunk", type=int, default=65536,
                   help="reads per STEP1/STEP2 pipeline chunk (0 = run "
                        "the phases strictly sequentially)")
    p.add_argument("--maxReadLength", type=int, default=160)
    p.add_argument("--regions", type=int, default=0,
                   help="genome-region shards (0=auto; >2 Gbp genomes "
                        "always shard)")
    p.add_argument("--mesh", nargs=2, type=int, default=None,
                   metavar=("DATA", "TABLE"),
                   help="run the coarse stage over a (data x table) device "
                        "mesh: reads shard over DATA, hash tables over "
                        "TABLE (the reference's multi-GPU mode, -g 0,1,..; "
                        "composes with --regions for >2 Gbp genomes)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the coarse stage and STEP 2: cuda "
                        "(CUDA kernels) or cpu (their plain PyTorch "
                        "versions)")
    return p


def options_from_args(argv: Optional[List[str]] = None
                      ) -> Tuple[ProgramOptions, torch.device]:
    args = build_parser().parse_args(argv)
    opts = ProgramOptions(
        inputfiles=args.inputfiles,
        genomefile=args.genomefile,
        outputfile=args.outputfile,
        outputdirectory=args.outputdirectory,
        threads=args.threads,
        kmer_length=args.kmerlength,
        num_hash_functions=args.hashmaps,
        window_size=args.windowSize,
        min_table_hits=args.minTableHits,
        batchsize=args.batchsize,
        max_results_per_map=args.maxResultsPerMap,
        max_hamming_percent=args.maxHammingPercent,
        hashtable_load_factor=args.hashtableLoadfactor,
        mapper_type={"SW": MapperType.SW, "edlib": MapperType.EDLIB,
                     "sthelse": MapperType.STHELSE}[args.mappertype],
        pair_type=SequencePairType.SINGLE_END if args.pairmode == "SE"
        else SequencePairType.PAIRED_END,
        min_insert_size=args.minInsertSize,
        max_insert_size=args.maxInsertSize,
        must_use_all_hash_functions=args.enforceHashmapCount,
        memory_for_hashtables=parse_memory_string(args.memHashtables),
        memory_total_limit=parse_memory_string(args.memTotal),
        save_binary_reads_to=args.save_preprocessedreads_to,
        load_binary_reads_from=args.load_preprocessedreads_from,
        save_hashtables_to=args.save_hashtables_to,
        load_hashtables_from=args.load_hashtables_from,
        tempdirectory=args.tempdir,
        show_progress=args.showProgress,
        use_quality_scores=args.useQualityScores,
        quality_score_bits=args.qualityScoreBits,
        replicate_index=args.replicateGpuData,
        three_n_seeding=args.threeN,
        undirectional=args.undirectional,
        probe_cap=args.probeCap,
        candidates_per_read_cap=args.candidatesPerRead,
        shd_pairs_per_read_budget=args.shdPairBudget,
        probe_tail_budget_per_read=args.probeTailBudget,
        probe_head_budget_per_read=args.probeHeadBudget,
        step2_pipeline_chunk=args.pipelineChunk,
        max_read_length=args.maxReadLength,
        num_regions=args.regions,
        mesh_data=args.mesh[0] if args.mesh else None,
        mesh_table=args.mesh[1] if args.mesh else None,
    )
    return opts, resolve_device(args.device)


def run(argv: Optional[List[str]] = None) -> Dict:
    """Parse, then run the pipeline; returns its result dict."""
    opts, device = options_from_args(argv)
    from .pipeline.driver import run_pipeline
    return run_pipeline(opts, device)


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
