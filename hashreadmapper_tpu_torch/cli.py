"""Command line of the PyTorch/CUDA port: the JAX package's flags (its
parser is shared) plus --device.

    python -m hashreadmapper_tpu_torch --threeN --genomefile g.fa \
        -i reads.fq.gz -o out [--device cuda|cpu] ...

--device cuda (the default) runs the hand-written CUDA kernels and raises
when no CUDA device is available; --device cpu runs their plain PyTorch
versions.  Options outside the port's slice raise NotImplementedError
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Tuple

import torch

from hashreadmapper_tpu import cli as shared_cli
from hashreadmapper_tpu.config import ProgramOptions

from .pipeline.engine import check_supported


def _add_device_flag(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--device", default="cuda",
                   help="torch device of the coarse stage: cuda (CUDA "
                        "kernels) or cpu (their plain PyTorch versions)")
    return p


def build_parser() -> argparse.ArgumentParser:
    p = _add_device_flag(shared_cli.build_parser())
    p.prog = "hashreadmapper-tpu-torch"
    p.description = ("bisulfite (3N) hash read mapper, PyTorch/CUDA port "
                     "of hashreadmapper_tpu")
    return p


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is "
                           "False; pass --device cpu to run the plain "
                           "PyTorch versions")
    return dev


def options_from_args(argv: Optional[List[str]] = None
                      ) -> Tuple[ProgramOptions, torch.device]:
    argv = list(sys.argv[1:] if argv is None else argv)
    build_parser().parse_args(argv)          # --help, unknown flags
    known, rest = _add_device_flag(
        argparse.ArgumentParser(add_help=False)).parse_known_args(argv)
    opts = shared_cli.options_from_args(rest)
    check_supported(opts)
    return opts, resolve_device(known.device)


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
