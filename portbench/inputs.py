"""The benchmark's inputs from --seed: the genome of a configuration and
the read pool of a traffic mix, made on the device with a torch.Generator
in a few large calls and handed to the program and the reference alike.

One general read generator serves every mix; a mix is its parameters:

    {"pool": reads, "length": bases, "variants": rate, "errors": rate,
     "strands": [["fwd", "none"], ["rc", "none"]],
     "assign": "random" | "cycle", "conversion": rate, "junk": rate}

The sample's genome is the reference genome with round(variants x length)
sites, drawn from the seed, changed to another base; every read carries
them.  A read is a slice of the sample's genome (chromosome chosen by
length, start uniform), with sequencing errors (each base, at the error
rate, changed to another base), then put on one of the strands
(reverse-complemented for "rc"), then bisulfite-converted in read space
(C->T for "ct", G->A for "ga", nothing for "none") at the conversion
rate; a junk read is random bases.  "random" draws each read's strand
uniformly, "cycle" gives read i strand i % len.  The mapper and the
reference get the reference genome, never the sample's.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

ACGT = np.frombuffer(b"ACGT", np.uint8)
_STREAMS = {"genome": 1, "reads": 2, "variants": 3}
_COLLAPSE = {"ct": (1, 3), "ga": (2, 0)}


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator on `device` for one input stream of a seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + _STREAMS[stream]) % (1 << 63))
    return g


def make_genome(config: Dict, seed: int, device
                ) -> Tuple[List[str], List[np.ndarray]]:
    """(names, base codes 0..3 int8 of each chromosome): uniform random
    bases at the configuration's chromosome lengths."""
    g = generator(seed, "genome", device)
    names, chroms = [], []
    for name, length in config["genome"]["chromosomes"]:
        codes = torch.randint(0, 4, (int(length),), generator=g,
                              device=device, dtype=torch.uint8)
        names.append(name)
        chroms.append(codes.cpu().numpy().view(np.int8))
        del codes
    return names, chroms


def genome_strings(chroms: Sequence[np.ndarray]) -> List[str]:
    """The chromosomes as ACGT strings."""
    return [ACGT[c.view(np.uint8)].tobytes().decode("ascii") for c in chroms]


def _other_base(codes: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    """Each base changed to one of the three others, uniformly."""
    step = torch.randint(1, 4, codes.shape, generator=g,
                         device=codes.device, dtype=codes.dtype)
    return (codes + step) % 4


def sample_genome(chroms: Sequence[np.ndarray], rate: float, seed: int,
                  device) -> torch.Tensor:
    """The sample's genome, all chromosomes end to end (uint8 codes on
    `device`): the reference with round(rate x length) sites changed."""
    g = generator(seed, "variants", device)
    genome = torch.cat([torch.from_numpy(c.view(np.uint8))
                        for c in chroms]).to(device)
    k = int(round(float(rate) * len(genome)))
    if k:
        sites = torch.randint(0, len(genome), (k,), generator=g,
                              device=device)
        genome[sites] = _other_base(genome[sites], g)
    return genome


def make_reads(mix: Dict, chroms: Sequence[np.ndarray], seed: int, device
               ) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
    """(bases [pool, length] int8, lengths [pool] int32, truth: chromosome,
    start, strand and junk of each read)."""
    n, length = int(mix["pool"]), int(mix["length"])
    genome = sample_genome(chroms, mix["variants"], seed, device)
    g = generator(seed, "reads", device)
    lens = torch.tensor([len(c) for c in chroms], dtype=torch.float64)
    chrom = torch.multinomial(lens, n, replacement=True,
                              generator=torch.Generator().manual_seed(
                                  int(seed) % (1 << 63))).to(device)
    span = (lens.to(device) - length)[chrom]
    start = (torch.rand(n, generator=g, device=device, dtype=torch.float64)
             * span).to(torch.int64)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(
        [len(c) for c in chroms])[:-1]]), dtype=torch.int64, device=device)
    idx = (offsets[chrom] + start)[:, None] + torch.arange(length,
                                                           device=device)
    reads = genome[idx]
    del genome, idx
    err = torch.rand(reads.shape, generator=g, device=device) < float(
        mix["errors"])
    reads = torch.where(err, _other_base(reads, g), reads).to(torch.int8)
    strands = mix["strands"]
    if mix["assign"] == "cycle":
        kind = torch.arange(n, device=device) % len(strands)
    else:
        kind = torch.randint(0, len(strands), (n,), generator=g,
                             device=device)
    rc = torch.zeros(n, dtype=torch.bool, device=device)
    for i, (orient, _) in enumerate(strands):
        if orient == "rc":
            rc |= kind == i
    reads = torch.where(rc[:, None], 3 - reads.flip(1), reads)
    conv = torch.rand(reads.shape, generator=g, device=device) < float(
        mix["conversion"])
    for i, (_, collapse) in enumerate(strands):
        if collapse == "none":
            continue
        src, dst = _COLLAPSE[collapse]
        mine = (kind == i)[:, None] & conv
        reads = torch.where(mine & (reads == src), dst, reads)
    junk = torch.rand(n, generator=g, device=device) < float(mix["junk"])
    reads = torch.where(junk[:, None],
                        torch.randint(0, 4, reads.shape, generator=g,
                                      device=device, dtype=torch.int8),
                        reads).to(torch.int8)
    truth = {"chromosome": chrom.cpu().numpy(), "start": start.cpu().numpy(),
             "strand": kind.cpu().numpy(), "junk": junk.cpu().numpy()}
    return (reads.cpu().numpy(), np.full(n, length, np.int32), truth)
