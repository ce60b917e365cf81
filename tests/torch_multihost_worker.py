"""Worker process of tests/test_torch_multihost.py: one rank of a gloo
group over localhost, the port's counterpart of tests/multihost_worker.py.

Each process owns 2 regions of a 4-region window partition (both on the
CPU), maps the full read set against them, and merges with the other
process through parallel/multihost.py::merge_region_results.  Every
process then checks the merged results against the port's
single-process whole-genome mapper and its 4-region RegionShardedMapper,
computed locally, and prints TORCH_MULTIHOST_OK <rank> on success.

    python torch_multihost_worker.py <rank> <world size> <host:port>
"""

import os
import random
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hashreadmapper_tpu_torch.config import ProgramOptions  # noqa: E402
from hashreadmapper_tpu_torch.cpu import oracle  # noqa: E402
from hashreadmapper_tpu_torch.io.genome import Genome  # noqa: E402
from hashreadmapper_tpu_torch.parallel import multihost  # noqa: E402
from hashreadmapper_tpu_torch.parallel.region_sharded import (  # noqa: E402
    RegionShardedMapper, chrom_gwin_base, region_key_payload)
from hashreadmapper_tpu_torch.parallel.segments import \
    partition_windows  # noqa: E402
from hashreadmapper_tpu_torch.pipeline.engine import CoarseMapper  # noqa: E402


def dataset():
    """tests/multihost_worker.py's dataset (identical on every process)."""
    rng = random.Random(99)
    chroms = ["".join(rng.choice("ACGT") for _ in range(n))
              for n in (700, 450, 350)]
    genome = Genome([f"c{i}" for i in range(len(chroms))], chroms)
    n_reads, maxlen = 64, 36
    reads = []
    for _ in range(n_reads):
        rl = rng.randint(14, maxlen)
        if rng.random() < 0.9:
            c = rng.randrange(len(chroms))
            s = rng.randrange(len(chroms[c]) - rl)
            b = oracle.encode_bases(chroms[c][s:s + rl])
            if rng.random() < 0.5:
                b = oracle.revcomp_bases(b)
        else:
            b = [rng.randrange(4) for _ in range(rl)]
        reads.append(b)
    bases = np.zeros((n_reads, maxlen), dtype=np.int8)
    lens = np.zeros(n_reads, dtype=np.int32)
    for i, r in enumerate(reads):
        bases[i, :len(r)] = r
        lens[i] = len(r)
    opts = ProgramOptions(
        kmer_length=8, num_hash_functions=8, window_size=32,
        min_table_hits=2, batchsize=32, max_hamming_percent=0.15,
        probe_cap=64, candidates_per_read_cap=32, max_read_length=maxlen)
    return genome, bases, lens, opts


def main():
    rank, world, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    multihost.initialize(coord, world, rank, backend="gloo")
    genome, bases, lens, opts = dataset()
    mesh = multihost.region_mesh(["cpu", "cpu"])
    assert mesh.num_regions == 2 * world, mesh
    assert mesh.region_offset == 2 * rank, mesh
    regions = partition_windows(genome, opts, mesh.num_regions)
    reference = RegionShardedMapper(genome, opts, mesh.num_regions,
                                    devices=["cpu"], partition="window")
    local_keys, local_payloads = [], []
    for r in range(len(mesh.local_devices)):
        mapper = CoarseMapper(genome, opts, mesh.local_devices[r],
                              segments=regions[mesh.region_offset + r])
        mapper.ensure_empty_drops()
        packed, _, _ = mapper.map_reads_packed(bases, lens)
        key, payload, _ = region_key_payload(
            mapper, packed, chrom_gwin_base(genome, opts))
        local_keys.append(key)
        local_payloads.append(payload)
    merged_key, merged_payload = multihost.merge_region_results(
        mesh, local_keys, local_payloads)

    # the single-process whole-genome mapper, with no read-key drop
    single_mapper = CoarseMapper(genome, opts, "cpu")
    single_mapper.ensure_empty_drops()
    single = single_mapper.map_reads(bases, lens)
    mapped = single.orientation != 3
    assert mapped.sum() >= 0.7 * len(lens), f"only {mapped.sum()} mapped"
    expect_key = np.where(
        mapped, (single.hamming.astype(np.int64) << 40)
        + single.global_window_id.astype(np.int64), np.int64(2**62))
    np.testing.assert_array_equal(merged_key, expect_key)
    for col, field in enumerate(("orientation", "hamming", "shift",
                                 "chromosome_id", "position")):
        np.testing.assert_array_equal(merged_payload[mapped, col],
                                      getattr(single, field)[mapped])
    # and the single-process region merge, every row
    regs = reference.map_reads(bases, lens)
    np.testing.assert_array_equal(merged_key, np.where(
        regs.orientation != 3,
        (regs.hamming.astype(np.int64) << 40) + regs.global_window_id64,
        np.int64(2**62)))
    for col, field in enumerate(("orientation", "hamming", "shift",
                                 "chromosome_id", "position", "bs_strand")):
        np.testing.assert_array_equal(merged_payload[:, col],
                                      getattr(regs, field))
    import torch.distributed as dist
    dist.destroy_process_group()
    print(f"TORCH_MULTIHOST_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
