"""Several processes, one region merge (counterpart of
hashreadmapper_tpu/parallel/multihost.py, over torch.distributed).

The reference is one process driving every card (SURVEY.md §2.3); this
module adds the layouts that span processes:

  * data-parallel reads: each process ingests and maps its own slice of
    the read set (process_read_slice); per-read results are disjoint, so
    no merge is needed;
  * genome regions: every process maps the same reads against ITS regions
    (parallel/region_sharded.py::region_key_payload gives each region's
    key and payload), and merge_region_results reduces them: the minimum
    key over the process's regions, a MIN all-reduce of the key over the
    group, then the payload of the winning region by a MAX all-reduce of
    the payload with the losers at INT32_MIN.  The result is bit-equal to
    the single-process RegionShardedMapper merge on any process count.

The backend is the caller's choice and is never switched: "gloo" reduces
host tensors, "nccl" each rank's own card (NCCL takes one rank a card).
Without an initialized process group the group is this one process.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

INT32_MIN = -(2**31)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "gloo") -> None:
    """torch.distributed.init_process_group: tcp://coordinator_address
    (host:port) with the given size and rank, or, with no arguments, the
    env:// rendezvous (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), as
    jax.distributed.initialize reads its environment."""
    import torch.distributed as dist
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)


def process_read_slice(num_reads: int, num_processes: int,
                       process_id: int) -> Tuple[int, int]:
    """Contiguous per-process read range [start, stop).

    Mirrors the even-share row partitioning of the reference's
    MultiGpu2dArray (multigpuarray.cuh:1315-1345) at host granularity."""
    per = (num_reads + num_processes - 1) // num_processes
    start = min(process_id * per, num_reads)
    stop = min(start + per, num_reads)
    return start, stop


def _group():
    """(backend, world size, rank), or None without a process group."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return dist.get_backend(), dist.get_world_size(), dist.get_rank()


@dataclasses.dataclass
class RegionMesh:
    """This process's region devices and its place among all regions."""
    local_devices: List[torch.device]
    region_offset: int          # global index of the first local region
    num_regions: int            # regions over all processes
    reduce_device: torch.device  # where the merge's all-reduces run


def region_mesh(devices=None) -> RegionMesh:
    """One region a device of `devices` (this process's CUDA cards by
    default, the CPU without one); the global region count and this
    process's offset are gathered over the group.  The reductions run on
    the host under gloo and on the first local card under nccl; a local
    device that does not match the backend raises."""
    if devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   or [torch.device("cpu")])
    local = [torch.device(d) for d in devices]
    group = _group()
    if group is None:
        return RegionMesh(local, 0, len(local), torch.device("cpu"))
    backend, world, rank = group
    if backend == "nccl":
        if local[0].type != "cuda":
            raise ValueError(f"the nccl backend reduces on a card; this "
                             f"process's first region device is {local[0]}")
        reduce_device = local[0]
    elif backend == "gloo":
        reduce_device = torch.device("cpu")
    else:
        raise ValueError(f"no region merge over the {backend!r} backend")
    import torch.distributed as dist
    counts = [None] * world
    dist.all_gather_object(counts, len(local))
    return RegionMesh(local, sum(counts[:rank]), sum(counts), reduce_device)


def _all_reduce(mesh: RegionMesh, x: np.ndarray, op) -> np.ndarray:
    group = _group()
    if group is None or group[1] == 1:
        return x
    import torch.distributed as dist
    t = torch.from_numpy(np.ascontiguousarray(x)).to(mesh.reduce_device)
    if (group[0] == "gloo") != (t.device.type == "cpu"):
        raise ValueError(f"a {group[0]} reduction of a tensor on {t.device}")
    dist.all_reduce(t, op=op)
    return t.cpu().numpy()


def merge_region_results(mesh: RegionMesh, local_keys: Sequence,
                         local_payloads: Sequence):
    """The reduction of every region's per-read results over the group.

    local_keys: one [N] int64 array per local region, this process's
    regions' best keys ((hamming << 40) + global window ordinal; 2**62 =
    unmapped); local_payloads: the matching [N, P] int32 rows (any int32
    fields, negative ones too: losers are masked with INT32_MIN).

    Returns (merged_key [N] int64, merged_payload [N, P] int32) as numpy,
    identical on every process.  Keys are unique per (read, window) since
    regions partition the windows, so the winner mask selects one
    region's payload (all regions agree on the unmapped filler row)."""
    import torch.distributed as dist
    keys = np.stack([np.asarray(k, dtype=np.int64) for k in local_keys])
    pays = np.stack([np.asarray(p, dtype=np.int32) for p in local_payloads])
    key = _all_reduce(mesh, keys.min(axis=0), dist.ReduceOp.MIN)
    masked = np.where((keys == key[None])[:, :, None], pays,
                      np.int32(INT32_MIN)).max(axis=0)
    return key, _all_reduce(mesh, masked, dist.ReduceOp.MAX)
