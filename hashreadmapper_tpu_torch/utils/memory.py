"""Memory accounting (MemoryUsage protocol equivalent; counterpart of
hashreadmapper_tpu/utils/memory.py).

Reference: include/memorymanagement.hpp (MemoryUsage {host, per-device}),
printDataStructureMemoryUsage (src/gpu/main_gpu.cu:70-83).  Device numbers
come from PyTorch's caching allocator on each CUDA card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass
class MemoryUsage:
    host: int = 0
    device: Dict[int, int] = dataclasses.field(default_factory=dict)

    def __add__(self, other: "MemoryUsage") -> "MemoryUsage":
        dev = dict(self.device)
        for k, v in other.device.items():
            dev[k] = dev.get(k, 0) + v
        return MemoryUsage(self.host + other.host, dev)


def get_available_host_memory_kb() -> int:
    """Reference: getAvailableMemoryInKB (memorymanagement.hpp)."""
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


def device_memory_stats() -> Dict[int, Dict[str, int]]:
    """Per-card allocator stats (bytes): in use and peak from
    torch.cuda.memory_stats, the limit the card's total memory.  Empty
    without a card, as the JAX package's CPU devices report none."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[i] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out


def print_data_structure_memory_usage(name: str, usage: MemoryUsage) -> None:
    """printDataStructureMemoryUsage equivalent (main_gpu.cu:70-83)."""
    mb = 1024.0 * 1024.0
    print(f"{name} memory usage: {usage.host / mb:.3f} MB on host")
    for dev_id, bytes_ in sorted(usage.device.items()):
        print(f"{name} memory usage: {bytes_ / mb:.3f} MB on device {dev_id}")
