"""Captured CUDA graphs of the batch steps (the port's counterpart of the
JAX engine's compiled dispatch units: engine._map_batch_at_impl and its
scored counterpart, _map_pool_scan_impl and
window_stream._window_batch_impl, one jax.jit program a batch).

PyTorch runs eagerly, so a read batch of the coarse step with the fused
STEP 2 is some 90 launches from the host (hand-written kernels and the
torch operations left around them), and the card idles between them.  A CapturedStep records the step once as a torch.cuda.CUDAGraph and
replays it once a batch: one graph launch, with the copies into its
static inputs and out of its static outputs beside it.

Contract:
  * The step is a function of its static input tensors that returns a
    tuple of tensors.  run(step, *args) copies args into the static
    inputs (same shapes and types, else ValueError), runs the step, and
    returns the static outputs: the caller copies what it keeps before
    the next run, which overwrites them.
  * On a CUDA device the first run warms the step up (the kernel
    library's load, the wrappers' range checks, the shared-memory
    attributes), captures it into the card's one graph memory pool and
    then replays it; every later run replays.  A failed capture or
    replay raises; nothing falls back to the eager step.
  * On the CPU run() runs the step eagerly on the same static inputs and
    copies its results into static outputs, so the buffer and copy-out
    logic is the one the card runs (run_eager does the same on any
    device).
  * Graphs that share the pool replay on one stream in turn; a graph's
    scratch may lie under another graph's static outputs, so every
    caller copies a replay's outputs out before any other graph of the
    pool replays, and keeps no static output past its step's life (the
    allocator frees a pool whose graphs are gone only when none of its
    blocks is held, and refuses a capture into it before that).  A
    replay goes on the current stream: the single mapper's on the
    caller's, a mesh's on stream(card), the card's own stream, which
    it orders after the caller's stream and the caller's after it.
  * State the step reads from outside its inputs (the index, the key
    drops, the staged genome) is created before the capture, outside
    the pool, and must not be replaced after it: the owners key or drop
    their graphs when it is.
  * The kernel wrappers count their Python calls (ops/*_kernel.py,
    `launches`); a replay makes none.  The capture's own counts are taken
    back (a capture launches nothing) and every replay adds them again,
    so a count still means launches on the card.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, Sequence, Tuple

import torch

from ..utils import tracing

Step = Callable[..., Sequence[torch.Tensor]]

# the ProgramOptions fields the batch steps read: a capture bakes them in,
# so they key the graphs (with the batch shape and the step's outputs)
STEP_OPTIONS = ("kmer_length", "min_table_hits", "probe_cap",
                "candidates_per_read_cap", "shd_pairs_per_read_budget",
                "probe_tail_budget_per_read", "probe_head_budget_per_read",
                "window_size", "max_read_length", "max_hamming_percent",
                "max_results_per_map", "three_n_seeding", "undirectional")


def options_key(opts) -> tuple:
    return tuple(getattr(opts, f) for f in STEP_OPTIONS)


def kernel_wrappers():
    """Every kernel wrapper that counts its launches."""
    from ..ops import (bandtb_kernel as bk, minhash_kernel as mk,
                       pairs_kernel as pk, probe_kernel as prk,
                       shd_kernel as sk, step2rows_kernel as s2k,
                       swdev_kernel as swk, vote_kernel as vk)
    return (mk.signature_stage, mk.sigs_from_bases, mk.sig_min_murmur,
            prk.probe_lookup, prk.probe_gather, vk.vote_candidates_fnc,
            pk.pair_select, sk.shd_best, sk.shd_hamming_matrix,
            sk.shd_pairs_best, pk.read_best, s2k.step2_rows,
            swk.pass_batched, swk.sw_forward, swk.sw_reverse, bk.shift_sub,
            bk.fill_pass, bk.traceback)


class _Card:
    """A card's shared graph pool, its capture stream and what its
    captures cost."""

    def __init__(self, device: torch.device):
        with torch.cuda.device(device):
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device)
        self.captures = 0
        self.capture_seconds = 0.0


_cards: Dict[int, _Card] = {}
_cards_lock = threading.Lock()


def _card(device: torch.device) -> _Card:
    with _cards_lock:
        card = _cards.get(device.index)
        if card is None:
            card = _cards[device.index] = _Card(device)
        return card


def pool_bytes(device) -> int:
    """Device bytes the card's graph pool holds (its segments)."""
    dev = _cuda_device(device)
    card = _cards.get(dev.index)
    if card is None:
        return 0
    pool = tuple(card.pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == dev.index
               and tuple(seg.get("segment_pool_id", ())) == pool)


def capture_stats(device) -> Tuple[int, float]:
    """(graphs captured on the card, their warm-up and capture seconds)."""
    card = _cards.get(_cuda_device(device).index)
    return (card.captures, card.capture_seconds) if card else (0, 0.0)


def _cuda_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"graph pools are per CUDA card, not {dev}")
    return torch.device("cuda", torch.cuda.current_device()
                        if dev.index is None else dev.index)


def _on(device: torch.device):
    """The card as the current device (skipped where it already is)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream(device) -> torch.cuda.Stream:
    """The card's own stream (its captures' stream): a mesh puts every
    replay and copy of the card on it, in order."""
    return _card(_cuda_device(device)).stream


class CapturedStep:
    """A batch step over static input buffers shaped like `like` (on
    `device`, else on like's devices): captured once and replayed on a
    CUDA device, run eagerly on the CPU (see the module docstring).
    run() takes the step function each time and uses it only to capture
    or to run eagerly, so a step does not hold its owner (a mapper and
    its device memory) alive.  An argument that is the static input
    itself (a caller that wrote into `inputs`) is not copied."""

    def __init__(self, like: Sequence[torch.Tensor], device=None):
        self.inputs = tuple(torch.empty(
            t.shape, dtype=t.dtype,
            device=t.device if device is None else device) for t in like)
        self.device = self.inputs[0].device
        self.outputs = None
        self.graph = None
        self._replay_counts = ()
        self.capture_seconds = 0.0

    def _load(self, args) -> None:
        if len(args) != len(self.inputs):
            raise ValueError(f"the step takes {len(self.inputs)} inputs, "
                             f"got {len(args)}")
        for buf, x in zip(self.inputs, args):
            if x.shape != buf.shape or x.dtype != buf.dtype \
                    or x.device != buf.device:
                raise ValueError(
                    f"step input {tuple(x.shape)} {x.dtype} on {x.device}; "
                    f"the static buffer is {tuple(buf.shape)} {buf.dtype} "
                    f"on {buf.device}")
            if x is not buf:
                buf.copy_(x)

    def run_eager(self, step: Step, *args) -> Tuple[torch.Tensor, ...]:
        """The step, eagerly, on the static inputs; its results copied into
        the static outputs."""
        self._load(args)
        got = tuple(step(*self.inputs))
        if self.outputs is None:
            self.outputs = tuple(torch.empty_like(x) for x in got)
        for dst, x in zip(self.outputs, got):
            dst.copy_(x)
        return self.outputs

    def run(self, step: Step, *args) -> Tuple[torch.Tensor, ...]:
        """One batch: the replay of the captured step on a CUDA device
        (captured at the first run), the eager step on the CPU.  Returns
        the static outputs."""
        if self.device.type != "cuda":
            return self.run_eager(step, *args)
        with _on(self.device):
            self._load(args)
            if self.graph is None:
                with tracing.span("engine.capture"):
                    self._capture(step)
            self.graph.replay()
        for fn, n in self._replay_counts:
            fn.launches += n
        return self.outputs

    def _capture(self, step: Step) -> None:
        card = _card(self.device)
        t0 = time.perf_counter()
        # the warm-up, on the current stream
        step(*self.inputs)
        wrappers = kernel_wrappers()
        before = [fn.launches for fn in wrappers]
        graph = torch.cuda.CUDAGraph()
        try:
            # torch.cuda.graph synchronizes and empties the device and host
            # caches first: the allocators free there the pools whose
            # graphs are all gone, and a later capture into the same pool
            # id needs that.  "thread_local": pipeline/driver.py's
            # workers may use the card meanwhile.
            with torch.cuda.graph(graph, pool=card.pool, stream=card.stream,
                                  capture_error_mode="thread_local"):
                outputs = tuple(step(*self.inputs))
            counts = [(fn, fn.launches - b)
                      for fn, b in zip(wrappers, before)]
        finally:
            # the capture recorded its kernels; it launched none
            for fn, b in zip(wrappers, before):
                fn.launches = b
        torch.cuda.synchronize(self.device)
        self.graph, self.outputs = graph, outputs
        self._replay_counts = tuple((fn, n) for fn, n in counts if n)
        self.capture_seconds = time.perf_counter() - t0
        with _cards_lock:
            card.captures += 1
            card.capture_seconds += self.capture_seconds
