"""The two entries that a traffic mix's window drives, each through the
program's own calls:

sam     the job: passes of `pass_reads` reads taken from the pool in turn,
        each through pipeline/driver.py::_pipelined_sw in chunks of
        --pipelineChunk reads (coarse map with the fused device STEP 2, then the
        native finish, rescore and records on the driver's two workers),
        then records.emit_sam and emit_vcf.  Every pass, and the warm-up,
        writes its SAM and VCF into named pipes that a thread drains
        (PipeSink): the same work each pass, nothing on disk; the first
        pass of the window's SAM and VCF are kept in memory for the check.
coarse  STEP 1 alone: map_reads of the mapper over the whole pool, a pass
        each, coarse rows on the host (run_pipeline's call under
        --mappertype sthelse).

An entry is set up (mapper, warm-up of the cell's own shapes) before the
window and keeps the coarse results that the check compares (kept["first"]
and, for coarse, kept["last"]: the first and the last pass's; for sam
also kept["sam"] and kept["vcf"], the first pass's text).
"""

from __future__ import annotations

import fcntl
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from .trace import SpanMapper, Spans


def pack(res) -> np.ndarray:
    """[N, 7] int64 rows of CoarseResults, as the reference packs them
    (window id as u32)."""
    return np.stack([res.orientation, res.hamming, res.shift,
                     res.chromosome_id, res.position,
                     res.global_window_id.astype(np.int64) & 0xFFFFFFFF,
                     res.bs_strand], axis=1).astype(np.int64)


def stats_vector(stats: Dict[str, int]) -> np.ndarray:
    keys = ("probe_overflow", "vote_overflow", "pair_budget_overflow",
            "probe_tail_overflow", "probe_head_overflow")
    return np.array([int(stats[k]) for k in keys], np.int64)


class PipeSink:
    """A named pipe that the emitters open and write as they would a file,
    drained by a thread: each stream (one open to its close) is read whole
    and dropped, except the one after keep_next(), kept in memory."""

    def __init__(self, path: str):
        os.mkfifo(path)
        self.path = path
        self.kept: Optional[bytes] = None
        self._keep = self._stop = False
        self._ended = threading.Event()
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        while True:
            fd = os.open(self.path, os.O_RDONLY)   # waits for a writer
            keep, self._keep = self._keep, False
            try:   # fewer wake-ups a stream, where the kernel allows it
                fcntl.fcntl(fd, fcntl.F_SETPIPE_SZ, 1 << 20)
            except OSError:
                pass
            chunks = []
            while True:
                b = os.read(fd, 1 << 20)
                if not b:
                    break
                if keep:
                    chunks.append(b)
            os.close(fd)
            if keep:
                self.kept = b"".join(chunks)
            self._ended.set()
            if self._stop:
                return

    def keep_next(self) -> None:
        """Keep the next stream (call before its writer opens the pipe)."""
        self._keep = True

    def ended(self) -> None:
        """Wait until the stream just written has been read to its end, so
        that the next writer starts a stream of its own."""
        if not self._ended.wait(60):
            raise RuntimeError(f"{self.path}: no stream ended in 60 s")
        self._ended.clear()

    def close(self) -> None:
        self._stop = True
        if self._thread.is_alive():
            # an empty stream wakes the thread, which then stops
            os.close(os.open(self.path, os.O_WRONLY))
            self._thread.join()


class Entry:
    """A pass loop over the pool; subclasses say what a pass is."""

    def __init__(self, mix: Dict, mapper, opts, genome, bases, lengths,
                 spans: Spans, workdir: str):
        self.mix = mix
        self.mapper = mapper
        self.opts = opts
        self.genome = genome
        self.bases = bases
        self.lengths = lengths
        self.spans = spans
        self.workdir = workdir
        self.kept: Dict = {}

    def close(self) -> None:
        """Stop what the entry started."""


class CoarseEntry(Entry):
    """map_reads over the whole pool a pass."""

    def warm(self) -> None:
        self.mapper.map_reads(self.bases, self.lengths)

    def run_pass(self, p: int) -> int:
        with self.spans.span("map_reads"):
            res = self.mapper.map_reads(self.bases, self.lengths)
        if p == 0:
            self.kept["first"] = res
        self.kept["last"] = res
        return len(self.lengths)

    def checked_rows(self) -> Tuple[int, int]:
        return 0, len(self.lengths)


class SamEntry(Entry):
    """_pipelined_sw, emit_sam and emit_vcf over a pass of reads."""

    def __init__(self, *args, reads, genome_rc, **kwargs):
        super().__init__(*args, **kwargs)
        from hashreadmapper_tpu_torch.pipeline import driver, records
        self._driver, self._records = driver, records
        self.reads = reads
        self.genome_rc = genome_rc
        self.proxy = SpanMapper(self.mapper, self.spans)
        self.pass_reads = int(self.mix["pass_reads"])
        if len(self.lengths) % self.pass_reads:
            raise ValueError("the pool must hold whole passes")
        # the emitter writes <base>.SAM as given and appends .VCF to a base
        self.base = os.path.join(self.workdir, "out")
        self.sam = PipeSink(self.base + ".SAM")
        self.vcf = PipeSink(self.base + ".VCF")

    def close(self) -> None:
        self.sam.close()
        self.vcf.close()

    def _one(self, r0: int, r1: int):
        reads = self.reads.slice_rows(r0, r1)
        with self.spans.span("pipelined_sw"):
            res, rec = self._driver._pipelined_sw(
                self.proxy, self.bases[r0:r1], reads, self.genome,
                self.genome_rc, self.opts)
        with self.spans.span("emit_sam"):
            self._records.emit_sam(rec, self.genome, self.sam.path,
                                   threads=max(1, self.opts.threads))
            self.sam.ended()
        with self.spans.span("emit_vcf"):
            self._records.emit_vcf(rec, self.genome, self.base)
            self.vcf.ended()
        return res

    def warm(self) -> None:
        self._one(0, self.opts.step2_pipeline_chunk)

    def run_pass(self, p: int) -> int:
        r0 = (p * self.pass_reads) % len(self.lengths)
        if p == 0:
            self.sam.keep_next()
            self.vcf.keep_next()
        res = self._one(r0, r0 + self.pass_reads)
        if p == 0:
            self.kept["first"] = res
            self.kept["sam"] = self.sam.kept.decode()
            self.kept["vcf"] = self.vcf.kept.decode()
            self.sam.kept = self.vcf.kept = None
        return self.pass_reads

    def checked_rows(self) -> Tuple[int, int]:
        return 0, self.pass_reads
