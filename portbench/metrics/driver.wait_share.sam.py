"""Share of the window's pass time that is neither in map_reads nor in
the emitters: the driver's main thread waiting on its two STEP-2 workers
(native finish, rescore and records), with the joins of their parts
(host spans)."""


def read(rec):
    busy = sum(rec.span_s(n) for n in ("map_reads", "emit_sam", "emit_vcf"))
    return 1.0 - busy / rec.span_s("pass")
