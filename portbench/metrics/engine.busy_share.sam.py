"""Share of the window's pass time that the driver's main thread spends
inside the mapper's map_reads(with_scores=True), each call ended by its
copy to the host (host spans around the calls)."""


def read(rec):
    return rec.span_s("map_reads") / rec.span_s("pass")
