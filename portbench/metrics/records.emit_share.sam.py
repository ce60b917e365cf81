"""Share of the window's pass time in records.emit_sam and emit_vcf, the
native SAM and VCF writers (host spans)."""


def read(rec):
    return (rec.span_s("emit_sam") + rec.span_s("emit_vcf")) \
        / rec.span_s("pass")
