"""hashreadmapper_tpu_torch: PyTorch + CUDA (Hopper) port of
hashreadmapper_tpu, the bisulfite (3N) hash read mapper.

The JAX package stays the reference.  This package imports torch, never
JAX and nothing of hashreadmapper_tpu: it keeps its own copies of the host
modules (config, io, align, cpu, native, pipeline.mapping/records/
mapping_edlib) and builds its own native library (_build.build_native).
"""

__version__ = "0.1.0"
