"""hashreadmapper_tpu_torch: PyTorch + CUDA (Hopper) port of
hashreadmapper_tpu, the bisulfite (3N) hash read mapper.

The JAX package stays the reference; this package imports torch and never
jax, and reuses the JAX package's jax-free host modules (config, io,
align, cpu, native, pipeline.mapping/records/mapping_edlib).
"""

__version__ = "0.1.0"
