"""Genome partitioning: segments and the region-sharded mapper."""
