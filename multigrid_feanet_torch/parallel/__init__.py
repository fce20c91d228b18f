"""Distributed execution: ``shard`` (the fused V-cycle by row slabs over a
process group) and ``sharding`` (the process group, the device mesh, the
block-partitioned V-cycle, halo exchanges, the data-parallel H-Net step)."""
