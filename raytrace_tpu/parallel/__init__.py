"""Parallelism: device meshes, tile-sharded rendering, gradient psum,
primitive-sharded ring intersection.

The reference is single-thread/single-process (SURVEY.md §2 parallelism
inventory: none), so this whole package is net-new: pixels/rays are the
big data-parallel axis (the SP/DP analog), scene parameters are
replicated with ``psum`` gradient all-reduce (the DP grad-sync analog),
and very large scenes can shard primitives around a device ring (the
TP/ring-attention analog,
``min``-reduction over circulating hit records).
"""
