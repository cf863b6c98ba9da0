"""Counting over several devices: a mesh of torch.distributed ranks.

The port of the JAX package's phylonium_tpu/parallel/. A shard is a rank:
an ``R x C`` mesh is a world of ``R * C`` processes, one device each
(parallel/mesh.py). The launcher starts the world
(``multihost.initialize_distributed``); the pipeline reads it.
``multihost`` loads without torch; ``mesh``, ``distributed``,
``map_shard`` and ``stream_mp`` import it.
"""
