"""Counting over several devices: a mesh of ranks or of local devices.

The port of the JAX package's phylonium_tpu/parallel/. In a
torch.distributed world of several ranks a shard is a rank: an ``R x C``
mesh is a world of ``R * C`` processes, one device each. The launcher
starts the world (``multihost.initialize_distributed``); the pipeline
reads it. A process of one rank spans its own local devices instead, as
the JAX package spans its local devices: an ``R x C`` mesh there is the
first ``R * C`` cards, or CPU cells where a caller patches
``utils.platform.local_devices`` (parallel/mesh.py).
``multihost`` loads without torch; ``mesh``, ``distributed``,
``map_shard`` and ``stream_mp`` import it.
"""
