"""phylonium-tpu-torch: the phylonium-tpu distance engine on PyTorch and CUDA.

A port of the JAX package ``phylonium_tpu`` to PyTorch, with its all-pairs
count and hybrid mapping's diagonal bitmaps in CUDA kernels written for
Hopper (csrc/pair_count.cu, csrc/diagonal_neq.cu). The host layer (FASTA
reading, the suffix index, anchor mapping and its chain state machine, the
pileup build, the estimators and PHYLIP output) is the JAX package's
jax-free host code, imported as it is; this package never imports jax.
"""

__version__ = "0.1.0"

from phylonium_tpu_torch.api import distance_matrix  # noqa: E402,F401
