"""phylonium-tpu-torch: the phylonium-tpu distance engine on PyTorch and CUDA.

A port of the JAX package ``phylonium_tpu`` to PyTorch, with its all-pairs
count, hybrid mapping's diagonal bitmaps and the streamed pileup build in
CUDA kernels written for Hopper (csrc/pair_count.cu, csrc/diagonal_neq.cu,
csrc/pileup_build.cu). The host layer (FASTA reading, the suffix index,
anchor mapping and its chain state machine, the pileup build, the
estimators and PHYLIP output, and the native C++ library under native/)
is the port's own copy of the JAX package's host code, laid out as there;
this package imports neither ``phylonium_tpu`` nor jax.
"""

__version__ = "0.1.0"

from phylonium_tpu_torch.api import distance_matrix  # noqa: E402,F401
