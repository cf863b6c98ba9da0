"""Plain PyTorch all-pairs counts: the judge of the CUDA kernel.

This is the torch form of the JAX package's one-hot contraction
(``phylonium_tpu/ops/match_matrix.py::block_counts``). Per column chunk it
unpacks both nibbles, builds the 11 one-hot state planes, applies the
11 x 11 match table by a product and contracts over columns:

    P[n, c, s] = 1{state[n, c] == s}
    Q[m, c, s] = sum_t MATCH_TABLE[s, t] * P[m, c, t]
    matches    = P . Q^T         homs = V . V^T,  V = P[..., :10] summed

It runs on any device. The tests use it, the CPU device path uses it, and
``chip_smoke.py`` holds the kernel against it on the card; the CUDA path
of the port never calls it.
"""

from __future__ import annotations

import torch

from phylonium_tpu.core.pileup import INVALID
from phylonium_tpu.ops.match_table import MATCH_TABLE

# packed bytes per chunk: 2^23 states, so every float32 partial sum is an
# integer below 2^24 and exact (0/1 operands; ops/shapes.py in the JAX
# package holds the same bound)
_MAX_CHUNK_BYTES = 1 << 22
# working-set bound for one chunk's planes, in bytes
_CHUNK_MEMORY = 1 << 30


def _planes(chunk: torch.Tensor) -> torch.Tensor:
    """[N, C] packed bytes -> [N, 2C, 11] float32 one-hot planes.

    Nibble values above INVALID (none occur) get no plane, like INVALID.
    """
    states = torch.cat((chunk & 15, chunk >> 4), dim=1)
    codes = torch.arange(INVALID + 1, dtype=torch.uint8, device=chunk.device)
    return (states.unsqueeze(-1) == codes).to(torch.float32)


def cross_counts_reference(
    a: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """[Na, W] x [Nb, W] packed uint8 -> (matches, homs) int64 [Na, Nb]."""
    # The counts must be exact integers. TF32 matmul rounds its inputs and
    # cuBLAS promises nothing about exactness in that mode, so the judge
    # of the kernel keeps full float32 products.
    torch.backends.cuda.matmul.allow_tf32 = False
    na, width = a.shape
    nb = b.shape[0]
    table = torch.as_tensor(MATCH_TABLE, dtype=torch.float32, device=a.device)
    # per packed byte: 2 states x 11 planes as bool and float32 for both
    # operands, plus the partner planes Q of b
    per_byte = 2 * 11 * (5 * (na + nb) + 4 * nb)
    step = max(1, min(_MAX_CHUNK_BYTES, _CHUNK_MEMORY // per_byte))
    matches = torch.zeros((na, nb), dtype=torch.int64, device=a.device)
    homs = torch.zeros((na, nb), dtype=torch.int64, device=a.device)
    for start in range(0, width, step):
        pa = _planes(a[:, start : start + step])
        pb = _planes(b[:, start : start + step])
        qb = pb @ table.T
        matches += (pa.flatten(1) @ qb.flatten(1).T).to(torch.int64)
        va = pa[..., :INVALID].sum(-1)
        vb = pb[..., :INVALID].sum(-1)
        homs += (va @ vb.T).to(torch.int64)
    return matches, homs
