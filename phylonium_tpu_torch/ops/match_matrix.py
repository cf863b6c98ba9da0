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

from phylonium_tpu_torch.core.pileup import INVALID
from phylonium_tpu_torch.ops.match_table import MATCH_PLANES, MATCH_TABLE

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


def onehot_operands(
    a: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's contraction as two int8 matrices, for one product.

    [Na, W] x [Nb, W] packed uint8 -> (A int8 [Na, (C + 1) L], B int8
    [2 Nb, (C + 1) L]) with L = 2 W states a row and C = len(MATCH_PLANES)
    classes of states that share a partner set (8):

        A = [P_0 .. P_{C-1} | V]
        B = [[Q_0 .. Q_{C-1} | 0]; [0 | V]]

    where P_c = [state in class c], Q_c = [state is a partner of class c]
    and V = [state < 10], so that ``A . B^T`` is ``[matches | homs]``
    ([Na, 2 Nb], exact in int32 while L < 2^31). These are the kernel's
    planes. Column order within a plane is any order shared by both sides;
    here the low nibbles, then the high ones. ``chip_smoke.py`` times
    ``torch._int_mm`` on these as the library yardstick of the kernel;
    nothing in the port calls it.
    """
    states_a = torch.cat((a & 15, a >> 4), dim=1)
    states_b = torch.cat((b & 15, b >> 4), dim=1)
    na, length = states_a.shape
    nb = states_b.shape[0]
    planes = len(MATCH_PLANES)
    ops_a = torch.empty((na, planes + 1, length), dtype=torch.int8, device=a.device)
    ops_b = torch.zeros((2, nb, planes + 1, length), dtype=torch.int8, device=a.device)

    def in_set(states: torch.Tensor, bits: int) -> torch.Tensor:
        return ((bits >> states.to(torch.int32)) & 1).to(torch.int8)

    for c, (members, partners) in enumerate(MATCH_PLANES.tolist()):
        ops_a[:, c] = in_set(states_a, members)
        ops_b[0, :, c] = in_set(states_b, partners)
    ops_a[:, planes] = states_a < INVALID
    ops_b[1, :, planes] = states_b < INVALID
    return ops_a.view(na, -1), ops_b.view(2 * nb, -1)
