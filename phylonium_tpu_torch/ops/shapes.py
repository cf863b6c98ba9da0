"""The host nibble pack of pileup rows, and the row layout on the card.

A copy of ``pack_states`` from the JAX package's ``phylonium_tpu/ops/shapes.py``:
the port carries its own host layer and imports nothing of that package.
The TPU kernels' shape math of that module (VMEM-budgeted column blocks,
shape buckets, sublane row padding) has no use on the card and is left out.
In its place, the card's row layout (``ROW_ALIGN``, ``packed_width``,
``pack_rows``; ops/states.py re-exports them beside the copy to the
device), here because this module loads without torch.
"""

from __future__ import annotations

import numpy as np

from phylonium_tpu_torch.core.pileup import INVALID

_PACKED_PAD = INVALID | (INVALID << 4)

ROW_ALIGN = 16  # bytes: one 128-bit load of the kernels


def pack_states(
    states: np.ndarray, n_pad: int, width: int | None = None
) -> np.ndarray:
    """Split-layout nibble packing: byte [g, j] = state[g, j] |
    state[g, j + L2] << 4 with L2 = ceil(L/2) (odd tails pad INVALID).
    Halves transfer + HBM bytes; states are 0..10 so they fit 4 bits.
    ``width`` right-pads with packed-INVALID columns (padding on host
    saves a device pad program per run).

    One native pass when available (the numpy formulation's temporaries
    make it far slower at 1000 x 1 Mbp scale).
    """
    n, length = states.shape
    l2 = -(-max(length, 1) // 2)
    width = max(width or l2, l2)
    try:
        from phylonium_tpu_torch.native import pack_states_native

        return pack_states_native(states, n_pad, width)
    except Exception:
        pass
    lo = np.full((n, l2), INVALID, dtype=np.uint8)
    hi = np.full((n, l2), INVALID, dtype=np.uint8)
    lo[:, : min(l2, length)] = states[:, :l2]
    hi[:, : length - l2] = states[:, l2:]
    out = np.full((n_pad, width), _PACKED_PAD, dtype=np.uint8)
    out[:n, :l2] = lo | (hi << 4)
    return out


def packed_width(length: int) -> int:
    """Bytes per packed row for ``length`` states: ceil(L/2), aligned."""
    half = -(-max(length, 1) // 2)
    return -(-half // ROW_ALIGN) * ROW_ALIGN


def pack_rows(states: np.ndarray) -> np.ndarray:
    """[N, L] uint8 states -> [N, packed_width(L)] packed bytes.

    Padding bytes hold INVALID in both nibbles and count nothing.
    """
    n, length = states.shape
    return pack_states(states, n, packed_width(length))
