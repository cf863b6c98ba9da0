"""The pileup as the port carries it to the device.

This system has no weights; its device state is the pileup, one row of
4-bit states per genome. Rows travel split-nibble packed, exactly as the
JAX package packs them (``ops/shapes.py::pack_states``), with
the width padded to a multiple of 16 bytes so that every row starts on a
16-byte boundary for the kernel's vector loads.
"""

from __future__ import annotations

import numpy as np
import torch

from phylonium_tpu_torch.ops.shapes import pack_states

ROW_ALIGN = 16  # bytes: one 128-bit load


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


def to_device(packed: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy packed rows to ``device``; through pinned memory to a card."""
    host = torch.from_numpy(packed)
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)
