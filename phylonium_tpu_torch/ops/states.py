"""The pileup as the port carries it to the device.

This system has no weights; its device state is the pileup, one row of
4-bit states per genome. Rows travel split-nibble packed, exactly as the
JAX package packs them (``ops/shapes.py::pack_states``), with
the width padded to a multiple of 16 bytes so that every row starts on a
16-byte boundary for the kernel's vector loads. The host half of that
layout (``ROW_ALIGN``, ``packed_width``, ``pack_rows``) lives in
ops/shapes.py, which loads without torch, and is re-exported here.
"""

from __future__ import annotations

import numpy as np
import torch

from phylonium_tpu_torch.ops.shapes import ROW_ALIGN, pack_rows, packed_width  # noqa: F401


def to_device(packed: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy packed rows to ``device``; through pinned memory to a card."""
    host = torch.from_numpy(packed)
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)
