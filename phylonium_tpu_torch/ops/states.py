"""The pileup as the port carries it to the device.

This system has no weights; its device state is the pileup, one row of
4-bit states per genome. Rows travel split-nibble packed, exactly as the
JAX package packs them (``ops/shapes.py::pack_states``), with
the width padded to a multiple of 16 bytes so that every row starts on a
16-byte boundary for the kernel's vector loads. The host half of that
layout (``ROW_ALIGN``, ``packed_width``, ``pack_rows``) lives in
ops/shapes.py, which loads without torch, and is re-exported here.

``to_device`` is the port's one host-to-device copy: the pair count's
rows, the mesh's cells, the early shipper's pieces, the feeder's and the
device server's group inputs all go through it.
"""

from __future__ import annotations

import numpy as np
import torch

from phylonium_tpu_torch.ops.shapes import ROW_ALIGN, pack_rows, packed_width  # noqa: F401


def to_device(array: np.ndarray, device: torch.device, stream=None, timed: bool = False):
    """Copy a host array to ``device``; to a card through pinned memory, on
    ``stream`` (default: the current stream). The pinned allocator keeps
    the staging buffer until its copy is done.

    ``timed``: return (tensor, seconds, event) instead, the copy alone
    timed by CUDA events (the pinning before it left out) and ``event``,
    its end, synchronized, so the tensor is resident; seconds and event
    are None on a CPU.
    """
    host = torch.from_numpy(array)
    if device.type != "cuda":
        return (host.to(device), None, None) if timed else host.to(device)
    with torch.cuda.stream(stream):
        pinned = host.pin_memory()
        if not timed:
            return pinned.to(device, non_blocking=True)
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = pinned.to(device, non_blocking=True)
        done.record(stream)
    done.synchronize()
    return out, start.elapsed_time(done) / 1e3, done
