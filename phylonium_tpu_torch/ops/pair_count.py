"""All-pairs counting: the wrappers around the pair-count kernel.

These port the JAX package's ``pair_counts_pallas``,
``pair_counts_pallas_blocked``, ``blocked_counts_device`` and
``cross_counts_pallas`` (phylonium_tpu/ops/pallas_match.py). On the TPU
the square block (N <= 512) and the 512-row panels (N > 512) were two
kernels because of VMEM; the CUDA kernel (csrc/pair_count.cu) tiles its
output into 128 x 128 blocks, so its shared memory does not grow with N
and one symmetric call serves every N.

A CUDA tensor goes to the kernel; a CPU tensor goes to the plain PyTorch
version (ops/match_matrix.py). The route follows the tensor's device and
nothing else: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

import numpy as np
import torch

from phylonium_tpu_torch.ops import _build
from phylonium_tpu_torch.ops.match_matrix import cross_counts_reference
from phylonium_tpu_torch.ops.match_table import PARTNER_MASK
from phylonium_tpu_torch.ops.states import ROW_ALIGN, pack_rows, to_device

# launches of the CUDA kernel, and calls of the plain version on the CPU
# route, since the last reset (callers set them to 0)
KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0
# pt_cross_counts launches the kernel twice: matches, then homologs
LAUNCHES_PER_CALL = 2

# One launch sums at most 2 states per packed byte into an int32 cell, so
# it takes rows narrower than this; pair_counts_rows counts wider rows in
# column chunks and sums them in int64, as the JAX package's
# pair_counts_pallas does (phylonium_tpu/ops/pallas_match.py:349-365).
_MAX_WIDTH = (1 << 31) // 2


def _chunk_bytes() -> int:
    """Packed bytes of one column chunk: the largest multiple of
    ROW_ALIGN below _MAX_WIDTH."""
    return (_MAX_WIDTH - 1) // ROW_ALIGN * ROW_ALIGN

# devices whose constant memory holds PARTNER_MASK
_masks_on: set[int] = set()


def _check(a: torch.Tensor, b: torch.Tensor, symmetric: bool) -> None:
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.uint8 or t.dim() != 2:
            raise ValueError(
                f"{name} must be a 2-D uint8 tensor of packed rows, got "
                f"{t.dtype} with shape {tuple(t.shape)}"
            )
        # rows of a panel, or a column chunk of them: a view whose rows
        # are contiguous and 16-byte aligned
        if t.stride(1) != 1:
            raise ValueError(f"{name} must be contiguous (row-major)")
        if t.data_ptr() % ROW_ALIGN:
            raise ValueError(f"{name} must start on a {ROW_ALIGN}-byte boundary")
        if t.stride(0) % ROW_ALIGN or t.stride(0) < t.shape[1]:
            raise ValueError(
                f"{name}'s row stride {t.stride(0)} is not a multiple of "
                f"{ROW_ALIGN} bytes at least its width {t.shape[1]}"
            )
    if a.device != b.device:
        raise ValueError(f"a is on {a.device} but b is on {b.device}")
    width = a.shape[1]
    if b.shape[1] != width:
        raise ValueError(f"row widths differ: {width} and {b.shape[1]}")
    if width % ROW_ALIGN:
        raise ValueError(
            f"row width {width} is not a multiple of {ROW_ALIGN} bytes "
            "(pack with ops.states.pack_rows)"
        )
    if width >= _MAX_WIDTH:
        raise ValueError(
            f"row width {width} bytes is more than one call counts "
            f"(< {_MAX_WIDTH}); pair_counts_rows counts it in column chunks"
        )
    if symmetric and (a.data_ptr() != b.data_ptr() or a.shape != b.shape):
        raise ValueError("symmetric counting needs a and b to be one tensor")


def _launch(a: torch.Tensor, b: torch.Tensor, symmetric: bool):
    lib = _build.load()
    device = a.device
    with torch.cuda.device(device):
        if device.index not in _masks_on:
            err = lib.pt_set_partner_mask(PARTNER_MASK.ctypes.data)
            if err:
                raise RuntimeError(f"pt_set_partner_mask: CUDA error {err}")
            _masks_on.add(device.index)
        na, nb = a.shape[0], b.shape[0]
        matches = torch.zeros((na, nb), dtype=torch.int32, device=device)
        homs = torch.zeros((na, nb), dtype=torch.int32, device=device)
        err = lib.pt_cross_counts(
            a.data_ptr(), a.stride(0), na,
            b.data_ptr(), b.stride(0), nb,
            a.shape[1],
            matches.data_ptr(), homs.data_ptr(),
            int(symmetric), torch.cuda.current_stream(device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"pt_cross_counts: CUDA error {err}")
    return matches, homs


def cross_counts(
    a: torch.Tensor, b: torch.Tensor, *, symmetric: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """[Na, W] x [Nb, W] packed uint8 -> (matches, homs) int32 [Na, Nb].

    ``symmetric=True`` (a is b) lets the kernel skip the output tiles
    below the diagonal: only cells with i <= j are then defined. The CPU
    route computes every cell either way.
    """
    global KERNEL_LAUNCHES, PLAIN_CALLS
    _check(a, b, symmetric)
    if a.device.type == "cuda":
        matches, homs = _launch(a, b, symmetric)
        KERNEL_LAUNCHES += LAUNCHES_PER_CALL
        return matches, homs
    if a.device.type != "cpu":
        raise ValueError(f"no pair-count route for device {a.device}")
    matches, homs = cross_counts_reference(a, b)
    PLAIN_CALLS += 1
    return matches.to(torch.int32), homs.to(torch.int32)


def _mirror_upper(m: np.ndarray) -> np.ndarray:
    upper = np.triu(m, 1)
    return upper + upper.T


def pair_counts_rows(rows: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs (substitutions, homologs) of packed rows already in place.

    ``rows``: [N, W] uint8 split-nibble rows on their device (the
    one-shot path's copy, or the streamed feeder's panel). One symmetric
    count for any N; the upper triangle is mirrored and the diagonal
    zeroed (the reference never compares a genome with itself). Rows of
    ``_MAX_WIDTH`` bytes or more are counted in column chunks, each a view
    of the panel, and the int32 chunk counts summed in int64. Returns
    int64 numpy arrays.
    """
    n, width = rows.shape
    matches = np.zeros((n, n), dtype=np.int64)
    homs = np.zeros((n, n), dtype=np.int64)
    step = _chunk_bytes()
    for start in range(0, max(width, 1), step):
        chunk = rows[:, start : start + step]
        m, h = cross_counts(chunk, chunk, symmetric=True)
        matches += m.cpu().numpy()
        homs += h.cpu().numpy()
    matches, homs = _mirror_upper(matches), _mirror_upper(homs)
    return homs - matches, homs


def pair_counts(
    states: np.ndarray, device: torch.device
) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs (substitutions, homologs) of an [N, L] uint8 pileup,
    packed on the host and copied to ``device``."""
    return pair_counts_rows(to_device(pack_rows(states), device))
