"""Anchor extension: diagonal mismatch bitmaps and capped LCE.

The port of the JAX package's phylonium_tpu/ops/anchor_extend.py (the XLA
ops ``diagonal_neq`` and ``lce_batch``) and of
phylonium_tpu/ops/anchor_extend_pallas.py (the Pallas kernel
``_diagonal_neq_pallas``). Both JAX forms of ``diagonal_neq`` compute one
function; here it is one CUDA kernel (csrc/diagonal_neq.cu) beside its
plain PyTorch version:

    for job j and i < length:
        neq[j, i] = a[off_a[j] + i] != b[off_b[j] + i]
                    or off_a[j] + i >= lim_a[j]
                    or off_b[j] + i >= lim_b[j]

A row comes back as packed words, int32 [B, ceil(length / 32)]: bit
``i % 32`` of word ``i // 32`` is position i, and the bits past
``length`` in the last word are 0. That is an eighth of a bool row, and
what the host unpacks with :func:`unpack_bits`.

Texts are 1-D uint8 tensors, unpadded: the kernel predicates its loads on
the limits, so no sentinel bytes are needed. Offsets and limits are int64
and the kernel computes positions in 64 bits.

A CUDA tensor goes to the kernel; a CPU tensor goes to the plain version.
The route follows the tensor's device and nothing else: a kernel that
fails to build or launch raises.
"""

from __future__ import annotations

import numpy as np
import torch

from phylonium_tpu_torch.ops import _build

# launches of the CUDA kernel, and calls of the plain version on the CPU
# route, since the last reset (callers set them to 0)
KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0

_BIT_WEIGHTS = 1 << torch.arange(8, dtype=torch.uint8)


def words_per_row(length: int) -> int:
    return -(-length // 32)


def _jobs(text_len: int, off, lim, name: str, nb: int | None) -> tuple:
    """Host int64 offsets and limits of one text, checked."""
    off = np.asarray(off, np.int64)
    if off.ndim != 1 or (nb is not None and off.shape != (nb,)):
        raise ValueError(
            f"off_{name} must be 1-D with one offset per job, got shape "
            f"{off.shape}"
        )
    lim = np.broadcast_to(np.asarray(lim, np.int64), off.shape)
    if off.size and off.min() < 0:
        raise ValueError(f"off_{name} holds a negative offset ({off.min()})")
    if lim.size and lim.max() > text_len:
        raise ValueError(
            f"lim_{name} holds {lim.max()}, beyond its text's "
            f"{text_len} bytes"
        )
    return off, lim


def _check(a: torch.Tensor, b: torch.Tensor, length: int = 0) -> None:
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.uint8 or t.dim() != 1:
            raise ValueError(
                f"{name} must be a 1-D uint8 tensor, got {t.dtype} with "
                f"shape {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device} but b is on {b.device}")
    if length < 0:
        raise ValueError(f"length must be >= 0, got {length}")


def pack_bits(neq: torch.Tensor) -> torch.Tensor:
    """bool [B, L] -> int32 words [B, ceil(L/32)], little bit order."""
    nb, length = neq.shape
    words = words_per_row(length)
    if words == 0:
        return torch.zeros((nb, 0), dtype=torch.int32, device=neq.device)
    padded = torch.zeros((nb, words * 32), dtype=torch.uint8,
                         device=neq.device)
    padded[:, :length] = neq
    weights = _BIT_WEIGHTS.to(neq.device)
    packed = (padded.view(nb, words * 4, 8) * weights).sum(
        -1, dtype=torch.uint8
    )
    return packed.view(torch.int32)


def unpack_bits(words, length: int) -> np.ndarray:
    """int32 words [B, W] (tensor or array) -> bool [B, length] on the host."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    raw = np.ascontiguousarray(words, dtype="<i4").view(np.uint8)
    bits = np.unpackbits(raw, axis=1, count=length, bitorder="little")
    return bits.view(bool)


def _job_tensor(a, b, off_a, off_b, lim_a, lim_b) -> torch.Tensor:
    """Checked jobs as one int64 [4, B] tensor on the texts' device:
    off_a, off_b, lim_a, lim_b (one host-to-device copy)."""
    off_a, lim_a = _jobs(a.numel(), off_a, lim_a, "a", None)
    off_b, lim_b = _jobs(b.numel(), off_b, lim_b, "b", off_a.shape[0])
    return torch.from_numpy(np.stack([off_a, off_b, lim_a, lim_b])).to(a.device)


def _plain(a, b, jobs: torch.Tensor, length: int) -> torch.Tensor:
    off_a, off_b, lim_a, lim_b = jobs
    i = torch.arange(length, dtype=torch.int64, device=a.device)
    pa = off_a[:, None] + i
    pb = off_b[:, None] + i
    inside = (pa < lim_a[:, None]) & (pb < lim_b[:, None])
    # clamp into the texts: a clamped byte is read only where `inside`
    # is already False, so its value never reaches the result; an empty
    # text has every limit at 0 and reads as one byte that nothing uses
    a = a if a.numel() else a.new_zeros(1)
    b = b if b.numel() else b.new_zeros(1)
    va = a[pa.clamp_(0, a.numel() - 1)]
    vb = b[pb.clamp_(0, b.numel() - 1)]
    return pack_bits((va != vb) | ~inside)


def diagonal_neq_bits_reference(
    a: torch.Tensor, b: torch.Tensor, off_a, off_b, lim_a, lim_b, length: int
) -> torch.Tensor:
    """The plain PyTorch version: gather, compare, force past-limit bits.

    Takes what :func:`diagonal_neq` takes and returns the same words, on
    the texts' device, whatever that device is.
    """
    _check(a, b, length)
    return _plain(a, b, _job_tensor(a, b, off_a, off_b, lim_a, lim_b), length)


def _launch(a, b, jobs: torch.Tensor, length: int, lib=None) -> torch.Tensor:
    """One launch of ``pt_diagonal_neq`` from ``lib`` (the package's
    library by default; tools/compare_kernels.py passes an older build)."""
    lib = lib or _build.load()
    nb = jobs.shape[1]
    with torch.cuda.device(a.device):
        out = torch.empty(
            (nb, words_per_row(length)), dtype=torch.int32, device=a.device
        )
        err = lib.pt_diagonal_neq(
            a.data_ptr(), a.numel(), b.data_ptr(), b.numel(),
            jobs[0].data_ptr(), jobs[1].data_ptr(),
            jobs[2].data_ptr(), jobs[3].data_ptr(),
            nb, length, out.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"pt_diagonal_neq: CUDA error {err}")
    return out


def diagonal_neq(
    a: torch.Tensor, b: torch.Tensor, off_a, off_b, lim_a, lim_b, length: int
) -> torch.Tensor:
    """Mismatch bitmaps of B diagonals as packed words on the texts' device.

    ``a``/``b``: 1-D uint8 texts on one device. ``off_*``: host arrays of
    B non-negative offsets; ``lim_*``: the texts' true ends per job (or
    one value for all), at most the text's length. Positions at or past a
    limit report a mismatch, as in the JAX package
    (anchor_extend.py:153-158). Returns int32 [B, ceil(length/32)].
    """
    global KERNEL_LAUNCHES, PLAIN_CALLS
    _check(a, b, length)
    jobs = _job_tensor(a, b, off_a, off_b, lim_a, lim_b)
    if a.device.type == "cuda":
        out = _launch(a, b, jobs, length)
        KERNEL_LAUNCHES += 1
        return out
    if a.device.type != "cpu":
        raise ValueError(f"no diagonal_neq route for device {a.device}")
    PLAIN_CALLS += 1
    return _plain(a, b, jobs, length)


def lce_batch(
    a: torch.Tensor, b: torch.Tensor, off_a, off_b, cap
) -> torch.Tensor:
    """Longest common extension of B suffix pairs, capped (plain torch).

    The number of leading equal bytes of ``a[off_a:]`` and ``b[off_b:]``
    per job, at most ``cap`` and never past either text's end: the
    semantics of the JAX package's ``lce_batch`` (anchor_extend.py:91-110)
    with its sentinel padding. ``off_*`` and ``cap`` are host arrays or
    tensors [B]. Returns int64 [B] on the texts' device. Nothing on the
    mapping path calls it; it stays for the anchor-extension API.
    """
    _check(a, b)
    device = a.device
    off_a = torch.as_tensor(np.asarray(off_a, np.int64), device=device)
    off_b = torch.as_tensor(np.asarray(off_b, np.int64), device=device)
    cap = torch.as_tensor(np.asarray(cap, np.int64), device=device)
    cap = torch.minimum(cap, torch.minimum(a.numel() - off_a, b.numel() - off_b))
    cap = cap.clamp(min=0)
    span = int(cap.max()) if cap.numel() else 0
    if span == 0:
        return torch.zeros_like(cap)
    i = torch.arange(span, dtype=torch.int64, device=device)
    inside = i < cap[:, None]
    va = a[(off_a[:, None] + i).clamp_(0, a.numel() - 1)]
    vb = b[(off_b[:, None] + i).clamp_(0, b.numel() - 1)]
    stop = (va != vb) | ~inside
    # first stop per row; a row with no stop runs its full span (== cap)
    first = torch.where(stop.any(1), stop.to(torch.uint8).argmax(1), span)
    return torch.minimum(first, cap)
