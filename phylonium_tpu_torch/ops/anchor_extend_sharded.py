"""Sharded-text anchor extension (X5): the index text split across devices.

The port of the JAX package's phylonium_tpu/ops/anchor_extend_sharded.py.
The sentinel-padded index text splits into ``S`` contiguous shards of
``width`` bytes, each carrying a ``tile``-byte halo copied from its right
neighbour (:func:`shard_text`, byte-equal to the JAX package's). Query
bytes are replicated: the hybrid mapper bounds the query batch, and the
reference text is what grows.

:func:`diagonal_neq_sharded` computes what ``ops.anchor_extend.diagonal_neq``
computes, as packed words, with the ``a`` text given as shards. Shard ``s``
lies on ``devices[s]`` (several shards may share a device) and answers
only for the words it owns: word ``w`` of job ``j`` belongs to the shard
whose range ``[s * width, (s + 1) * width)`` holds ``off_a[j] + 32 w``,
the last shard owning everything past the end. The JAX op owns
``tile``-byte rounds; a word is a finer unit with the same property, one
owner for every position, and the halo covers the 31 bytes an owned word
reads past its shard as long as ``tile >= 32``. The owner applies the
limits, every other shard writes the word 0, and the rows merge by an OR
on the first device, which equals the JAX op's ``psum > 0``.

On a card the shard step is ``pt_diagonal_neq_shard`` of
csrc/diagonal_neq.cu, the K3 kernel with a base and an owned range; on
the CPU it is the plain version :func:`diagonal_neq_shard_reference`. The
route follows each shard's device: a kernel that fails to build or launch
raises. The sharding needs no collective: it stays inside one process, so
it also runs under the multi-rank map split, where each rank maps other
queries.
"""

from __future__ import annotations

import numpy as np
import torch

from phylonium_tpu_torch.ops import _build
from phylonium_tpu_torch.ops.anchor_extend import (
    _check,
    _jobs,
    pack_bits,
    words_per_row,
)

# launches of the shard kernel, and calls of the plain version on the CPU
# route, since the last reset (callers set them to 0)
KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0

# the JAX package's ops/anchor_extend.py sentinel past the a text's end
SENTINEL_A = 0xFD
# bytes an owned word reads past its first position
_WORD_REACH = 31
_UNBOUNDED = (1 << 63) - 1


def shard_text(text: np.ndarray, n_shards: int, tile: int) -> np.ndarray:
    """[S, width + tile] host array: contiguous shards + right halo.

    ``width = ceil(len(text) / S)``; bytes past the text's end hold the
    sentinel. Byte-equal to the JAX package's ``shard_text``.
    """
    n = text.shape[0]
    width = -(-n // n_shards)
    padded = np.full(n_shards * width + tile, SENTINEL_A, dtype=np.uint8)
    padded[:n] = text
    out = np.empty((n_shards, width + tile), dtype=np.uint8)
    for s in range(n_shards):
        out[s] = padded[s * width : s * width + width + tile]
    return out


def shard_devices(device: torch.device) -> list[torch.device]:
    """The local devices of ``device``'s type, one shard each: every CUDA
    card of this process, or the one CPU."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(device.type)]


def place(tensors, devices: list[torch.device]) -> list[torch.Tensor]:
    """One tensor a device: ``tensors`` a host array with a row per device,
    or a tensor copied to every device, one copy per distinct device."""
    if isinstance(tensors, np.ndarray):
        return [torch.from_numpy(np.ascontiguousarray(row)).to(d)
                for row, d in zip(tensors, devices)]
    copies = {}
    for d in devices:
        if d not in copies:
            copies[d] = tensors.to(d)
    return [copies[d] for d in devices]


def _own_end(s: int, n_shards: int, width: int) -> int:
    return _UNBOUNDED if s == n_shards - 1 else (s + 1) * width


def diagonal_neq_shard_reference(
    shard: torch.Tensor, base: int, own_end: int, b: torch.Tensor,
    jobs: torch.Tensor, length: int,
) -> torch.Tensor:
    """The plain PyTorch version of one shard's step, on the shard's device.

    ``shard`` holds global a-positions ``[base, base + len(shard))``;
    ``jobs`` is int64 [4, B] (off_a, off_b, lim_a, lim_b, global). Returns
    the rows' words: owned words as ``diagonal_neq`` computes them, every
    other word 0.
    """
    off_a, off_b, lim_a, lim_b = jobs
    i = torch.arange(length, dtype=torch.int64, device=shard.device)
    pa = off_a[:, None] + i
    pb = off_b[:, None] + i
    stop_a = torch.clamp(lim_a, max=base + shard.numel())
    inside = (pa < stop_a[:, None]) & (pb < lim_b[:, None])
    shard = shard if shard.numel() else shard.new_zeros(1)
    b = b if b.numel() else b.new_zeros(1)
    va = shard[(pa - base).clamp_(0, shard.numel() - 1)]
    vb = b[pb.clamp_(0, b.numel() - 1)]
    word_start = off_a[:, None] + (i // 32) * 32
    owned = (word_start >= base) & (word_start < own_end)
    return pack_bits(((va != vb) | ~inside) & owned)


def _launch(shard, base: int, own_end: int, b, jobs, length: int) -> torch.Tensor:
    lib = _build.load()
    nb = jobs.shape[1]
    with torch.cuda.device(shard.device):
        out = torch.empty(
            (nb, words_per_row(length)), dtype=torch.int32, device=shard.device
        )
        err = lib.pt_diagonal_neq_shard(
            shard.data_ptr(), shard.numel(), base, own_end,
            b.data_ptr(), b.numel(),
            jobs[0].data_ptr(), jobs[1].data_ptr(),
            jobs[2].data_ptr(), jobs[3].data_ptr(),
            nb, length, out.data_ptr(),
            torch.cuda.current_stream(shard.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"pt_diagonal_neq_shard: CUDA error {err}")
    return out


def diagonal_neq_shard(shard, base: int, own_end: int, b, jobs, length: int):
    """One shard's words: the kernel for a CUDA shard, the plain version
    for a CPU one."""
    global KERNEL_LAUNCHES, PLAIN_CALLS
    if shard.device.type == "cuda":
        out = _launch(shard, base, own_end, b, jobs, length)
        KERNEL_LAUNCHES += 1
        return out
    if shard.device.type != "cpu":
        raise ValueError(f"no diagonal_neq_shard route for device {shard.device}")
    PLAIN_CALLS += 1
    return diagonal_neq_shard_reference(shard, base, own_end, b, jobs, length)


def diagonal_neq_sharded(
    shards, b, off_a, off_b, lim_a, lim_b, length: int,
    devices: list[torch.device], tile: int,
) -> torch.Tensor:
    """Sharded-text counterpart of ``ops.anchor_extend.diagonal_neq``.

    ``shards``: the host array of :func:`shard_text`, or its rows already
    placed (``place(shards, devices)``), one per entry of ``devices``.
    ``b``: the replicated text, a tensor or its copies from ``place``.
    ``off_*``/``lim_*``: global host offsets and limits, as
    ``diagonal_neq`` takes them; ``lim_a`` at most ``S * width``. Returns
    int32 words [B, ceil(length / 32)] on ``devices[0]``, equal to
    ``diagonal_neq`` on the unsharded text.
    """
    n_shards = len(devices)
    if len(shards) != n_shards:
        raise ValueError(f"{len(shards)} shards for {n_shards} devices")
    if tile < _WORD_REACH + 1:
        raise ValueError(f"tile {tile} is below the {_WORD_REACH + 1} bytes an owned word reads")
    width = shards[0].shape[0] - tile
    if width < 1:
        raise ValueError(f"shards of {shards[0].shape[0]} bytes hold no text past a {tile}-byte halo")
    shards = place(shards, devices) if isinstance(shards, np.ndarray) else list(shards)
    replicas = list(b) if isinstance(b, (list, tuple)) else place(b, devices)
    for s in range(n_shards):
        _check(shards[s], replicas[s], length)
    off_a, lim_a = _jobs(n_shards * width, off_a, lim_a, "a", None)
    off_b, lim_b = _jobs(replicas[0].numel(), off_b, lim_b, "b", off_a.shape[0])
    jobs = torch.from_numpy(np.stack([off_a, off_b, lim_a, lim_b]))
    return merge(shards, replicas, place(jobs, devices), length, width,
                 diagonal_neq_shard)


def merge(shards, replicas, jobs, length: int, width: int, step) -> torch.Tensor:
    """Every shard's words from ``step`` (``diagonal_neq_shard``, its
    kernel ``_launch`` or its plain version), ORed on the first shard's
    device. ``jobs``: the int64 [4, B] jobs, one copy a shard."""
    out = None
    for s, shard in enumerate(shards):
        words = step(shard, s * width, _own_end(s, len(shards), width),
                     replicas[s], jobs[s], length)
        out = words if out is None else out.bitwise_or_(words.to(out.device))
    return out
