"""One group's pileup rows, built and split-nibble packed on the device.

The port of the JAX package's phylonium_tpu/ops/pileup_device.py (the XLA
program ``_build_packed`` and its wrapper ``build_packed_rows_device``,
and ``build_pileup_device``, the serial path's device pileup, which runs
here through the same kernel).
The host prep is the port's copy of the JAX package's
``ops/pileup_prep.py``: ``group_payload`` packs the group's queries into 2-bit
codes, ``prep_intervals`` turns its homologies into (start, end, B, dir)
records, and ``build_overlay`` lists the (row, col, state) entries that
the 2-bit codes cannot carry. The device half is one CUDA kernel
(csrc/pileup_build.cu) beside its plain PyTorch version; both write

    out[g, j] = state[g, j] | state[g, j + l2] << 4    (j < l2 = ceil(L/2))

and INVALID in both nibbles beyond, into a row slice of the panel, byte
for byte what the JAX program returns at the same width.

The overlay goes to the device sorted by (row, col) with per-row offsets,
so the kernel reads a tile's entries instead of scattering them: two
entries of one row (c and c + l2) share a byte.

A CUDA tensor goes to the kernel; a CPU tensor goes to the plain version.
The route follows the output's device and nothing else: a kernel that
fails to build or launch raises.

``build_pileup_device`` builds a whole panel: it cuts the genomes into
groups (``row_groups``) and builds them through the streamed feeder
(core/stream.py), whose worker preps group k + 1 on the host while the
card builds group k.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from phylonium_tpu_torch.config import ConfigError
from phylonium_tpu_torch.core.pileup import INVALID, N_BASE
from phylonium_tpu_torch.ops.pileup_prep import (
    _MAX_GROUP_BASES,
    build_overlay,
    group_payload,
    prep_intervals,
)
from phylonium_tpu_torch.ops import _build

# launches of the CUDA kernel, and calls of the plain version on the CPU
# route, since the last reset (callers set them to 0)
KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0

_INVALID_PAIR = INVALID | (INVALID << 4)

# The kernel's tiling (csrc/pileup_build.cu: kTile, kRecChunk,
# kOverlayChunk): a block makes TILE_BYTES output bytes of one row, 16 a
# thread, and stages the records and overlay entries of each of its two
# column spans in shared memory RECORD_CHUNK and OVERLAY_CHUNK at a time.
# The tests build their edge cases from these.
TILE_BYTES = 4096
RECORD_CHUNK = 128
OVERLAY_CHUNK = 512


class GroupInputs(NamedTuple):
    """Host arrays of one group build, as the kernel reads them."""

    words: np.ndarray      # int32 [n_words]: the 2-bit codes' uint32 words
                           # (a device tensor where the group is resident)
    intervals: np.ndarray  # int64 [rows, H, 4]: (start, end, B, dir)
    offsets: np.ndarray    # int64 [rows + 1]: row g's overlay entries
    cols: np.ndarray       # int32 [K]: overlay columns, sorted per row
    vals: np.ndarray       # uint8 [K]: overlay states


def sort_overlay(overlay, rows: int):
    """``build_overlay``'s (row, col, val) -> (offsets, cols, vals).

    Drops the padding entries (row >= rows) and sorts by (row, col); row
    g's entries are ``cols[offsets[g]:offsets[g + 1]]``.
    """
    orow, ocol, oval = (np.asarray(a) for a in overlay)
    keep = orow < rows
    orow, ocol, oval = orow[keep], ocol[keep], oval[keep]
    order = np.lexsort((ocol, orow))
    offsets = np.searchsorted(orow[order], np.arange(rows + 1))
    return (
        offsets.astype(np.int64),
        ocol[order].astype(np.int32),
        oval[order].astype(np.uint8),
    )


def prepare_group(queries: list, homologies: list, ref_len: int,
                  resident=None) -> GroupInputs:
    """Host prep of one group: 2-bit words, records and the sorted overlay.

    ``homologies`` holds per genome a list of Homology objects or a raw
    [H, 5] int64 array of the native mapper. ``resident`` (optional) is a
    (words, bases, seps) triple for THIS group whose words already lie on
    the device (the early query shipper's, core/query_ship.py): then
    ``group_payload`` is skipped and the returned ``words`` is that
    tensor, as the JAX ``build_packed_rows_device(resident=...)`` does
    (phylonium_tpu/ops/pileup_device.py:234). Raises ConfigError, as the
    JAX package does, when the group's query bases need more than int32
    indexing.
    """
    limit = _MAX_GROUP_BASES - 2 * ref_len - 1
    if queries and sum(len(q) for q in queries) > limit:
        raise ConfigError(
            "device pileup group exceeds int32 indexing; use smaller "
            "row groups"
        )
    if resident is None:
        packed32, bases, seps = group_payload(queries)
        words = packed32.view(np.int32)
    else:
        words, bases, seps = resident
    intervals = prep_intervals(homologies, bases, ref_len)
    overlay = build_overlay(intervals, queries, bases, seps, ref_len)
    return GroupInputs(
        words, intervals, *sort_overlay(overlay, intervals.shape[0]),
    )


def _check(words, intervals, overlay, ref_len: int, out: torch.Tensor) -> None:
    offsets, cols, vals = overlay
    if out.dtype != torch.uint8 or out.dim() != 2:
        raise ValueError(
            f"out must be a 2-D uint8 tensor, got {out.dtype} with shape "
            f"{tuple(out.shape)}"
        )
    if out.stride(1) != 1:
        raise ValueError("out's rows must be contiguous")
    if ref_len < 1:
        raise ValueError(f"ref_len must be >= 1, got {ref_len}")
    rows, width = out.shape
    l2 = -(-ref_len // 2)
    if width < l2:
        raise ValueError(f"out holds {width} bytes a row, fewer than {l2}")
    expect = {
        "words": (words, torch.int32, 1),
        "intervals": (intervals, torch.int64, 3),
        "offsets": (offsets, torch.int64, 1),
        "cols": (cols, torch.int32, 1),
        "vals": (vals, torch.uint8, 1),
    }
    for name, (t, dtype, dim) in expect.items():
        if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous {dim}-D {dtype} tensor, got "
                f"{t.dtype} with shape {tuple(t.shape)}"
            )
        if t.device != out.device:
            raise ValueError(f"{name} is on {t.device} but out on {out.device}")
    if words.numel() < 1:
        raise ValueError("words holds no 2-bit codes")
    if intervals.shape[0] != rows or intervals.shape[1] < 1 or intervals.shape[2] != 4:
        raise ValueError(
            f"intervals must be [{rows}, H >= 1, 4], got {tuple(intervals.shape)}"
        )
    if offsets.numel() != rows + 1 or cols.numel() != vals.numel():
        raise ValueError(
            f"the overlay needs {rows + 1} offsets and one value per column, "
            f"got {offsets.numel()} offsets, {cols.numel()} columns and "
            f"{vals.numel()} values"
        )


def _plain(words, intervals, overlay, ref_len: int, out: torch.Tensor) -> None:
    offsets, cols, vals = overlay
    rows = out.shape[0]
    device = out.device
    start, end, base, direction = intervals.unbind(-1)
    # coverage: +1 at each start, -1 at each end; padding records sit at
    # ref_len, the slot past the last column
    delta = torch.zeros((rows, ref_len + 1), dtype=torch.int64, device=device)
    delta.scatter_add_(1, start, torch.ones_like(start))
    delta.scatter_add_(1, end, -torch.ones_like(end))
    covered = delta[:, :ref_len].cumsum(1) > 0
    # (B, dir) of the last record starting at or before each column:
    # successive differences scattered at the starts, then summed
    fill = torch.zeros((2, rows, ref_len + 1), dtype=torch.int64, device=device)
    for k, values in enumerate((base, direction)):
        steps = values.diff(dim=1, prepend=torch.zeros_like(values[:, :1]))
        fill[k].scatter_add_(1, start, steps)
    b, d = fill[:, :, :ref_len].cumsum(2)
    col = torch.arange(ref_len, dtype=torch.int64, device=device)
    q = torch.where(d == 1, b - col, b + col).clamp_(0, 16 * words.numel() - 1)
    word = words.to(torch.int64) & 0xFFFFFFFF
    code = (word[q >> 4] >> ((q & 15) * 2)) & 3
    state = torch.where(covered, code + N_BASE * d, INVALID).to(torch.uint8)
    if cols.numel():
        row = torch.repeat_interleave(
            torch.arange(rows, device=device), offsets.diff()
        )
        state.index_put_((row, cols.to(torch.int64)), vals)
    l2 = -(-ref_len // 2)
    if 2 * l2 > ref_len:
        state = torch.cat(
            (state, torch.full((rows, 1), INVALID, dtype=torch.uint8,
                               device=device)), dim=1,
        )
    out[:, :l2] = state[:, :l2] | (state[:, l2:] << 4)
    out[:, l2:] = _INVALID_PAIR


def build_packed_rows_reference(
    words, intervals, overlay, ref_len: int, out: torch.Tensor
) -> None:
    """The plain PyTorch version: scatter-and-cumsum rasters, one gather of
    codes, the overlay by ``index_put_``, the nibble pack.

    Takes what :func:`build_packed_rows` takes and writes the same bytes,
    on whatever device ``out`` is.
    """
    _check(words, intervals, overlay, ref_len, out)
    _plain(words, intervals, overlay, ref_len, out)


def _launch(words, intervals, overlay, ref_len: int, out: torch.Tensor,
            lib=None) -> None:
    """One launch of ``pt_pileup_build`` from ``lib`` (the package's
    library by default; tools/compare_kernels.py passes an older build)."""
    offsets, cols, vals = overlay
    lib = lib or _build.load()
    rows, width = out.shape
    with torch.cuda.device(out.device):
        err = lib.pt_pileup_build(
            words.data_ptr(), words.numel(),
            intervals.data_ptr(), rows, intervals.shape[1],
            offsets.data_ptr(), cols.data_ptr(), vals.data_ptr(),
            ref_len, width, out.data_ptr(), out.stride(0),
            torch.cuda.current_stream(out.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"pt_pileup_build: CUDA error {err}")


def build_packed_rows(
    words: torch.Tensor,
    intervals: torch.Tensor,
    overlay: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    ref_len: int,
    out: torch.Tensor,
) -> None:
    """Write one group's split-nibble rows into ``out`` ([rows, W] uint8).

    The inputs are :class:`GroupInputs`' arrays as tensors on ``out``'s
    device: ``words`` int32 [n_words], ``intervals`` int64 [rows, H, 4] and
    ``overlay`` = (offsets int64 [rows + 1], cols int32 [K], vals uint8
    [K]). ``out`` may be a row slice of a larger panel; W >= ceil(L/2).
    """
    global KERNEL_LAUNCHES, PLAIN_CALLS
    _check(words, intervals, overlay, ref_len, out)
    if out.device.type == "cuda":
        _launch(words, intervals, overlay, ref_len, out)
        KERNEL_LAUNCHES += 1
        return
    if out.device.type != "cpu":
        raise ValueError(f"no pileup-build route for device {out.device}")
    PLAIN_CALLS += 1
    _plain(words, intervals, overlay, ref_len, out)


def row_groups(lengths: list[int], ref_len: int, group_rows: int) -> list[tuple[int, int]]:
    """[lo, hi) row ranges of a device build: at most ``group_rows`` genomes
    each, their query bases below the int32 limit.

    The limit, ``_MAX_GROUP_BASES - 2 * ref_len - 1``, and the greedy cut
    are the JAX package's (phylonium_tpu/ops/pileup_device.py:303-338).
    A single query above the limit raises ConfigError, as there.
    """
    limit = _MAX_GROUP_BASES - 2 * ref_len - 1
    longest = max(lengths, default=0)
    if longest > limit:
        raise ConfigError(
            "device pileup builder addresses queries with int32 indices; a "
            f"{longest}-base query needs the host builder (unset "
            "PHYLONIUM_TPU_DEVICE_PILEUP)"
        )
    bounds = []
    lo = 0
    while lo < len(lengths):
        hi, bases = lo + 1, lengths[lo]
        while (hi < len(lengths) and hi - lo < group_rows
               and bases + lengths[hi] < limit):
            bases += lengths[hi]
            hi += 1
        bounds.append((lo, hi))
        lo = hi
    return bounds


def build_pileup_device(
    queries: list[np.ndarray],
    homologies: list,
    ref_len: int,
    device: torch.device,
) -> torch.Tensor:
    """The [N, W] split-nibble pileup panel, built on ``device``.

    The counterpart of the JAX package's ``build_pileup_device``
    (phylonium_tpu/ops/pileup_device.py:287): the serial path's pileup
    under ``PHYLONIUM_TPU_DEVICE_PILEUP=1``, after complete deletion, from
    any mapper's homologies. No kernel of its own: each group of
    ``row_groups`` (at most the streamed feeder's ``effective_group_rows``
    genomes) goes through ``prepare_group`` and
    ``build_packed_rows`` into one resident panel, which
    ``ops.pair_count.pair_counts_rows`` counts as it stands. Where the JAX
    program returned [N, L] states padded to a shape bucket, this returns
    ``pack_rows`` of the host pileup, byte for byte. Returns once every
    group is built.
    """
    from phylonium_tpu_torch.core.stream import DeviceRowFeeder, effective_group_rows

    n = len(queries)
    bounds = row_groups([len(q) for q in queries], ref_len, effective_group_rows(n))
    feeder = DeviceRowFeeder(n, ref_len, device)
    try:
        for lo, hi in bounds:
            feeder.feed(queries[lo:hi], homologies[lo:hi])
        panel = feeder.built()
    except BaseException:
        feeder.cancel()
        raise
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return panel
