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

``DevicePanel`` is the one [rows, W] panel that groups are built into
and counted from: the streamed feeder's in process (core/stream.py), the
device server's (serve/daemon.py) and ``build_pileup_device``'s, the
serial path's device pileup, which cuts the genomes into groups
(``row_groups``) and preps group k + 1 on the host while the card builds
group k.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from phylonium_tpu_torch.core.pileup import INVALID, N_BASE
from phylonium_tpu_torch.ops import _build, pair_count

# the host half, which loads without torch; re-exported under this
# module's names
from phylonium_tpu_torch.ops.pileup_groups import (  # noqa: F401
    effective_group_rows,
    prepare_group,
    row_groups,
    sort_overlay,
)
from phylonium_tpu_torch.ops.shapes import _PACKED_PAD, packed_width
from phylonium_tpu_torch.ops.states import to_device
from phylonium_tpu_torch.utils import profile

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

    The inputs are ``ops.pileup_groups.GroupInputs``' arrays as tensors on ``out``'s
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


class DevicePanel:
    """An [rows, W] packed panel on ``device``, built group by group and
    counted.

    ``build`` writes one group's rows; ``ready`` returns the panel with
    the current stream ordered after every build; ``count`` counts it.
    Rows ``n`` and beyond hold packed INVALID and count nothing (the pod
    feeder's padding rows, parallel/stream_mp.py).

    On a card the panel is allocated on the current stream and built on
    ``stream`` (default: a side stream of its own), which starts after
    the current stream's work so far; each build's host arrays are copied
    there through pinned memory (``ops.states.to_device``), in a
    ``copy_span`` span where one is named, and an event after each build
    orders the count. On a CPU device each build runs the plain version at
    once. ``lock`` is held around each launch (the device server's
    ``kernel_lock``); ``launches`` counts this panel's launches and plain
    calls of the build and the count, under the device server's names.
    """

    def __init__(self, n: int, ref_len: int, device: torch.device,
                 rows: int | None = None, stream=None, lock=None,
                 copy_span: str | None = None):
        rows = n if rows is None else rows
        if rows < n:
            raise ValueError(f"a panel of {rows} rows cannot hold {n} genomes")
        self.n = n
        self.ref_len = ref_len
        self.device = device
        self.rows_built = 0
        self.launches = dict.fromkeys(("build", "build_plain", "count", "count_plain"), 0)
        self._lock = lock or contextlib.nullcontext()
        self._copy_span = copy_span if device.type == "cuda" else None
        self._events: list = []
        self.panel = torch.empty((rows, packed_width(ref_len)), dtype=torch.uint8,
                                 device=device)
        self.stream = None
        if device.type == "cuda":
            self.stream = stream or torch.cuda.Stream(device)
            # the panel's memory may have served earlier work on the
            # current stream: the build stream starts after it
            self.stream.wait_stream(torch.cuda.current_stream(device))
            self.panel.record_stream(self.stream)
        if rows > n:
            # a rank with no genomes of its own builds nothing: ready()
            # orders the current stream after the padding
            with self._enqueued():
                self.panel[n:].fill_(_PACKED_PAD)

    @contextlib.contextmanager
    def _enqueued(self):
        """Work enqueued on the build stream, with an event after it; on a
        CPU device it runs as it is called."""
        if self.stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            yield
            event = torch.cuda.Event()
            event.record(self.stream)
        self._events.append(event)

    def build(self, lo: int, words, records, wait=None) -> None:
        """Write one group's rows [lo, lo + rows) (``build_packed_rows``).

        ``words`` and ``records`` (intervals, offsets, cols, vals:
        ``GroupInputs`` after its words) are host arrays, copied here, or
        tensors already on the device, which the build stream then holds
        until it has read them. ``wait``: an event the build waits for
        first (the early shipper's copy of ``words``).
        """
        inputs = [words, *records]
        rows = records[0].shape[0]
        with self._enqueued():
            if wait is not None:
                self.stream.wait_event(wait)
            host = [a for a in inputs if not torch.is_tensor(a)]
            with (profile.span(self._copy_span, attrs={"bytes": sum(a.nbytes for a in host)})
                  if self._copy_span else contextlib.nullcontext()):
                inputs = [a if torch.is_tensor(a) else to_device(a, self.device, self.stream)
                          for a in inputs]
            if self.stream is not None:
                for t in inputs:
                    t.record_stream(self.stream)
            with self._lock:
                before = KERNEL_LAUNCHES, PLAIN_CALLS
                build_packed_rows(inputs[0], inputs[1], tuple(inputs[2:]), self.ref_len,
                                  self.panel[lo : lo + rows])
                self.launches["build"] += KERNEL_LAUNCHES - before[0]
                self.launches["build_plain"] += PLAIN_CALLS - before[1]
        self.rows_built += rows

    def ready(self) -> torch.Tensor:
        """The panel, with the current stream ordered after its builds."""
        if self.stream is not None:
            current = torch.cuda.current_stream(self.device)
            for event in self._events:
                current.wait_event(event)
        return self.panel

    def count(self) -> tuple[np.ndarray, np.ndarray]:
        """int64 (subs, homs) of the whole panel
        (``ops.pair_count.pair_counts_rows``), after its builds."""
        panel = self.ready()
        with self._lock:
            before = pair_count.KERNEL_LAUNCHES, pair_count.PLAIN_CALLS
            counts = pair_count.pair_counts_rows(panel)
            self.launches["count"] += pair_count.KERNEL_LAUNCHES - before[0]
            self.launches["count_plain"] += pair_count.PLAIN_CALLS - before[1]
        return counts

    def synchronize(self) -> None:
        """Block until every build enqueued so far has run."""
        if self.stream is not None:
            self.stream.synchronize()


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
    ``row_groups`` (at most ``effective_group_rows`` genomes, the streamed
    feeder's) goes through ``prepare_group`` and ``DevicePanel.build``,
    which ``ops.pair_count.pair_counts_rows`` counts as it stands. Where
    the JAX program returned [N, L] states padded to a shape bucket, this
    returns ``pack_rows`` of the host pileup, byte for byte. Each group is
    prepped and built on the caller's thread in a ``feed.group`` span with
    its ``feed.prep``, as the feeder records them. Returns once every
    group is built.
    """
    n = len(queries)
    panel = DevicePanel(n, ref_len, device)
    for lo, hi in row_groups([len(q) for q in queries], ref_len, effective_group_rows(n)):
        with profile.span(profile.GROUP_RANGE, attrs={"lo": lo, "rows": hi - lo}):
            with profile.span("feed.prep"):
                words, *records = prepare_group(queries[lo:hi], homologies[lo:hi], ref_len)
            panel.build(lo, words, records)
    panel.synchronize()
    return panel.ready()
