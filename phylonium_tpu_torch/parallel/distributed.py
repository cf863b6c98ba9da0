"""Sharded all-pairs counting over a mesh of ranks or of local devices (X3s).

The port of the JAX package's phylonium_tpu/parallel/distributed.py
(``_local_counts_pallas`` under ``shard_map``). The packed pileup
``[n_pad, l_pad]`` is split ``('rows', 'cols')``: cell ``(i, c)`` holds
genome block ``i`` of column shard ``c``.

On a mesh of ranks each rank

- packs its genome block on the host and copies only its own cell to its
  device (``pair_counts_sharded``), or finds the cell already built there
  by the pod feeder (parallel/stream_mp.py); ``counts_from_cell`` runs the
  rest on the resident cell:
- all_gathers the other blocks of its column shard over its column's
  ranks (``rows_group``), the path's only bulk movement;
- counts its block against all of them with the pair-count kernel
  (``ops.pair_count.cross_counts(symmetric=False)``, K2), in column chunks
  below ``_MAX_WIDTH`` as ``pair_counts_rows`` does, summing in int64;
- all_reduces the int64 partials over its row's ranks (``cols_group``);
- all_gathers the reduced row blocks, so that every rank holds the whole
  matrix, as every JAX process does (``gathered_counts``).

On a local mesh (parallel/mesh.py, a process of one rank spanning its
local devices) the process does the same for every cell, with copies for
collectives and no process group (``counts_from_cells``): it packs each
genome block once and copies each cell to its device; puts each column
shard's blocks onto every distinct device of that column's cells, one
copy a device (the row gather); queues every cell's K2 launches before
it waits for any device, so that cells on different cards count at once;
sums each row's partials in int64, in cell order, on the device of the
row's first cell (the column reduction); and assembles the reduced row
blocks on the host.

Counts are integer sums, so any mesh gives the single-device matrix bit
for bit. The JAX package sums int32 with ``psum``; the port's int64 sum is
the same integer. The split-nibble packing is exact under any column
split, because a column sum does not depend on the order of columns;
shards start on ``ROW_ALIGN`` bytes, as the kernel's loads need.

Under gloo the collectives run on host copies (``.cpu()`` before,
``.to(device)`` after), by rule of the backend; the kernel still runs on
the card. Without a card the shard step is the kernel's plain version,
``ops.match_matrix.cross_counts_reference``, through the same wrapper. A
failed collective or kernel raises in its rank: no rank counts on the host
instead, which would leave its peers waiting in the collective; on a local
mesh a failed cell fails the count.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from phylonium_tpu_torch.ops import pair_count
from phylonium_tpu_torch.ops.shapes import _PACKED_PAD, pack_states
from phylonium_tpu_torch.ops.states import ROW_ALIGN, to_device
from phylonium_tpu_torch.parallel.mesh import Mesh
from phylonium_tpu_torch.parallel.multihost import native_stdout_to_stderr

# the bytes this rank's collectives passed in the last sharded count
# (counts_from_cell or counts_from_cells, which pair_counts_sharded
# calls), with its panel and mesh (comm_account reads them), and the host
# seconds of its steps ("seconds": the cells' pack and copy under
# pair_counts_sharded, row gather, count until the devices are done,
# reduction, result gather). On a local mesh the gather and reduction
# bytes are each cell's (the same for every cell, else the list of them).
LAST_COMM: dict = {}

_COMM_KEYS = ("gather_recv_bytes", "psum_bytes", "result_gather_recv_bytes")


def sharded_shape(n: int, length: int, n_rows: int, n_cols: int) -> tuple[int, int, int]:
    """The one source of the sharded geometry: ``(n_pad, lc, l_pad)``.

    Rows pack split-nibble to ``ceil(length / 2)`` bytes; each of the
    ``n_cols`` column shards is ``lc`` bytes, a multiple of ``ROW_ALIGN``,
    and ``l_pad = n_cols * lc``. ``n_pad`` is ``n`` rounded up to a
    multiple of ``n_rows``. Padding holds INVALID and counts nothing.
    """
    half = -(-max(length, 1) // 2)
    per_col = -(-half // n_cols)
    lc = -(-per_col // ROW_ALIGN) * ROW_ALIGN
    n_pad = n + (-n) % n_rows
    return n_pad, lc, n_cols * lc


def _all_gather(t: torch.Tensor, group, mesh: Mesh, key: str) -> list[torch.Tensor]:
    """Every rank's ``t`` over ``group``, in group order, on mesh.device;
    adds the bytes received from the other ranks to LAST_COMM[key]."""
    if mesh.backend is None:
        return [t]
    src = t.cpu() if mesh.backend == "gloo" else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    with native_stdout_to_stderr():
        dist.all_gather(parts, src, group=group)
    me = dist.get_rank(group)
    LAST_COMM[key] += sum(p.nbytes for k, p in enumerate(parts) if k != me)
    return [p.to(mesh.device) for p in parts]


def _all_reduce(t: torch.Tensor, group, mesh: Mesh, key: str) -> torch.Tensor:
    """The sum of ``t`` over ``group``; adds its bytes to LAST_COMM[key]."""
    if mesh.backend is None:
        return t
    buf = t.cpu() if mesh.backend == "gloo" else t
    with native_stdout_to_stderr():
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    LAST_COMM[key] += buf.nbytes
    return buf.to(mesh.device)


def _row_block(states: np.ndarray, i: int, nr: int, l_pad: int) -> np.ndarray:
    """Genome block ``i``, packed: [nr, l_pad] bytes."""
    block = states[i * nr : min((i + 1) * nr, states.shape[0])]
    if block.shape[0]:
        return pack_states(block, nr, l_pad)
    return np.full((nr, l_pad), _PACKED_PAD, dtype=np.uint8)


def _cell_of(packed: np.ndarray, c: int, lc: int) -> np.ndarray:
    return np.ascontiguousarray(packed[:, c * lc : (c + 1) * lc])


def gathered_counts(m: torch.Tensor, h: torch.Tensor, n: int) -> tuple[np.ndarray, np.ndarray]:
    """[n_pad, n_pad] (matches, homologs) -> host int64 (substitutions,
    homologs) [n, n] with zero diagonals."""
    m = m.cpu().numpy().astype(np.int64)[:n, :n]
    h = h.cpu().numpy().astype(np.int64)[:n, :n]
    subs = h - m
    np.fill_diagonal(subs, 0)
    np.fill_diagonal(h, 0)
    return subs, h


def pair_counts_sharded(states: np.ndarray, mesh: Mesh) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs (substitutions, homologs) over ``mesh`` (collective on a
    mesh of ranks).

    ``states``: the [N, L] uint8 pileup, the same on every rank. On a mesh
    of ranks packs this rank's cell on the host, copies it to the rank's
    device and counts it with :func:`counts_from_cell`; on a local mesh
    packs each genome block once, copies every cell to its device and
    counts them with :func:`counts_from_cells`. Returns int64 [N, N] host
    matrices, the same on every rank.
    """
    n, length = states.shape
    rows, cols = mesh.shape
    n_pad, lc, l_pad = sharded_shape(n, length, rows, cols)
    nr = n_pad // rows
    t0 = time.perf_counter()
    if mesh.backend == "local":
        cells = []
        for i in range(rows):
            packed = _row_block(states, i, nr, l_pad)
            cells += [to_device(_cell_of(packed, c, lc), mesh.devices[i * cols + c])
                      for c in range(cols)]
        cell_s = time.perf_counter() - t0
        result = counts_from_cells(cells, n, length, mesh)
    else:
        i, c = mesh.cell
        mine = to_device(_cell_of(_row_block(states, i, nr, l_pad), c, lc), mesh.device)
        cell_s = time.perf_counter() - t0
        result = counts_from_cell(mine, n, length, mesh)
    LAST_COMM["seconds"] = {"cell": cell_s, **LAST_COMM["seconds"]}
    return result


def _start_account(n: int, length: int, mesh: Mesh):
    """Reset LAST_COMM for a count of the ``n`` x ``length`` panel on
    ``mesh``; returns ``lap(name)``, which records the host seconds since
    the last lap under ``name``."""
    seconds: dict[str, float] = {}
    LAST_COMM.clear()
    LAST_COMM.update({"panel": (n, length), "mesh": tuple(mesh.shape), "seconds": seconds},
                     **dict.fromkeys(_COMM_KEYS, 0))
    t0 = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t0
        t1 = time.perf_counter()
        seconds[name] = t1 - t0
        t0 = t1

    return lap


def _count_cell(mine: torch.Tensor, everyone: torch.Tensor, n_pad: int) -> torch.Tensor:
    """int64 [2, rows of mine, n_pad] (matches, homologs) of ``mine``
    against ``everyone`` on their device, K2 in column chunks below
    ``_MAX_WIDTH``; queued, not waited for."""
    counts = torch.zeros((2, mine.shape[0], n_pad), dtype=torch.int64, device=mine.device)
    step = pair_count._chunk_bytes()
    for start in range(0, mine.shape[1], step):
        m, h = pair_count.cross_counts(
            mine[:, start : start + step], everyone[:, start : start + step],
            symmetric=False,
        )
        counts[0] += m
        counts[1] += h
    return counts


def _synchronize(devices) -> None:
    for device in dict.fromkeys(devices):
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def counts_from_cell(
    mine: torch.Tensor, n: int, length: int, mesh: Mesh
) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs (substitutions, homologs) of the ``n`` x ``length`` panel
    whose cell ``mine`` this rank holds on ``mesh.device`` (collective).

    ``mine``: this rank's [n_pad / R, lc] packed cell of the
    ``sharded_shape`` geometry, wherever it was built (the host pack of
    ``pair_counts_sharded``, or the pod feeder's panel,
    parallel/stream_mp.py). The port of the JAX package's
    ``_sharded_counts`` (phylonium_tpu/parallel/stream_mp.py:188): the row
    gather, the count, the reduction and the result gather. Returns int64
    [N, N] host matrices, the same on every rank.
    """
    rows, cols = mesh.shape
    n_pad, lc, _ = sharded_shape(n, length, rows, cols)
    if tuple(mine.shape) != (n_pad // rows, lc) or mine.device != mesh.device:
        raise ValueError(
            f"the cell is {tuple(mine.shape)} on {mine.device}; the {rows} x "
            f"{cols} mesh of a {n} x {length} panel holds [{n_pad // rows}, "
            f"{lc}] on {mesh.device}"
        )
    lap = _start_account(n, length, mesh)
    everyone = torch.cat(_all_gather(mine, mesh.rows_group, mesh, "gather_recv_bytes"))
    lap("gather")
    counts = _count_cell(mine, everyone, n_pad)
    _synchronize([counts.device])
    lap("count")
    counts = _all_reduce(counts, mesh.cols_group, mesh, "psum_bytes")
    lap("reduce")
    blocks = _all_gather(counts, mesh.rows_group, mesh, "result_gather_recv_bytes")
    full = torch.cat(blocks, dim=1)
    result = gathered_counts(full[0], full[1], n)
    lap("result")
    return result


def _per_cell(values: list[int]):
    """One cell's bytes where every cell moved the same, else the list."""
    return values[0] if len(set(values)) == 1 else values


def counts_from_cells(
    cells: list[torch.Tensor], n: int, length: int, mesh: Mesh
) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs (substitutions, homologs) of the ``n`` x ``length`` panel
    whose cells ``cells[k]`` lie on ``mesh.devices[k]`` of a local mesh.

    The row gather, the count, the column reduction and the result of
    :func:`counts_from_cell`, for every cell in this process, with copies
    between its devices in place of collectives. Every cell's launches
    are queued before the first wait, so cells on different cards count
    at once. Returns int64 [N, N] host matrices.
    """
    rows, cols = mesh.shape
    n_pad, lc, _ = sharded_shape(n, length, rows, cols)
    nr = n_pad // rows
    for k, cell in enumerate(cells):
        if tuple(cell.shape) != (nr, lc) or cell.device != mesh.devices[k]:
            raise ValueError(
                f"cell {k} is {tuple(cell.shape)} on {cell.device}; the {rows} x "
                f"{cols} mesh of a {n} x {length} panel holds [{nr}, {lc}] on "
                f"{mesh.devices[k]}"
            )
    lap = _start_account(n, length, mesh)
    # the row gather: column c's blocks on each distinct device of its
    # cells, one copy a device (as anchor_extend_sharded.place places)
    everyone, took = [None] * len(cells), [0] * len(cells)
    for c in range(cols):
        column = [i * cols + c for i in range(rows)]
        on: dict = {}
        for k in column:
            device = mesh.devices[k]
            if device not in on:
                on[device] = torch.cat([cells[j].to(device) for j in column])
            everyone[k] = on[device]
            took[k] = sum(cells[j].nbytes for j in column if j != k)
    lap("gather")
    partials = [_count_cell(cell, everyone[k], n_pad) for k, cell in enumerate(cells)]
    _synchronize(mesh.devices)
    lap("count")
    # the column reduction: each row's partials summed in cell order on the
    # device of its first cell
    reduced = []
    for i in range(rows):
        first = partials[i * cols]
        total = first.clone()
        for c in range(1, cols):
            total += partials[i * cols + c].to(first.device)
        reduced.append(total)
    _synchronize(r.device for r in reduced)
    lap("reduce")
    blocks = [r.cpu() for r in reduced]
    full = torch.cat(blocks, dim=1)
    result = gathered_counts(full[0], full[1], n)
    lap("result")
    LAST_COMM.update(
        gather_recv_bytes=_per_cell(took), psum_bytes=_per_cell([p.nbytes for p in partials]),
        result_gather_recv_bytes=sum(b.nbytes for b in blocks),
    )
    return result


def comm_account(n: int, length: int, mesh: Mesh) -> dict:
    """Predicted beside measured bytes of one sharded count, per rank.

    The prediction is the JAX package's formula (distributed.py:331-333):
    a cell receives ``(R - 1) * (n_pad / R) * lc`` bytes of its column
    shard's other blocks, and the reduction moves two ``[n_pad / R,
    n_pad]`` matrices, here int64 (8 bytes a cell, where JAX's psum is
    int32). The port adds the final gather of the reduced row blocks, which
    the JAX package makes with ``process_allgather`` outside its program:
    a rank receives the ``R - 1`` blocks of the other rows, and the host of
    a local mesh takes all ``R`` off their devices. On a local mesh the
    gather and reduction bytes are each cell's, whichever device each cell
    lies on: a block counts as taken from another cell even where the two
    share a device. The measured side is what this rank's collective
    wrappers, or the local mesh's copies, passed in the last sharded count
    (``counts_from_cell`` or ``counts_from_cells``, under
    ``pair_counts_sharded`` or the pod feeder) of the same panel and mesh
    (None when there was none); the JAX package parsed its compiled HLO
    instead. It needs no host states: the geometry is ``sharded_shape``'s.
    """
    rows, cols = mesh.shape
    n_pad, lc, l_pad = sharded_shape(n, length, rows, cols)
    nr = n_pad // rows
    # a 1 x 1 mesh outside any world runs no collective
    ranked = mesh.backend is not None
    others = rows if mesh.backend == "local" else rows - 1
    predicted = {
        "gather_recv_bytes": (rows - 1) * nr * lc,
        "psum_bytes": 2 * nr * n_pad * 8 * ranked,
        "result_gather_recv_bytes": others * 2 * nr * n_pad * 8,
    }
    ran = LAST_COMM.get("panel") == (n, length) and LAST_COMM.get("mesh") == (rows, cols)
    out = {"mesh": (rows, cols), "panel": (n, length),
           "sharded_bytes_per_device": nr * lc}
    for key, value in predicted.items():
        out[f"predicted_{key}"] = value
        out[f"measured_{key}"] = LAST_COMM[key] if ran else None
    return out
