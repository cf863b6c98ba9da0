"""Sharded all-pairs counting over a mesh of ranks (X3s).

The port of the JAX package's phylonium_tpu/parallel/distributed.py
(``_local_counts_pallas`` under ``shard_map``). The packed pileup
``[n_pad, l_pad]`` is split ``('rows', 'cols')``: rank ``(i, c)`` holds
genome block ``i`` of column shard ``c``. Each rank

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
instead, which would leave its peers waiting in the collective.
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
# (counts_from_cell, which pair_counts_sharded calls), with its panel and
# mesh (comm_account reads them), and the host seconds of its steps
# ("seconds": the cell's pack and copy under pair_counts_sharded, row
# gather, count until the card is done, reduction, result gather)
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


def _my_cell(states: np.ndarray, mesh: Mesh, n_pad: int, lc: int, l_pad: int) -> np.ndarray:
    """This rank's [n_pad / R, lc] packed cell, from its genome block."""
    n = states.shape[0]
    nr = n_pad // mesh.shape[0]
    i, c = mesh.cell
    block = states[i * nr : min((i + 1) * nr, n)]
    if block.shape[0]:
        packed = pack_states(block, nr, l_pad)
    else:
        packed = np.full((nr, l_pad), _PACKED_PAD, dtype=np.uint8)
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
    """All-pairs (substitutions, homologs) over ``mesh`` (collective).

    ``states``: the [N, L] uint8 pileup, the same on every rank. Packs this
    rank's cell on the host, copies it to the rank's device and counts it
    with :func:`counts_from_cell`. Returns int64 [N, N] host matrices, the
    same on every rank.
    """
    n, length = states.shape
    n_pad, lc, l_pad = sharded_shape(n, length, *mesh.shape)
    t0 = time.perf_counter()
    mine = to_device(_my_cell(states, mesh, n_pad, lc, l_pad), mesh.device)
    cell_s = time.perf_counter() - t0
    result = counts_from_cell(mine, n, length, mesh)
    LAST_COMM["seconds"] = {"cell": cell_s, **LAST_COMM["seconds"]}
    return result


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
    seconds: dict[str, float] = {}
    LAST_COMM.clear()
    LAST_COMM.update({"panel": (n, length), "mesh": (rows, cols), "seconds": seconds},
                     **dict.fromkeys(_COMM_KEYS, 0))
    t0 = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t0
        t1 = time.perf_counter()
        seconds[name] = t1 - t0
        t0 = t1

    everyone = torch.cat(_all_gather(mine, mesh.rows_group, mesh, "gather_recv_bytes"))
    lap("gather")
    counts = torch.zeros((2, mine.shape[0], n_pad), dtype=torch.int64, device=mesh.device)
    step = pair_count._chunk_bytes()
    for start in range(0, lc, step):
        m, h = pair_count.cross_counts(
            mine[:, start : start + step], everyone[:, start : start + step],
            symmetric=False,
        )
        counts[0] += m
        counts[1] += h
    if counts.is_cuda:
        torch.cuda.synchronize(counts.device)
    lap("count")
    counts = _all_reduce(counts, mesh.cols_group, mesh, "psum_bytes")
    lap("reduce")
    blocks = _all_gather(counts, mesh.rows_group, mesh, "result_gather_recv_bytes")
    full = torch.cat(blocks, dim=1)
    result = gathered_counts(full[0], full[1], n)
    lap("result")
    return result


def comm_account(n: int, length: int, mesh: Mesh) -> dict:
    """Predicted beside measured bytes of one sharded count, per rank.

    The prediction is the JAX package's formula (distributed.py:331-333):
    a rank receives ``(R - 1) * (n_pad / R) * lc`` bytes of its column
    shard's other blocks, and the reduction moves two ``[n_pad / R,
    n_pad]`` matrices, here int64 (8 bytes a cell, where JAX's psum is
    int32). The port adds the final gather of the reduced row blocks, which
    the JAX package makes with ``process_allgather`` outside its program.
    The measured side is what this rank's collective wrappers passed in the
    last sharded count (``counts_from_cell``, under ``pair_counts_sharded``
    or the pod feeder) of the same panel and mesh (None when there was
    none); the JAX package parsed its compiled HLO instead. It needs no
    host states: the geometry is ``sharded_shape``'s.
    """
    rows, cols = mesh.shape
    n_pad, lc, l_pad = sharded_shape(n, length, rows, cols)
    nr = n_pad // rows
    # a 1 x 1 mesh outside any world runs no collective
    ranked = mesh.backend is not None
    predicted = {
        "gather_recv_bytes": (rows - 1) * nr * lc,
        "psum_bytes": 2 * nr * n_pad * 8 * ranked,
        "result_gather_recv_bytes": (rows - 1) * 2 * nr * n_pad * 8,
    }
    ran = LAST_COMM.get("panel") == (n, length) and LAST_COMM.get("mesh") == (rows, cols)
    out = {"mesh": (rows, cols), "panel": (n, length),
           "sharded_bytes_per_device": nr * lc}
    for key, value in predicted.items():
        out[f"predicted_{key}"] = value
        out[f"measured_{key}"] = LAST_COMM[key] if ran else None
    return out
