"""Streamed map -> build -> resident-shard count across the ranks of a world.

The port of the JAX package's phylonium_tpu/parallel/stream_mp.py. The
serial route of a world of several ranks (core/pipeline.py's mesh route)
maps the queries round-robin, exchanges every homology list, builds the
whole [N, L] pileup on every rank, and only then packs and copies each
rank's cell (parallel/distributed.py). This path overlaps them, as the JAX
package does on a pod: rank ``r`` owns the contiguous genome block that
its cell holds under the ``(R, 1)`` mesh, maps it group by group, and its
device builds each group's packed rows (the X1 kernel, through the
streamed feeder of core/stream.py) while the next group maps. The count
is the usual collective (``distributed.counts_from_cell``: row gather, K2
per rank, exact reduction, result gather) on the resident cells: no
exchange, no host pileup, no copy after mapping. A rank's host memory
peaks at one row group.

The mesh is ``(world size, 1)``: rows are ranks, as under the JAX
package's pod mesh with one device a process. Under it a cell is
``[n_pad / R, packed_width(L)]``, exactly the feeder's panel width; a
rank whose block lies past the last genome feeds nothing and still
brings its all-INVALID cell to the collective.

Collective discipline, as in the JAX package: a feeder, kernel or
collective error raises in its rank. No rank counts on the host instead,
which would leave its peers waiting in the collective; ``feed()`` after a
worker error raises it, and a failed mapping cancels the feeder, which
stops its worker.
"""

from __future__ import annotations

import os
import sys
from typing import NamedTuple

import numpy as np

from phylonium_tpu_torch.core.map_native import map_batch_native
from phylonium_tpu_torch.core.stream import DEFAULT_GROUP_ROWS, DeviceRowFeeder
from phylonium_tpu_torch.index.esa import ESAIndex
from phylonium_tpu_torch.parallel.distributed import counts_from_cell, sharded_shape
from phylonium_tpu_torch.parallel.mesh import Mesh, make_mesh
from phylonium_tpu_torch.parallel.multihost import world
from phylonium_tpu_torch.utils.profile import phase
from phylonium_tpu_torch.utils.progress import ProgressBar


class PodGeometry(NamedTuple):
    """Rank ``rank``'s share of an ``n``-genome panel over ``ranks`` rows."""

    n_pad: int          # n rounded up to a multiple of ranks
    width: int          # lc: packed bytes a row, the whole row under (R, 1)
    rows_per_block: int  # n_pad / ranks: the cell's rows
    row_lo: int         # first genome of the block
    row_hi: int         # past its last real genome; <= row_lo when none

    @property
    def real_rows(self) -> int:
        return max(self.row_hi - self.row_lo, 0)


def pod_geometry(n: int, ref_len: int, ranks: int, rank: int) -> PodGeometry:
    """The block and cell of ``rank`` (JAX :69-83), from
    ``distributed.sharded_shape(n, ref_len, ranks, 1)``."""
    n_pad, lc, _ = sharded_shape(n, ref_len, ranks, 1)
    rows_per_block = n_pad // ranks
    row_lo = rank * rows_per_block
    return PodGeometry(n_pad, lc, rows_per_block, row_lo,
                       min(row_lo + rows_per_block, n))


def pod_mesh(device) -> Mesh:
    """The ``(world size, 1)`` mesh of the pod streamed path (collective:
    every rank calls it alike)."""
    return make_mesh((world()[0], 1), device)


class PodShardFeeder:
    """Builds this rank's cell of the panel on ``mesh.device`` group by
    group, and counts the resident cells of all ranks.

    ``feed(queries, homologies)`` takes the next mapped group of the
    rank's block, in order; ``cell()`` waits for the builds and returns
    the [rows_per_block, width] cell; ``finish()`` is collective and
    returns host int64 (substitutions, homologs), the same on every rank.
    """

    def __init__(self, n: int, ref_len: int, mesh: Mesh):
        ranks, cols = mesh.shape
        if cols != 1:
            raise ValueError(f"the pod feeder takes an (R, 1) mesh, not {mesh.shape}")
        self.n = n
        self.ref_len = ref_len
        self.mesh = mesh
        self.geometry = pod_geometry(n, ref_len, ranks, mesh.rank)
        self._feeder = DeviceRowFeeder(
            self.geometry.real_rows, ref_len, mesh.device,
            rows=self.geometry.rows_per_block,
        )

    @property
    def groups(self) -> int:
        """Groups built so far (one X1 launch or plain call each)."""
        return self._feeder.groups

    def feed(self, queries: list, homologies: list) -> None:
        self._feeder.feed(queries, homologies)

    def cancel(self) -> None:
        self._feeder.cancel()

    def cell(self):
        """This rank's cell, every group built (raises what the worker
        hit, or a block fed short)."""
        return self._feeder.built()

    def finish(self) -> tuple[np.ndarray, np.ndarray]:
        """The collective count on the resident cells (every rank calls
        it; an error raises in its rank)."""
        return counts_from_cell(self.cell(), self.n, self.ref_len, self.mesh)


def stream_group_rows() -> int:
    """Rows a mapping group: ``PHYLONIUM_TPU_STREAM_GROUP`` or 128, as the
    JAX package takes them (JAX :220-222), not ``effective_group_rows``."""
    return int(os.environ.get("PHYLONIUM_TPU_STREAM_GROUP") or DEFAULT_GROUP_ROWS)


def map_and_feed(ref: ESAIndex, threshold: int, queries: list, cfg,
                 feeder: PodShardFeeder, group_rows: int | None = None) -> None:
    """Map the rank's block in groups with the native mapper, feeding each
    group as it completes; a failure cancels the feeder and raises."""
    g = feeder.geometry
    group_rows = group_rows or stream_group_rows()
    bar = ProgressBar(f"Mapping {len(queries)} sequences", max(g.real_rows, 1),
                      enabled=cfg.progress_enabled)
    try:
        for lo in range(g.row_lo, g.row_hi, group_rows):
            hi = min(lo + group_rows, g.row_hi)
            batch = [queries[j].as_array() for j in range(lo, hi)]
            out = map_batch_native(ref._native, batch, threshold, bar, lo - g.row_lo)
            feeder.feed(batch, out)
            bar.update(hi - g.row_lo)
    except BaseException:
        feeder.cancel()
        raise
    bar.finish()


def map_pileup_count_streamed_mp(
    ref: ESAIndex, threshold: int, queries: list, cfg, mesh: Mesh, timings: dict
) -> tuple[tuple[np.ndarray, np.ndarray], PodShardFeeder]:
    """The pod streamed pipeline on ``mesh`` (``pod_mesh``): map and feed
    this rank's block (phase ``map+feed``), then count the resident cells
    (phase ``compare``), timed into ``timings``.

    Returns the host int64 (substitutions, homologs), bit-identical to
    the serial route's (any split of the mapping gives the same
    homologies; the count is exact), and the feeder, whose ``mesh`` and
    ``groups`` the run report reads.
    """
    n = len(queries)
    feeder = PodShardFeeder(n, len(ref.subject), mesh)
    with phase(timings, "map+feed"):
        map_and_feed(ref, threshold, queries, cfg, feeder)
    if cfg.verbose >= 2:
        size, rank = world()
        g = feeder.geometry
        print(f"pod stream: process {rank}/{size} mapped+fed rows "
              f"[{g.row_lo}, {g.row_hi}) of {n}", file=sys.stderr)
    bar = ProgressBar("Comparing the sequences", (n * n - n) // 2,
                      enabled=cfg.progress_enabled)
    with phase(timings, "compare"):
        counts = feeder.finish()
    bar.finish()
    return counts, feeder
