"""The host half of a group build: its row cuts and its prepared inputs.

``row_groups`` cuts a panel's genomes into device builds below the build
kernel's int32 limit, and ``prepare_group`` turns one group into the
arrays the pileup-build kernel reads (``GroupInputs``): the 2-bit words,
the interval records and the overlay sorted by (row, col)
(``sort_overlay``). All of it is numpy, without torch: the early query
shipper cuts its groups with ``row_groups`` while the files are read, and
a device-server run preps its groups here and sends them to the server,
so neither loads torch. ``ops/pileup_device.py`` re-exports these names
beside the kernel's wrapper.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from phylonium_tpu_torch.config import ConfigError
from phylonium_tpu_torch.ops.pileup_prep import (
    _MAX_GROUP_BASES,
    build_overlay,
    group_payload,
    prep_intervals,
)


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
