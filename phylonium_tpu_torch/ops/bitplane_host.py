"""Host pair counting via packed bitplanes + popcount.

This is the cold-start fallback of the adaptive compare backend: when the
device kernel executable is not yet available (first run on a machine
with an empty compile cache, or a degraded remote compile service), the
pipeline counts on the host while the kernel compiles in the background
(core/pipeline.pair_counts).  It replaces the reference's SIMD mismatch
loops (libs/seqcmp*.c, libs/revseqcmp*.c) with the same trick those use
— bit-parallel compares — expressed as numpy popcounts over packed
one-hot planes:

    matches[i, j] = sum_s popcount(P_s[i] & Q_s[j])
    homologs[i, j] = popcount(V[i] & V[j])

with P_s = bitplane of "state == s", Q_s = OR of P_t over the states t
that match s per the 11x11 MATCH_TABLE (ops/match_table.py), and V the
validity plane.  Partner states are distinct, so the OR loses nothing
and the result is bit-exact vs the scalar oracle (pair_counts_numpy).

Column chunking bounds plane memory and gives the caller an abort hook:
``poll`` is consulted between chunks.

A copy of the JAX package's ``phylonium_tpu/ops/bitplane_host.py``: the port carries
its own host layer and imports nothing of that package.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from phylonium_tpu_torch.core.pileup import INVALID, N_STATES
from phylonium_tpu_torch.ops.match_table import MATCH_TABLE

# plane working set cap (bytes) — sets the column chunk size
_PLANE_BUDGET = 256 << 20


def _chunk_cols(n: int) -> int:
    # 21 planes (10 P + 10 Q + valid) of n rows, 1 bit per column
    cols = _PLANE_BUDGET * 8 // (21 * max(n, 1))
    return max(1 << 16, (cols >> 16) << 16)


def _count_chunk(
    states: np.ndarray, matches: np.ndarray, homs: np.ndarray
) -> None:
    """Accumulate counts of one [N, C] uint8 chunk (upper triangle)."""
    n = states.shape[0]
    planes = np.stack(
        [np.packbits(states == s, axis=1) for s in range(N_STATES)]
    )
    valid = np.packbits(states != INVALID, axis=1)
    partner = np.zeros_like(planes)
    for s in range(N_STATES):
        for t in np.flatnonzero(MATCH_TABLE[s, :N_STATES]):
            partner[s] |= planes[t]
    # uint64 views drive the popcount pipe 8 bytes at a time
    w = planes.shape[2] - planes.shape[2] % 8
    p64 = planes[:, :, :w].view(np.uint64)
    q64 = partner[:, :, :w].view(np.uint64)
    v64 = valid[:, :w].view(np.uint64)
    tail = planes[:, :, w:]
    qtail = partner[:, :, w:]
    vtail = valid[:, w:]
    for i in range(n - 1):
        matches[i, i + 1 :] += np.bitwise_count(
            p64[:, i : i + 1] & q64[:, i + 1 :]
        ).sum(axis=(0, 2), dtype=np.int64)
        homs[i, i + 1 :] += np.bitwise_count(
            v64[i] & v64[i + 1 :]
        ).sum(axis=1, dtype=np.int64)
        if tail.shape[2]:
            matches[i, i + 1 :] += np.bitwise_count(
                tail[:, i : i + 1] & qtail[:, i + 1 :]
            ).sum(axis=(0, 2), dtype=np.int64)
            homs[i, i + 1 :] += np.bitwise_count(
                vtail[i] & vtail[i + 1 :]
            ).sum(axis=1, dtype=np.int64)


def pair_counts_host(
    states: np.ndarray,
    poll: Callable[[], bool] | None = None,
    progress: Callable[[float], None] | None = None,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Host counting: native AVX2 kernel when available, else numpy
    bitplanes.  Same contract as :func:`pair_counts_bitplanes`;
    ``progress`` receives the completed column fraction per chunk."""
    try:
        from phylonium_tpu_torch.native import pair_counts_range
    except Exception:
        return pair_counts_bitplanes(states, poll, progress)

    states = np.ascontiguousarray(states, dtype=np.uint8)
    n, length = states.shape
    subs = np.zeros((n, n), dtype=np.int64)
    homs = np.zeros((n, n), dtype=np.int64)
    # chunk for poll granularity: ~0.5 Gbp of pair work per call
    step = max(1 << 16, (1 << 29) // max(n * (n - 1) // 2, 1))
    for start in range(0, max(length, 1), step):
        if poll is not None and poll():
            return None
        end = min(start + step, length)
        pair_counts_range(states, start, end, subs, homs)
        if progress is not None:
            progress(end / max(length, 1))
    return subs, homs


def pair_counts_bitplanes(
    states: np.ndarray,
    poll: Callable[[], bool] | None = None,
    progress: Callable[[float], None] | None = None,
) -> tuple[np.ndarray, np.ndarray] | None:
    """All-pairs (substitutions, homologs), exact int64, on the host.

    ``poll`` is called between column chunks; returning True abandons
    the computation (the function then returns None).  Used by the
    pipeline to hand over to the device kernel mid-count.
    """
    n, length = states.shape
    matches = np.zeros((n, n), dtype=np.int64)
    homs = np.zeros((n, n), dtype=np.int64)
    step = _chunk_cols(n)
    for start in range(0, max(length, 1), step):
        if poll is not None and poll():
            return None
        _count_chunk(states[:, start : start + step], matches, homs)
        if progress is not None:
            progress(min(start + step, length) / max(length, 1))
    matches += matches.T
    homs += homs.T
    subs = homs - matches
    np.fill_diagonal(subs, 0)
    np.fill_diagonal(homs, 0)
    return subs, homs
