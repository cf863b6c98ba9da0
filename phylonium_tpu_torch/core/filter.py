"""Overlap filtering of homology piles.

``filter_overlaps_max`` mirrors the weighted-interval-scheduling DP of the
reference (`src/process.cxx:354-401`): chain non-overlapping homologies so
the total number of chained nucleotides is maximal, then keep only chain
members.  Tie-breaking matches the reference: the *first* maximal score
wins both in the predecessor scan (strict ``>``) and in the final
``max_element`` over the score buffer (first maximum).

``filter_overlaps_strict`` mirrors `src/process.cxx:312-339` (drop anything
overlapping anything); it is exposed for completeness but — like in the
reference — not used by the main pipeline.

A copy of the JAX package's ``phylonium_tpu/core/filter.py``: the port carries
its own host layer and imports nothing of that package.
"""

from __future__ import annotations

import numpy as np

from phylonium_tpu_torch.core.homology import Homology


def filter_overlaps_max(pile: list[Homology]) -> list[Homology]:
    """Keep the maximum-nucleotide chain of non-overlapping homologies.

    The pile must be sorted by projected start. Returns the filtered list
    (also mutates nothing; the reference filters in place).
    """
    n = len(pile)
    if n < 2:
        return list(pile)

    starts = np.fromiter((h.start() for h in pile), dtype=np.int64, count=n)
    ends = np.fromiter((h.end() for h in pile), dtype=np.int64, count=n)
    lengths = np.fromiter((h.length for h in pile), dtype=np.int64, count=n)

    # score[-1] = 0 sentinel lives at buffer index 0 (src/process.cxx:360-367).
    predecessor = np.full(n, -1, dtype=np.int64)
    score = np.zeros(n + 1, dtype=np.int64)  # score[i+1] is homology i's score
    score[1] = lengths[0]

    for i in range(1, n):
        # candidates k < i with end_k <= start_i; first maximal score wins
        ok = ends[:i] <= starts[i]
        max_value = 0
        max_index = -1
        if ok.any():
            cand_scores = np.where(ok, score[1 : i + 1], np.iinfo(np.int64).min)
            k = int(np.argmax(cand_scores))  # argmax returns first maximum
            if cand_scores[k] > 0:
                max_value = int(cand_scores[k])
                max_index = k
        predecessor[i] = max_index
        score[i + 1] = max_value + lengths[i]

    # Walk back from the first global maximum (src/process.cxx:387-395).
    # max_element over the whole buffer including the sentinel.
    best = int(np.argmax(score))
    index = best - 1
    visited = np.zeros(n, dtype=bool)
    while index >= 0:
        visited[index] = True
        index = int(predecessor[index])

    return [h for h, v in zip(pile, visited) if v]


def filter_overlaps_strict(pile: list[Homology]) -> list[Homology]:
    """Drop every homology that overlaps any other (src/process.cxx:312-339)."""
    n = len(pile)
    if n < 2:
        return list(pile)

    keep = []
    border = 0
    for k in range(n - 1):
        h = pile[k]
        overlaps_left = border > h.index_reference_projected
        border = max(border, h.index_reference_projected + h.length)
        overlaps_right = h.overlaps(pile[k + 1])
        if not overlaps_left and not overlaps_right:
            keep.append(h)
    # The last homology is special-cased in the reference: it is kept iff
    # its immediate predecessor does not overlap it (src/process.cxx:330-336).
    if not pile[n - 2].overlaps(pile[n - 1]):
        keep.append(pile[n - 1])
    return keep
