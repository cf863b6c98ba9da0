"""Programmatic API: the port's pipeline as a library call.

    from phylonium_tpu_torch import distance_matrix

    result = distance_matrix(["a.fasta", "b.fasta"], device="cuda")
    result.distances        # [N, N] float64 (jc by default)

It mirrors ``phylonium_tpu.api.distance_matrix`` and returns the same
``DistanceResult``; the pair count runs on ``device``. Like the JAX
API it maps with the default backend (native C++ on the host): hybrid
mapping, whose bitmaps also run on the device, is the CLI's
``--map-backend hybrid``.
"""

from __future__ import annotations

import numpy as np

from phylonium_tpu.api import DistanceResult, _as_sequences
from phylonium_tpu.core.reference_pick import pick_first_pass, pick_second_pass
from phylonium_tpu.io.phylip import estimate
from phylonium_tpu_torch.config import TorchRunConfig
from phylonium_tpu_torch.core.pipeline import process


def distance_matrix(
    genomes,
    *,
    device: str = "cuda",
    distance: str = "jc",
    reference: str | None = None,
    two_pass: bool = False,
    complete_deletion: bool = False,
    anchor_p_value: float | None = None,
    count_backend: str = "auto",
    threads: int | None = None,
) -> DistanceResult:
    """Run the full pipeline and return the distance matrix.

    ``genomes``: FASTA paths, ``Sequence`` objects, or (name, seq) pairs,
    one genome each. ``device``: torch device of the pair count.
    ``distance``: "jc" | "raw" | "ani". ``reference``: pin the reference
    genome by name (CLI ``-r``); ``two_pass``: recompute against the most
    central genome (``-2``). Remaining keywords mirror their CLI flags.
    """
    if distance not in ("jc", "raw", "ani"):
        raise ValueError(
            f"distance must be 'jc', 'raw', or 'ani' (got {distance!r})"
        )
    queries = _as_sequences(genomes)
    if len(queries) < 2:
        raise ValueError("need at least two genomes")

    cfg = TorchRunConfig(progress="never", device=device)
    cfg.distance = distance
    cfg.complete_deletion = complete_deletion
    if anchor_p_value is not None:
        cfg.anchor_p_value = anchor_p_value
    cfg.count_backend = count_backend
    cfg.two_pass = two_pass
    if threads:
        from phylonium_tpu.native import set_threads

        set_threads(threads)

    if reference is not None:
        matches = [i for i, q in enumerate(queries) if q.name == reference]
        if not matches:
            raise ValueError(f"no genome named {reference!r}")
        reference_index = matches[0]
    else:
        reference_index = pick_first_pass(queries)

    counts = process(queries[reference_index], queries, cfg)
    if two_pass:
        second = pick_second_pass(counts)
        if second != reference_index:
            reference_index = second
            counts = process(queries[reference_index], queries, cfg)

    dist = np.array(estimate(counts, distance), dtype=np.float64, copy=True)
    np.fill_diagonal(dist, 0.0)
    return DistanceResult(
        names=[q.name for q in queries],
        distances=dist,
        counts=counts,
        reference_index=reference_index,
        lengths=np.array([len(q) for q in queries], dtype=np.int64),
    )
