"""Programmatic API: the port's pipeline as a library call.

    from phylonium_tpu_torch import distance_matrix

    result = distance_matrix(["a.fasta", "b.fasta"], device="cuda")
    result.distances        # [N, N] float64 (jc by default)

It mirrors ``phylonium_tpu.api.distance_matrix``; ``DistanceResult`` and
``_as_sequences`` are a copy of that module's (phylonium_tpu/api.py), which
the port carries instead of importing. The pair count runs on ``device``. Like the JAX
API it maps with the default backend (native C++ on the host): hybrid
mapping, whose bitmaps also run on the device, is the CLI's
``--map-backend hybrid``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from phylonium_tpu_torch.config import TorchRunConfig
from phylonium_tpu_torch.core.pipeline import process
from phylonium_tpu_torch.core.reference_pick import pick_first_pass, pick_second_pass
from phylonium_tpu_torch.data.sequence import Sequence, filter_nucl
from phylonium_tpu_torch.io.fasta import GenomeReader
from phylonium_tpu_torch.io.phylip import estimate
from phylonium_tpu_torch.model.evo import EvoCounts


@dataclass
class DistanceResult:
    """Outcome of one pipeline run."""

    names: list[str]
    distances: np.ndarray  # [N, N] float64, diagonal 0
    counts: EvoCounts  # substitutions / homologs matrices
    reference_index: int  # which genome anchored the run
    lengths: np.ndarray  # filtered genome lengths
    extras: dict = field(default_factory=dict)

    @property
    def reference_name(self) -> str:
        return self.names[self.reference_index]

    def coverage(self) -> np.ndarray:
        """Per-pair coverage (homologs / row-genome length)."""
        return self.counts.coverage(self.lengths)


def _as_sequences(genomes) -> list[Sequence]:
    seqs: list[Sequence] = []
    reader = GenomeReader()
    for g in genomes:
        if isinstance(g, Sequence):
            seqs.append(g)
        elif isinstance(g, str):
            # one FASTA file = one genome; contigs join with '!'
            seqs.append(reader.joined(g))
        else:
            name, data = g
            if isinstance(data, str):
                data = data.encode()
            seqs.append(Sequence(str(name), filter_nucl(data)))
    return seqs


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
    mesh: str | None = None,
    threads: int | None = None,
) -> DistanceResult:
    """Run the full pipeline and return the distance matrix.

    ``genomes``: FASTA paths, ``Sequence`` objects, or (name, seq) pairs,
    one genome each. ``device``: torch device of the pair count.
    ``distance``: "jc" | "raw" | "ani". ``reference``: pin the reference
    genome by name (CLI ``-r``); ``two_pass``: recompute against the most
    central genome (``-2``). ``mesh``: "R,C", count on an R x C mesh
    (``--mesh``): ``R*C`` ranks, or ``R*C`` local cards in a process of
    one rank. Every rank of a world of R*C ranks calls this function
    alike and gets the same result. Remaining keywords mirror their CLI
    flags.

    The run is the CLI's, in the caller's process: on a CUDA ``device``
    in a single process, a panel that 'auto' counting streams (more than
    one feeding group, which the dispatch model sends to the card) or
    that takes the low-memory path is built and counted by the device
    server, which the call spawns if none answers on its socket and which
    stays up after it (``PHYLONIUM_TPU_DEVD_IDLE_S``), as the JAX API's
    does; ``PHYLONIUM_TPU_DEVD=0`` keeps the work in this process.
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
    if mesh:
        cfg.mesh = mesh
    if threads:
        from phylonium_tpu_torch.native import set_threads

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
