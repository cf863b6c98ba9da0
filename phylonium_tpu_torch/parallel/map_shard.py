"""Multi-rank query-sharded mapping.

The port of the JAX package's phylonium_tpu/parallel/map_shard.py. Mapping
is host work (anchor chaining over the suffix index), so in a world of
several ranks each rank maps only the queries it owns, round-robin by
index, and the homology lists are exchanged with two all_gathers.
Homologies are small (5 integers each), so the exchange is a few MB at
most while the mapping work divides by the rank count.

Every rank would compute the same homologies for a query (a pure function
of subject, query and threshold), so the exchanged result equals the
single-process mapping.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from phylonium_tpu_torch.core.homology import Homology
from phylonium_tpu_torch.parallel.multihost import native_stdout_to_stderr

_FIELDS = 6  # query_index + the 5 Homology fields


def owner_of(query_index: int, process_count: int) -> int:
    return query_index % process_count


def _all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    with native_stdout_to_stderr():
        dist.all_gather(parts, t)
    return parts


def exchange_homologies(
    homologies: list[list[Homology] | None], owned: list[int]
) -> list[list[Homology]]:
    """All_gather per-query homology lists across the world's ranks.

    ``homologies[j]`` must be filled for every ``j in owned`` (this rank's
    queries); other entries are ignored and replaced by their owners'
    results. Collective: every rank calls it with the same query count
    and a disjoint and complete split. The records travel as int64 on the
    rank's CUDA device under NCCL, on the host under gloo.
    """
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    rows = [
        (j, h.direction, h.index_reference, h.index_reference_projected,
         h.index_query, h.length)
        for j in owned for h in homologies[j]
    ]
    flat = np.array(rows, dtype=np.int64).reshape(-1, _FIELDS)
    totals = [int(t) for t in _all_gather(
        torch.tensor([flat.shape[0]], dtype=torch.int64, device=device))]
    cap = max(max(totals), 1)
    padded = torch.zeros((cap, _FIELDS), dtype=torch.int64)
    padded[: flat.shape[0]] = torch.from_numpy(flat)
    gathered = _all_gather(padded.to(device))

    out: list[list[Homology]] = [[] for _ in homologies]
    for total, part in zip(totals, gathered):
        for rec in part[:total].cpu().numpy().tolist():
            out[rec[0]].append(Homology(*rec[1:]))
    return out
