"""Complete deletion — restrict all genomes to the core genome.

Mirrors ``complete_delete`` (`src/process.cxx:725-776`): an N-way sweep
with one front iterator per genome.  Repeatedly take the max of the front
starts and the min of the front ends; when that window is non-empty, emit
a trimmed slice of every genome's front homology; then advance the genome
whose front homology ends leftmost (first minimum).

After this, every genome's homology list has the same length and the i-th
entries of all lists cover exactly the same reference window — the
invariant the ``-p`` segsite output relies on (src/process.cxx:471-513).

A copy of the JAX package's ``phylonium_tpu/core/complete_deletion.py``: the port carries
its own host layer and imports nothing of that package.
"""

from __future__ import annotations

from phylonium_tpu_torch.core.homology import Homology


def complete_delete(
    homologies: list[list[Homology]],
) -> list[list[Homology]]:
    size = len(homologies)
    core: list[list[Homology]] = [[] for _ in range(size)]

    front = [0] * size

    def front_has_not_reached_back() -> bool:
        return all(front[g] < len(homologies[g]) for g in range(size))

    while front_has_not_reached_back():
        fronts = [homologies[g][front[g]] for g in range(size)]
        common_start = max(h.start() for h in fronts)
        ends = [h.end() for h in fronts]
        common_end = min(ends)

        if common_start < common_end:
            for g in range(size):
                core[g].append(fronts[g].trim(common_start, common_end))

        # advance the genome whose homology ends leftmost (first minimum)
        leftmost = ends.index(common_end)
        front[leftmost] += 1

    return core
