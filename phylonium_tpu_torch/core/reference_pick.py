"""Reference-genome selection.

- First pass (`src/phylonium.cxx:360-382`): the genome of median joined
  length.  The reference uses ``std::nth_element``; the deterministic
  equivalent is the element of rank ``N // 2`` under a stable
  sort-by-length (ties keep input order).
- Second pass (`src/phylonium.cxx:317-344`): the most *central* genome —
  the one minimizing its row sum of Jukes-Cantor distances from the first
  pass (NaNs estimated as 0, first minimum wins).

A copy of the JAX package's ``phylonium_tpu/core/reference_pick.py``: the port carries
its own host layer and imports nothing of that package.
"""

from __future__ import annotations

import sys

import numpy as np

from phylonium_tpu_torch.data.sequence import Sequence
from phylonium_tpu_torch.model.evo import EvoCounts


def pick_first_pass(queries: list[Sequence], verbose: bool = False) -> int:
    """Median-length genome via libstdc++-exact nth_element.

    With tied lengths the chosen element depends on the introselect
    implementation; core/nth_element.py reproduces libstdc++ so the
    choice matches reference binaries bit-for-bit.  The chosen sequence
    is then located by *value* in the original list, mirroring the
    ``std::find`` at src/phylonium.cxx:374-375.
    """
    from phylonium_tpu_torch.core.nth_element import nth_element

    order = list(range(len(queries)))
    nth_element(
        order,
        len(queries) // 2,
        comp=lambda i, j: len(queries[i]) < len(queries[j]),
    )
    chosen = queries[order[len(queries) // 2]]

    reference_index = next(
        i
        for i, q in enumerate(queries)
        if q.name == chosen.name and q.nucl == chosen.nucl
    )
    if verbose:
        print(
            f"chosen reference: {queries[reference_index].name}",
            file=sys.stderr,
        )
    return reference_index


def pick_second_pass(counts: EvoCounts) -> int:
    dist = counts.estimate_jc(zero_on_error=True)
    sums = dist.sum(axis=1)
    # NaN row sums (raw distance >= 0.75 somewhere) never win the strict
    # `<` comparison in the reference scan (src/phylonium.cxx:335)
    sums = np.where(np.isnan(sums), np.inf, sums)
    return int(np.argmin(sums))  # first minimum, like the reference scan
