"""Segregating-site / reference-position output (``-p``).

Mirrors the reference's post-complete-deletion segsite dump
(`src/process.cxx:471-513`): for each core-genome block, OR together the
per-genome segsite masks against genome 0 and write

    >partK\t(start+1..end+1)  count  pos+1 ...
    <reference substring start..end>

Computed here directly from the pileup: a column is a segsite iff any
genome's state fails the match rule against genome 0's state — exactly
``is_segsite`` / ``is_segsite_rev`` (src/process.cxx:707-723) after
projecting both sides to reference order (the reference's rev/rev mask
reversal, src/process.cxx:688-692, is this projection).

A copy of the JAX package's ``phylonium_tpu/core/segsites.py``: the port carries
its own host layer and imports nothing of that package.
"""

from __future__ import annotations

import numpy as np

from phylonium_tpu_torch.core.homology import Homology
from phylonium_tpu_torch.ops.match_table import MATCH_TABLE


def segsite_mask(states: np.ndarray, start: int, end: int) -> np.ndarray:
    """[end-start] bool: OR over genomes of mismatch-vs-genome-0."""
    blk = states[:, start:end]
    mismatch = MATCH_TABLE[blk[0][None, :], blk] == 0  # [N, B]
    return mismatch.any(axis=0)


def write_refpos(
    path: str,
    subject: bytes,
    states: np.ndarray,
    blocks: list[Homology],
) -> None:
    # the reference writes through std::ofstream(REFPOS_FILE_NAME)
    # (src/process.cxx:479): an unopenable path ('' / missing
    # directory) sets failbit and every write silently no-ops, exit
    # code unaffected — match that instead of crashing
    try:
        f = open(path, "w")
    except OSError:
        return
    with f:
        counter = 1
        for h in blocks:
            start, end = h.start(), h.end()
            mask = segsite_mask(states, start, end)
            positions = np.flatnonzero(mask)
            parts = [
                f">part{counter}\t({start + 1}..{end + 1})  {positions.size}"
            ]
            parts.extend(f"  {int(p) + 1}" for p in positions)
            f.write("".join(parts) + "\n")
            f.write(subject[start:end].decode("ascii") + "\n")
            counter += 1
