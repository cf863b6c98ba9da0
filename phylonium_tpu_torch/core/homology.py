"""Homologous-interval data model and interval algebra.

Mirrors the semantics of class ``homology`` in the reference
(`src/process.h:14-144`) exactly; every method cites its counterpart.

A homology records that ``length`` query bases starting at ``index_query``
were anchored to the reference starting at ``index_reference`` (a position
in the doubled index text ``S = ref + '#' + revcomp(ref)``).  If the match
hit the reverse strand, ``index_reference_projected`` holds the equivalent
start on the forward strand and ``direction`` is ``REVERSE``.

Interval comparisons (``overlaps``, ``starts_left_of``, ``ends_left_of``)
are all in *projected reference* coordinates.

For bulk/device work, lists of homologies convert to a structured numpy
array via :func:`to_arrays` / :func:`from_arrays`.

A copy of the JAX package's ``phylonium_tpu/core/homology.py``: the port carries
its own host layer and imports nothing of that package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

FORWARD = 0
REVERSE = 1


@dataclass(slots=True)
class Homology:
    direction: int = FORWARD
    index_reference: int = 0
    index_reference_projected: int = 0
    index_query: int = 0
    length: int = 0

    @classmethod
    def at(cls, ir: int, iq: int, length: int = 0) -> "Homology":
        """Fresh forward homology from coordinates (src/process.h:32-36)."""
        return cls(FORWARD, ir, ir, iq, length)

    # -- projected reference coordinates (src/process.h:38-56) --
    def start(self) -> int:
        return self.index_reference_projected

    def end(self) -> int:
        return self.index_reference_projected + self.length

    def start_query(self) -> int:
        return self.index_query

    def end_query(self) -> int:
        return self.index_query + self.length

    def extend(self, stride: int) -> int:
        """Extend to the right (src/process.h:62-65)."""
        self.length += stride
        return self.length

    def reverse_eh(self, reference_length: int) -> None:
        """Project reverse-strand coordinates onto the forward strand.

        Mirrors src/process.h:72-80: a match starting at or past
        ``reference_length`` (the '#' separator position) lies on the
        reverse complement half of the index text; its forward-strand
        start is ``2 * reference_length + 1 - length - index_reference``.
        """
        if self.index_reference < reference_length:
            return
        self.index_reference_projected = (
            2 * reference_length + 1 - self.length - self.index_reference
        )
        self.direction = REVERSE

    def overlaps(self, other: "Homology") -> bool:
        """Projected-interval overlap test (src/process.h:86-97)."""
        if self.start() == other.start():
            return True
        if self.starts_left_of(other):
            return not self.ends_left_of(other)
        if other.starts_left_of(self):
            return not other.ends_left_of(self)
        return False

    def starts_left_of(self, other: "Homology") -> bool:
        return self.start() < other.start()

    def ends_left_of(self, other: "Homology") -> bool:
        return self.end() <= other.start()

    def trim(self, start: int, end: int) -> "Homology":
        """Restrict to the projected window [start, end).

        Mirrors src/process.h:119-143 including the direction-dependent
        query-coordinate adjustment: trimming the *right* end of a
        reverse-strand homology cuts the *left* end of its query range.
        """
        if end <= start:
            return Homology(
                self.direction,
                self.index_reference,
                self.index_reference_projected,
                self.index_query,
                self.length,
            )

        offset = (
            start - self.start()
            if (start > self.start() and start < self.end())
            else 0
        )
        drift = self.end() - end if (self.end() > end and end > self.start()) else 0

        that = Homology(
            self.direction,
            self.index_reference,
            self.index_reference_projected + offset,
            self.index_query,
            self.length - offset - drift,
        )
        if self.direction == FORWARD:
            that.index_reference += offset
            that.index_query += offset
        else:
            that.index_reference += drift
            that.index_query += drift
        return that


# Structured dtype for bulk conversion; int64 throughout.
HOMOLOGY_DTYPE = np.dtype(
    [
        ("direction", np.int64),
        ("index_reference", np.int64),
        ("index_reference_projected", np.int64),
        ("index_query", np.int64),
        ("length", np.int64),
    ]
)


def to_arrays(homologies: list[Homology]) -> np.ndarray:
    out = np.zeros(len(homologies), dtype=HOMOLOGY_DTYPE)
    for k, h in enumerate(homologies):
        out[k] = (
            h.direction,
            h.index_reference,
            h.index_reference_projected,
            h.index_query,
            h.length,
        )
    return out


def from_arrays(arr: np.ndarray) -> list[Homology]:
    return [
        Homology(
            int(r["direction"]),
            int(r["index_reference"]),
            int(r["index_reference_projected"]),
            int(r["index_query"]),
            int(r["length"]),
        )
        for r in arr
    ]
