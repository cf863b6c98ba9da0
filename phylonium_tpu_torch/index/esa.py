"""ESA facade: doubled index text + suffix index over it.

Construction mirrors `src/esa.cxx:69-81`: the index text is
``S = subject + '#' + revcomp(subject)`` of length ``2n + 1``, so forward
and reverse-strand matches come out of one search and the '#' separator
(absent from the ACGT/'!' query alphabet) keeps matches from spanning
strands.

Backends:
- ``native``: C++ ESA (SA-IS + child-array descent + k-mer seeded search,
  OpenMP), used when the shared library is available.
- ``numpy``: portable oracle (phylonium_tpu/index/esa_numpy.py).

Both implement the same behavioral spec:
``longest_match(q, qs, qlen) -> (l, i, j)`` and expose ``SA``; results are
bit-identical (tested against each other).

A copy of the JAX package's ``phylonium_tpu/index/esa.py``: the port carries
its own host layer and imports nothing of that package.
"""

from __future__ import annotations

import os

import numpy as np

from phylonium_tpu_torch.data.sequence import Sequence, revcomp
from phylonium_tpu_torch.index.esa_numpy import NumpySuffixIndex


class ESAIndex:
    """Index over S = subject + '#' + revcomp(subject)."""

    def __init__(self, subject: Sequence, backend: str | None = None):
        self.subject = subject
        text = subject.nucl + b"#" + revcomp(subject.nucl)
        self.S = np.frombuffer(text, dtype=np.uint8)
        self.size = len(text)  # == 2n + 1
        self.border = self.size // 2  # == n; '#' position

        if backend is None:
            backend = os.environ.get("PHYLONIUM_TPU_ESA_BACKEND", "auto")
        self.backend_name = backend
        self._native = None
        self._numpy = None

        if backend in ("auto", "native"):
            try:
                from phylonium_tpu_torch.native import NativeESA

                self._native = NativeESA(self.S)
                self.backend_name = "native"
            except Exception:
                if backend == "native":
                    raise
                self._native = None
        if self._native is None:
            self._numpy = NumpySuffixIndex(self.S)
            self.backend_name = "numpy"

    @property
    def SA(self) -> np.ndarray:
        if self._native is not None:
            return self._native.SA
        return self._numpy.SA

    def longest_match(self, q: np.ndarray, qs: int, qlen: int
                      ) -> tuple[int, int, int]:
        if self._native is not None:
            return self._native.longest_match(q, qs, qlen)
        return self._numpy.longest_match(q, qs, qlen)

    def map_query(self, query, threshold: int):
        """Anchor-map a query against this index (native fast path).

        Returns the sorted, overlap-filtered homology list; equivalent to
        anchors.anchor_homologies + sort + filter_overlaps_max.
        """
        if self._native is not None:
            return self._native.map_query(query.as_array(), threshold)
        return None  # caller falls back to the Python chain loop

