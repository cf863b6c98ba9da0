"""Numpy enhanced-suffix-array backend (portable oracle).

This is the pure-Python/numpy implementation of the index behind anchor
finding.  It implements the *behavioral spec* extracted from the
reference's ESA (`src/esa.cxx`), not its machinery:

    longest_match(query) -> (l, i, j)

where ``l`` is the length of the longest prefix of ``query`` that occurs
anywhere in the index text ``S``, and ``[i, j]`` (inclusive) is the suffix
-array range of suffixes having that prefix.  The reference's
``get_match_cached`` (`src/esa.cxx:446-563`) provably returns exactly this
triple — the CLD/FVC child-array descent and the 6-mer LCP-interval cache
are lookup accelerations only — so any correct algorithm is bit-compatible.
Here we use plain binary search over the suffix array with vectorized LCP
scans, which is simple and adequate for an oracle; the production backend
is the C++ ESA (phylonium_tpu/native).

Suffix order matches libdivsufsort: plain byte-lexicographic order where a
suffix that is a proper prefix of another sorts first (no sentinel).

A copy of the JAX package's ``phylonium_tpu/index/esa_numpy.py``: the port carries
its own host layer and imports nothing of that package.
"""

from __future__ import annotations

import numpy as np


def build_suffix_array(s: np.ndarray) -> np.ndarray:
    """Suffix array by prefix doubling (Manber-Myers) with numpy lexsort.

    O(n log^2 n); fine up to a few Mbp.  ``s`` is a uint8 array.
    """
    n = s.size
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    rank = s.astype(np.int64)
    sa = np.argsort(rank, kind="stable").astype(np.int64)
    k = 1
    while True:
        # key2[i] = rank[i + k] or -1 past the end (shorter suffix first)
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - k] = rank[k:]
        sa = np.lexsort((key2, rank)).astype(np.int64)

        # recompute ranks: identical (rank, key2) pairs share a rank
        r_sa = rank[sa]
        k2_sa = key2[sa]
        changed = np.empty(n, dtype=np.int64)
        changed[0] = 0
        if n > 1:
            changed[1:] = (r_sa[1:] != r_sa[:-1]) | (k2_sa[1:] != k2_sa[:-1])
        new_rank = np.empty(n, dtype=np.int64)
        new_rank[sa] = np.cumsum(changed)
        rank = new_rank
        if rank[sa[-1]] == n - 1:
            break
        k *= 2
    return sa


def lcp_bytes(a: np.ndarray, astart: int, b: np.ndarray, bstart: int,
              maxlen: int) -> int:
    """Length of the common prefix of a[astart:] and b[bstart:], capped.

    The cap is also bounded by both array ends (mirroring the reference's
    NUL-terminated scans, `src/process.cxx:171-184`).
    """
    maxlen = min(maxlen, a.size - astart, b.size - bstart)
    if maxlen <= 0:
        return 0
    # geometric chunking: most comparisons mismatch early
    done = 0
    chunk = 64
    while done < maxlen:
        step = min(chunk, maxlen - done)
        av = a[astart + done : astart + done + step]
        bv = b[bstart + done : bstart + done + step]
        neq = av != bv
        if neq.any():
            return done + int(np.argmax(neq))
        done += step
        chunk *= 4
    return maxlen


class NumpySuffixIndex:
    """Suffix array over S with longest-prefix-match queries."""

    def __init__(self, S: np.ndarray):
        assert S.dtype == np.uint8
        self.S = S
        self.m = int(S.size)
        self.SA = build_suffix_array(S)

    # -- internal: compare query[qs:qs+plen] against suffix SA[mid] --
    def _suffix_lcp(self, q: np.ndarray, qs: int, sa_pos: int, cap: int) -> int:
        return lcp_bytes(self.S, sa_pos, q, qs, cap)

    def _cmp_prefix(self, q: np.ndarray, qs: int, plen: int, sa_idx: int) -> int:
        """Compare suffix S[SA[sa_idx]:] with q[qs:qs+plen].

        Returns <0 if suffix < prefix, 0 if the suffix starts with the
        prefix, >0 if suffix > prefix.  A suffix shorter than the prefix
        that matches to its end is considered smaller (divsufsort order).
        """
        p = int(self.SA[sa_idx])
        l = lcp_bytes(self.S, p, q, qs, plen)
        if l == plen:
            return 0
        if p + l >= self.m:  # suffix exhausted -> smaller
            return -1
        return int(self.S[p + l]) - int(q[qs + l])

    def _lower_bound(self, q: np.ndarray, qs: int, plen: int) -> int:
        lo, hi = 0, self.m
        while lo < hi:
            mid = (lo + hi) // 2
            if self._cmp_prefix(q, qs, plen, mid) < 0:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def _upper_bound(self, q: np.ndarray, qs: int, plen: int) -> int:
        lo, hi = 0, self.m
        while lo < hi:
            mid = (lo + hi) // 2
            if self._cmp_prefix(q, qs, plen, mid) <= 0:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def longest_match(self, q: np.ndarray, qs: int, qlen: int
                      ) -> tuple[int, int, int]:
        """Longest prefix of q[qs:qs+qlen] occurring in S.

        Returns (l, i, j): match length and inclusive SA range of all
        suffixes sharing that prefix.
        """
        if qlen <= 0 or self.m == 0:
            return 0, 0, max(self.m - 1, 0)

        # insertion point of the (full remaining) query among suffixes
        pos = self._lower_bound(q, qs, qlen)
        l = 0
        if pos < self.m:
            l = self._suffix_lcp(q, qs, int(self.SA[pos]), qlen)
        if pos > 0:
            l = max(l, self._suffix_lcp(q, qs, int(self.SA[pos - 1]), qlen))

        if l == 0:
            return 0, 0, self.m - 1

        i = self._lower_bound(q, qs, l)
        j = self._upper_bound(q, qs, l) - 1
        return l, i, j
