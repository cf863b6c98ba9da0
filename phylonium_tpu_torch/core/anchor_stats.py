"""Anchor length statistics.

Minimum anchor length such that a random exact match is unlikely
(p < ANCHOR_P_VALUE), based on the shortest-unique-substring length
distribution of Haubold et al. (2009).

Float semantics mirror the reference exactly (IEEE doubles, same libm):
- ``shuprop`` mirrors `src/process.cxx:140-161` including the `s >= 1.0`
  clamp-and-break.
- ``min_anchor_length`` mirrors `src/process.cxx:77-86`.
- ``binomial_coefficient`` (src/process.cxx:103-125) is exact for the
  argument range reachable here; ``math.comb`` is identical.

A copy of the JAX package's ``phylonium_tpu/core/anchor_stats.py``: the port carries
its own host layer and imports nothing of that package.
"""

from __future__ import annotations

import math

# The probability with which an anchor is allowed to be random
# (src/phylonium.cxx:55). Constant; the reference exposes no flag for it.
ANCHOR_P_VALUE = 0.025


def shuprop(x: int, p: float, l: int) -> float:
    """P{longest shortest-unique-substring length <= x}.

    :param x: candidate shustring length
    :param p: half the GC content
    :param l: length of the subject (here: the doubled index text)
    """
    xx = float(x)
    ll = float(l)
    s = 0.0

    for k in range(0, x + 1):
        kk = float(k)
        t = math.pow(p, kk) * math.pow(0.5 - p, xx - kk)
        s += math.pow(2.0, xx) * (t * math.pow(1.0 - t, ll)) * math.comb(x, k)
        if s >= 1.0:
            s = 1.0
            break

    return s


def min_anchor_length(p: float, g: float, l: int) -> int:
    """Smallest x with P{random match of length x} < p."""
    x = 1
    while shuprop(x, g / 2.0, l) < 1.0 - p:
        x += 1
    return x
