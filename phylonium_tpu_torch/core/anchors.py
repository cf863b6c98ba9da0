"""Anchor seeding and homology segment extraction (Python oracle).

Behavioral spec, with the reference rules it must reproduce bit-exactly
(`src/process.cxx:198-295`; parity enforced end-to-end by
tests/test_oracle_parity.py):

- a *seed* is accepted at the query cursor if it is either a unique
  longest index match of at least ``threshold`` bases
  (src/process.cxx:219-225), or — probed first because it is cheaper —
  a plain text extension on the diagonal predicted by the previous seed,
  attempted when the unseeded gap is at most ``threshold``; the diagonal
  probe needs no uniqueness (src/process.cxx:227-242);
- a seed *collinear* with the previous one (same diagonal:
  equidistant on query and index text; strictly to the right; same
  strand half of the doubled text, src/process.cxx:251-253) merges into
  the open segment, spanning the gap;
- a diagonal jump closes the open segment; it is kept iff it ever
  absorbed a collinear seed or its founding seed was at least twice the
  threshold (src/process.cxx:261,289);
- the cursor advances by the last probe's match length + 1 even when
  the probe produced no acceptable seed (src/process.cxx:281);
- if a single seed covered the whole query the result is one full-query
  segment (identical sequences, src/process.cxx:284-287).

This implementation is the correctness oracle; the C++ backend
(phylonium_tpu/native) implements the same spec for production speed and
is tested for bit-identical output.

A copy of the JAX package's ``phylonium_tpu/core/anchors.py``: the port carries
its own host layer and imports nothing of that package.
"""

from __future__ import annotations

from phylonium_tpu_torch.core.homology import Homology
from phylonium_tpu_torch.data.sequence import Sequence
from phylonium_tpu_torch.index.esa import ESAIndex
from phylonium_tpu_torch.index.esa_numpy import lcp_bytes


def anchor_homologies(
    ref: ESAIndex, threshold: int, seq: Sequence
) -> list[Homology]:
    segments: list[Homology] = []

    strand_border = ref.size // 2
    query = seq.as_array()
    qlen = len(seq)
    S, SA = ref.S, ref.SA

    prev_q = prev_s = prev_len = 0  # last accepted seed
    merged = False  # open segment absorbed a collinear seed
    open_seg = Homology.at(0, 0)

    def keep_open() -> None:
        if merged or prev_len // 2 >= threshold:
            open_seg.reverse_eh(strand_border)
            segments.append(open_seg)

    cursor = 0
    while cursor < qlen:
        probe_len = 0  # cursor stride comes from the last probe
        hit_s = -1

        # cheap probe: extend along the predicted diagonal
        diag_s = prev_s + (cursor - prev_q)
        if diag_s < ref.size and cursor - (prev_q + prev_len) <= threshold:
            probe_len = lcp_bytes(query, cursor, S, diag_s, qlen - cursor)
            if probe_len >= threshold:
                hit_s = diag_s
        if hit_s < 0:
            # full probe: longest index match, accepted only when unique
            length, lo, hi = ref.longest_match(query, cursor, qlen - cursor)
            probe_len = max(length, 0)
            if lo == hi and probe_len >= threshold:
                hit_s = int(SA[lo])

        if hit_s >= 0:
            prev_end_s = prev_s + prev_len
            prev_end_q = prev_q + prev_len
            collinear = (
                hit_s > prev_end_s
                and cursor - prev_end_q == hit_s - prev_end_s
                and (hit_s < strand_border) == (prev_s < strand_border)
            )
            if collinear:
                open_seg.extend((cursor - prev_end_q) + probe_len)
                merged = True
            else:
                keep_open()
                open_seg = Homology.at(hit_s, cursor, probe_len)
                merged = False
            prev_q, prev_s, prev_len = cursor, hit_s, probe_len

        cursor += probe_len + 1

    # identical sequences: one seed covered the whole query
    if prev_len >= qlen:
        open_seg = Homology.at(prev_s, 0, qlen)
    keep_open()

    return segments
