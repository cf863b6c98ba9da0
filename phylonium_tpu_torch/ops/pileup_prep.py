"""Host prep for the device pileup build.

The packing, interval-record, and overlay computations are pure numpy;
ops/pileup_device.py feeds them to the build kernel (see that module for
the device-side semantics each record feeds).

A copy of the JAX package's ``phylonium_tpu/ops/pileup_prep.py``: the port carries
its own host layer and imports nothing of that package.  ``padded_pack``,
which served only the early query shipper, is left out.
"""

from __future__ import annotations

import numpy as np

from phylonium_tpu_torch.core.homology import REVERSE, Homology
from phylonium_tpu_torch.core.pileup import N_BASE

# byte codes: A=0 C=1 G=2 T=3, '!' separators carried sparsely as code 4
_SEP_BYTE = ord("!")


def pack_queries(queries: list[np.ndarray]):
    """Concatenate and 2-bit-pack query byte arrays.

    Returns (packed uint8 [ceil(T/4)], sep_idx int64 [S], bases int64
    [N+1]) where T = total bases and sep_idx are global positions of
    '!' contig separators (code 4, unrepresentable in 2 bits).
    """
    try:
        from phylonium_tpu_torch.native import pack2_native

        return pack2_native(queries)
    except Exception:
        return _pack_queries_numpy(queries)


def _pack_queries_numpy(queries: list[np.ndarray]):
    """Numpy oracle for :func:`pack_queries` (bit-parity asserted in
    tests/test_pileup_device.py; much slower than the native pass)."""
    bases = np.zeros(len(queries) + 1, np.int64)
    for k, q in enumerate(queries):
        bases[k + 1] = bases[k] + len(q)
    cat = (
        np.concatenate(queries) if queries else np.zeros(0, np.uint8)
    )
    codes = np.zeros(len(cat), np.uint8)
    codes[cat == 67] = 1
    codes[cat == 71] = 2
    codes[cat == 84] = 3
    sep_idx = np.flatnonzero(cat == _SEP_BYTE).astype(np.int64)
    pad = (-len(codes)) % 4
    if pad:
        codes = np.pad(codes, (0, pad))
    quads = codes.reshape(-1, 4)
    packed = (
        quads[:, 0]
        | (quads[:, 1] << 2)
        | (quads[:, 2] << 4)
        | (quads[:, 3] << 6)
    ).astype(np.uint8)
    return packed, sep_idx, bases


def intervals_from_homologies(
    homologies: list[list[Homology]], bases: np.ndarray, ref_len: int
) -> np.ndarray:
    """[N, Hmax, 4] int64 (start, end, B, dir) interval records.

    ``B`` encodes the per-column query index: for a forward interval the
    query position of reference column r is ``B + r``; for a reverse
    interval it is ``B - r`` (global coordinates into the concatenated
    query array).  Padding rows scatter into the out-of-range slot
    ``ref_len`` and are sliced away on device.
    """
    n = len(homologies)
    hmax = max((len(h) for h in homologies), default=0)
    hmax = max(hmax, 1)
    out = np.full((n, hmax, 4), ref_len, dtype=np.int64)
    out[:, :, 3] = 0
    for g, hv in enumerate(homologies):
        if isinstance(hv, np.ndarray):
            # raw [H, 5] int64 rows (direction, ir, irp, iq, length) —
            # the low-memory pipeline's representation; vectorized
            if not len(hv):
                continue
            d, irp, iq, ln = hv[:, 0], hv[:, 2], hv[:, 3], hv[:, 4]
            keep = ln > 0
            d, irp, iq, ln = d[keep], irp[keep], iq[keep], ln[keep]
            order = np.argsort(irp, kind="stable")
            d, irp, iq, ln = d[order], irp[order], iq[order], ln[order]
            giq = bases[g] + iq
            b = np.where(d == REVERSE, giq + ln - 1 + irp, giq - irp)
            out[g, : len(irp), 0] = irp
            out[g, : len(irp), 1] = irp + ln
            out[g, : len(irp), 2] = b
            out[g, : len(irp), 3] = d
            continue
        # drop zero-length entries BEFORE filling: a skipped slot mid-list
        # would leave a fill row (start == end == ref_len) inside the
        # delta chain, corrupting the telescoped B/dir fills of every
        # later interval of this genome (host build_pileup skips them
        # too, core/pileup.py)
        hv = sorted(
            (h for h in hv if h.length > 0), key=lambda h: h.start()
        )
        for k, h in enumerate(hv):
            start, end = h.start(), h.end()
            iq = bases[g] + h.index_query
            if h.direction == REVERSE:
                b = iq + h.length - 1 + start  # query idx of col r: b - r
            else:
                b = iq - start  # query idx of col r: b + r
            out[g, k] = (start, end, b, h.direction)
    return out


def _bucket(n: int, lo: int = 128) -> int:
    """Quarter-octave size bucket (shared compiled shapes across runs)."""
    n = max(n, lo)
    q = 1 << max((n - 1).bit_length() - 2, 4)
    return -(-n // q) * q


# one build's concatenated query bases must fit int32 indexing.  The
# largest device index is a reverse interval's base b = iq + len - 1 +
# start <= group_bases + 2 * ref_len (intervals_from_homologies), so the
# group bound reserves that headroom in build_pileup_device.
_MAX_GROUP_BASES = 1 << 31


def group_payload(queries: list[np.ndarray]):
    """Host prep of one group's shippable query payload.

    Returns (packed32 uint32 — bucketed-padded 2-bit codes viewed as
    little-endian words, the windowed build's gather unit, bases int64
    [N+1], seps int64 — RAW global '!' positions in the concatenated
    group).  Separator positions stay host-side: they become part of
    the sparse overlay of :func:`build_overlay`, never a per-column
    device gather.
    """
    packed, sep_idx, bases = pack_queries(queries)
    packed = np.pad(packed, (0, _bucket(len(packed)) - len(packed)))
    return packed.view(np.uint32), bases, sep_idx


# byte -> 2-bit-code-or-separator, the host mirror of the device
# fetch semantics (A/other=0, C=1, G=2, T=3, '!'=4)
_CODE_LUT = np.zeros(256, np.uint8)
_CODE_LUT[ord("C")] = 1
_CODE_LUT[ord("G")] = 2
_CODE_LUT[ord("T")] = 3
_CODE_LUT[_SEP_BYTE] = 4


def _expand_ranges(lo: np.ndarray, hi: np.ndarray):
    """(values, owners) for the concatenation of [lo_k, hi_k) ranges."""
    counts = np.maximum(hi - lo, 0)
    total = int(counts.sum())
    if not total:
        return (
            np.zeros(0, dtype=lo.dtype),
            np.zeros(0, dtype=np.int64),
        )
    k = np.repeat(np.arange(len(lo)), counts)
    off = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    return lo[k] + off, k


def build_overlay(
    intervals: np.ndarray,
    queries: list[np.ndarray],
    bases: np.ndarray,
    seps: np.ndarray,
    ref_len: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sparse (row, col, state) fix-up records for one group build.

    The windowed device fetch (`_build_core_nosep`) is exact only for
    16-column groups lying wholly inside one interval.  This computes,
    from the HOST's query bytes, the exact states for

    1. every covered column of a partial group — the head
       ``[start, min(end, ceil16(start)))`` and tail
       ``[max(head_end, floor16(end)), end)`` of each interval record
       (start, end, B, dir): query position of column r is ``B + r``
       forward / ``B - r`` reverse, state = code(byte) + N_BASE*dir;
    2. every '!' separator column inside full groups (the 2-bit slot
       packs as code 0): same formula, code('!') = 4 — matching the
       reference's contig-border semantics (`src/sequence.cxx:171-199`).

    At most ~30 columns per interval plus the (rare) separators, so the
    scatter stays sparse.  (row, col) pairs repeat only with equal
    values (ref intervals are disjoint), keeping the unordered scatter
    deterministic.  Outputs are padded to a shape bucket with
    out-of-range rows (scatter mode='drop').
    """
    rows_parts, cols_parts, vals_parts = [], [], []
    n_real = min(intervals.shape[0], len(queries), len(bases) - 1)
    seps = np.asarray(seps, dtype=np.int64)
    for g in range(n_real):
        iv = intervals[g]
        st, en, b, d = iv[:, 0], iv[:, 1], iv[:, 2], iv[:, 3]
        # boundary (partial-group) columns per interval
        head_hi = np.minimum(en, (st + 15) & ~np.int64(15))
        tail_lo = np.maximum(head_hi, en & ~np.int64(15))
        c1, k1 = _expand_ranges(st, head_hi)
        c2, k2 = _expand_ranges(tail_lo, en)
        cols = np.concatenate([c1, c2])
        k = np.concatenate([k1, k2])
        # separator columns anywhere inside intervals (the boundary
        # set re-emits some — same value, harmless)
        i0, i1 = np.searchsorted(seps, [bases[g], bases[g + 1]])
        if i1 > i0:
            sp = seps[i0:i1]
            qlo = np.where(d == 0, b + st, b - en + 1)
            qhi = np.where(d == 0, b + en, b - st + 1)
            valid = st < en  # fill rows: start == end == ref_len
            j0 = np.where(valid, np.searchsorted(sp, qlo), 0)
            j1 = np.where(valid, np.searchsorted(sp, qhi), 0)
            sidx, sk = _expand_ranges(j0, j1)
            p = sp[sidx]
            scols = np.where(d[sk] == 0, p - b[sk], b[sk] - p)
            cols = np.concatenate([cols, scols])
            k = np.concatenate([k, sk])
        if not len(cols):
            continue
        qpos = np.where(d[k] == 0, b[k] + cols, b[k] - cols)
        local = (qpos - bases[g]).astype(np.int64)
        vals = (
            _CODE_LUT[queries[g][local]] + N_BASE * d[k]
        ).astype(np.uint8)
        rows_parts.append(np.full(len(cols), g, dtype=np.int64))
        cols_parts.append(cols)
        vals_parts.append(vals)
    if rows_parts:
        orow = np.concatenate(rows_parts).astype(np.int32)
        ocol = np.concatenate(cols_parts).astype(np.int32)
        oval = np.concatenate(vals_parts)
    else:
        orow = np.zeros(0, np.int32)
        ocol = np.zeros(0, np.int32)
        oval = np.zeros(0, np.uint8)
    pad = _bucket(len(orow), lo=16) - len(orow)
    # padded entries: out-of-range row -> dropped by the scatter
    orow = np.pad(orow, (0, pad), constant_values=1 << 30)
    ocol = np.pad(ocol, (0, pad))
    oval = np.pad(oval, (0, pad))
    return orow, ocol, oval


def prep_intervals(
    homologies: list[list[Homology]],
    bases: np.ndarray,
    ref_len: int,
    pad_rows: int = 0,
) -> np.ndarray:
    """Host half of one group build: padded interval records exactly as
    the JAX package's ``_build_packed`` consumes them."""
    intervals = intervals_from_homologies(homologies, bases, ref_len)
    hmax = intervals.shape[1]
    h_pad = _bucket(hmax, lo=16) - hmax
    rows = intervals.shape[0] + pad_rows
    if h_pad or pad_rows:
        out = np.full((rows, hmax + h_pad, 4), ref_len, dtype=np.int64)
        out[:, :, 3] = 0
        out[: intervals.shape[0], :hmax] = intervals
        intervals = out
    return intervals


