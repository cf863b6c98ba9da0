"""Pileup-build inputs shared by the port's tests and ``chip_smoke.py``.

It imports only the port (the port's Homology, which the JAX package's
host pileup takes as it takes its own): the card-only tests and the smoke
run import it on a machine without jax. Each generator returns (queries,
homologies, ref_len): query byte arrays and, per genome, a list of
Homology objects.
"""

from __future__ import annotations

import numpy as np

from phylonium_tpu_torch.core.homology import FORWARD, REVERSE, Homology
from phylonium_tpu_torch.ops.pileup_device import (
    OVERLAY_CHUNK,
    RECORD_CHUNK,
    TILE_BYTES,
)

ACGT = np.frombuffer(b"ACGT", np.uint8)


def hom(direction, proj_start, iq, length):
    return Homology(
        direction=direction,
        index_reference=proj_start,
        index_reference_projected=proj_start,
        index_query=iq,
        length=length,
    )


def raw(hv):
    """Homology objects -> the native mapper's raw [H, 5] int64 rows."""
    return np.array(
        [[h.direction, h.index_reference, h.index_reference_projected,
          h.index_query, h.length] for h in hv],
        dtype=np.int64,
    ).reshape(-1, 5)


def panel(rng, n, ref_len):
    """tests/test_stream.py's panel: forward, reverse, partial and empty
    rows (every 5th genome has no homology), '!' separators."""
    queries, homologies = [], []
    for g in range(n):
        qlen = ref_len + int(rng.integers(0, 60))
        q = rng.choice(ACGT, qlen).astype(np.uint8)
        if g % 4 == 1 and qlen > 40:
            q[qlen // 2] = ord("!")
        hv = []
        if g % 5 != 4 and ref_len == 1:
            rev = g % 3 == 0
            hv.append(hom(REVERSE if rev else FORWARD, 0,
                          qlen - 2 if rev else 0, 1))
        elif g % 5 != 4:
            cut = int(rng.integers(1, ref_len))
            len1 = int(rng.integers(1, cut + 1))
            hv.append(hom(FORWARD, cut - len1, 0, len1))
            len2 = int(rng.integers(0, ref_len - cut + 1))
            if len2 > 0:
                rev = g % 3 == 0
                hv.append(hom(REVERSE if rev else FORWARD, cut,
                              qlen - len2 - 1 if rev else cut, len2))
        queries.append(q)
        homologies.append(hv)
    return queries, homologies, ref_len


def tiling(rng, n=24, ref_len=640):
    """tests/test_stream.py's dense tilings: 1..40-column forward and
    reverse records back to back at every start alignment mod 16, with
    separators."""
    queries, homologies = [], []
    for g in range(n):
        qlen = 2 * ref_len
        q = rng.choice(ACGT, qlen).astype(np.uint8)
        q[rng.integers(0, qlen, 5)] = ord("!")
        hv = []
        col, qpos = g % 16, 0
        while col < ref_len - 41 and qpos < qlen - 100:
            length = int(rng.integers(1, 41))
            if (col + g) % 3 == 0:
                hv.append(hom(REVERSE, col, qlen - qpos - length, length))
            else:
                hv.append(hom(FORWARD, col, qpos, length))
            col += length + int(rng.integers(0, 3))
            qpos += length + 1
        queries.append(q)
        homologies.append(hv)
    return queries, homologies, ref_len


def zero_length_mid_list(rng):
    """A zero-length homology between two real ones: every pileup build
    drops it (tests/test_pileup_device.py:136)."""
    q = rng.choice(ACGT, 1200).astype(np.uint8)
    hv = [
        hom(FORWARD, 10, 0, 200),
        hom(FORWARD, 400, 300, 0),
        hom(REVERSE, 600, 500, 250),
    ]
    return [q], [hv], 1000


def both_nibbles(rng, ref_len=101):
    """Overlay entries on both nibbles of one byte: '!' at the query
    positions of columns c and c + ceil(L/2) inside one forward record,
    and a reverse record whose head and tail columns share bytes."""
    l2 = -(-ref_len // 2)
    q = rng.choice(ACGT, 3 * ref_len).astype(np.uint8)
    q[7] = q[7 + l2] = ord("!")
    r = rng.choice(ACGT, 2 * ref_len).astype(np.uint8)
    r[3] = ord("!")
    return (
        [q, r],
        [[hom(FORWARD, 0, 0, ref_len)],
         [hom(REVERSE, 1, 2, ref_len - 2)]],
        ref_len,
    )


class _Rows:
    """Records laid down one at a time, each on fresh query bases of its
    row: ``add(row, direction, col, length)``."""

    def __init__(self, rng, rows: int, qlen: int):
        self.queries = [rng.choice(ACGT, qlen).astype(np.uint8)
                        for _ in range(rows)]
        self.homologies = [[] for _ in range(rows)]
        self.used = [0] * rows

    def add(self, row: int, direction: int, col: int, length: int,
            gap: int = 1) -> int:
        """Query position of the record's first base."""
        iq = self.used[row] + gap
        self.used[row] = iq + length
        assert self.used[row] <= len(self.queries[row])
        self.homologies[row].append(hom(direction, col, iq, length))
        return iq

    def query_pos(self, row: int, col: int) -> int:
        """The query position the row's record maps ``col`` to."""
        for h in self.homologies[row]:
            if h.start() <= col < h.end():
                if h.direction == REVERSE:
                    return h.index_query + h.length - 1 - (col - h.start())
                return h.index_query + col - h.start()
        raise ValueError(f"no record of row {row} covers column {col}")


def tile_edges(rng, tile=TILE_BYTES):
    """Records across the build kernel's tile edges in both column spans,
    records longer than a tile, and an odd ref_len whose l2 falls inside a
    tile, so the last tile is ragged in both spans."""
    ref_len = 6 * tile + 333
    l2 = -(-ref_len // 2)
    rows = _Rows(rng, 4, 2 * ref_len)
    # row 0: a forward record over two tiles and more; a reverse one
    # across l2, so in both spans of one tile
    rows.add(0, FORWARD, 100, 2 * tile - 501)
    rows.add(0, REVERSE, l2 - tile - 9, 2 * tile + 41)
    # row 1: short records across every tile edge of both spans
    edges = sorted([k * tile for k in range(1, 4)]
                   + [l2 + k * tile for k in range(3)])
    for k, e in enumerate(edges):
        rows.add(1, REVERSE if k % 2 else FORWARD, e - 37 - k, 87 + 2 * k)
    # row 2: records ending exactly at an edge, the next starting there
    for k, e in enumerate(edges):
        rows.add(2, FORWARD if k % 2 else REVERSE, e - 64, 64)
        rows.add(2, REVERSE if k % 2 else FORWARD, e, 19 + k)
    # row 3: one reverse record over the whole reference
    rows.add(3, REVERSE, 0, ref_len)
    for r in range(4):
        q = rows.queries[r]
        q[rng.integers(0, len(q), 9)] = ord("!")
    return rows.queries, rows.homologies, ref_len


def dense_chunks(rng, tile=TILE_BYTES):
    """More records and overlay entries in one tile's span than the kernel
    stages at a time: 1-column records back to back (each one also an
    overlay entry), with gaps, across a tile edge, in the low and the high
    span, and a record with a separator at every third query base."""
    ref_len = 4 * tile + 1
    l2 = -(-ref_len // 2)
    many = 2 * OVERLAY_CHUNK + 5
    assert many > 3 * RECORD_CHUNK and many + 100 < tile
    rows = _Rows(rng, 4, 4 * many + 4 * tile)
    for k in range(many):
        rows.add(0, REVERSE if k % 3 == 0 else FORWARD, 40 + k, 1, gap=k % 2)
        rows.add(1, FORWARD if k % 3 == 0 else REVERSE, l2 + 40 + k, 1, gap=0)
    col = tile - 2 * RECORD_CHUNK
    for k in range(3 * RECORD_CHUNK + 7):
        rows.add(2, REVERSE if k % 2 else FORWARD, col, 1)
        col += 1 + k % 2
    iq = rows.add(3, FORWARD, 10, 4 * OVERLAY_CHUNK)
    rows.queries[3][iq : iq + 4 * OVERLAY_CHUNK : 3] = ord("!")
    iq = rows.add(3, REVERSE, l2 + 5, 2 * OVERLAY_CHUNK + 50)
    rows.queries[3][iq : iq + 2 * OVERLAY_CHUNK + 50 : 2] = ord("!")
    return rows.queries, rows.homologies, ref_len


def reverse_windows(rng, ref_len=1501):
    """Forward and reverse records at every query-base residue mod 16, so
    each thread's 16-column window meets its 2-bit codes at every shift
    inside a code word, and crosses a word boundary in both directions."""
    rows = _Rows(rng, 16, 4 * ref_len)
    for r in range(16):
        rows.add(r, REVERSE, 3 + r, 600 + 37 * r, gap=r)
        rows.add(r, FORWARD, 700 + 37 * r, ref_len - 700 - 37 * r - r,
                 gap=(5 * r) % 16)
    return rows.queries, rows.homologies, ref_len


def query_ends(rng, ref_len=2100):
    """Records that reach the first and the last base of the group's
    query codes, where a window's code indices leave [0, n_codes) and the
    kernel takes the clamped per-column path: 4 queries of 2,048 bases
    pack to exactly 512 words, with no padding after the last code."""
    queries = [rng.choice(ACGT, 2048).astype(np.uint8) for _ in range(4)]
    homologies = [
        [hom(FORWARD, 7, 0, 1000), hom(REVERSE, 1009, 1048, 1000)],
        [hom(REVERSE, 3, 0, 2000)],
        [hom(FORWARD, 50, 1037, 1011)],
        [hom(REVERSE, 11, 1048, 1000), hom(FORWARD, 1013, 1049, 999)],
    ]
    return queries, homologies, ref_len


def both_nibbles_at_a_tile_edge(rng, tile=TILE_BYTES):
    """Separators at the query bases of columns tile - 1 and tile, l2 - 1
    and l2, and l2 + tile - 1 and l2 + tile: overlay entries on both
    nibbles of the bytes at a tile edge, forward and reverse."""
    ref_len = 2 * tile + 501
    l2 = -(-ref_len // 2)
    rows = _Rows(rng, 2, ref_len + 10)
    rows.add(0, FORWARD, 0, ref_len)
    rows.add(1, REVERSE, 0, ref_len)
    for r in range(2):
        for col in (tile - 1, tile, l2 - 1, l2, l2 + tile - 1, l2 + tile):
            rows.queries[r][rows.query_pos(r, col)] = ord("!")
    return rows.queries, rows.homologies, ref_len


def _one_empty_row(rng):
    queries, homologies, ref_len = panel(rng, 6, 513)
    homologies[2] = []
    return queries, homologies, ref_len


# name -> rng -> (queries, homologies, ref_len): the edge shapes the card
# holds the build kernel to
EDGE_CASES = {
    "ref_len_1": lambda rng: panel(rng, 5, 1),
    "ref_len_2": lambda rng: panel(rng, 5, 2),
    "odd_ref_len_301": lambda rng: panel(rng, 7, 301),
    "even_ref_len_700": lambda rng: panel(rng, 7, 700),
    "every_alignment_separators": tiling,
    "zero_length_mid_list": zero_length_mid_list,
    "overlay_on_both_nibbles": both_nibbles,
    "a_row_with_no_intervals": _one_empty_row,
    "one_row": lambda rng: panel(rng, 1, 2600),
    "300_rows": lambda rng: panel(rng, 300, 1500),
    "records_across_tile_edges": tile_edges,
    "more_than_one_chunk": dense_chunks,
    "reverse_windows_across_code_words": reverse_windows,
    "records_at_the_query_ends": query_ends,
    "overlay_on_both_nibbles_at_a_tile_edge": both_nibbles_at_a_tile_edge,
}


def write_fasta_panel(tmp_path, n, length, seed, contigs=1):
    """``n`` FASTA files of 1 %, 2 %, ... mutants of one random genome,
    each cut into ``contigs`` contigs; returns their paths."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, length)
    files = []
    for k in range(n):
        arr = base.copy()
        idx = rng.random(arr.size) < 0.01 * (k + 1)
        arr[idx] = (arr[idx] + rng.integers(1, 4, int(idx.sum()))) % 4
        seq = ACGT[arr].tobytes()
        step = length // contigs + 1
        body = b"".join(
            b">Q%02d_c%d\n%s\n" % (k, c, seq[c * step : (c + 1) * step])
            for c in range(contigs)
        )
        path = tmp_path / f"Q{k:02d}.fasta"
        path.write_bytes(body)
        files.append(str(path))
    return files
