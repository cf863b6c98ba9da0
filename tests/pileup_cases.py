"""Pileup-build inputs shared by the port's tests and ``chip_smoke.py``.

jax-free: the card-only tests and the smoke run import it on a machine
without jax. Each generator returns (queries, homologies, ref_len):
query byte arrays and, per genome, a list of Homology objects.
"""

from __future__ import annotations

import numpy as np

from phylonium_tpu.core.homology import FORWARD, REVERSE, Homology

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
