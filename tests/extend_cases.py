"""Diagonal-mismatch inputs shared by the port's tests and ``chip_smoke.py``.

numpy (and torch in ``texts_on``) only: the card-only tests and the smoke
run import it on a machine without jax. Each generator takes a numpy Generator and returns (a, b,
off_a, off_b, lim_a, lim_b, length): two uint8 texts, int64 offsets and
limits a job (a limit may be one value for all jobs), and the row length.
The cases are the edges of csrc/diagonal_neq.cu: its 32-byte spans at
every alignment of either text, words cut by ``end`` or by ``length``, the
byte path at a text's end, and more jobs than one grid row.
"""

from __future__ import annotations

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
MAX_GRID_Y = 65535  # jobs one launch's grid holds before it loops


def texts(rng, na: int, nb: int, p: float = 0.03):
    """A random text and a ``p``-mutated copy of it cut to ``nb`` bytes."""
    a = ACGT[rng.integers(0, 4, na)]
    b = a.copy()
    hit = rng.random(na) < p
    b[hit] = ACGT[(np.searchsorted(ACGT, b[hit]) + rng.integers(1, 4, hit.sum())) % 4]
    return a, b[:nb].copy()


def residues(rng):
    """off_a and off_b at all 16 x 16 residues mod 16 against each other."""
    a, b = texts(rng, 6000, 5000)
    ra, rb = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    off_a = 16 * rng.integers(0, 200, 256) + ra.ravel()
    off_b = 16 * rng.integers(0, 200, 256) + rb.ravel()
    return a, b, off_a, off_b, len(a), len(b), 1000


def _length(length: int, na: int = 4000):
    def make(rng):
        a, b = texts(rng, na, na - 7)
        jobs = 12
        off_a = rng.integers(0, na - length, jobs) if na > length else np.zeros(jobs, np.int64)
        off_b = rng.integers(0, na - 7 - length, jobs) if na - 7 > length else np.zeros(jobs, np.int64)
        off_a[0], off_b[1] = na, na - 7   # at the text ends
        off_a[2], off_b[3] = na - 5, na - 40
        return a, b, off_a, off_b, len(a), len(b), length
    return make


def end_inside_a_word(rng):
    """Limits that stop each job inside a word, at every bit of it."""
    a, b = texts(rng, 5000, 5000, p=0.0)
    off_a = rng.integers(0, 2000, 33)
    off_b = off_a + rng.integers(0, 3, 33)
    lim_a = off_a + 64 + np.arange(33)     # end = 64 + k: bit k of word 2
    lim_b = np.full(33, len(b))
    return a, b, off_a, off_b, lim_a, lim_b, 200


def limit_zero(rng):
    a, b = texts(rng, 3000, 3000)
    off_a = np.array([0, 17, 1500, 2999, 40, 3])
    off_b = np.array([5, 0, 1499, 100, 2990, 3])
    lim_a = np.array([0, 3000, 1600, 3000, 2000, 0])
    lim_b = np.array([3000, 0, 3000, 2500, 3000, 0])
    return a, b, off_a, off_b, lim_a, lim_b, 700


def offsets_at_the_text_end(rng):
    """Offsets at and just before each text's end, at every residue."""
    a, b = texts(rng, 2003, 1999)
    back = np.array([0, 1, 5, 15, 16, 17, 31, 32, 33, 47, 48, 49, 64])
    off_a = len(a) - back
    off_b = len(b) - back[::-1]
    return a, b, off_a, off_b, len(a), len(b), 100


def short_texts(rng):
    """Texts shorter than one 16-byte load."""
    a, b = texts(rng, 11, 7, p=0.3)
    off_a = np.array([0, 3, 10, 11, 0])
    off_b = np.array([0, 1, 6, 7, 7])
    return a, b, off_a, off_b, len(a), len(b), 40


def many_jobs(rng):
    """More jobs than one grid row, so the launch loops over jobs."""
    a, b = texts(rng, 3000, 3000)
    jobs = MAX_GRID_Y + 101
    off_a = rng.integers(0, len(a) + 1, jobs)
    off_b = rng.integers(0, len(b) + 1, jobs)
    return a, b, off_a, off_b, len(a), len(b), 33


def texts_on(device, a, b, shift: int):
    """``a`` and ``b`` copied to ``device``, starting ``shift`` and
    ``13 * shift % 16`` bytes into buffers of their own, so that with
    ``shift`` > 0 the 16-byte loads covering a text's first bytes would
    begin before it."""
    import torch

    out = []
    for host, pad in ((a, shift), (b, (13 * shift) % 16)):
        buf = torch.zeros(len(host) + pad, dtype=torch.uint8, device=device)
        buf[pad:] = torch.from_numpy(host).to(device)
        out.append(buf[pad:])
    return out


# name -> rng -> (a, b, off_a, off_b, lim_a, lim_b, length)
CASES = {
    "residues_mod_16": residues,
    "length_1": _length(1),
    "length_31": _length(31),
    "length_32": _length(32),
    "length_33": _length(33),
    "length_2^19+5": _length((1 << 19) + 5, na=(1 << 19) + 3000),
    "end_inside_a_word": end_inside_a_word,
    "limit_zero": limit_zero,
    "offsets_at_the_text_end": offsets_at_the_text_end,
    "text_shorter_than_16_bytes": short_texts,
    "more_jobs_than_one_grid_row": many_jobs,
}
