"""Seeded genome panels and their FASTA files.

The panel shape of ``chip_smoke.py::eco29_panel`` and ``bench.py::simulate_panel``,
rewritten without either package: a random base genome, then ``n - 1``
substitution mutants of it (a star tree) whose rates run evenly from
``low`` to ``low + span``, the last one a draft assembly in ``contigs``
pieces with an inversion of ``min(inversion, length // 6)`` bases at a
third of its length. Two things differ:

- genome ``k`` is ``2 k`` bases shorter, by one deletion at a random
  place (the draft, its separators counted, ``2 k + 1``), so that no two
  genomes have the same length: real assemblies differ in length, and
  phylonium picks the reference of median length, which then names one
  genome with no tie to break;
- the substitutions are drawn as a binomial count of positions, which
  keeps a genome's cost at a few milliseconds.

Every size and rate comes from the configuration; the seed draws only
the bases and the places, so every seed does the same amount of work.

Each genome draws from a stream of its own (seed, slot, version). A
panel can turn over (``period`` > 0): from its second CLI run on (run
``r`` = 1, 2, ...) every slot ``k`` with ``k % period == r % period``
holds a genome it has not held before, drawn as the slot's first one was (same rate, same
length), except the ancestor and the slot of median length, which the
reference genome stays. So ``1 / period`` of the panel is new in each
run, the reference genome and its anchor threshold never change, and a
slot's ``v``-th genome is a file of its own, ``<prefix><k>v<v>.fasta``.
"""

from __future__ import annotations

import os

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
_CODE = np.zeros(256, np.uint8)
_CODE[ACGT] = np.arange(4, dtype=np.uint8)
_COMPLEMENT = bytes.maketrans(b"ACGT", b"TGCA")
LINE = 80


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for ``seed`` (any integer) and one of its streams."""
    return np.random.default_rng([seed % (1 << 64), *stream])


def check_shape(shape: dict) -> tuple[int, int]:
    n, length = int(shape["genomes"]), int(shape["length"])
    if n < 5 or length < 1000:
        raise ValueError(f"a panel needs 5 genomes of 1000 bases or more, not {n} x {length}")
    return n, length


def joined_lengths(shape: dict) -> list[int]:
    """Each slot's length as read, its contigs joined by one separator
    each: ``L - 2 k``, the draft ``L - 2 k - 1``."""
    n, length = check_shape(shape)
    return [length - 2 * k - (k == n - 1) for k in range(n)]


def median_slot(shape: dict) -> int:
    """The slot of median length (rank ``n // 2`` ascending)."""
    lengths = joined_lengths(shape)
    return sorted(range(len(lengths)), key=lengths.__getitem__)[len(lengths) // 2]


def mutant(shape: dict, base: np.ndarray, k: int, rng: np.random.Generator) -> list[bytes]:
    """Slot ``k``'s genome (``k`` > 0) as a list of contigs: ``base`` with
    the slot's substitutions, deletion and, for the last slot, the draft's
    contigs and inversion."""
    n, length = check_shape(shape)
    low, span = float(shape["divergence_low"]), float(shape["divergence_span"])
    rate = low + span * (k - 1) / max(n - 2, 1)
    arr = base.copy()
    hit = rng.integers(0, length, rng.binomial(length, rate))
    arr[hit] = ACGT[(_CODE[arr[hit]] + rng.integers(1, 4, hit.size)) % 4]
    draft = k == n - 1
    # the draft's contig separators lengthen it again: it loses one
    # more base than they add back, so its joined length is L - 2k - 1
    cut = 2 * k + (int(shape["draft_contigs"]) if draft else 0)
    at = int(rng.integers(0, length - cut))
    arr = np.concatenate((arr[:at], arr[at + cut:]))
    if not draft:
        return [arr.tobytes()]
    seq = bytearray(arr.tobytes())
    third = len(seq) // 3
    inv = min(int(shape["draft_inversion"]), len(seq) // 6)
    seq[third:third + inv] = bytes(seq[third:third + inv])[::-1].translate(_COMPLEMENT)
    pieces = int(shape["draft_contigs"])
    size = -(-len(seq) // pieces)
    return [bytes(seq[i:i + size]) for i in range(0, len(seq), size)]


def fasta_bytes(name: str, contigs: list[bytes]) -> bytes:
    """One genome as FASTA, ``LINE`` bases a line."""
    parts = []
    for ci, contig in enumerate(contigs):
        parts.append(b">%s_c%d\n" % (name.encode(), ci))
        arr = np.frombuffer(contig, np.uint8)
        full = arr.size // LINE
        block = np.full((full, LINE + 1), ord("\n"), np.uint8)
        block[:, :LINE] = arr[:full * LINE].reshape(full, LINE)
        parts.append(block.tobytes())
        if arr.size > full * LINE:
            parts.append(arr[full * LINE:].tobytes() + b"\n")
    return b"".join(parts)


class Panel:
    """The panel of ``shape`` for ``seed``, one FASTA file a genome in
    ``directory``: ``files(r)`` writes what run ``r`` needs and is not
    written yet, and returns its paths in slot order."""

    def __init__(self, shape: dict, seed: int, directory: str, prefix: str = "G",
                 stream: int = 0, period: int = 0):
        self.n, length = check_shape(shape)
        self.shape, self.seed, self.stream = shape, seed, stream
        self.directory, self.prefix, self.period = directory, prefix, int(period)
        self.base = ACGT[rng_for(seed, stream).integers(0, 4, length)]
        self.fixed = {0, median_slot(shape)}
        self.written = 0
        os.makedirs(directory, exist_ok=True)

    def version(self, k: int, run: int) -> int:
        """How many times slot ``k`` has turned over by run ``run``."""
        if not self.period or k in self.fixed:
            return 0
        first = k % self.period or self.period
        return 0 if run < first else (run - first) // self.period + 1

    def files(self, run: int = 0) -> list[str]:
        paths = []
        for k in range(self.n):
            v = self.version(k, run)
            name = f"{self.prefix}{k:04d}" + (f"v{v}" if v else "")
            path = os.path.join(self.directory, name + ".fasta")
            if not os.path.exists(path):
                contigs = ([self.base.tobytes()] if k == 0 else
                           mutant(self.shape, self.base, k, rng_for(self.seed, self.stream, k, v)))
                with open(path, "wb") as f:
                    f.write(fasta_bytes(name, contigs))
                self.written += 1
            paths.append(path)
        return paths


def write_panel(shape: dict, seed: int, directory: str, prefix: str = "G",
                stream: int = 0) -> list[str]:
    """Write the panel of ``shape`` for ``seed`` into ``directory``, one
    FASTA file a genome; returns the paths in panel order."""
    return Panel(shape, seed, directory, prefix, stream).files(0)
