"""Sequence data model.

Behavioral parity notes (all citations into the reference phylonium sources):

- ``Sequence``/``Genome`` mirror `src/sequence.h:18-160`.
- ``revcomp`` mirrors the complement bit trick `src/sequence.cxx:84-94`:
  bytes below ``'A'`` are passed through unchanged; everything else is
  complemented with ``c ^= (c & 2) ? 4 : 21``.
- ``filter_nucl`` mirrors `src/sequence.cxx:109-146`: keep only ACGTacgt,
  uppercasing as we go.
- ``gc_content`` mirrors `src/sequence.cxx:152-165`: a byte counts as G/C
  iff ``(c & 'G' & 'C') == ('G' & 'C')`` (i.e. ``(c & 0x43) == 0x43``).
- ``join`` mirrors `src/sequence.cxx:171-199`: contigs are concatenated
  with a ``'!'`` separator so exact matches can never span contig borders.

Sequences are stored as ``bytes`` (ASCII) and exposed as numpy ``uint8``
views for vectorized host work and zero-copy device upload.

A copy of the JAX package's ``phylonium_tpu/data/sequence.py``: the port carries
its own host layer and imports nothing of that package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Technical sequence-length limit, mirroring src/sequence.cxx:36-42
# (64-bit index => limit 2^62).
LENGTH_LIMIT = 1 << 62

# Contig separator used by join(); matches never span it because it does
# not occur in any query's match alphabet (src/sequence.cxx:189).
SEPARATOR = 0x21  # b'!'


def _build_revcomp_table() -> np.ndarray:
    table = np.arange(256, dtype=np.uint8)
    for c in range(ord("A"), 256):
        table[c] = c ^ (4 if (c & 2) else 21)
    return table


def _build_filter_table() -> np.ndarray:
    # 0 = drop; otherwise the (uppercased) replacement byte.
    table = np.zeros(256, dtype=np.uint8)
    for ch in b"ACGT":
        table[ch] = ch
        table[ch + 32] = ch  # lowercase
    return table


_REVCOMP_TABLE = _build_revcomp_table()
_FILTER_TABLE = _build_filter_table()


def revcomp(nucl: bytes) -> bytes:
    """Reverse complement of an ASCII nucleotide string."""
    arr = np.frombuffer(nucl, dtype=np.uint8)
    return _REVCOMP_TABLE[arr[::-1]].tobytes()


def filter_nucl(raw: bytes) -> bytes:
    """Keep only canonical nucleotides (ACGT), uppercased."""
    if len(raw) >= (1 << 16):
        # one native pass beats the three numpy passes on big contigs
        try:
            from phylonium_tpu_torch.native import filter_nucl_native

            return filter_nucl_native(raw)
        except Exception:
            pass
    arr = np.frombuffer(raw, dtype=np.uint8)
    mapped = _FILTER_TABLE[arr]
    return mapped[mapped != 0].tobytes()


def gc_content(nucl: bytes) -> float:
    """Fraction of G/C bytes (by the reference's bitmask test)."""
    arr = np.frombuffer(nucl, dtype=np.uint8)
    if arr.size == 0:
        return float("nan")
    gc = int(np.count_nonzero((arr & 0x43) == 0x43))
    return gc / arr.size


# ASCII byte per 2-bit-or-separator code (codes 0-4; see compact())
_CODE_BYTES = np.frombuffer(b"ACGT!", dtype=np.uint8)
# the four ASCII bytes of each packed byte (code k in bits 2k, 2k+1), as
# one uint32 each: a packed genome unpacks in one lookup a byte
_QUAD_BYTES = np.stack(
    [_CODE_BYTES[(np.arange(256) >> (2 * k)) & 3] for k in range(4)], axis=1
).view(np.uint32).reshape(256)


class Sequence:
    """A named nucleotide string (one joined genome or one contig).

    Storage has two modes.  Normal: ``nucl`` holds the ASCII bytes.
    Compacted (``compact()``, engaged by the CLI's low-memory mode on
    panels whose raw sequences alone would blow the host's RAM): the
    filtered alphabet {A,C,G,T,'!'} packs to 2 bits/base plus a sparse
    separator-position list — 4x smaller — and ``nucl`` becomes a
    property that reconstructs the exact bytes on demand.  Hot paths
    use :meth:`codes_slice` (pileup state codes straight from the
    packed form, no byte round trip).  The reference has no analogue —
    it holds every genome as raw bytes for the process lifetime
    (`src/phylonium.cxx:272-287`); at 1000 x 5 Mbp that is 5 GB before
    any work starts.
    """

    __slots__ = ("name", "_nucl", "_packed", "_seps", "_length")

    def __init__(self, name: str = "", nucl: bytes = b""):
        if len(nucl) > LENGTH_LIMIT:
            raise ValueError(
                f"The input sequence {name} is too long. "
                f"The technical limit is {LENGTH_LIMIT}."
            )
        self.name = name
        self._nucl = nucl
        self._packed = None
        self._seps = None
        self._length = len(nucl)

    @property
    def nucl(self) -> bytes:
        if self._nucl is not None:
            return self._nucl
        return self.as_array().tobytes()

    @nucl.setter
    def nucl(self, value: bytes) -> None:
        self._nucl = value
        self._packed = None
        self._seps = None
        self._length = len(value)

    def compact(self) -> None:
        """2-bit-pack the nucleotides in place (idempotent).

        Only valid on filtered/joined sequences (alphabet ACGT + '!');
        anything else keeps byte storage so behavior never changes
        silently."""
        if self._packed is not None or not self._nucl:
            return
        arr = self.as_array()
        ok = (
            (arr == 65) | (arr == 67) | (arr == 71) | (arr == 84)
            | (arr == SEPARATOR)
        )
        if not ok.all():
            return  # unfiltered content: stay on byte storage
        try:
            # the native 2-bit pass
            from phylonium_tpu_torch.native import pack2_native

            packed, seps, _ = pack2_native([arr])
        except Exception:
            codes = np.zeros(len(arr), np.uint8)
            codes[arr == 67] = 1
            codes[arr == 71] = 2
            codes[arr == 84] = 3
            seps = np.flatnonzero(arr == SEPARATOR).astype(np.int64)
            pad = (-len(codes)) % 4
            if pad:
                codes = np.pad(codes, (0, pad))
            q = codes.reshape(-1, 4)
            packed = (
                q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)
            ).astype(np.uint8)
        self._packed = packed
        self._seps = np.asarray(seps, dtype=np.int64)
        self._nucl = None

    @property
    def compacted(self) -> bool:
        return self._packed is not None

    @property
    def nbytes(self) -> int:
        """Bytes the storage holds: the 2-bit pack and the separator
        positions when compacted, else the ASCII bytes."""
        if self._packed is not None:
            return self._packed.nbytes + self._seps.nbytes
        return len(self._nucl)

    def _codes(self, start: int = 0, stop: int | None = None) -> np.ndarray:
        """uint8 codes 0-4 (A C G T '!') for [start, stop) from the
        packed form."""
        if stop is None:
            stop = self._length
        b0, b1 = start >> 2, (stop + 3) >> 2
        chunk = self._packed[b0:b1]
        quads = np.empty((len(chunk), 4), np.uint8)
        quads[:, 0] = chunk & 3
        quads[:, 1] = (chunk >> 2) & 3
        quads[:, 2] = (chunk >> 4) & 3
        quads[:, 3] = chunk >> 6
        codes = quads.reshape(-1)[start - 4 * b0 : stop - 4 * b0]
        if len(self._seps):
            i0, i1 = np.searchsorted(self._seps, [start, stop])
            if i1 > i0:
                codes[self._seps[i0:i1] - start] = 4
        return codes

    def codes_slice(self, start: int, stop: int) -> np.ndarray:
        """Pileup state codes (A=0 C=1 G=2 T=3 '!'=4) for the query
        range [start, stop) — the low-memory chunked pileup builder's
        unit of work; works on both storage modes."""
        if self._packed is not None:
            return self._codes(start, stop)
        from phylonium_tpu_torch.core.pileup import byte_to_code

        return byte_to_code(self.as_array()[start:stop])

    def __len__(self) -> int:
        return self._length

    def __eq__(self, other) -> bool:
        if not isinstance(other, Sequence):
            return NotImplemented
        return self.name == other.name and self.nucl == other.nucl

    def __repr__(self) -> str:
        return f"Sequence(name={self.name!r}, len={self._length})"

    @property
    def size(self) -> int:
        return self._length

    def as_array(self) -> np.ndarray:
        """uint8 view of the nucleotides (zero-copy on byte storage,
        reconstructed on compacted storage)."""
        if self._nucl is None:
            arr = _QUAD_BYTES[self._packed].view(np.uint8)[: self._length]
            arr[self._seps] = SEPARATOR
            return arr
        return np.frombuffer(self._nucl, dtype=np.uint8)

    def gc_content(self) -> float:
        return gc_content(self.nucl)


@dataclass
class Genome:
    """All contigs read from one FASTA file (src/sequence.h:96-160)."""

    name: str = ""
    contigs: list[Sequence] = field(default_factory=list)

    @property
    def joined_length(self) -> int:
        if not self.contigs:
            return 0
        return sum(len(c) for c in self.contigs) + len(self.contigs) - 1


def join(gen: Genome) -> Sequence:
    """Linearize a genome into one sequence with '!' separators."""
    contigs = gen.contigs
    if len(contigs) == 0:
        return Sequence()
    if len(contigs) == 1:
        # use genome name, not sequence name (src/sequence.cxx:179-182)
        return Sequence(gen.name, contigs[0].nucl)
    return Sequence(gen.name, b"!".join(c.nucl for c in contigs))
