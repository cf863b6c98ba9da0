"""FASTA input.

Streaming parser with the same acceptance/rejection behavior as the
reference's pfasta v15 (`libs/pfasta.c`):

- the file must be non-empty and start with '>' (pfasta.c:311-318);
- a record name is the first whitespace-delimited word after '>' and must
  be non-empty (pfasta.c:349-376); the rest of the header line is the
  comment;
- sequence lines are concatenated with all whitespace stripped; a record
  must have a non-empty sequence (pfasta.c:434-470);
- errors carry 1-based line numbers.

Like pfasta, ``stream_fasta`` and ``read_fasta`` consume input in bounded
chunks from the file descriptor (pfasta.c:58,304-330 uses a 16 KiB
buffer; here 1 MiB), so peak scratch memory is O(record), not O(file)
plus copies.  Records are yielded as they complete.

``GenomeReader`` (the CLI's read, ``api``) reads a whole file into a
buffer its thread reuses and lands the genome in one native pass: each
record filtered like ``filter_nucl``, the records joined by '!' as
``data.sequence.join`` joins them, straight into the one ``bytes`` object
the genome keeps.  A file pfasta rejects goes to ``read_fasta``'s parser,
which words the error.  ``read_genome`` reads through the parser.  The
genome's name comes from the file path like `src/io.cxx:36-59`: strip
directories, strip a ``.fa``/``.fas``/``.fasta`` extension (unknown
extensions are kept).

A copy of the JAX package's ``phylonium_tpu/io/fasta.py`` (its
``GenomeReader`` the port's own): the port carries its own host layer and
imports nothing of that package.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import BinaryIO, Iterator

import numpy as np

from phylonium_tpu_torch.data.sequence import Genome, Sequence, filter_nucl, join

CHUNK_SIZE = 1 << 20


class FastaError(ValueError):
    pass


@dataclass
class FastaRecord:
    name: str
    comment: str
    sequence: bytes


_WS = b" \t\n\r\x0b\x0c"

_native_land = None  # the native module for GenomeReader; False when absent


def _scan_body(chunk: bytes) -> tuple[bytes, int]:
    """(whitespace-stripped bytes, newline count) for one body span."""
    return (
        chunk.translate(None, delete=_WS),
        chunk.count(b"\n"),
    )


class _Parser:
    """Incremental FASTA state machine fed arbitrary byte chunks; records
    carry their sequence bytes with whitespace stripped."""

    _START, _HEADER, _BODY = range(3)

    def __init__(self, origin: str):
        self.origin = origin
        self.state = self._START
        self.line = 1  # 1-based line of the next unread byte
        self.record_line = 1  # line the open record's '>' sits on
        self.at_line_start = True
        self.header = bytearray()
        self.pieces: list[bytes] = []
        self.body_seen = 0  # non-whitespace bytes of the open record

    def _open_record(self) -> None:
        self.state = self._HEADER
        self.record_line = self.line
        self.header = bytearray()
        self.pieces = []
        self.body_seen = 0

    def _close_record(self) -> FastaRecord:
        parts = bytes(self.header).split(None, 1)
        if not parts or not parts[0]:
            raise FastaError(
                f"{self.origin}: Empty name on line {self.record_line}."
            )
        seq = self.pieces[0] if len(self.pieces) == 1 else b"".join(
            self.pieces
        )
        if not self.body_seen:
            raise FastaError(
                f"{self.origin}: Empty sequence on line {self.record_line}."
            )
        name = parts[0].decode("ascii", errors="replace")
        comment = (
            parts[1].decode("ascii", errors="replace")
            if len(parts) > 1
            else ""
        )
        return FastaRecord(name, comment, seq)

    def feed(self, chunk: bytes) -> Iterator[FastaRecord]:
        pos = 0
        end = len(chunk)
        while pos < end:
            if self.state is self._START:
                if chunk[pos : pos + 1] != b">":
                    raise FastaError(
                        f"{self.origin}: File must start with '>'."
                    )
                self._open_record()
                self.at_line_start = False
                pos += 1
            elif self.state is self._HEADER:
                nl = chunk.find(b"\n", pos)
                if nl < 0:
                    self.header += chunk[pos:]
                    pos = end
                else:
                    self.header += chunk[pos:nl]
                    self.line += 1
                    self.at_line_start = True
                    self.state = self._BODY
                    pos = nl + 1
            else:  # _BODY
                # a '>' at a line start opens the next record; anything
                # else (including a mid-line '>') is sequence bytes
                if self.at_line_start and chunk[pos : pos + 1] == b">":
                    yield self._close_record()
                    self._open_record()
                    self.at_line_start = False
                    pos += 1
                    continue
                stop = chunk.find(b"\n>", pos)
                stop = end if stop < 0 else stop + 1
                body = chunk[pos:stop]
                piece, newlines = _scan_body(body)
                if piece:
                    self.pieces.append(piece)
                self.body_seen += len(piece)
                self.line += newlines
                self.at_line_start = body.endswith(b"\n") or (
                    self.at_line_start and not body
                )
                pos = stop

    def finish(self) -> Iterator[FastaRecord]:
        if self.state is self._START:
            raise FastaError(f"{self.origin}: File is empty.")
        if self.state is self._HEADER:
            # header at EOF without newline: still a complete header of
            # an (empty-bodied) record
            self.state = self._BODY
        yield self._close_record()


def stream_fasta(
    f: BinaryIO, origin: str = "<stream>", chunk_size: int = CHUNK_SIZE
) -> Iterator[FastaRecord]:
    """Yield records from a binary stream with O(record) memory."""
    parser = _Parser(origin)
    while True:
        chunk = f.read(chunk_size)
        if not chunk:
            break
        yield from parser.feed(chunk)
    yield from parser.finish()


def parse_fasta_bytes(
    data: bytes, origin: str = "<bytes>"
) -> list[FastaRecord]:
    if len(data) == 0:
        raise FastaError(f"{origin}: File is empty.")
    parser = _Parser(origin)
    records = list(parser.feed(data))
    records.extend(parser.finish())
    return records


def read_fasta(file_name: str, prefix: str = "") -> list[Sequence]:
    """Read one FASTA file into filtered sequences (src/io.cxx:66-97),
    through ``_Parser``: the path that words a rejected file's error."""
    with open(file_name, "rb") as f:
        records = list(stream_fasta(f, file_name))
    return [
        Sequence(prefix + rec.name, filter_nucl(rec.sequence))
        for rec in records
    ]


def extract_genome(file_name: str) -> str:
    """path/name.fasta -> name (src/io.cxx:36-59)."""
    base = file_name.rsplit("/", 1)[-1]
    root, ext = os.path.splitext(base)
    if ext in (".fa", ".fas", ".fasta"):
        return root
    return base


def _native():
    """The native module where its library loads, else None."""
    global _native_land
    if _native_land is None:
        from phylonium_tpu_torch import native

        try:
            native.get_lib()
            _native_land = native
        except (OSError, native.NativeBuildError):
            _native_land = False
    return _native_land or None


class GenomeReader:
    """Reads genomes, each FASTA file in one native pass.

    A file is read whole (``readinto``) into a buffer that the calling
    thread keeps and reuses, grown to the largest file it has read; then
    ``phy_fasta_layout`` finds its records by pfasta's rules (each body's
    span and its count of kept bases) and ``phy_fasta_land`` writes the
    genome: each body filtered and uppercased as ``filter_nucl`` does, the
    records joined by '!', straight into one ``bytes`` object of the joined
    size, which ``Sequence.nucl`` then holds. Both calls run outside the GIL, and that object is the one
    allocation a genome takes. A file pfasta rejects goes to ``read_fasta``
    (``_Parser``), which raises the ``FastaError`` it always has, with its
    line; so does every file where the native library is absent.
    ``native_files`` and ``fallback_files`` count the files each way took.
    One reader serves any number of threads.
    """

    def __init__(self):
        self._local = threading.local()
        self._lock = threading.Lock()
        self.native_files = 0
        self.fallback_files = 0

    def joined(self, file_name: str) -> Sequence:
        """``join(read_genome(file_name))``: the genome's records joined
        by '!' under its name."""
        nucl = self._land(file_name)
        if nucl is None:
            with self._lock:
                self.fallback_files += 1
            return join(read_genome(file_name))
        return Sequence(extract_genome(file_name), nucl)

    def _land(self, file_name: str) -> bytes | None:
        """The joined bytes of one file, or None where it takes the
        parser."""
        native = _native()
        if native is None:
            return None
        local = self._local
        if not hasattr(local, "raw"):
            local.raw = np.empty(0, np.uint8)
            local.spans = np.empty((64, 3), np.int64)
        with open(file_name, "rb", buffering=0) as f:
            n = self._read_whole(f)
        raw = local.raw
        records = native.fasta_layout(raw, n, local.spans)
        if records > len(local.spans):
            local.spans = np.empty((records, 3), np.int64)
            records = native.fasta_layout(raw, n, local.spans)
        if records < 0:
            return None
        nucl = native.fasta_land(raw, local.spans, records)
        with self._lock:
            self.native_files += 1
        return nucl

    def _read_whole(self, f) -> int:
        """Read the open file to its end into this thread's buffer; its
        length."""
        local = self._local
        # one byte of room: a read that fills the buffer has not seen the end
        need = os.fstat(f.fileno()).st_size + 1
        if len(local.raw) < need:
            local.raw = np.empty(1 << (need - 1).bit_length(), np.uint8)
        n = 0
        while got := f.readinto(local.raw[n:]):
            n += got
            if n == len(local.raw):  # the file grew since its fstat
                local.raw = np.concatenate((local.raw, np.empty_like(local.raw)))
        return n


def read_genome(file_name: str) -> Genome:
    return Genome(extract_genome(file_name), read_fasta(file_name))
