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

Like pfasta, input is consumed in bounded chunks from the file
descriptor (pfasta.c:58,304-330 uses a 16 KiB buffer; here 1 MiB so the
native one-pass body scan — the analogue of pfasta's SSE2
``find_first_space`` — amortizes), so peak scratch memory is O(record),
not O(file) plus copies.  Records are yielded as they complete.

``read_genome`` applies ``filter_nucl`` per record and derives the genome
name from the file path like `src/io.cxx:36-59`: strip directories, strip
a ``.fa``/``.fas``/``.fasta`` extension (unknown extensions are kept).

A copy of the JAX package's ``phylonium_tpu/io/fasta.py``: the port carries
its own host layer and imports nothing of that package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import BinaryIO, Iterator

from phylonium_tpu_torch.data.sequence import Genome, Sequence, filter_nucl

CHUNK_SIZE = 1 << 20


class FastaError(ValueError):
    pass


@dataclass
class FastaRecord:
    name: str
    comment: str
    sequence: bytes


_WS = b" \t\n\r\x0b\x0c"

_native_scan = None  # resolved once; False when the backend is absent
_native_filter = None  # fused read-path hook; False when absent


def _scan_body(chunk: bytes) -> tuple[bytes, int]:
    """(whitespace-stripped bytes, newline count) for one body span.

    One native pass on large spans (stripping and newline counting as
    separate Python/numpy passes dominated the read phase); pure-python
    fallback keeps the module importable without the C++ backend."""
    global _native_scan
    if len(chunk) >= 4096 and _native_scan is not False:
        if _native_scan is None:
            try:
                from phylonium_tpu_torch.native import fasta_scan_native

                _native_scan = fasta_scan_native
            except Exception:
                _native_scan = False
        if _native_scan:
            return _native_scan(chunk)
    return (
        chunk.translate(None, delete=_WS),
        chunk.count(b"\n"),
    )


def _filter_body(chunk: bytes) -> tuple[bytes, int, int]:
    """(ACGT-filtered uppercased bytes, newlines, non-ws count): the
    fused read-path hook — one native traversal replaces the strip pass
    + the later per-record filter_nucl pass (and their copies).  The
    non-ws count keeps pfasta's empty-SEQUENCE check exact: an all-N
    body filters to zero bytes but is NOT an empty sequence."""
    from phylonium_tpu_torch.native import fasta_filter_native

    return fasta_filter_native(chunk)


class _Parser:
    """Incremental FASTA state machine fed arbitrary byte chunks.

    ``body_hook(span) -> (piece, newlines, nonws)`` transforms body
    spans; the default strips whitespace (records carry raw sequence
    bytes).  read_fasta passes the fused filter hook instead.
    """

    _START, _HEADER, _BODY = range(3)

    def __init__(self, origin: str, body_hook=None):
        self.origin = origin
        self.state = self._START
        self.line = 1  # 1-based line of the next unread byte
        self.record_line = 1  # line the open record's '>' sits on
        self.at_line_start = True
        self.header = bytearray()
        self.pieces: list[bytes] = []
        self.body_seen = 0  # non-whitespace bytes of the open record
        self.body_hook = body_hook or self._default_hook

    @staticmethod
    def _default_hook(span: bytes) -> tuple[bytes, int, int]:
        stripped, newlines = _scan_body(span)
        return stripped, newlines, len(stripped)

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
                piece, newlines, nonws = self.body_hook(body)
                if piece:
                    self.pieces.append(piece)
                self.body_seen += nonws
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
    """Read one FASTA file into filtered sequences (src/io.cxx:66-97).

    Filtering happens inside the parse via the fused native body pass
    (strip + filter + counts in one traversal); without the native
    backend, records parse raw and filter per record as before —
    byte-identical output either way (tests/test_fasta_stream.py)."""
    global _native_filter
    if _native_filter is None:
        try:
            from phylonium_tpu_torch.native import fasta_filter_native  # noqa: F401

            _native_filter = _filter_body
        except Exception:
            _native_filter = False
    hook = _native_filter or None
    with open(file_name, "rb") as f:
        parser = _Parser(file_name, body_hook=hook)
        records = []
        while True:
            chunk = f.read(CHUNK_SIZE)
            if not chunk:
                break
            records.extend(parser.feed(chunk))
        records.extend(parser.finish())
    if hook is not None:
        return [Sequence(prefix + rec.name, rec.sequence) for rec in records]
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


def read_genome(file_name: str) -> Genome:
    return Genome(extract_genome(file_name), read_fasta(file_name))
