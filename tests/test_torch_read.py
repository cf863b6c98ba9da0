"""The port's read layer: ``cli._read_all`` over ``io.fasta.GenomeReader``.

- the genomes, their names and the early shipper's content keys are the
  same at 1, 2 and 8 read workers, raw and 2-bit compacted, as the JAX
  package reads them, on a seeded panel of portbench's shape;
- the ``read`` span counts the files the one native pass landed
  (``native_files``) and the files that took the parser
  (``fallback_files``): all of a sound panel natively, in a run report;
  a malformed file by the parser, and the run fails with the parser's
  message;
- the one native pass (``GenomeReader.joined``) lands every record as the
  port's ``_Parser`` (``read_fasta``) and the JAX package's reader do,
  and a file pfasta rejects fails with their message and line.
"""

import json
import os
import sys

import pytest

import phylonium_tpu.data.sequence as j_seq
import phylonium_tpu.io.fasta as j_fasta
from phylonium_tpu_torch import cli
from phylonium_tpu_torch.config import PROG
from phylonium_tpu_torch.core.query_ship import QueryShipper, content_key
from phylonium_tpu_torch.data.sequence import Sequence
from phylonium_tpu_torch.io import fasta as t_fasta
from phylonium_tpu_torch.io.fasta import read_fasta
from phylonium_tpu_torch.serve import client as devd_client
from phylonium_tpu_torch.utils import profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from portbench.panel import Panel  # noqa: E402

# portbench's ct563 shape at 12 genomes of 300 kb (the draft in 5 contigs)
SHAPE = {"genomes": 12, "length": 300_000, "divergence_low": 0.002,
         "divergence_span": 0.018, "draft_contigs": 5, "draft_inversion": 50_000}
GROUP = 4


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """The panel's files and each genome as the JAX package reads it."""
    files = Panel(SHAPE, 2870114253, str(tmp_path_factory.mktemp("read_panel"))).files(0)
    return files, [j_seq.join(j_fasta.read_genome(f)) for f in files]


class _KeyRecorder:
    """A device server client that holds every piece and records its key."""

    def __init__(self):
        self.keys = []

    def request(self, header, arrays=(), timeout=900.0):
        self.keys.append(header["key"])
        return {"ok": True, "have": True}, []


@pytest.mark.parametrize("compact", [False, True], ids=["raw", "compacted"])
@pytest.mark.parametrize("workers", [1, 2, 8])
def test_read_all_is_the_same_at_any_worker_count(panel, monkeypatch, workers, compact):
    files, want = panel
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "1")
    client = _KeyRecorder()
    monkeypatch.setattr(devd_client, "get_client", lambda device: client)
    shipper = QueryShipper(len(files), "cpu", group_rows=GROUP, transport="devd")
    read = profile.Span("read", None, None, None)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # threads switch often: a lost count would show
    try:
        got = cli._read_all(files, workers, compact, shipper, read)
        assert shipper.drain(30.0)
    finally:
        sys.setswitchinterval(interval)
        shipper.stop()
    assert [q.name for q in got] == [w.name for w in want]
    assert [q.nucl for q in got] == [w.nucl for w in want]
    assert all(q.compacted == compact for q in got)
    groups = [slice(lo, lo + GROUP) for lo in range(0, len(files), GROUP)]
    if compact:
        packed = [Sequence(w.name, w.nucl) for w in want]
        for s in packed:
            s.compact()
        keys = [content_key(packed[g]) for g in groups]
    else:
        keys = [content_key([w.as_array() for w in want[g]]) for g in groups]
    assert client.keys == keys
    assert read.attrs == {"files": len(files), "bases": sum(len(w) for w in want),
                          "blocked_s": read.attrs["blocked_s"],
                          "native_files": len(files), "fallback_files": 0}


def test_a_traced_run_counts_the_native_files(panel, tmp_path, monkeypatch, capsys):
    files, _ = panel
    report = tmp_path / "report.json"
    monkeypatch.setenv("PHYLONIUM_TPU_RUN_REPORT", str(report))
    assert cli.main(["--device", "cpu", "--count-backend", "host", *files]) == 0
    (read,) = [s for s in json.loads(report.read_text())["spans"] if s["name"] == "read"]
    assert read["attrs"]["files"] == len(files)
    assert read["attrs"]["native_files"] == len(files)
    assert read["attrs"]["fallback_files"] == 0


def test_a_malformed_file_takes_the_parser_and_fails_the_run(panel, tmp_path, capsys):
    files, _ = panel
    bad = tmp_path / "bad.fasta"
    bad.write_bytes(b">ok\nACGT\n>hollow\n\n  \n")
    with pytest.raises(ValueError) as err:
        read_fasta(str(bad))
    message = str(err.value)
    assert message == f"{bad}: Empty sequence on line 3."
    panel_files = [*files[:5], str(bad)]
    read = profile.Span("read", None, None, None)
    with pytest.raises(ValueError) as err:
        cli._read_all(panel_files, 2, False, None, read)
    assert str(err.value) == message
    assert (read.attrs["native_files"], read.attrs["fallback_files"]) == (5, 1)
    capsys.readouterr()
    assert cli.main(["--device", "cpu", "--count-backend", "host", *panel_files]) == 1
    assert capsys.readouterr().err == f"{PROG}: {message}\n"


@pytest.mark.parametrize("cores,files,threads,want", [
    (8, 563, 0, 4),   # half the cores
    (8, 3, 0, 3),     # one worker a file
    (1, 563, 0, 1),
    (64, 563, 0, 8),  # at most 8
    (8, 563, 6, 6),   # -t as given
])
def test_read_workers_follow_the_cores_and_the_files(monkeypatch, cores, files, threads, want):
    from phylonium_tpu_torch.config import TorchRunConfig

    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cores)))
    cfg = TorchRunConfig()
    cfg.threads = threads
    assert cli._read_workers(cfg, files) == want


def test_a_pipe_lands_as_its_file(panel, tmp_path):
    """A FASTA stream whose size fstat does not know (a pipe, as from a
    shell's process substitution) grows the reader's buffer as it comes."""
    import threading

    from phylonium_tpu_torch.io.fasta import GenomeReader

    files, want = panel
    draft = files[-1]  # the draft: 5 records
    fifo = tmp_path / "draft.fasta"
    os.mkfifo(fifo)
    data = open(draft, "rb").read()

    def write():
        with open(fifo, "wb") as f:
            f.write(data)

    writer = threading.Thread(target=write)
    writer.start()
    reader = GenomeReader()
    got = reader.joined(str(fifo))
    writer.join(timeout=30)
    assert not writer.is_alive()
    assert got.nucl == want[-1].nucl and got.name == "draft"
    assert (reader.native_files, reader.fallback_files) == (1, 0)


def _iupac_body(seed: int, size: int, width: int = 61, end: bytes = b"\n") -> bytes:
    """``size`` bytes of mixed-case ACGT, N and IUPAC codes in lines of
    ``width``, each ended by ``end``."""
    import numpy as np

    alphabet = np.frombuffer(b"ACGTacgtNnRYKMSWBDHVryk", np.uint8)
    body = alphabet[np.random.default_rng(seed).integers(0, len(alphabet), size)].tobytes()
    return b"".join(body[i:i + width] + end for i in range(0, len(body), width))


# (file bytes, the parser's error or None): each the native one-pass read
# of the port must land as the port's _Parser and the JAX package read it
READ_CASES = {
    "crlf": (b">r1 a comment\r\nACGT\r\nttaa\r\n>r2\r\nGGCC\r\n", None),
    "mixed_line_ends": (b">r1\r\nAC\nGT\r\n\n>r2 x\ty\nAAAA\r\nCC\n", None),
    "lowercase_n_iupac": (b">m\n" + _iupac_body(3, 5000) + b">m2\n"
                          + _iupac_body(4, 777, width=50, end=b"\r\n"), None),
    "gt_mid_line": (b">r1\nGG>GG\nCC>\n>r2\nA>C\n", None),
    "no_final_newline": (b">r1\nACGT\n>r2\nGGTTA", None),
    "multi_contig": (b">c1 first\nACGTNNacgt\n>c2\n\nGGCC-TTAA\r\n>c3\nNNNN\n>c4\nT\n",
                     None),
    "record_over_1mib": (b">big one\n" + _iupac_body(5, (1 << 20) + 4099, width=80)
                         + b">small\nACGT\n", None),
    "all_n_bodies": (b">a\nNNNN\nnnnn\n>b\nRYKM\n>c\nACGT\n", None),
    "header_at_eof": (b">r1\nACGT\n>r2", "Empty sequence on line 3."),
    "empty_file": (b"", "File is empty."),
    "empty_name": (b">ok\nAC\n>  \t\nGG\n", "Empty name on line 3."),
    "empty_sequence": (b">ok\nAC\n>x\n \n\t\r\n>y\nGG\n", "Empty sequence on line 3."),
    "no_leading_gt": (b"ACGT\n>r1\nACGT\n", "File must start with '>'."),
}


@pytest.mark.parametrize("case", sorted(READ_CASES))
def test_native_read_agrees_with_the_parser(tmp_path, case):
    """The port's one-pass read (GenomeReader.joined: phy_fasta_layout and
    phy_fasta_land) against the port's _Parser (read_fasta) and the JAX
    package's reader: every record's bytes, the joined genome, and every
    error's message and line; a sound file is landed natively, a
    malformed one by the parser."""
    data, error = READ_CASES[case]
    path = tmp_path / f"{case}.fasta"
    path.write_bytes(data)
    name = str(path)
    reader = t_fasta.GenomeReader()
    if error is not None:
        messages = []
        for read in (reader.joined, read_fasta, t_fasta.read_genome, j_fasta.read_genome):
            with pytest.raises(ValueError) as err:
                read(name)
            messages.append(str(err.value))
        assert messages == [f"{name}: {error}"] * 4
        assert (reader.native_files, reader.fallback_files) == (0, 1)
        return
    joined = reader.joined(name)
    assert (reader.native_files, reader.fallback_files) == (1, 0)
    assert type(joined.nucl) is bytes
    parsed = read_fasta(name)
    theirs = j_fasta.read_genome(name)
    assert [(s.name, s.nucl) for s in parsed] == [(c.name, c.nucl) for c in theirs.contigs]
    assert joined.nucl.split(b"!") == [s.nucl for s in parsed]
    assert joined.name == theirs.name == path.stem
    assert joined.nucl == j_seq.join(theirs).nucl
