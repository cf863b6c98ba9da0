"""The low-memory route as a large panel reaches it, on the CPU at a small size.

A panel of the benchmark's ``mtb512`` shape (``portbench/configs/mtb512.json``:
closely related genomes, 0.005 % to 0.015 % from one ancestor, one draft in
5 contigs), made by ``portbench/panel.py`` at 12 genomes of 60 kb. The
budget ``PHYLONIUM_TPU_LOWMEM_BYTES`` is set below the panel's size, so the
default rule (``cli._predicts_lowmem`` from the file sizes, then
``pipeline.should_lowmem`` on the exact ones) picks the route, as it does
past 2 GiB; ``PHYLONIUM_TPU_LOWMEM`` is never set. The CLI runs in this
process on ``--device cpu``, through a CPU device server
(``PHYLONIUM_TPU_DEVD=1``, the early shipper on:
``PHYLONIUM_TPU_STREAM=force``) and with the feeder in process
(``PHYLONIUM_TPU_DEVD=0``). Checked:

- each PHYLIP matrix equals the benchmark's plain reference
  (``portbench/reference.py``) cell for cell, and the reference's float32
  control does not;
- the run report: the route's carrier and its three groups, built in the
  server or in process;
- the ``lowmem`` span (the groups, and the memory the route held) and,
  for each group, ``lowmem.group`` with ``lowmem.unpack``, ``lowmem.map``
  and ``lowmem.feed`` inside it, all inside the ``map+feed`` phase;
- the benchmark's three readers of these spans (``portbench/metrics/``)
  give their values on the report, and nothing on one without the spans.
"""

import contextlib
import importlib.util
import io
import json
import os
import signal
import subprocess
import sys
import time

import pytest

from phylonium_tpu_torch.serve import client as devd_client

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTBENCH = os.path.join(REPO, "portbench")
if PORTBENCH not in sys.path:
    # reference.py's worker processes import it by its own name
    sys.path.append(PORTBENCH)

import panel  # noqa: E402
import reference  # noqa: E402

with open(os.path.join(PORTBENCH, "configs", "mtb512.json")) as _f:
    SHAPE = {**json.load(_f)["panel"], "genomes": 12, "length": 60_000}
# below the panel's 12 x 60 kb, so that the default rule takes the route:
# group_rows_for gives 4 rows a group, 3 groups
BUDGET = 400_000
SPANS = ("lowmem.group", "lowmem.unpack", "lowmem.map", "lowmem.feed")
SLACK_S = 1e-6  # a span's ends are rounded to seconds as float64


@pytest.fixture(scope="module")
def daemon_sock(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lowmem_devd")
    sock = str(tmp / "d.sock")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["PHYLONIUM_TPU_DEVD_SOCK"] = sock
    env["PHYLONIUM_TPU_DEVD_IDLE_S"] = "600"
    log = tmp / "d.log"
    with open(log, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "phylonium_tpu_torch.serve", "--device", "cpu"],
            stdout=out, stderr=out, env=env,
        )
    try:
        deadline = time.time() + 60
        while time.time() < deadline and not os.path.exists(sock + ".pid"):
            assert proc.poll() is None, log.read_text()[-2000:]
            time.sleep(0.05)
        assert os.path.exists(sock)
        yield sock
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=20)
        assert proc.returncode == 0, log.read_text()[-2000:]


@pytest.fixture(scope="module")
def mtb_panel(tmp_path_factory):
    """The panel's files and the plain reference's answer for them."""
    directory = tmp_path_factory.mktemp("mtb_panel")
    files = panel.write_panel(SHAPE, 3_000_000_041, str(directory))
    assert sum(panel.joined_lengths(SHAPE)) > BUDGET
    return files, reference.matrix(files, workers=2)


def _reset_client():
    if devd_client._client is not None:
        devd_client._client.close()
    devd_client._client = None


def _run(files, tmp_path, sock, devd):
    """The CLI in this process: (rc, stdout, stderr, run report)."""
    from phylonium_tpu_torch.cli import main

    report = tmp_path / "report.json"
    with pytest.MonkeyPatch.context() as mp:
        for name in ("PHYLONIUM_TPU_LOWMEM", "PHYLONIUM_TPU_DEBUG",
                     "PHYLONIUM_TPU_STREAM_GROUP"):
            mp.delenv(name, raising=False)
        mp.setenv("PHYLONIUM_TPU_LOWMEM_BYTES", str(BUDGET))
        mp.setenv("PHYLONIUM_TPU_RUN_REPORT", str(report))
        mp.setenv("PHYLONIUM_TPU_DEVD", "1" if devd else "0")
        mp.setenv("PHYLONIUM_TPU_STREAM", "force")
        mp.setenv("PHYLONIUM_TPU_DEVD_SOCK", sock)
        _reset_client()
        out, err = io.StringIO(), io.StringIO()
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = main(["--progress=never", "--device", "cpu", *files])
        finally:
            _reset_client()
    return rc, out.getvalue(), err.getvalue(), json.loads(report.read_text())


@pytest.fixture(scope="module", params=["server", "in process"])
def lowmem_run(request, mtb_panel, daemon_sock, tmp_path_factory):
    files, answer = mtb_panel
    rc, out, err, report = _run(files, tmp_path_factory.mktemp("lowmem_run"), daemon_sock,
                                request.param == "server")
    assert rc == 0, err
    return request.param, out, report, answer


def test_the_matrix_is_the_reference(lowmem_run):
    _, out, _, answer = lowmem_run
    got = reference.parse_phylip(out)
    assert got is not None and got[0] == answer.names
    assert reference.cells_differ(got[1], answer.cells) == 0
    assert out == answer.text


def test_the_float32_control_is_not_correct(mtb_panel):
    """The reference's distances in float32, the precision below the
    configuration's float64, differ in printed cells at this divergence:
    the exact comparison tells them apart."""
    _, answer = mtb_panel
    assert reference.cells_differ(answer.control_cells, answer.cells) > 0


def test_the_default_rule_took_the_route(lowmem_run):
    route, _, report, _ = lowmem_run
    lowmem = report["lowmem"]
    assert lowmem["group_rows"] == 4 and lowmem["homologies"] >= 12
    assert report["stream_groups"] == 3 and report["compare_carrier"] == "torch-cpu"
    (loop,) = _named(report, "lowmem")
    assert loop["attrs"]["groups"] == 3
    assert "map+feed" in report["timings"]
    assert ("devd" in report) == (route == "server")
    if route == "server":
        # the shipper sent the compacted genomes in the route's groups
        assert report["early_ship"]["taken"] == 3


def _named(report, name):
    return [s for s in report["spans"] if s["name"] == name and s["process"] == "cli"]


def _inside(inner, outer):
    return (outer["start"] - SLACK_S <= inner["start"]
            and inner["end"] <= outer["end"] + SLACK_S)


def test_the_route_records_its_spans(lowmem_run):
    _, _, report, _ = lowmem_run
    (phase,), (loop,) = _named(report, "map+feed"), _named(report, "lowmem")
    assert loop["parent"] == phase["id"] and _inside(loop, phase)
    attrs = loop["attrs"]
    assert attrs["groups"] == 3 and attrs["group_rows"] == 4
    # 2 bits a base (and the separators' positions) held
    bases = sum(panel.joined_lengths(SHAPE))
    assert bases / 4 / 1e6 <= attrs["compact_mb"] < bases / 3 / 1e6
    groups = _named(report, "lowmem.group")
    assert [g["attrs"]["rows"] for g in groups] == [4, 4, 4]
    assert [g["attrs"]["lo"] for g in groups] == [0, 4, 8]
    lengths = panel.joined_lengths(SHAPE)
    assert [g["attrs"]["bases"] for g in groups] == [sum(lengths[k:k + 4])
                                                     for k in (0, 4, 8)]
    # unpacked and alive at once: at least the group being mapped, at most
    # every group (each rounded up to whole packed bytes)
    largest = max(g["attrs"]["bases"] for g in groups)
    assert largest / 1e6 <= attrs["unpacked_peak_mb"] <= (bases + 3 * 12) / 1e6
    by_id = {g["id"]: g for g in groups}
    for g in groups:
        assert g["parent"] == loop["id"] and _inside(g, phase)
    for name in SPANS[1:]:
        spans = _named(report, name)
        assert len(spans) == 3
        for s in spans:
            assert s["parent"] in by_id and _inside(s, by_id[s["parent"]])


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", os.path.join(PORTBENCH, "metrics", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@pytest.mark.parametrize("name", ["lowmem_unpack_s", "lowmem_feed_wait_s", "lowmem_held_mb"])
def test_the_benchmark_metrics_read_the_route(lowmem_run, name):
    _, _, report, _ = lowmem_run
    read = _metric(name)
    record = {"runs": [{"report": report}, {"report": report}]}
    if name == "lowmem_held_mb":
        (loop,) = _named(report, "lowmem")
        assert read(record) == loop["attrs"]["compact_mb"] + loop["attrs"]["unpacked_peak_mb"]
    else:
        span = {"lowmem_unpack_s": "lowmem.unpack", "lowmem_feed_wait_s": "lowmem.feed"}[name]
        want = sum(s["end"] - s["start"] for s in _named(report, span))
        assert read(record) == pytest.approx(want)
    # a run of a program without these spans (the streamed route's, or a
    # program older than them): nothing to read
    assert read({"runs": [{"report": {"timings": {}}}]}) is None
    without = [s for s in report["spans"] if not s["name"].startswith("lowmem")]
    assert read({"runs": [{"report": {**report, "spans": without}}]}) is None


@pytest.mark.parametrize("length", [1, 2, 3, 4, 5, 8, 10_037])
def test_a_compacted_genome_unpacks_to_its_bytes(length):
    """The route's unpack (``Sequence.as_array`` on the 2-bit pack, one
    lookup a packed byte) gives the genome's bytes back at every length
    modulo 4, separators at either end included, as a writable copy."""
    import numpy as np

    from phylonium_tpu_torch.data.sequence import Sequence

    rng = np.random.default_rng(length)
    arr = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, length)].copy()
    if length > 2:
        arr[[0, length // 2, length - 1]] = ord("!")
    seq = Sequence("g", arr.tobytes())
    seq.compact()
    assert seq.compacted and len(seq) == length
    got = seq.as_array()
    assert got.dtype == np.uint8 and got.flags.writeable and got.flags.c_contiguous
    np.testing.assert_array_equal(got, arr)
    assert seq.nucl == arr.tobytes()
    assert seq.nbytes == -(-length // 4) + 8 * (3 if length > 2 else 0)


def test_the_route_counts_the_unpacked_bytes_alive():
    """``unpacked_peak_mb`` counts each unpacked genome until its last
    holder drops it, wherever that holder is (the loop, the feeder's
    queue, its worker), and keeps the most at once."""
    from phylonium_tpu_torch.core.lowmem import _Unpacked
    from phylonium_tpu_torch.data.sequence import Sequence

    seqs = [Sequence(f"g{k}", b"ACGT" * (1000 * (k + 1))) for k in range(3)]
    for seq in seqs:
        seq.compact()
    unpacked = _Unpacked()
    held = [seq.as_array() for seq in seqs[:2]]
    for k in range(2):
        unpacked.add(held[k])
    assert unpacked.live == unpacked.peak == 4000 + 8000
    queue = [held.pop()]  # one kept by a holder, one dropped
    held.clear()
    assert unpacked.live == 8000
    third = seqs[2].as_array()
    unpacked.add(third)
    assert (unpacked.live, unpacked.peak) == (20_000, 20_000)
    del queue, third
    assert unpacked.live == 0 and unpacked.peak == 20_000
