"""The port's spans (utils/profile.py) on the CPU: the CLI's and the
device server's, in the run report.

One CPU daemon for the module (``python -m phylonium_tpu_torch.serve
--device cpu``), the CLI in process on ``--device cpu`` with
``PHYLONIUM_TPU_DEVD=1`` and ``PHYLONIUM_TPU_STREAM=force``, as
``tests/test_torch_devd.py`` drives it. Checked:

- the report's spans form one tree under ``run``; each span lies inside
  its parent (a server span inside the client's request span on the
  shared clock, within 1 ms), and a queued one (the feeder's groups, the
  server's builds) starts after its parent and ends inside the run;
- the ``index`` span carries the native build's ``threads``, ``sais_s``,
  ``buckets_s`` and ``levels``;
- each ``timings`` entry is its span's duration, ``devd_count_s`` the
  server's ``devd.count`` and ``devd.finish_wait_s`` the client's
  ``devd.finish``; the phases and ``process.rest`` tile ``process``;
- the root's self time is under 5 % of ``cli.main``;
- the server's spans carry the client's ids and lie between the client's
  first request and the end of its ``devd.finish``; ``devd.rss`` is there;
- ``-2``: the second pass's spans carry ``attrs["pass"] = 2``;
- with no report, ``--profile``, ``-v -v`` or debug, nothing is recorded,
  no request carries a span id, and ``span()`` is one shared no-op that
  allocates nothing;
- the ``PHYLONIUM_TPU_DEBUG`` lines keep their text and print the spans'
  durations;
- each of the benchmark's span metrics (``portbench/metrics/``) reads
  what the spans say.
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import signal
import subprocess
import sys
import time
import tracemalloc

import pytest

from phylonium_tpu_torch.serve import client as devd_client
from phylonium_tpu_torch.utils import profile
from pileup_cases import write_fasta_panel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = os.path.join(REPO, "portbench", "metrics")
# the clock both processes read is one; a span's ends are rounded to
# seconds as float64, a quarter of a microsecond apart
CLOCK_SLACK_S = 1e-3
ROUNDING_S = 1e-6


@pytest.fixture(scope="module")
def daemon_sock(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spans_devd")
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
        assert "devd: finish" not in log.read_text()


def _reset_client():
    if devd_client._client is not None:
        devd_client._client.close()
    devd_client._client = None


def _run(args, sock, **env):
    """The CLI in process through the module's daemon: (rc, stdout, stderr)."""
    from phylonium_tpu_torch.cli import main

    with pytest.MonkeyPatch.context() as mp:
        for name in ("PHYLONIUM_TPU_RUN_REPORT", "PHYLONIUM_TPU_DEBUG"):
            mp.delenv(name, raising=False)
        mp.setenv("PHYLONIUM_TPU_DEVD_SOCK", sock)
        mp.setenv("PHYLONIUM_TPU_DEVD", "1")
        mp.setenv("PHYLONIUM_TPU_STREAM", "force")
        mp.setenv("PHYLONIUM_TPU_STREAM_GROUP", "3")
        for name, value in env.items():
            mp.setenv(name, value)
        _reset_client()
        out, err = io.StringIO(), io.StringIO()
        try:
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = main(["--progress=never", "--device", "cpu", *args])
        finally:
            _reset_client()
    return rc, out.getvalue(), err.getvalue()


def _reported(tmp_path, sock, args, **env):
    report = tmp_path / "report.json"
    rc, out, err = _run(args, sock, PHYLONIUM_TPU_RUN_REPORT=str(report), **env)
    assert rc == 0, err
    return json.loads(report.read_text()), out, err


@pytest.fixture(scope="module")
def traced(daemon_sock, tmp_path_factory):
    """A run report of a fresh 8-genome panel in groups of 3: every piece
    misses the server's cache and ships."""
    tmp = tmp_path_factory.mktemp("spans_run")
    files = write_fasta_panel(tmp, 8, 3000, seed=301)
    main_s = []
    from phylonium_tpu_torch import cli

    timed_main = cli.main

    def clocked(argv):
        t = time.time()
        try:
            return timed_main(argv)
        finally:
            main_s.append(time.time() - t)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "main", clocked)
        report, _, _ = _reported(tmp, daemon_sock, files)
    report["main_s"] = main_s[0]
    return report


def _by_id(report):
    return {s["id"]: s for s in report["spans"]}


def _named(report, name, process="cli"):
    return [s for s in report["spans"] if s["name"] == name and s["process"] == process]


def _seconds(s):
    return s["end"] - s["start"]


def _union(intervals):
    total, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def test_spans_form_one_tree(traced):
    spans = traced["spans"]
    ids = _by_id(traced)
    assert len(ids) == len(spans)
    fields = {"name", "start", "end", "id", "parent", "process", "thread", "attrs"}
    assert all(set(s) == fields for s in spans)
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "run" and root["process"] == "cli"
    for s in spans:
        assert s["start"] <= s["end"], s
        if s is root:
            continue
        parent = ids[s["parent"]]  # every parent is in the report
        slack = CLOCK_SLACK_S if s["process"] != parent["process"] else 0.0
        assert s["start"] >= parent["start"] - slack, (s, parent)
        if s["attrs"].get("queued"):
            assert s["end"] <= root["end"], s
        else:
            assert s["end"] <= parent["end"] + slack, (s, parent)
    names = {s["name"] for s in spans}
    assert {"run", "options", "read", "pick", "process", "index", "map+pileup+feed",
            "compare", "compare.join", "print", "ship.piece", "devd.connect",
            "feed.group", "feed.take", "feed.prep", "feed.request", "devd.qhave",
            "devd.qgroup", "devd.group", "devd.build", "devd.finish",
            "devd.finish.join", "devd.count", "devd.rss", "process.rest"} <= names
    assert len(_named(traced, "feed.group")) == 3 == len(_named(traced, "ship.piece"))
    assert all(s["parent"] == root["id"] for s in _named(traced, "ship.piece"))
    (feeding,) = _named(traced, "map+pileup+feed")
    assert all(s["parent"] == feeding["id"] for s in _named(traced, "feed.group"))
    (read,) = _named(traced, "read")
    assert read["attrs"]["files"] == 8 and read["attrs"]["bases"] == 8 * 3000
    assert read["attrs"]["blocked_s"] >= 0


def test_timings_are_their_spans(traced):
    timings = traced["timings"]
    assert {"index", "map+pileup+feed", "compare"} <= set(timings)
    for name, seconds in timings.items():
        (s,) = _named(traced, name)
        assert abs(_seconds(s) - seconds) < ROUNDING_S, (name, s, seconds)
    (count,) = _named(traced, "devd.count", "devd")
    assert abs(traced["devd_count_s"] - _seconds(count)) < ROUNDING_S
    (finish,) = _named(traced, "devd.finish")
    assert abs(traced["devd"]["finish_wait_s"] - _seconds(finish)) < ROUNDING_S
    # compare = the wait for the feeder's worker + the wait for finish
    (join,) = _named(traced, "compare.join")
    assert _seconds(join) + _seconds(finish) <= timings["compare"] + ROUNDING_S
    assert _seconds(count) <= _seconds(finish)


def test_index_span_carries_the_build(traced):
    """The ``index`` span carries the native build's account: its OpenMP
    threads (one below the parallel cutoff, as this 3 kbp reference is),
    the seconds of the suffix sort and of the bucket tables, inside the
    span, and the SA-IS levels that ran."""
    (index,) = _named(traced, "index")
    attrs = index["attrs"]
    assert attrs["threads"] == 1 and attrs["levels"] >= 1
    assert 0 < attrs["sais_s"] and 0 < attrs["buckets_s"]
    assert attrs["sais_s"] + attrs["buckets_s"] <= _seconds(index)


def test_phases_and_the_rest_tile_process(traced):
    (proc,) = _named(traced, "process")
    kids = sorted((s["start"], s["end"]) for s in traced["spans"]
                  if s["parent"] == proc["id"] and s["thread"] == proc["thread"])
    assert kids[0][0] == proc["start"] and kids[-1][1] == proc["end"]
    for (_, end), (start, _) in zip(kids, kids[1:]):
        assert abs(start - end) < ROUNDING_S
    assert _named(traced, "process.rest")


def test_the_root_self_time_is_small(traced):
    (root,) = _named(traced, "run")
    kids = [(s["start"], s["end"]) for s in traced["spans"]
            if s["parent"] == root["id"] and s["thread"] == root["thread"]]
    assert {s["name"] for s in traced["spans"] if s["parent"] == root["id"]
            and s["thread"] == root["thread"]} == {"options", "read", "pick", "process",
                                                    "print"}
    self_s = _seconds(root) - _union(kids)
    assert self_s < 0.05 * traced["main_s"], (self_s, traced["main_s"])
    assert _seconds(root) <= traced["main_s"]


def test_server_spans_carry_the_client_ids(traced):
    ids = _by_id(traced)
    server = [s for s in traced["spans"] if s["process"] == "devd"]
    requests = [s for s in traced["spans"] if s["process"] == "cli"
                and s["name"].startswith("devd.") and s["name"] != "devd.connect"]
    assert server and requests
    for s in server:
        parent = ids[s["parent"]]
        if parent["process"] == "cli":
            # a request's span under the client's span of the same request
            assert parent["name"] == s["name"] and parent in requests
            assert parent["start"] - CLOCK_SLACK_S <= s["start"]
            assert s["end"] <= parent["end"] + CLOCK_SLACK_S
    assert {s["name"] for s in server if ids[s["parent"]]["process"] == "cli"} == {
        "devd.qhave", "devd.qgroup", "devd.group", "devd.finish"}
    (finish,) = _named(traced, "devd.finish")
    first = min(s["start"] for s in requests)
    for s in server:
        assert first - CLOCK_SLACK_S <= s["start"] and s["end"] <= finish["end"] + CLOCK_SLACK_S
    assert all(s["parent"] in {g["id"] for g in _named(traced, "devd.group", "devd")}
               for s in _named(traced, "devd.build", "devd"))
    assert all("queued_s" in s["attrs"] for s in _named(traced, "devd.build", "devd"))
    assert all(s["attrs"]["lock_wait_s"] >= 0 for s in requests)


def test_the_server_memory_is_reported(traced):
    devd = traced["devd"]
    assert devd["spans_dropped"] == 0
    rss = devd["rss"]
    assert set(rss) == {"rss_mb", "anon_mb", "file_mb"}
    assert rss["rss_mb"] > 0 and 0 < rss["anon_mb"] <= rss["rss_mb"]


def test_the_memory_without_the_split_in_status_comes_from_smaps(monkeypatch):
    """gVisor's /proc/self/status has VmRSS but no RssAnon or RssFile: the
    split then sums /proc/self/smaps."""
    import io as _io

    from phylonium_tpu_torch.serve import daemon

    files = {"/proc/self/status": b"Name:\tpython3\nVmSize:\t9000 kB\nVmRSS:\t 3000 kB\n",
             "/proc/self/smaps": b"7f-8f r-xp 0 libtorch.so\nRss:  1000 kB\nAnonymous:  0 kB\n"
                                 b"9f-af rw-p 0 \nRss:  2000 kB\nAnonymous:  1500 kB\n"}
    monkeypatch.setattr(daemon, "open", lambda path, mode="r": _io.BytesIO(files[path]),
                        raising=False)
    assert daemon._rss_mb() == {"rss_mb": 3000 * 1024 / 1e6, "anon_mb": 1500 * 1024 / 1e6,
                                "file_mb": 1500 * 1024 / 1e6}


def test_the_second_pass_is_marked(daemon_sock, tmp_path):
    files = write_fasta_panel(tmp_path, 11, 3000, seed=21, contigs=2)
    report, _, _ = _reported(tmp_path, daemon_sock, ["-2", *files])
    processes = _named(report, "process")
    assert len(processes) == 2  # this panel's second pass picks another reference
    assert [p["attrs"].get("pass") for p in sorted(processes, key=lambda s: s["start"])] == [
        None, 2]
    second = [s for s in report["spans"] if s["attrs"].get("pass") == 2]
    assert {"devd.finish", "devd.count", "compare", "feed.group"} <= {s["name"] for s in second}
    assert all(s["start"] >= processes[0]["end"] for s in second)


def test_nothing_is_recorded_when_nothing_asks(daemon_sock, tmp_path, monkeypatch):
    made, sent = [], []
    recorder = profile.Recorder
    send = devd_client.send_msg
    monkeypatch.setattr(profile, "Recorder",
                        lambda *a, **k: made.append(a) or recorder(*a, **k))
    monkeypatch.setattr(devd_client, "send_msg",
                        lambda sock, header, arrays=(): sent.append(header) or send(
                            sock, header, arrays))
    files = write_fasta_panel(tmp_path, 7, 2500, seed=303)
    rc, out, err = _run(files, daemon_sock)
    assert rc == 0 and out and err == ""
    assert made == [] and sent and not any("span" in h for h in sent)
    monkeypatch.undo()
    reported, _, _ = _reported(tmp_path, daemon_sock, files)
    assert reported["spans"]


def test_span_is_a_shared_noop_that_allocates_nothing():
    assert profile.recorder() is None
    assert profile.span("a") is profile.span("b", attrs={"x": 1})
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(10000):
            with profile.span("a") as s:
                s.note("k", 1)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    here = [stat for stat in after.compare_to(before, "filename")
            if stat.traceback[0].filename == profile.__file__]
    assert sum(stat.size_diff for stat in here) == 0


_TRACES = (r"query shipper \[\+\d+\.\d\ds\]: device server connected",
           r"query shipper \[\+\d+\.\d\ds\]: group 0 pack (\d+\.\d\d)s ship \d+\.\d MB in "
           r"(\d+\.\d\d)s",
           r"row feeder: group @0 prep (\d+\.\d\d)s request (\d+\.\d\d)s",
           r"row feeder: finish wire (\d+\.\d\d)s \(daemon (\d+\.\d+(e-\d+)?)s\)")


def test_debug_lines_keep_their_text_and_read_the_spans(daemon_sock, tmp_path):
    files = write_fasta_panel(tmp_path, 8, 2500, seed=305)
    report, out, err = _reported(tmp_path, daemon_sock, files, PHYLONIUM_TPU_DEBUG="1")
    found = [re.search(p, err) for p in _TRACES]
    assert all(found), err
    (first,) = [s for s in _named(report, "feed.group") if s["attrs"]["lo"] == 0]
    prep, request = ([s for s in report["spans"] if s["parent"] == first["id"]
                      and s["name"] == name][0] for name in ("feed.prep", "feed.request"))
    assert found[2].group(1) == f"{_seconds(prep):.2f}"
    assert found[2].group(2) == f"{_seconds(request):.2f}"
    (finish,) = _named(report, "devd.finish")
    assert found[3].group(1) == f"{_seconds(finish):.2f}"
    assert float(found[3].group(2)) == report["devd_count_s"]
    (piece,) = [s for s in _named(report, "ship.piece") if s["attrs"]["gidx"] == 0]
    (qgroup,) = [s for s in report["spans"] if s["parent"] == piece["id"]
                 and s["name"] == "devd.qgroup"]
    assert abs(float(found[1].group(1)) - (qgroup["start"] - piece["start"])) <= 0.0051
    assert abs(float(found[1].group(2)) - _seconds(qgroup)) <= 0.0051
    assert len(re.findall(r"row feeder: group @\d+ ", err)) == 3


def _metric(name):
    spec = importlib.util.spec_from_file_location(f"metric_{name}",
                                                  os.path.join(METRICS, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


_SPAN_METRICS = {"fasta_s": ("read", "cli"), "ship_s": ("ship.piece", "cli"),
                 "prep_s": ("feed.prep", "cli"), "feed_join_s": ("compare.join", "cli"),
                 "finish_wait_s": ("devd.finish", "cli"),
                 "server_copy_s": ("devd.copy", "devd"),
                 "server_count_s": ("devd.count", "devd"), "print_s": ("print", "cli")}


@pytest.mark.parametrize("name", [*_SPAN_METRICS, "lock_wait_s", "server_anon_mb"])
def test_the_benchmark_metrics_read_the_spans(traced, name):
    read = _metric(name)
    record = {"runs": [{"report": traced}, {"report": traced}]}
    if name == "server_anon_mb":
        assert read(record) == traced["devd"]["rss"]["anon_mb"]
    elif name == "lock_wait_s":
        waits = [s["attrs"]["lock_wait_s"] for s in traced["spans"]
                 if s["process"] == "cli" and "lock_wait_s" in s["attrs"]]
        assert len(waits) == 3 + 3 + 3 + 1  # qhave, qgroup, group, finish
        assert read(record) == pytest.approx(sum(waits))
    else:
        spans = _named(traced, *_SPAN_METRICS[name])
        if not spans:  # the CPU server copies nothing: devd.copy is a card's
            assert name == "server_copy_s" and read(record) is None
            extra = {**traced, "spans": [*traced["spans"], {
                "name": "devd.copy", "start": 1.0, "end": 1.25, "id": "d0",
                "parent": None, "process": "devd", "thread": "t", "attrs": {}}]}
            assert read({"runs": [{"report": extra}]}) == 0.25
        else:
            assert read(record) == pytest.approx(sum(map(_seconds, spans)))
    # a report without spans (a program that records none): nothing to read
    assert read({"runs": [{"report": {"timings": {}}}]}) is None
