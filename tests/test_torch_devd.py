"""The port's device server (phylonium_tpu_torch/serve/) on the CPU.

One daemon for the module (``python -m phylonium_tpu_torch.serve --device
cpu`` on a socket under the module's temporary directory, stopped and
checked gone at the end); the tests that need a daemon of their own (an
injected fault, another protocol) let the CLI spawn it on a socket of
their own and stop it by its pidfile. Held against the JAX package:

- ``wire`` frames byte for byte; the content keys of raw and compacted
  pieces, as the JAX shipper computes them;
- the CLI with ``PHYLONIUM_TPU_DEVD=1`` and ``PHYLONIUM_TPU_STREAM=force``
  prints the golden bytes (default, ``dist_ani``, ``two_pass``, low
  memory); a second identical run takes every piece from the server's
  cache and ships 0 bytes; ``-2`` builds pass 2 from the pieces pass 1
  parked, under a new generation; the shipper parks a panel once, and a
  second shipper of it ships 0 bytes; an op the server lacks is refused;
- ``PHYLONIUM_TPU_DEBUG``: the shipper and the feeder print the JAX
  package's devd trace lines to stderr (connected or unavailable, each
  piece and group, the finish's wire time), none without the variable,
  and the matrix is the same;
- a slow build never stalls ``group`` replies; cancel; stale pass-1
  builds dropped; the lock wait and the socket wait within one deadline;
  feeder generations never repeat;
- every fault fails the run (exit 1, no matrix, the socket named):
  poison (the client retires the daemon, the next run spawns a fresh
  one), an unreachable server, a daemon of another protocol (replaced on
  the next connect), a daemon on another device, several ranks;
- ``devd_enabled``'s table against the JAX gate (its ``cpu_pinned`` and
  ``_is_multiprocess`` patched to the port's device and world), and
  ``_stream_predicts_win``'s server branch against the JAX function with
  the JAX tail;
- the default route: which runs on a card the server takes (``devd_route``,
  and no prewarm for them); a CLI child with one card faked, no routing
  variable and a calibrated store streams through the module's daemon
  (the client takes the card for the daemon's CPU), imports no torch and
  prints the JAX CLI's bytes; where no daemon can start (its socket's
  directory cannot be made, or it finds no card and exits) the run exits
  1 with no matrix and a message naming the socket, the daemon's log and
  ``PHYLONIUM_TPU_DEVD=0``.
"""

import contextlib
import gc
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from golden_panel import GOLDEN_CASES, RD_SEED, write_panel
from phylonium_tpu.core.pileup import build_pileup
from phylonium_tpu.ops.match_table import pair_counts_numpy
from phylonium_tpu_torch.config import ConfigError
from phylonium_tpu_torch.core.query_ship import DevdGroup, QueryShipper, content_key
from phylonium_tpu_torch.core.stream import DeviceRowFeeder
from phylonium_tpu_torch.serve import client as devd_client
from phylonium_tpu_torch.serve import daemon
from phylonium_tpu_torch.serve.client import DevdClient, DevdError
from pileup_cases import panel, write_fasta_panel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "data", "golden")
CPU = torch.device("cpu")


def _env(sock: str, **extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["PHYLONIUM_TPU_DEVD_SOCK"] = sock
    env["PHYLONIUM_TPU_DEVD_IDLE_S"] = "600"
    env.update(extra)
    return env


def _wait_for(sock: str, proc: subprocess.Popen, log) -> None:
    deadline = time.time() + 60
    while time.time() < deadline and not os.path.exists(sock + ".pid"):
        if proc.poll() is not None:
            raise RuntimeError(f"daemon exited {proc.returncode}: {log.read_text()[-2000:]}")
        time.sleep(0.05)
    assert os.path.exists(sock), "the daemon's socket never appeared"


def _stop(sock: str) -> None:
    """SIGTERM the daemon of ``sock`` by its pidfile; assert it is gone and
    its socket removed."""
    try:
        with open(sock + ".pid") as f:
            pid = int(f.read())
    except FileNotFoundError:
        assert not os.path.exists(sock)
        return
    os.kill(pid, signal.SIGTERM)
    deadline = time.time() + 20
    while time.time() < deadline and os.path.exists(sock + ".pid"):
        time.sleep(0.05)
    assert not os.path.exists(sock) and not os.path.exists(sock + ".pid")


@pytest.fixture(scope="module")
def module_daemon(tmp_path_factory):
    """One CPU daemon for the module, on a socket in a temporary directory."""
    tmp = tmp_path_factory.mktemp("devd")
    sock = str(tmp / "d.sock")
    log = tmp / "d.log"
    with open(log, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "phylonium_tpu_torch.serve", "--device", "cpu"],
            stdout=out, stderr=out, env=_env(sock),
        )
    try:
        _wait_for(sock, proc, log)
        yield sock
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=20)
        assert proc.returncode == 0, log.read_text()[-2000:]
        assert not os.path.exists(sock)


def _reset_client():
    if devd_client._client is not None:
        devd_client._client.close()
    devd_client._client = None


@pytest.fixture
def devd(module_daemon, monkeypatch):
    """This process's client pointed at the module daemon, fresh."""
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD_SOCK", module_daemon)
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "1")
    _reset_client()
    yield module_daemon
    _reset_client()


@pytest.fixture
def own_socket(tmp_path, monkeypatch):
    """A socket of the test's own; whatever daemon the test spawned on it
    is stopped at the end."""
    sock = str(tmp_path / "o.sock")
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD_SOCK", sock)
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "1")
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD_IDLE_S", "120")
    _reset_client()
    yield sock
    _reset_client()
    _stop(sock)


def _run(args):
    from phylonium_tpu_torch.cli import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["--progress=never", *args])
    return rc, out.getvalue(), err.getvalue()


def _jax_run(args) -> str:
    """The JAX CLI's stdout, in process, with its own device server off:
    its client would replace a daemon of the port's protocol."""
    from phylonium_tpu.cli import main

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PHYLONIUM_TPU_DEVD", "0")
        mp.delenv("PHYLONIUM_TPU_DEVD_SOCK", raising=False)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(["--progress=never", *args]) == 0
    return out.getvalue()


def _passes(monkeypatch):
    """LAST_RUN_INFO after each pass of the CLI's pipeline."""
    import phylonium_tpu_torch.cli as cli
    from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO

    passes = []
    process = cli.process

    def recorded(*args, **kwargs):
        counts = process(*args, **kwargs)
        passes.append(json.loads(json.dumps(LAST_RUN_INFO)))
        return counts

    monkeypatch.setattr(cli, "process", recorded)
    return passes


def _ops(monkeypatch):
    """The ops this process sends to the server, in order."""
    sent = []
    request = DevdClient.request

    def recorded(self, header, arrays=(), timeout=900.0):
        sent.append(dict(header))
        return request(self, header, arrays, timeout)

    monkeypatch.setattr(DevdClient, "request", recorded)
    return sent


# -- the wire and the content keys -------------------------------------


def _frame(send_msg, header, arrays) -> bytes:
    a, b = socket.socketpair()
    try:
        send_msg(a, header, arrays)
        a.close()
        chunks = []
        while True:
            chunk = b.recv(1 << 16)
            if not chunk:
                return b"".join(chunks)
            chunks.append(chunk)
    finally:
        b.close()


def test_wire_frames_equal_the_jax_frames():
    from phylonium_tpu.serve import wire as jax_wire
    from phylonium_tpu_torch.serve import wire

    rng = np.random.default_rng(3)
    arrays = [np.arange(7, dtype=np.int64), rng.integers(0, 255, (3, 5), dtype=np.uint8),
              np.asfortranarray(rng.random((4, 3)))]
    header = {"op": "group", "run": "r-1", "gen": 3, "lo": 8, "n": 29}
    ours = _frame(wire.send_msg, header, arrays)
    assert ours == _frame(jax_wire.send_msg, header, arrays)
    assert ours.startswith(b"PHYD1")
    # an empty overlay: no body bytes, the header names its shape
    arrays.insert(2, np.zeros((0, 4), np.int32))
    empty = _frame(wire.send_msg, header, arrays)
    assert empty.endswith(ours[-(7 * 8 + 15 + 12 * 8):])
    assert (wire.MAGIC, wire._MAX_HEADER, wire._MAX_BODY) == (
        jax_wire.MAGIC, jax_wire._MAX_HEADER, jax_wire._MAX_BODY)
    a, b = socket.socketpair()
    try:
        wire.send_msg(a, header, arrays)
        got_header, got = wire.recv_msg(b)
        assert got_header["gen"] == 3 and len(got) == len(arrays)
        for want, have in zip(arrays, got):
            assert have.dtype == want.dtype and np.array_equal(have, want)
        a.sendall(b"NOPE!" + b"\0" * 4)
        with pytest.raises(ConnectionError):
            wire.recv_msg(b)
    finally:
        a.close()
        b.close()


class _KeyRecorder:
    """A client that answers every qhave with a hit and records the keys."""

    def __init__(self):
        self.keys = []

    def request(self, header, arrays=(), timeout=900.0):
        self.keys.append(header["key"])
        return {"ok": True, "have": True}, []


def test_content_keys_equal_the_jax_keys(rng, monkeypatch):
    import phylonium_tpu.serve.client as jax_client
    from phylonium_tpu.core.query_ship import DevdGroup as JaxDevdGroup
    from phylonium_tpu.core.query_ship import QueryShipper as JaxShipper
    from phylonium_tpu.core.query_ship import _payload_from_compacted as jax_payload
    from phylonium_tpu.data.sequence import Sequence as JaxSequence
    from phylonium_tpu_torch.data.sequence import Sequence

    queries, _, _ = panel(rng, 11, 700)
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "1")
    theirs, ours = _KeyRecorder(), _KeyRecorder()
    monkeypatch.setattr(jax_client, "get_client", lambda: theirs)
    monkeypatch.setattr(devd_client, "get_client", lambda device: ours)
    jax_shipper = JaxShipper(11, group_rows=4)
    shipper = QueryShipper(11, CPU, group_rows=4, transport="devd")
    for q in queries:
        jax_shipper.add(q)
        shipper.add(q)
    for lo, hi in ((0, 4), (4, 8), (8, 11)):
        got = shipper.take(lo, hi)
        assert isinstance(got, DevdGroup) and got.gidx == lo // 4
        assert isinstance(jax_shipper.take(lo, hi), JaxDevdGroup)
    assert jax_shipper.drain(10.0)
    assert len(ours.keys) == 3 and ours.keys == theirs.keys
    assert ours.keys == [content_key(queries[lo:lo + 4]) for lo in (0, 4, 8)]
    assert shipper.hits == 3 and shipper.shipped_bytes() == 0
    shipper.stop()
    jax_shipper.cancel()

    # compacted genomes: the packs under the "packed4" domain
    port_seqs = [Sequence(f"g{k}", q.tobytes()) for k, q in enumerate(queries)]
    jax_seqs = [JaxSequence(f"g{k}", q.tobytes()) for k, q in enumerate(queries)]
    for s in port_seqs + jax_seqs:
        s.compact()
    for lo, hi in ((0, 4), (4, 8), (8, 11)):
        assert content_key(port_seqs[lo:hi]) == jax_payload(jax_seqs[lo:hi])[3]
    compacted = QueryShipper(11, CPU, group_rows=4, transport="devd")
    ours.keys.clear()
    for s in port_seqs:
        compacted.add_seq(s)
    assert compacted.drain(10.0)
    assert ours.keys == [jax_payload(jax_seqs[lo:lo + 4])[3] for lo in (0, 4, 8)]
    compacted.stop()


# -- the server on the CLI's route ---------------------------------------


@pytest.fixture(scope="module")
def golden_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden_panel_devd")
    return write_panel(str(d)), str(d)


@pytest.mark.parametrize("name,env", [
    ("default", {}),
    ("dist_ani", {}),
    ("two_pass", {}),
    ("default", {"PHYLONIUM_TPU_LOWMEM": "force"}),
], ids=["default", "dist_ani", "two_pass", "lowmem"])
def test_devd_cli_reproduces_golden_fixture(name, env, golden_files, devd, monkeypatch):
    files, tmp = golden_files
    monkeypatch.chdir(tmp)
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    monkeypatch.setenv("PHYLONIUM_TPU_RD_SEED", str(RD_SEED))
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    passes = _passes(monkeypatch)
    rc, out, err = _run(["--device", "cpu", *GOLDEN_CASES[name], *files])
    assert rc == 0, err
    with open(os.path.join(GOLDEN_DIR, f"{name}.stdout"), "rb") as f:
        assert out.encode() == f.read()
    assert len(passes) == (2 if "-2" in GOLDEN_CASES[name] else 1)
    for info in passes:
        server = info["devd"]
        assert server["socket"] == devd and server["device"] == "cpu"
        assert server["protocol"] == daemon.PROTOCOL
        # the server built each group and counted the panel, with the plain
        # versions on its CPU; this process launched and called nothing
        assert server["launches"] == {"build": 0, "build_plain": info["stream_groups"],
                                      "count": 0, "count_plain": 1}
        assert info["stream_groups"] == 4 and info["early_ship"]["taken"] == 4
        assert info["early_ship"]["repacked"] == 0
        assert info["kernel_launches"] == info["plain_calls"] == 0
        assert info["build_kernel_launches"] == info["build_plain_calls"] == 0
        assert isinstance(info["devd_count_s"], float)
        assert info["cuda_initialized"] is False
        assert ("lowmem" in info) == bool(env)


def test_second_run_takes_every_piece_from_the_cache(tmp_path, devd, monkeypatch):
    files = write_fasta_panel(tmp_path, 10, 2500, seed=101)
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "4")
    passes = _passes(monkeypatch)
    sent = _ops(monkeypatch)
    rc0, first, _ = _run(["--device", "cpu", *files])
    _reset_client()
    rc1, second, _ = _run(["--device", "cpu", *files])
    assert rc0 == rc1 == 0 and second == first
    cold, warm = passes
    assert cold["early_ship"]["cache_hits"] == 0
    assert warm["early_ship"] == {**cold["early_ship"], "mb": 0.0, "cache_hits": 3}
    assert warm["devd"]["cache_hits"] == 3
    qgroups = [h for h in sent if h["op"] == "qgroup"]
    assert len(qgroups) == 3  # the cold run's pieces, none in the warm run
    assert _jax_run(files) == first


def test_two_pass_reuses_pass_one_pieces(tmp_path, devd, monkeypatch):
    """A panel whose second pass picks another reference: pass 2 sends no
    piece again, only groups of a new generation, and prints the JAX CLI's
    matrix."""
    files = write_fasta_panel(tmp_path, 11, 3000, seed=21, contigs=2)
    reference = _jax_run(["-2", *files])
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "4")
    passes = _passes(monkeypatch)
    sent = _ops(monkeypatch)
    rc, out, err = _run(["-2", "--device", "cpu", *files])
    assert rc == 0 and out == reference, err
    assert len(passes) == 2
    finishes = [k for k, h in enumerate(sent) if h["op"] == "finish"]
    assert len(finishes) == 2
    pass2 = sent[finishes[0] + 1:]
    assert not [h for h in pass2 if h["op"] in ("qhave", "qgroup")]
    gens = [{h["gen"] for h in sent[:finishes[0]] if h["op"] == "group"},
            {h["gen"] for h in pass2 if h["op"] == "group"}]
    assert len(gens[0]) == len(gens[1]) == 1 and gens[0] != gens[1]
    assert all(h.get("gidx") is not None for h in sent if h["op"] == "group")
    runs = {h["run"] for h in sent if "run" in h}
    assert len(runs) == 1  # one run id: its pieces stay resident
    for info in passes:
        assert info["early_ship"]["taken"] == 3 and info["early_ship"]["repacked"] == 0


_TRACES = (r"query shipper \[\+\d+\.\d\ds\]: device server connected",
           r"query shipper \[\+\d+\.\d\ds\]: group 0 pack \d+\.\d\ds ship \d+\.\d MB in ",
           r"query shipper \[\+\d+\.\d\ds\]: group 2 cache hit \(0 bytes\)",
           r"row feeder: group @0 prep \d+\.\d\ds request \d+\.\d\ds",
           r"row feeder: finish wire \d+\.\d\ds \(daemon \d+\.\d+(e-\d+)?s\)")


def test_debug_traces_of_the_devd_branches(tmp_path, devd, monkeypatch):
    import re

    files = write_fasta_panel(tmp_path, 10, 2500, seed=113)
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "4")
    monkeypatch.delenv("PHYLONIUM_TPU_DEBUG", raising=False)
    rc0, quiet, quiet_err = _run(["--device", "cpu", *files])
    _reset_client()
    monkeypatch.setenv("PHYLONIUM_TPU_DEBUG", "1")
    rc1, traced, err = _run(["--device", "cpu", *files])
    assert rc0 == rc1 == 0 and traced == quiet
    # the quiet run parked every piece: the traced run's are all hits
    hits = [line for line in err.splitlines() if "cache hit" in line]
    assert len(hits) == 3
    for pattern in _TRACES[:1] + _TRACES[2:]:
        assert re.search(pattern, err), (pattern, err)
    assert "query shipper" not in quiet_err and "row feeder" not in quiet_err
    # a cold panel: each piece packed and shipped
    cold = write_fasta_panel(tmp_path, 10, 2500, seed=114)
    _reset_client()
    rc, out, err = _run(["--device", "cpu", *cold])
    assert rc == 0 and re.search(_TRACES[1], err), err
    assert len(re.findall(r"row feeder: group @\d+ ", err)) == 3
    assert out == _jax_run(cold)


def test_debug_trace_of_an_unavailable_server(tmp_path, own_socket, monkeypatch):
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD_SPAWN_WAIT", "1")
    monkeypatch.setenv("PHYLONIUM_TPU_DEBUG", "1")
    monkeypatch.setattr(DevdClient, "spawn_daemon", lambda self: None)
    files = write_fasta_panel(tmp_path, 7, 2200, seed=115)
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "3")
    rc, out, err = _run(["--device", "cpu", *files])
    assert rc == 1 and out == ""
    assert "query shipper [+" in err and "]: device server unavailable (DevdError(" in err


def test_drain_parks_the_whole_panel(rng, devd):
    queries, _, _ = panel(rng, 9, 600)
    shipper = QueryShipper(9, CPU, group_rows=3, transport="devd")
    for q in queries:
        shipper.add(q)
    assert shipper.drain(60.0) is True
    assert shipper.shipped_groups() == 3 and shipper.hits == 0
    shipper.stop()
    again = QueryShipper(9, CPU, group_rows=3, transport="devd")
    for q in queries:
        again.add(q)
    assert again.drain(60.0) is True
    assert again.hits == 3 and again.shipped_bytes() == 0
    again.stop()


def test_feeder_through_the_server_equals_the_host_pileup(rng, devd):
    n, length = 13, 900
    queries, homologies, _ = panel(rng, n, length)
    feeder = DeviceRowFeeder(n, length, CPU, devd=True)
    assert feeder.panel is None
    lo = 0
    for g in (5, 5, 3):
        feeder.feed(queries[lo:lo + g], homologies[lo:lo + g])
        lo += g
    subs, homs = feeder.finish()
    es, eh = pair_counts_numpy(build_pileup(queries, homologies, length))
    assert np.array_equal(subs, es) and np.array_equal(homs, eh)
    assert feeder.groups == 3 and isinstance(feeder.devd_count_s, float)
    assert feeder.devd_reply["launches"]["build_plain"] == 3
    with pytest.raises(RuntimeError, match="lies in the server"):
        feeder.built()


def test_an_op_the_server_lacks_is_refused(devd):
    """An op the server does not serve (the JAX daemon's ``prewarm`` among
    them) is refused by name, and the daemon stays up and unpoisoned."""
    client = DevdClient(spawn=False, device="cpu")
    try:
        for op in ("prewarm", "bogus"):
            with pytest.raises(DevdError, match=f"unknown op '{op}'"):
                client.request({"op": op, "n": 4, "ref_len": 100}, timeout=30.0)
        reply = client.ping(timeout=30.0)
        assert reply["ok"] and reply["poisoned"] is None
    finally:
        client.close()


def test_ping_probe_and_the_live_pidfile(devd, tmp_path):
    client = DevdClient(spawn=False, device="cpu")
    reply = client.ping(timeout=30.0)
    assert reply["ok"] and reply["device"] == "cpu" and reply["protocol"] == daemon.PROTOCOL
    assert reply["warm"] is True and reply["poisoned"] is None
    assert set(reply["launches"]) == {"build", "build_plain", "count", "count_plain"}
    probe, _ = client.request({"op": "probe", "mb": 1}, timeout=30.0)
    assert probe["ok"] and probe["seconds"] > 0
    client.close()
    # a second daemon never binds over a live one's socket
    second = subprocess.run(
        [sys.executable, "-m", "phylonium_tpu_torch.serve", "--device", "cpu"],
        env=_env(devd), capture_output=True, text=True, timeout=120,
    )
    assert second.returncode == 0 and "already serves" in second.stderr
    assert DevdClient(spawn=False, device="cpu").ping(timeout=30.0)["pid"] == reply["pid"]


def test_qcache_drops_the_least_recently_used(monkeypatch):
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD_CACHE_MB", "0.00003")  # 30 bytes
    state = daemon._State(CPU)
    for key in "abc":
        state.qcache_put(key, key, 10)
    assert state.qcache_get("a") is not None  # "a" is now the most recent
    state.qcache_put("d", "d", 10)
    assert list(state.qcache) == ["c", "a", "d"] and state.qcache_bytes == 30


def test_qcache_under_concurrent_connections(monkeypatch):
    """Connection threads put and get pieces at once: the byte count stays
    the sum of the entries held, within the cap."""
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD_CACHE_MB", "0.001")  # 1000 bytes
    state = daemon._State(CPU)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for k in range(200):
                state.qcache_put(f"{t}-{k % 7}", None, 10 + (k % 5) * 30)
                state.qcache_get(f"{(t + 1) % 16}-{k % 7}")

        threads = [threading.Thread(target=work, args=(t,)) for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert state.qcache_bytes == sum(nbytes for _, nbytes in state.qcache.values())
    assert state.qcache_bytes <= state.qcache_cap


# -- the daemon's build thread, in process ----------------------------------


def _group(run, gen, lo, queries, homologies, ref_len, n):
    from phylonium_tpu_torch.ops import pileup_device

    words, *records = pileup_device.prepare_group(queries, homologies, ref_len)
    header = {"op": "group", "run": run, "gen": gen, "lo": lo, "rows": len(queries),
              "n": n, "ref_len": ref_len}
    return header, [*records, words]


def _gated_builds(monkeypatch):
    """Hold the build thread at each build until ``gate`` is set; count the
    builds that ran."""
    gate, built = threading.Event(), []
    build = daemon._build_one

    def gated(state, run, stream, item):
        assert gate.wait(60)
        built.append(item[0]["gen"])
        build(state, run, stream, item)

    monkeypatch.setattr(daemon, "_build_one", gated)
    return gate, built


def test_a_slow_build_never_stalls_group_replies(rng, monkeypatch):
    """With PHYLONIUM_TPU_DEVD_INJECT=slow_build each build waits 3 s; the
    group replies come back at once and finish joins the builds."""
    queries, homologies, _ = panel(rng, 6, 600)
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD_INJECT", "slow_build")
    state = daemon._State(CPU)
    t0 = time.perf_counter()
    for lo in (0, 3):
        reply, _ = daemon._handle(state, *_group("r", 1, lo, queries[lo:lo + 3],
                                                 homologies[lo:lo + 3], 600, 6))
        assert reply["ok"]
    assert time.perf_counter() - t0 < 2.0  # no reply waited on a 3 s build
    reply, (subs, homs) = daemon._handle(state, {"op": "finish", "run": "r", "gen": 1,
                                                  "n": 6}, [])
    assert reply["ok"] and time.perf_counter() - t0 >= 6.0
    es, eh = pair_counts_numpy(build_pileup(queries, homologies, 600))
    assert np.array_equal(subs, es) and np.array_equal(homs, eh)
    assert reply["launches"] == {"build": 0, "build_plain": 2, "count": 0, "count_plain": 1}


def test_cancel_drops_the_queued_builds(rng, monkeypatch):
    queries, homologies, _ = panel(rng, 6, 500)
    gate, built = _gated_builds(monkeypatch)
    state = daemon._State(CPU)
    for lo in (0, 3):
        daemon._handle(state, *_group("r", 1, lo, queries[lo:lo + 3],
                                      homologies[lo:lo + 3], 500, 6))
    assert daemon._handle(state, {"op": "cancel", "run": "r"}, [])[0]["ok"]
    gate.set()
    state.runs["r"].queue.join()
    assert len(built) <= 1  # at most the build that was already held
    reply, _ = daemon._handle(state, {"op": "finish", "run": "r", "gen": 1, "n": 6}, [])
    assert not reply["ok"] and "no panel" in reply["error"]


def test_stale_pass_one_builds_are_dropped(rng, monkeypatch):
    """Items queued under generation 1 are dropped once generation 2 (the
    second pass of -2, same run id) has begun, and pass 2 counts exactly."""
    queries, homologies, _ = panel(rng, 6, 500)
    gate, built = _gated_builds(monkeypatch)
    state = daemon._State(CPU)
    for lo in (0, 3):
        daemon._handle(state, *_group("r", 1, lo, queries[lo:lo + 3],
                                      homologies[lo:lo + 3], 500, 6))
    daemon._handle(state, *_group("r", 2, 0, queries, homologies, 500, 6))
    gate.set()
    reply, (subs, homs) = daemon._handle(state, {"op": "finish", "run": "r", "gen": 2,
                                                  "n": 6}, [])
    assert reply["ok"]
    assert built.count(1) <= 1 and built.count(2) == 1  # no stale item ran after gen 2
    es, eh = pair_counts_numpy(build_pileup(queries, homologies, 500))
    assert np.array_equal(subs, es) and np.array_equal(homs, eh)


def test_feeder_generations_never_repeat():
    gens, ids = [], []
    for _ in range(20):
        feeder = DeviceRowFeeder(2, 10, CPU)
        feeder.cancel()
        gens.append(feeder.gen)
        ids.append(id(feeder))
        del feeder
        gc.collect()
    assert len(set(gens)) == len(gens) and gens == sorted(gens)


def test_lock_wait_and_socket_wait_share_one_deadline():
    """A request behind a busy connection fails by its own deadline: the
    socket gets only what the wait for the lock left."""
    a, b = socket.socketpair()  # b never answers
    client = DevdClient.__new__(DevdClient)
    client.path, client.device = "test.sock", "cpu"
    client._lock, client._sock, client._spawned = threading.Lock(), a, None
    holder = threading.Thread(target=lambda: (client._lock.acquire(), time.sleep(1.5),
                                              client._lock.release()))
    holder.start()
    time.sleep(0.1)
    t0 = time.monotonic()
    with pytest.raises(DevdError, match="test.sock"):
        client.request({"op": "ping"}, timeout=2.0)
    assert time.monotonic() - t0 < 2.8  # without the shared deadline: 1.4 + 2.0 s
    holder.join()
    b.close()
    client.close()


# -- every fault fails the run -------------------------------------------------


def test_poison_retires_the_daemon_and_fails_the_run(tmp_path, own_socket, monkeypatch):
    files = write_fasta_panel(tmp_path, 8, 2000, seed=41)
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "4")
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD_INJECT", "poison")
    rc, out, err = _run(["--device", "cpu", *files])
    assert rc == 1 and out == ""
    assert f"device server at {own_socket}" in err and "poisoned" in err
    assert "illegal memory access" in err
    # the client retired it: the daemon is gone, pidfile and socket too
    assert not os.path.exists(own_socket + ".pid") and not os.path.exists(own_socket)
    monkeypatch.delenv("PHYLONIUM_TPU_DEVD_INJECT")
    _reset_client()
    rc, out, err = _run(["--device", "cpu", *files])
    assert rc == 0, err
    assert out == _jax_run(files)


def test_an_unreachable_server_fails_the_run(tmp_path, own_socket, monkeypatch):
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD_SPAWN_WAIT", "1")
    monkeypatch.setattr(DevdClient, "spawn_daemon", lambda self: None)
    files = write_fasta_panel(tmp_path, 7, 2200, seed=31)
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "3")
    rc, out, err = _run(["--device", "cpu", *files])
    assert rc == 1 and out == ""
    assert f"device server at {own_socket}" in err and "did not come up" in err


def test_a_daemon_of_another_protocol_is_replaced(tmp_path, own_socket, monkeypatch):
    code = ("import sys; from phylonium_tpu_torch.serve import daemon; "
            "daemon.PROTOCOL = 'phyd-torch-0+another-tree'; "
            "sys.exit(daemon.serve(device='cpu'))")
    log = tmp_path / "old.log"
    with open(log, "wb") as out:
        old = subprocess.Popen([sys.executable, "-c", code], stdout=out, stderr=out,
                               env=_env(own_socket))
    _wait_for(own_socket, old, log)
    probe = DevdClient(spawn=False, device="cpu")
    assert probe.ping()["protocol"] == "phyd-torch-0+another-tree"
    probe.close()
    files = write_fasta_panel(tmp_path, 8, 2000, seed=43)
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "4")
    rc, out, err = _run(["--device", "cpu", *files])
    assert rc == 0, err
    assert old.wait(timeout=20) == 0  # SIGTERM by its pidfile
    assert DevdClient(spawn=False, device="cpu").ping()["protocol"] == daemon.PROTOCOL


def test_a_refused_protocol_fails_the_run(tmp_path, own_socket, monkeypatch):
    """Where the daemon that comes up speaks another protocol (another
    tree's server on the path), the run fails and names both."""
    code = ("import sys; from phylonium_tpu_torch.serve import daemon; "
            "daemon.PROTOCOL = 'phyd-torch-0+another-tree'; "
            "sys.exit(daemon.serve(device='cpu'))")
    log = tmp_path / "other.log"

    def other_tree(self):
        with open(log, "ab") as out:
            self._spawned = subprocess.Popen([sys.executable, "-c", code], stdout=out,
                                             stderr=out, env=_env(self.path))
        return self._spawned

    monkeypatch.setattr(DevdClient, "spawn_daemon", other_tree)
    files = write_fasta_panel(tmp_path, 7, 2200, seed=47)
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "4")
    rc, out, err = _run(["--device", "cpu", *files])
    assert rc == 1 and out == ""
    assert f"device server at {own_socket}" in err and "refused protocol" in err
    assert "phyd-torch-0+another-tree" in err and daemon.PROTOCOL in err


def test_a_cuda_client_is_refused_by_a_cpu_daemon(devd):
    with pytest.raises(DevdError) as raised:
        DevdClient(device="cuda")
    assert f"device server at {devd}" in str(raised.value)
    assert "serves device cpu" in str(raised.value) and "cuda:0" in str(raised.value)


def test_several_ranks_refuse_the_server(tmp_path, monkeypatch):
    import phylonium_tpu_torch.parallel.multihost as multihost

    files = write_fasta_panel(tmp_path, 4, 1500, seed=5)
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "1")
    monkeypatch.setattr(multihost, "world", lambda: (4, 0))
    rc, out, err = _run(["--device", "cpu", *files])
    assert rc == 1 and out == "" and "several ranks" in err


@pytest.mark.parametrize("env", [None, "0", "1"])
@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:1"])
@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_devd_enabled_table(env, device, ranks, monkeypatch):
    """The JAX gate's table: 0 is off, 1 is on on any device, unset is on
    exactly for a card in a world of one rank (the JAX ``cpu_pinned()``
    patched to a CPU ``--device``, its ``_is_multiprocess`` to several
    ranks). The one departure: 1 in a world of several ranks is refused."""
    import phylonium_tpu.core.pipeline as jax_pipeline
    import phylonium_tpu.serve.client as jax_client
    import phylonium_tpu.utils.platform as jax_platform
    import phylonium_tpu_torch.parallel.multihost as multihost

    if env is None:
        monkeypatch.delenv("PHYLONIUM_TPU_DEVD", raising=False)
    else:
        monkeypatch.setenv("PHYLONIUM_TPU_DEVD", env)
    monkeypatch.setattr(multihost, "world", lambda: (ranks, 0))
    monkeypatch.setattr(jax_platform, "cpu_pinned", lambda: device == "cpu")
    monkeypatch.setattr(jax_pipeline, "_is_multiprocess", lambda: ranks > 1)
    want = jax_client.devd_enabled()
    if env == "1" and ranks > 1:
        assert want is True
        with pytest.raises(ConfigError, match="several ranks"):
            devd_client.devd_enabled(device)
    else:
        assert devd_client.devd_enabled(device) is want
        assert want is (env == "1" or (env is None and device != "cpu" and ranks == 1))


# name: (config fields, environment, whether the server takes the run)
_ROUTES = {
    "streamed": ({}, {"PHYLONIUM_TPU_STREAM": "force"}, True),
    "low-memory": ({}, {"PHYLONIUM_TPU_LOWMEM": "force"}, True),
    "low-memory, host count": ({"count_backend": "host"}, {"PHYLONIUM_TPU_LOWMEM": "force"},
                               False),
    "device count": ({"count_backend": "device"}, {"PHYLONIUM_TPU_STREAM": "force"}, False),
    "one group": ({}, {"PHYLONIUM_TPU_STREAM_GROUP": "64"}, False),
    "complete deletion": ({"complete_deletion": True}, {"PHYLONIUM_TPU_STREAM": "force"},
                          False),
    "hybrid": ({"map_backend": "hybrid"}, {"PHYLONIUM_TPU_STREAM": "force"}, False),
    "X2": ({}, {"PHYLONIUM_TPU_DEVICE_PILEUP": "1", "PHYLONIUM_TPU_STREAM": "0"}, False),
    "in process": ({}, {"PHYLONIUM_TPU_STREAM": "force", "PHYLONIUM_TPU_DEVD": "0"}, False),
    "cpu": ({"device": "cpu"}, {"PHYLONIUM_TPU_STREAM": "force"}, False),
}


@pytest.mark.parametrize("name", list(_ROUTES))
def test_default_route_of_a_card_run(name, monkeypatch):
    """With no PHYLONIUM_TPU_DEVD a run on a card sends the feeder routes
    to the server, and then makes no prewarm; the serial routes stay in
    process."""
    from phylonium_tpu_torch.config import TorchRunConfig
    from phylonium_tpu_torch.core import pipeline

    fields, env, served = _ROUTES[name]
    for key in ("PHYLONIUM_TPU_DEVD", "PHYLONIUM_TPU_STREAM", "PHYLONIUM_TPU_STREAM_GROUP",
                "PHYLONIUM_TPU_LOWMEM", "PHYLONIUM_TPU_DEVICE_PILEUP"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    # a threshold of 0 Gbp keeps the dispatch model's count on the card
    monkeypatch.setenv("PHYLONIUM_TPU_AUTO_DEVICE_GBP", "0")
    cfg = TorchRunConfig(**{"device": "cuda", **fields})
    n, ref_len = 29, 5_000
    assert pipeline.devd_route(n, ref_len, n * ref_len, cfg) is served
    if served:
        assert pipeline.prewarm_device(n, ref_len, n * ref_len, cfg) is None


# The port's entry point (``python -m phylonium_tpu_torch``, by runpy) with
# one card faked: the CUDA driver's count patched to one; with argv[2] "1"
# the client also takes the card for the CPU daemon's device, so that a
# ``--device cuda`` run reaches the module's CPU daemon. What the run
# loaded goes to argv[1] before the entry point's torch guard and exit.
_CARD_CHILD = """
import json, runpy, sys
report, to_cpu, *args = sys.argv[1:]
sys.argv = ["phylonium_tpu_torch", *args]
import phylonium_tpu_torch.cli as cli
from phylonium_tpu_torch.serve import client
from phylonium_tpu_torch.utils import platform
platform.cuda_device_count = lambda: 1
if to_cpu == "1":
    client.device_name = lambda device: "cpu"
main = cli.main
def recorded(argv=None):
    rc = main(argv)
    from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO
    torch = sys.modules.get("torch")
    with open(report, "w") as f:
        json.dump({"rc": rc, "torch": torch is not None, "info": LAST_RUN_INFO}, f)
    return rc
cli.main = recorded
runpy.run_module("phylonium_tpu_torch", run_name="__main__", alter_sys=True)
"""


def _card_run(files, tmp_path, sock, to_cpu: bool, store: dict):
    """One default-route CLI run of ``files`` on the faked card, in a child
    under PHYLONIUM_TPU_EXPECT_NO_TORCH, with a calibration store holding
    ``store`` and the server's socket at ``sock``."""
    path = tmp_path / "calibration.json"
    path.write_text(json.dumps(store))
    report = tmp_path / "child.json"
    env = _env(sock, HOME=str(tmp_path), PHYLONIUM_TPU_CALIBRATION_FILE=str(path),
               PHYLONIUM_TPU_EXPECT_NO_TORCH="1", PHYLONIUM_TPU_DEVD_SPAWN_WAIT="60")
    for key in ("PHYLONIUM_TPU_DEVD", "PHYLONIUM_TPU_STREAM", "PHYLONIUM_TPU_STREAM_GROUP",
                "PHYLONIUM_TPU_LOWMEM", "PHYLONIUM_TPU_DEVICE_PILEUP",
                "PHYLONIUM_TPU_AUTO_DEVICE_GBP", "PHYLONIUM_TPU_DEVD_INJECT"):
        env.pop(key, None)
    r = subprocess.run(
        [sys.executable, "-c", _CARD_CHILD, str(report), "1" if to_cpu else "0",
         "--progress=never", "--device", "cuda", *files],
        capture_output=True, cwd=tmp_path, env=env, timeout=300,
    )
    child = json.loads(report.read_text()) if report.exists() else None
    return r, child


# a copy rate, and a host compare slow enough that the measured model's
# server branch streams the small panel (its host time above the tail)
_CALIBRATED = {"link_mb_s": 1000.0, "host_compare_gbps": 0.001, "map_gbps": 0.25}


def test_a_card_run_takes_the_server_by_default(module_daemon, tmp_path):
    """No routing variable, one card, a calibrated store: the run streams
    through the server, imports no torch and makes no context, and prints
    the JAX CLI's bytes."""
    files = write_fasta_panel(tmp_path, 10, 2500, seed=61)
    r, child = _card_run(files, tmp_path, module_daemon, True, _CALIBRATED)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert child["rc"] == 0 and child["torch"] is False
    info = child["info"]
    assert info["calibration"]["link_mb_s"] == 1000.0
    assert info["stream_model"]["devd"] is True
    assert info["cuda_initialized"] is False and "prewarm" not in info
    groups = info["stream_groups"]
    assert groups == 2 and info["early_ship"]["taken"] == groups
    assert info["devd"]["socket"] == module_daemon
    assert info["devd"]["launches"] == {"build": 0, "build_plain": groups, "count": 0,
                                        "count_plain": 1}
    assert info["kernel_launches"] == info["plain_calls"] == 0
    assert info["build_kernel_launches"] == info["build_plain_calls"] == 0
    assert r.stdout.decode() == _jax_run(files)


@pytest.mark.parametrize("fault", ["socket directory", "daemon exits"])
def test_a_daemon_that_cannot_start_fails_the_run(fault, tmp_path):
    """The default route on the faked card where no daemon comes up: the
    socket's directory cannot be made (a file stands in its place), or the
    daemon it spawns finds no card and exits. Exit 1, no matrix, nothing
    run in process, and the message names the socket, the daemon's log
    and PHYLONIUM_TPU_DEVD=0."""
    files = write_fasta_panel(tmp_path, 10, 2500, seed=67)
    if fault == "socket directory":
        (tmp_path / "taken").write_text("a file, not a directory")
        sock = str(tmp_path / "taken" / "d.sock")
    else:
        sock = str(tmp_path / "devd" / "d.sock")
    r, child = _card_run(files, tmp_path, sock, False, _CALIBRATED)
    err = r.stderr.decode()
    assert r.returncode == 1 and r.stdout == b"", err[-2000:]
    assert child["rc"] == 1 and child["torch"] is False and "devd" not in child["info"]
    start = f"phylonium-tpu-torch: device server at {sock}: "
    assert start in err
    message = err[err.index(start):].strip()  # the log's tail may span lines
    assert f"the daemon's log {sock}.log ends: " in message
    assert message.endswith("PHYLONIUM_TPU_DEVD=0 runs the device work in this process")
    if fault == "daemon exits":
        assert "the spawned daemon exited with 1" in message
        assert "finds no CUDA device" in message  # the log's tail
        assert not os.path.exists(sock) and not os.path.exists(sock + ".pid")
    else:
        assert "no daemon could be spawned" in message


# -- the stream model's server branch against the JAX one ---------------------


@pytest.mark.parametrize("n,ref_len,link,host", [
    (29, 5_000_000, 40_000.0, 60.9), (116, 5_000_000, 9_000.0, 165.0),
    (3, 100_000, 40_000.0, 60.9), (3, 1_000, 1.0, 1e5), (600, 1_000_000, None, 60.9),
    (2, 10, 5.0, 0.001), (1000, 5_000_000, 0.5, 3.0),
])
def test_stream_predicts_win_devd_branch_equals_the_jax(n, ref_len, link, host,
                                                        tmp_path, monkeypatch):
    import phylonium_tpu.core.pipeline as jax_pipeline
    import phylonium_tpu.utils.platform as jax_platform
    from phylonium_tpu.config import RunConfig
    from phylonium_tpu_torch.config import TorchRunConfig
    from phylonium_tpu_torch.core import pipeline

    for key in ("PHYLONIUM_TPU_AUTO_DEVICE_GBP", "PHYLONIUM_TPU_STREAM"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "1")
    monkeypatch.setattr(jax_platform, "cpu_pinned", lambda: False)
    monkeypatch.setattr(pipeline, "_DEVD_TAIL_S", jax_pipeline._DEVICE_TAIL_S)
    path = tmp_path / "calibration.json"
    data = {"host_compare_gbps": host}
    if link is not None:
        data["link_mb_s"] = link
    path.write_text(json.dumps(data))
    monkeypatch.setenv("PHYLONIUM_TPU_CALIBRATION_FILE", str(path))
    ours = pipeline._stream_predicts_win(n, ref_len, TorchRunConfig(device="cuda"))
    ours_model = dict(pipeline.LAST_RUN_INFO.get("stream_model", {}))
    theirs = jax_pipeline._stream_predicts_win(n, ref_len, RunConfig())
    assert ours == theirs
    if link is not None:
        assert ours_model == jax_pipeline.LAST_RUN_INFO["stream_model"]
        assert ours_model["devd"] is True
