"""The device-server daemon: one resident process on one device, many CLI runs.

The port of the JAX package's ``phylonium_tpu/serve/daemon.py``. Run as
``python -m phylonium_tpu_torch.serve --device cuda|cpu`` (default
``cuda``). It binds a unix socket (default
``~/.cache/phylonium_tpu_torch/devd-<device>.sock``, override
``PHYLONIUM_TPU_DEVD_SOCK``; never the JAX daemon's socket, whose
protocol check would replace this daemon and the other way round), makes
its CUDA context and loads the kernel library in the background, and
serves:

    ping                                 -> {ok, warm, device, pid, protocol,
                                             poisoned, qcache_mb, qcache_groups,
                                             launches, memory_reserved}
    probe   {mb, seed}                   -> {ok, seconds, mb_s}: one copy of
                                             ``mb`` random MB to the device,
                                             timed with CUDA events
    qhave   {run, gidx, key}             -> {ok, have}: a content-cache hit
                                             binds the cached words to the
                                             run's piece ``gidx``, 0 bytes
                                             shipped
    qgroup  {run, gidx, key} + [words]   -> {ok, seconds}: the piece's 2-bit
                                             words copied to the device; the
                                             reply follows the copy's event
    group   {run, gen, lo, rows, n, ref_len, gidx?}
            + [intervals, offsets, cols, vals] (+ [words] without gidx)
                                         -> {ok}: queues the build of
                                             rows [lo, lo + rows) of the run's
                                             [n, W] panel (the pileup-build
                                             kernel into the pass's
                                             ``ops.pileup_device.DevicePanel``);
                                             words that come with the group
                                             are resident before the reply,
                                             the build is not
    finish  {run, gen, n}                -> {ok, seconds, launches,
                                             memory_reserved, pid, device,
                                             rss?, spans?, spans_dropped?}
                                             + [subs, homs]: joins the build
                                             queue, waits on the builds'
                                             events, counts the panel
                                             (``ops.pair_count``); ``seconds``
                                             is the count's, ``rss`` this
                                             process's memory then
    cancel  {run}                        -> {ok}: drops the run's queued builds

The JAX daemon's ``prewarm`` op is not carried: its one caller there is
the drain that follows the compare race, which the port leaves out
(core/pipeline.py); this daemon warms its context and kernel library
once, at start.

Threads: the accept loop serves each connection on a thread of its own,
so control ops (ping, qhave, cancel) answer while another connection's
request runs. Each run has
one build thread. All copies share one CUDA stream and all builds
another (``_State.streams``): the caching allocator reuses a freed block
only on the stream it was made on, so streams made per run or per
connection would leave each run's panel reserved for good. ``_State.lock`` guards the
run table and the content cache, and is held only for their lookups and
updates, never across a copy, a build or a count; ``kernel_lock``
serializes the kernel launches, so that each run's launch counts are
exact. CUDA's current device is a thread's own: every thread sets the
daemon's device first.

A run's state lives until its client's connection closes, so a crashed
CLI can never leak a panel into the next run; the content cache
(``PHYLONIUM_TPU_DEVD_CACHE_MB``, default 4096, least recently used out
first) lives as long as the daemon, so the same piece of genomes (a
re-run of a panel, the second pass of ``-2``) is copied once. A ``-2``
second pass keeps its run id, whose pieces stay resident, and sends a
new generation: its first ``group`` starts a fresh panel, and the build
thread drops every queued item of another generation. A build failure
surfaces at ``finish``; a failed op answers ``{ok: false, error}``. An
error that leaves the CUDA context unusable for the rest of the process
(``_POISON_MARKS``) marks the daemon poisoned: it tells the client, which
retires it, and exits. It also exits after
``PHYLONIUM_TPU_DEVD_IDLE_S`` idle seconds (default 1800), and on
SIGTERM, removing its socket and pidfile.

Spans (utils/profile.py, on the host's wall clock, which the client
shares): a request whose header carries the client's span id (``span``)
is recorded as a ``devd.<op>`` span under it, into its run's bounded list
(``SPAN_CAP``; the rest are counted), with ``devd.copy`` for each
host-to-device copy and its ``pin_memory`` (``attrs.bytes``),
``devd.build`` on the build thread for each queued build (under the
``devd.group`` that queued it; ``attrs.queued_s``), and
``devd.finish.join`` (the wait for the build queue) and ``devd.count``
(the events' wait, the count, the results to the host) inside
``devd.finish``. The ``finish`` reply carries the run's spans so far and
clears them, and ``rss``: ``VmRSS``, ``RssAnon`` and ``RssFile`` in MB,
read in a ``devd.rss`` span. A request without a span id records
nothing, and its ``finish`` reply has neither.

On ``--device cpu`` the builds and counts run the kernels' plain
versions, as the in-process route does there; on a card the kernels
launch, with no fallback. ``PHYLONIUM_TPU_DEVD_INJECT`` injects faults
for the tests: ``poison`` (``probe`` and ``finish`` fail as an illegal
memory access does), ``slow_build`` (each build waits 3 s first) and
``kill_after_group`` (the daemon SIGKILLs itself after its first
``group`` reply).
"""

from __future__ import annotations

import os
import queue
import re
import signal
import socket
import sys
import threading
import time
import traceback

import numpy as np
import torch

from phylonium_tpu_torch.config import ConfigError
from phylonium_tpu_torch.ops import _build, pair_count, pileup_device
from phylonium_tpu_torch.ops.states import to_device
# PROTOCOL and sock_path live in wire.py, which the CLI's client imports
# without torch; re-exported here, where they were first defined
from phylonium_tpu_torch.serve.wire import (  # noqa: F401
    PROTOCOL,
    WireError,
    recv_msg,
    send_msg,
    sock_path,
)
from phylonium_tpu_torch.utils import profile
from phylonium_tpu_torch.utils.platform import resolve_device

# CUDA errors after which the context is unusable for the rest of the
# process: every later op would fail the same way until the idle timeout
_POISON_MARKS = (
    "illegal memory access",
    "unspecified launch failure",
    "device-side assert",
    "misaligned address",
    "illegal instruction",
)

_INJECTED_POISON = "CUDA error: an illegal memory access was encountered (injected fault)"

# the accept loop's tick: how soon a poisoned or idle daemon notices
_ACCEPT_TICK_S = 1.0

# the most spans a run keeps between two finish replies (a run of 563
# genomes records about 30)
SPAN_CAP = 4096


def _is_poison(err: str) -> bool:
    low = err.lower()
    return any(m in low for m in _POISON_MARKS)


def _inject() -> str:
    return os.environ.get("PHYLONIUM_TPU_DEVD_INJECT", "")


class _Pass:
    """One generation of a run: its panel, made and built by the run's
    thread."""

    def __init__(self, gen, n: int, ref_len: int):
        self.gen = gen
        self.n = n
        self.ref_len = ref_len
        self.panel: pileup_device.DevicePanel | None = None
        self.error: str | None = None
        self.cancelled = False


class _Run:
    """A run's pieces (gidx -> words on the device) and its current pass."""

    def __init__(self):
        self.groups: dict = {}
        self.gen = None
        self.current: _Pass | None = None
        self.queue: queue.Queue | None = None
        self.closed = False
        self.spans = profile.Recorder("devd", cap=SPAN_CAP)


class _State:
    def __init__(self, device: torch.device):
        self.device = device
        self.warm = False
        self.poisoned: str | None = None
        self.lock = threading.Lock()  # runs and qcache
        self.kernel_lock = threading.Lock()
        self.runs: dict[str, _Run] = {}
        # content-addressed pieces across connections: key -> (words, nbytes)
        self.qcache: dict = {}
        self.qcache_bytes = 0
        self.qcache_cap = int(
            float(os.environ.get("PHYLONIUM_TPU_DEVD_CACHE_MB", 4096)) * 1e6
        )
        self._streams: dict = {}

    def stream(self, name: str):
        """The daemon's one CUDA stream for ``name`` ('copy' or 'build')."""
        with self.lock:
            if name not in self._streams:
                self._streams[name] = torch.cuda.Stream(self.device)
            return self._streams[name]

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def enter_thread(self) -> None:
        """Make the daemon's device this thread's current device."""
        if self.cuda:
            torch.cuda.set_device(self.device)

    def run(self, run: str) -> _Run:
        with self.lock:
            return self.runs.setdefault(run, _Run())

    def qcache_put(self, key: str, words, nbytes: int) -> None:
        with self.lock:
            if key in self.qcache:
                return
            while self.qcache and self.qcache_bytes + nbytes > self.qcache_cap:
                old = next(iter(self.qcache))
                self.qcache_bytes -= self.qcache.pop(old)[1]
            self.qcache[key] = (words, nbytes)
            self.qcache_bytes += nbytes

    def qcache_get(self, key: str):
        with self.lock:
            hit = self.qcache.pop(key, None)
            if hit is not None:
                self.qcache[key] = hit  # most recently used last
            return hit

    def poison(self, err: str, where: str) -> None:
        if _is_poison(err) and self.poisoned is None:
            self.poisoned = err[:300]
            sys.stderr.write(f"devd: context poisoned ({where}), exiting: {err}\n")

    def memory_reserved(self) -> int:
        return torch.cuda.memory_reserved(self.device) if self.cuda else 0

    def launches(self) -> dict:
        """The process's launches and plain calls of the two kernels."""
        return {
            "build": pileup_device.KERNEL_LAUNCHES,
            "build_plain": pileup_device.PLAIN_CALLS,
            "count": pair_count.KERNEL_LAUNCHES,
            "count_plain": pair_count.PLAIN_CALLS,
        }

    def copy(self, array: np.ndarray):
        """``ops.states.to_device``'s timed copy on the copy stream, in a
        ``devd.copy`` span: (tensor, seconds, event), resident on return;
        on the CPU (host tensor, None, None), with no span."""
        if not self.cuda:
            return to_device(array, self.device, timed=True)
        with profile.span("devd.copy", attrs={"bytes": array.nbytes}):
            return to_device(array, self.device, self.stream("copy"), timed=True)


def _rss_mb() -> dict:
    """This process's resident memory now, in MB: ``VmRSS``, and of it
    ``RssAnon`` and ``RssFile`` (/proc/self/status). Where the status has
    no such split (gVisor's), the sums of ``Anonymous`` and of ``Rss``
    less ``Anonymous`` over /proc/self/smaps; empty where neither file
    says."""
    kb = {}
    try:
        with open("/proc/self/status", "rb") as f:
            for name, value in re.findall(rb"^(VmRSS|RssAnon|RssFile):\s+(\d+)", f.read(),
                                          re.M):
                kb[name.decode()] = int(value)
        if "VmRSS" in kb and "RssAnon" not in kb:
            with open("/proc/self/smaps", "rb") as f:
                smaps = f.read()
            rss = sum(map(int, re.findall(rb"^Rss:\s+(\d+)", smaps, re.M)))
            kb["RssAnon"] = sum(map(int, re.findall(rb"^Anonymous:\s+(\d+)", smaps, re.M)))
            kb["RssFile"] = rss - kb["RssAnon"]
    except OSError:
        pass
    names = {"VmRSS": "rss_mb", "RssAnon": "anon_mb", "RssFile": "file_mb"}
    return {names[k]: v * 1024 / 1e6 for k, v in kb.items()}


def _build_one(state: _State, run: _Run, stream, item) -> None:
    header, arrays, words = item
    p: _Pass = header["pass"]
    if words is None:
        with state.lock:
            words = run.groups[int(header["gidx"])]
    if p.panel is None:
        # allocated on the build stream, whose pool every run's panel reuses
        with torch.cuda.stream(stream):
            p.panel = pileup_device.DevicePanel(
                p.n, p.ref_len, state.device, stream=stream, lock=state.kernel_lock,
                copy_span="devd.copy",
            )
    p.panel.build(int(header["lo"]), words, arrays)


def _builder(state: _State, run: _Run) -> queue.Queue:
    """The run's build queue, with its thread (started at the first group).

    The thread drops an item whose generation is not the run's current one
    (a stale pass-1 build after pass 2 began), an item of a cancelled or
    failed pass, and everything once the run's connection closed."""
    if run.queue is not None:
        return run.queue
    run.queue = q = queue.Queue()

    def work():
        stream = None
        try:
            state.enter_thread()
            if state.cuda:
                stream = state.stream("build")
        except Exception as e:  # noqa: BLE001 — each item then fails at finish
            setup_error = repr(e)[:500]
        else:
            setup_error = None
        while True:
            item = q.get()
            try:
                if item is None:
                    return
                p: _Pass = item[0]["pass"]
                if (run.closed or item[0]["gen"] != run.gen or p.cancelled
                        or p.error is not None):
                    continue
                if setup_error is not None:
                    p.error = setup_error
                    continue
                cause, queued = item[0]["cause"]
                with profile.recording(run.spans if cause is not None else None), \
                        profile.span("devd.build", cause, {
                            "lo": item[0]["lo"], "queued": True,
                            "queued_s": (time.time_ns() - queued) / 1e9}):
                    if _inject() == "slow_build":
                        time.sleep(3.0)
                    _build_one(state, run, stream, item)
            except Exception as e:  # noqa: BLE001 — raised at finish
                err = repr(e)[:500]
                item[0]["pass"].error = err
                state.poison(err, "build")
            finally:
                q.task_done()

    threading.Thread(target=work, daemon=True, name="devd-build").start()
    return q


def _warmup(state: _State) -> None:
    """The CUDA context and the kernel library, before the first request."""
    try:
        state.enter_thread()
        if state.cuda:
            torch.empty(1, device=state.device)
            _build.load()
        state.warm = True
    except Exception as e:  # noqa: BLE001 — the daemon stays up, unwarm
        sys.stderr.write(f"devd: warmup failed: {e!r}\n")
        state.poison(repr(e), "warmup")


def _handle(state: _State, header: dict, arrays: list):
    """One request -> (reply header, reply arrays)."""
    op = header.get("op")
    if op == "ping":
        with state.lock:
            qcache_mb, qcache_groups = round(state.qcache_bytes / 1e6, 1), len(state.qcache)
        return {
            "ok": True, "warm": state.warm, "device": str(state.device),
            "pid": os.getpid(), "protocol": PROTOCOL, "poisoned": state.poisoned,
            "qcache_mb": qcache_mb, "qcache_groups": qcache_groups,
            "launches": state.launches(), "memory_reserved": state.memory_reserved(),
        }, []

    if state.poisoned:
        # the context can never heal in this process: every device op gets
        # the poison, so the client retires this daemon
        return {"ok": False, "error": state.poisoned, "poisoned": True}, []

    if op == "probe":
        if _inject() == "poison":
            raise RuntimeError(_INJECTED_POISON)
        mb = int(header.get("mb", 16))
        rng = np.random.default_rng(int(header.get("seed", 0)))
        data = rng.integers(0, 256, mb << 20).astype(np.uint8)
        t0 = time.perf_counter()
        seconds = state.copy(data)[1]
        if seconds is None:
            seconds = time.perf_counter() - t0
        return {"ok": True, "seconds": seconds,
                "mb_s": round(mb / seconds, 2) if seconds > 0 else None}, []

    if op == "qhave":
        hit = state.qcache_get(header["key"]) if header.get("key") else None
        if hit is None:
            return {"ok": True, "have": False}, []
        run = state.run(header["run"])
        with state.lock:
            run.groups[int(header["gidx"])] = hit[0]
        return {"ok": True, "have": True}, []

    if op == "qgroup":
        (packed,) = arrays
        words, seconds, _ = state.copy(packed)
        run = state.run(header["run"])
        with state.lock:
            run.groups[int(header["gidx"])] = words
        if header.get("key"):
            state.qcache_put(header["key"], words, packed.nbytes)
        return {"ok": True, "seconds": seconds}, []

    if op == "group":
        run = state.run(header["run"])
        gen = header.get("gen")
        if run.current is None or gen != run.gen:
            # a new generation (the second pass of -2) starts a fresh panel
            run.gen = gen
            run.current = _Pass(gen, int(header["n"]), int(header["ref_len"]))
        p = run.current
        if int(header["ref_len"]) != p.ref_len or int(header["n"]) != p.n:
            return {"ok": False, "error": (
                f"group of run {header['run']} for a {header['n']} x "
                f"{header['ref_len']} panel, but its pass builds {p.n} x {p.ref_len}")}, []
        words = None
        if header.get("gidx") is None:
            # raw codes come with the group: resident before the reply
            *arrays, packed = arrays
            words = state.copy(packed)[0]
        elif int(header["gidx"]) not in run.groups:
            return {"ok": False, "error": f"run {header['run']} holds no piece "
                                          f"{header['gidx']}"}, []
        # the build's span names this request's as its cause
        item = ({**header, "pass": p, "cause": (profile.current_id(), time.time_ns())},
                list(arrays), words)
        _builder(state, run).put(item)
        return {"ok": True}, []

    if op == "finish":
        if _inject() == "poison":
            raise RuntimeError(_INJECTED_POISON)
        with state.lock:
            run = state.runs.get(header["run"])
        p = None if run is None else run.current
        if p is None or (header.get("gen") is not None and header["gen"] != run.gen):
            return {"ok": False, "error": f"no panel for run {header['run']}"}, []
        if run.queue is not None:
            with profile.span("devd.finish.join"):
                run.queue.join()  # every queued build launched, or failed
        n = int(header["n"])
        if p.error is not None:
            run.current = None
            return {"ok": False, "error": f"group build failed: {p.error}"}, []
        built = 0 if p.panel is None else p.panel.rows_built
        if built != n or p.n != n:
            run.current = None
            return {"ok": False, "error": (
                f"run {header['run']} built {built} of {n} rows")}, []
        with profile.timed("devd.count") as count:
            subs, homs = p.panel.count()
        # the panel is consumed; the pieces stay for a later pass
        run.current = None
        return {"ok": True, "seconds": count.seconds, "launches": p.panel.launches,
                "memory_reserved": state.memory_reserved(), "pid": os.getpid(),
                "device": str(state.device)}, [subs, homs]

    if op == "cancel":
        with state.lock:
            run = state.runs.get(header.get("run"))
        if run is not None and run.current is not None:
            run.current.cancelled = True  # the build thread skips its items
            run.current = None
        return {"ok": True}, []

    return {"ok": False, "error": f"unknown op {op!r}"}, []


def _serve_conn(state: _State, conn: socket.socket, activity: dict) -> None:
    touched: set = set()  # run ids made over this connection
    try:
        state.enter_thread()
        while True:
            try:
                header, arrays = recv_msg(conn)
            except (WireError, OSError, ValueError):
                return  # the client is gone
            activity["t"] = time.time()
            run_id, cause = header.get("run"), header.get("span")
            if isinstance(run_id, str):
                touched.add(run_id)
            spans = state.run(run_id).spans if cause is not None and isinstance(
                run_id, str) else None
            reported = spans is not None and header.get("op") == "finish"
            with profile.recording(spans):
                with profile.span(f"devd.{header.get('op')}", cause):
                    try:
                        reply, out = _handle(state, header, arrays)
                    except Exception as e:  # noqa: BLE001 — the daemon stays up
                        err = repr(e)[:500]
                        reply, out = {"ok": False, "error": err}, []
                        state.poison(err, header.get("op"))
                    if reported and reply.get("ok"):
                        # the run's report holds what it replies: the memory now
                        with profile.span("devd.rss"):
                            reply["rss"] = _rss_mb()
            if reported and reply.get("ok"):
                reply["spans"], reply["spans_dropped"] = spans.take()
            if state.poisoned:
                reply.setdefault("poisoned", True)
            try:
                send_msg(conn, reply, out)
            except OSError:
                return
            if header.get("op") == "group" and _inject() == "kill_after_group":
                os.kill(os.getpid(), signal.SIGKILL)
            activity["t"] = time.time()
    finally:
        conn.close()
        for run_id in touched:  # a run's state never outlives its client
            with state.lock:
                run = state.runs.pop(run_id, None)
            if run is not None:
                run.closed = True
                if run.queue is not None:
                    run.queue.put(None)


def _owned(path: str) -> bool:
    try:
        with open(path + ".pid") as f:
            return int(f.read().strip()) == os.getpid()
    except (OSError, ValueError):
        return False


def serve(path: str | None = None, device: str = "cuda", idle_s: float | None = None) -> int:
    try:
        dev = resolve_device(device)
    except ConfigError as e:
        sys.stderr.write(f"devd: {e}\n")
        return 1
    path = path or sock_path(device)
    if idle_s is None:
        idle_s = float(os.environ.get("PHYLONIUM_TPU_DEVD_IDLE_S", 1800))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # never bind over a live daemon: that would unlink its socket and
    # orphan its warm context and content cache
    try:
        with open(path + ".pid") as f:
            other = int(f.read().strip())
        if other != os.getpid():
            os.kill(other, 0)  # raises if it is gone
            sys.stderr.write(f"devd: pid {other} already serves {path}; exiting\n")
            return 0
    except (OSError, ValueError):
        pass
    try:
        os.unlink(path)
    except OSError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    os.chmod(path, 0o600)
    # a deep backlog: clients queue while the accept loop is busy
    srv.listen(128)
    srv.settimeout(_ACCEPT_TICK_S)
    with open(path + ".pid", "w") as f:
        f.write(str(os.getpid()))
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))

    state = _State(dev)
    threading.Thread(target=_warmup, args=(state,), daemon=True).start()
    sys.stderr.write(f"devd: serving {dev} on {path} (pid {os.getpid()}, {PROTOCOL})\n")
    sys.stderr.flush()
    activity = {"t": time.time()}
    try:
        while True:
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                if state.poisoned:
                    sys.stderr.write("devd: poisoned, exiting\n")
                    return 0
                if time.time() - activity["t"] > idle_s:
                    sys.stderr.write("devd: idle timeout, exiting\n")
                    return 0
                continue
            activity["t"] = time.time()
            threading.Thread(
                target=_serve_conn, args=(state, conn, activity), daemon=True,
                name="devd-conn",
            ).start()
    finally:
        srv.close()
        if _owned(path):
            for suffix in ("", ".pid"):
                try:
                    os.unlink(path + suffix)
                except OSError:
                    pass
        if threading.current_thread() is threading.main_thread():
            # the connection and build threads may sit inside a kernel or
            # a plain version's native loop, and finalizing the interpreter
            # under them can abort the process: it ends here instead
            exc = sys.exc_info()[1]
            if exc is not None and not isinstance(exc, SystemExit):
                traceback.print_exc()
            code = 1 if exc is not None and not (isinstance(exc, SystemExit) and not exc.code) else 0
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(code)
        sys.stderr.flush()


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="python -m phylonium_tpu_torch.serve")
    parser.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu (default cuda)")
    args = parser.parse_args(argv)
    return serve(device=args.device)
