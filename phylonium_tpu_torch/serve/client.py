"""Connect-or-spawn client of the device server (serve/daemon.py).

The port of the JAX package's ``phylonium_tpu/serve/client.py``.
``get_client(device)`` hands out one process-wide client; the query
shipper and the stream feeder share its connection, and its requests
serialize under a lock. If no daemon answers on the device's socket, one
is spawned detached (``python -m phylonium_tpu_torch.serve --device
<device>``, ``start_new_session``), logging to ``<socket>.log``, and the
connect is retried while it starts. A daemon that answers ``ping`` with
another protocol, or poisoned, is replaced: its exact pid from its
pidfile is sent SIGTERM, never a pattern kill. A daemon on another device
than the run's is refused.

Every failure raises :class:`DevdError` with the socket's path and the
daemon's error: an unreachable server, a refused protocol, a wrong
device, poison, a failed build, a timeout. Where no daemon comes up (its
socket's directory cannot be made, the daemon exits at start or never
answers), the error also quotes the tail of the daemon's log and names
``PHYLONIUM_TPU_DEVD=0``, which runs the device work in process. The run
fails with it; no caller retries in process or on the host.

Every request is a ``devd.<op>`` span (utils/profile.py) on the calling
thread, with its wait for the one connection's lock in
``attrs.lock_wait_s``, and the first connect a ``devd.connect`` span
(``attrs.spawned``: whether it spawned the daemon and waited for it).

Like the JAX client, this module imports numpy only, never torch: the CLI
process of a device-server run makes no tensor.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np

from phylonium_tpu_torch.config import ConfigError
from phylonium_tpu_torch.serve.wire import PROTOCOL, recv_msg, send_msg, sock_path
from phylonium_tpu_torch.utils import profile
from phylonium_tpu_torch.utils.platform import device_type, parse_device


class DevdError(RuntimeError):
    pass


def devd_enabled(device) -> bool:
    """Does this run's streamed and low-memory device work go through the
    device server?

    The JAX package's gate (phylonium_tpu/serve/client.py:36-51),
    condition for condition. ``PHYLONIUM_TPU_DEVD=0`` keeps the work in
    this process; ``=1`` sends it to the server on any device, CPU runs
    included (the tests); otherwise the server takes it exactly where
    ``device`` is a CUDA card (the JAX ``not cpu_pinned()``) and the run
    is a world of one rank (the JAX ``not _is_multiprocess()``). The
    server keeps the card's context, its kernel library and the genomes
    it was sent across runs, so such a run never imports torch, while an
    in-process run waits seconds for torch's import and the context. A
    world of several ranks keeps each rank's cell on its own rank: off by
    default, and ``=1`` there raises ConfigError.
    """
    env = os.environ.get("PHYLONIUM_TPU_DEVD", "")
    if env == "0":
        return False
    from phylonium_tpu_torch.parallel.multihost import world

    several = world()[0] > 1
    if env == "1":
        if several:
            raise ConfigError(
                "PHYLONIUM_TPU_DEVD=1 asks for the device server, but this is a "
                "world of several ranks, whose cells stay each on its own rank; "
                "unset PHYLONIUM_TPU_DEVD"
            )
        return True
    return not several and device_type(device) == "cuda"


def device_name(device) -> str:
    """The daemon's name for ``device``: a bare ``cuda`` is ``cuda:0``,
    the device a fresh daemon resolves it to."""
    dev = parse_device(device)
    if dev.type == "cuda" and dev.index is None:
        return "cuda:0"
    return str(dev)


class DevdClient:
    def __init__(self, path: str | None = None, spawn: bool = True, device: str = "cuda"):
        self.device = str(device)
        self.path = path or sock_path(self.device)
        self._lock = threading.Lock()
        self.pid: int | None = None
        self._spawned: subprocess.Popen | None = None
        with profile.span("devd.connect") as connect:
            self._sock = self._connect(spawn)
            connect.note("spawned", self._spawned is not None)

    def _error(self, msg: str) -> DevdError:
        return DevdError(f"device server at {self.path}: {msg}")

    def _try_connect(self, timeout: float):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)
        try:
            s.connect(self.path)
        except OSError:
            s.close()
            raise
        return s

    def _pidfile_alive(self) -> int | None:
        try:
            with open(self.path + ".pid") as f:
                pid = int(f.read().strip())
            os.kill(pid, 0)
            return pid
        except (OSError, ValueError):
            return None

    def _hello(self, sock) -> dict | None:
        """The daemon's ping reply; None when it does not answer in time
        (busy is not stale: the requests decide)."""
        try:
            sock.settimeout(10.0)
            send_msg(sock, {"op": "ping"})
            reply, _ = recv_msg(sock)
            return reply
        except OSError:
            return None

    @staticmethod
    def _protocol_ok(reply: dict | None) -> bool:
        """This tree's protocol and a healthy context; a daemon too busy
        to answer passes (the requests decide)."""
        return reply is None or (
            not reply.get("poisoned") and reply.get("protocol") == PROTOCOL
        )

    def _accept(self, sock, reply: dict | None):
        """Hold a connected daemon to the run's device; return the socket."""
        if reply is not None:
            self.pid = reply.get("pid")
            theirs, ours = reply.get("device"), device_name(self.device)
            if theirs != ours:
                sock.close()
                raise self._error(
                    f"the daemon serves device {theirs}, but this run asks for "
                    f"{ours}; stop it or set PHYLONIUM_TPU_DEVD_SOCK"
                )
        return sock

    def _connect(self, spawn: bool):
        try:
            sock = self._try_connect(2.0)
        except OSError:
            if not spawn:
                raise self._error("no device server answers")
            sock = None
        if sock is not None:
            reply = self._hello(sock)
            if not spawn or self._protocol_ok(reply):
                return self._accept(sock, reply)
            # another tree's daemon, or a poisoned one: replace it
            sock.close()
            self._kill_stale()
        wait = float(os.environ.get("PHYLONIUM_TPU_DEVD_SPAWN_WAIT", 60.0))
        deadline = time.monotonic() + wait
        # spawn only when no live daemon owns the socket: one still
        # starting is waited for, never replaced
        proc = None
        if self._pidfile_alive() is None:
            try:
                proc = self.spawn_daemon()
            except OSError as e:
                raise self._not_up(f"no daemon could be spawned: {e}") from e
        last: Exception | None = None
        while time.monotonic() < deadline:
            try:
                sock = self._try_connect(2.0)
            except OSError as e:
                last = e
                if proc is not None and proc.poll() is not None:
                    raise self._not_up(f"the spawned daemon exited with {proc.returncode}")
                time.sleep(0.1)
                continue
            reply = self._hello(sock)
            if reply is not None and reply.get("protocol") != PROTOCOL:
                sock.close()
                raise self._error(
                    f"refused protocol {reply.get('protocol')!r} (this tree "
                    f"speaks {PROTOCOL!r})"
                )
            return self._accept(sock, reply)
        raise self._not_up(f"did not come up within {wait:.0f} s: {last!r}")

    def _not_up(self, msg: str) -> DevdError:
        """No daemon serves the socket: the error names the daemon's log
        and its tail, and the way to run without a server."""
        return self._error(
            f"{msg}; the daemon's log {self.path}.log ends: {self._log_tail()}; "
            "PHYLONIUM_TPU_DEVD=0 runs the device work in this process"
        )

    def _log_tail(self) -> str:
        try:
            with open(self.path + ".log", "rb") as f:
                return f.read()[-1500:].decode(errors="replace").strip()
        except OSError:
            return "(no log)"

    def _kill_stale(self) -> None:
        try:
            with open(self.path + ".pid") as f:
                pid = int(f.read().strip())
            os.kill(pid, signal.SIGTERM)
            if self._spawned is not None and self._spawned.pid == pid:
                self._spawned.wait(5.0)  # this process's child: reap it
            else:
                for _ in range(50):
                    os.kill(pid, 0)
                    time.sleep(0.1)
        except (OSError, ValueError, subprocess.TimeoutExpired):
            pass
        for suffix in ("", ".pid"):
            try:
                os.unlink(self.path + suffix)
            except OSError:
                pass

    def spawn_daemon(self) -> subprocess.Popen:
        env = dict(os.environ)
        repo = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        env["PHYLONIUM_TPU_DEVD_SOCK"] = self.path
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path + ".log", "ab") as log:
            self._spawned = subprocess.Popen(
                [sys.executable, "-m", "phylonium_tpu_torch.serve", "--device", self.device],
                stdout=log, stderr=log, stdin=subprocess.DEVNULL,
                start_new_session=True, env=env,
            )
        return self._spawned

    def request(self, header: dict, arrays=(), timeout: float = 900.0
                ) -> tuple[dict, list[np.ndarray]]:
        """One request and its reply, within ``timeout`` seconds from now:
        the wait for the connection's lock and the socket's share one
        deadline. It is a ``devd.<op>`` span, with the lock's wait in
        ``attrs.lock_wait_s``; where the span is recorded, the header
        carries its id (``span``), under which the server records its own
        spans of the request."""
        with profile.timed(f"devd.{header.get('op')}") as span:
            if span.id is not None:
                header = {**header, "span": span.id}
            deadline = time.monotonic() + timeout
            if not self._lock.acquire(timeout=max(timeout, 0.0)):
                raise self._error(f"busy: the connection was not free within {timeout:.1f} s")
            span.note("lock_wait_s", span.elapsed())
            try:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise self._error(
                        f"{header.get('op')}: no time left of {timeout:.1f} s after the "
                        "wait for the connection"
                    )
                try:
                    if self._sock is None:
                        self._sock = self._try_connect(min(2.0, left))
                    self._sock.settimeout(left)
                    send_msg(self._sock, header, arrays)
                    reply, out = recv_msg(self._sock)
                except OSError as e:
                    # the connection is out of step now (a timed-out request's
                    # reply may still come): drop it, the next request reconnects
                    if self._sock is not None:
                        self._sock.close()
                        self._sock = None
                    raise self._error(f"{header.get('op')}: i/o failed: {e!r}") from e
            finally:
                self._lock.release()
        if not reply.get("ok"):
            if reply.get("poisoned"):
                # the daemon's context can never heal: retire it now, so
                # that the next run spawns a fresh one
                self._kill_stale()
                raise self._error(
                    f"poisoned, retired: {reply.get('error', 'request failed')}"
                )
            raise self._error(f"{header.get('op')}: {reply.get('error', 'request failed')}")
        return reply, out

    def ping(self, timeout: float = 5.0) -> dict:
        reply, _ = self.request({"op": "ping"}, timeout=timeout)
        return reply

    def close(self) -> None:
        if self._sock is None:
            return
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = None


_client: DevdClient | None = None
_client_lock = threading.Lock()


def get_client(device: str = "cuda") -> DevdClient:
    """The process-wide shared client of ``device``'s server (connect or
    spawn on first use; a new one when the socket or device changed)."""
    global _client
    with _client_lock:
        stale = _client is not None and (
            _client.path != sock_path(str(device)) or _client.device != str(device)
        )
        if stale:
            _client.close()
            _client = None
        if _client is None:
            _client = DevdClient(device=str(device))
        return _client
