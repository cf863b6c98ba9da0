"""The benchmark of ``phylonium_tpu_torch``: one cell, run once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``workloads`` in ``BENCHMARK.json`` at the checkout's root) names
a configuration (a panel shape, ``portbench/configs/<name>.json``) and a
traffic mix (``portbench/traffic/<name>.json``: the calibration store's
and the device server's state, the warm-up runs, the flags). A per-layer
metric ``m`` is read by ``portbench/metrics/m.py``'s ``read(run)``, which
returns nothing where it finds nothing to read. A new cell, mix or metric
is a new file and an entry in ``BENCHMARK.json``; this file needs no edit.

The run:

1. set-up (``setup_s``): the panel from ``--seed`` as FASTA files under
   ``$TMPDIR/portbench``; the card's check (``torch.cuda`` in a child
   process, beside the panel); the calibration store and the device
   server's socket under the same directory, every other inherited
   ``PHYLONIUM_TPU_*`` variable cleared; the store taught a copy rate the
   way a card user's installation learns it (the cell's own first run, or
   the traffic's learning panel where the cell's panel lies below the
   static rule, with the server it spawned stopped after it); for a warm
   server, the server started on the run's socket; the traffic's warm-up
   runs;
2. the window: whole CLI runs back to back, each a fresh process through
   the entry point (``python -m phylonium_tpu_torch <files>``, in the
   copied child wrapper), while ``--seconds`` have not elapsed; between
   runs only what the traffic says (the new genomes of a panel that turns
   over written, the server stopped for a cold run), timed apart.
   ``matrix_s`` is the mean wall, spawn to exit; ``peak_rss_mb`` the
   highest, over the runs, of the CLI's ``ru_maxrss`` plus the server's
   peak ``VmRSS`` while that run lasted;
3. after the window: the card's peak memory, every server stopped (its
   whole process group), then the plain reference (``reference.py``) from
   the same files, and every window run's matrix held against its own
   panel's answer:
   ``correct`` when each run exited as the reference says and printed
   every cell as it prints it; last, the check that this process holds no
   JAX module (nor the JAX package).

With ``--trace 1`` the harness starts the server itself inside
``torch.profiler`` (``child.DEVD_TRACE``) and reports the per-layer
metrics, the card's busy time and the breakdown instead.

The result is the last line of stdout; everything else goes to stderr,
which ends with each compared number beside its limit.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import traceback  # noqa: E402

from traces import (  # noqa: E402
    HBM_BYTES_S,
    INT8_OPS_S,
    busy,
    device_ops,
    idle_gaps,
    server_kernels,
)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "phylonium_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "phylonium_tpu")
SOCKET_MAX = 107
CLI_TIMEOUT_S = 300
STOP_WAIT_S = 120


class BenchError(RuntimeError):
    """The run cannot go on: it prints no result and exits 1."""


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(root: str, name: str) -> tuple[dict, dict, dict]:
    """(workload, configuration, traffic) of the cell ``name``."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(root, "portbench", "traffic", cell["traffic"] + ".json"))
    return {**cell, "bench": bench}, config, traffic


def become_subreaper() -> None:
    """Orphans (a server spawned by a CLI run that has exited) become
    this process's children, so that stopping one can wait for it."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)  # PR_SET_CHILD_SUBREAPER
    except (OSError, AttributeError):
        pass


def pid_alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def reap(pid: int) -> None:
    try:
        os.waitpid(pid, os.WNOHANG)
    except ChildProcessError:
        pass


def resident_kb(pid: int) -> int:
    """A process's resident memory now (``VmRSS``, kB), 0 when it is gone.
    Not ``VmHWM``: that is the peak of the process's whole life, which a
    server that outlives a run carries into the next."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except (OSError, ValueError):
        pass
    return 0


class ServerWatch:
    """The live server's resident memory, sampled every 20 ms: ``begin()``
    starts one CLI run's reading and ``read()`` gives its peak since, so
    that what a server held before the run (set-up's, an earlier run's)
    does not count."""

    def __init__(self, servers: "Servers"):
        self.servers, self.peak = servers, 0
        self.lock = threading.Lock()
        self.stopping = threading.Event()
        self.thread = threading.Thread(target=self._watch, daemon=True)
        self.thread.start()

    def _sample(self) -> int:
        pid = self.servers.current()
        now = resident_kb(pid) if pid is not None else 0
        with self.lock:
            self.peak = max(self.peak, now)
            return self.peak

    def _watch(self) -> None:
        while not self.stopping.wait(0.02):
            self._sample()

    def begin(self) -> None:
        with self.lock:
            self.peak = 0
        self._sample()

    def read(self) -> int:
        return self._sample()

    def stop(self) -> None:
        self.stopping.set()
        self.thread.join()


class Spawner:
    """The small process that starts every CLI child (``child.SPAWNER``)."""

    def __init__(self):
        from child import SPAWNER

        self.proc = subprocess.Popen([sys.executable, "-c", SPAWNER], stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, text=True)

    def run(self, spec: dict) -> dict:
        self.proc.stdin.write(json.dumps(spec) + "\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line:
            raise BenchError("the spawner died")
        return json.loads(line)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


class Servers:
    """The device servers of one run's socket: the ones the CLI spawned
    (found by its pidfile and the log the spawns append to) and the traced
    ones this harness starts."""

    def __init__(self, sock: str, env: dict, device: str, trace_dir: str | None):
        self.sock, self.env, self.device, self.trace_dir = sock, env, device, trace_dir
        self.started: list[subprocess.Popen] = []

    def pids(self) -> set[int]:
        found = {p.pid for p in self.started}
        try:
            with open(self.sock + ".pid") as f:
                found.add(int(f.read().strip()))
        except (OSError, ValueError):
            pass
        try:
            with open(self.sock + ".log") as f:
                found |= {int(m) for m in re.findall(r"devd: serving .* \(pid (\d+),", f.read())}
        except OSError:
            pass
        return found

    def current(self) -> int | None:
        try:
            with open(self.sock + ".pid") as f:
                pid = int(f.read().strip())
        except (OSError, ValueError):
            return None
        return pid if pid_alive(pid) else None

    def start(self, wait: bool) -> None:
        """A server on the run's socket, inside the profiler where the run
        is traced, else as the CLI spawns one. Its pidfile is written at
        once, so that a CLI run that comes before the socket waits for
        this server instead of spawning its own."""
        from child import DEVD_TRACE

        if self.trace_dir:
            out = os.path.join(self.trace_dir, f"devd{len(self.started)}")
            argv = [sys.executable, "-c", DEVD_TRACE, out, self.device]
        else:
            argv = [sys.executable, "-m", f"{PROGRAM}.serve", "--device", self.device]
        with open(self.sock + ".log", "ab") as logf:
            proc = subprocess.Popen(argv, stdout=logf, stderr=logf, stdin=subprocess.DEVNULL,
                                    env=self.env, start_new_session=True)
        self.started.append(proc)
        with open(self.sock + ".pid", "w") as f:
            f.write(str(proc.pid))
        if wait:
            deadline = time.monotonic() + STOP_WAIT_S
            while not os.path.exists(self.sock):
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise BenchError(f"the server did not come up on {self.sock}")
                time.sleep(0.05)

    def stop(self) -> int:
        """SIGTERM each live server's process group, wait for it (a traced
        one writes its trace first), SIGKILL what outlives the wait."""
        alive = [p for p in self.pids() if pid_alive(p)]
        for pid in alive:
            try:
                os.killpg(pid, signal.SIGTERM)
            except OSError:
                pass
        deadline = time.monotonic() + STOP_WAIT_S
        for pid in alive:
            while pid_alive(pid) and time.monotonic() < deadline:
                reap(pid)
                time.sleep(0.02)
            if pid_alive(pid):
                log(f"server {pid} outlived SIGTERM by {STOP_WAIT_S} s: SIGKILL")
                try:
                    os.killpg(pid, signal.SIGKILL)
                except OSError:
                    pass
            reap(pid)
        for proc in self.started:
            if proc.poll() is None:
                proc.wait()
        for path in (self.sock, self.sock + ".pid"):
            if os.path.exists(path) and self.current() is None:
                os.unlink(path)
        return len(alive)


class MemorySampler:
    """The card's used memory from ``nvidia-smi``, sampled every 100 ms."""

    def __init__(self):
        self.samples: list[int] = []
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits",
                 "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
            return
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            first = line.split(",")[0].strip()
            if first.isdigit():
                self.samples.append(int(first) << 20)

    def stop(self) -> int:
        if self.proc is None:
            return 0
        self.proc.terminate()
        self.proc.wait()
        self.thread.join(10)
        return max(self.samples, default=0)


def host_stolen_s() -> float:
    """The seconds the host's hypervisor gave this machine's cores to
    others (``steal`` in ``/proc/stat``), summed over the cores."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return 0.0


def child_env(root: str, run_dir: str, env_extra: dict) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("PHYLONIUM_TPU_")}
    env.pop("PORTBENCH_CHILD_PRELUDE", None)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (root, os.environ.get("PYTHONPATH"))))
    cache = os.path.join(root, ".portbench_cache")
    env["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    env["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    env["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    env["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache, "inductor")
    env["PHYLONIUM_TPU_DEVD_SOCK"] = os.path.join(run_dir, "d.sock")
    env["PHYLONIUM_TPU_CALIBRATION_FILE"] = os.path.join(run_dir, "calibration.json")
    env.update(env_extra)
    return env


def route(report: dict) -> str:
    devd = report.get("devd")
    if devd:
        return f"devd(pid {devd.get('pid')}, {devd.get('cache_hits')} cache hits)"
    if report.get("compare_carrier") == "host":
        return "host"
    return "in process, streamed" if report.get("stream_groups") else "in process, serial"


class Cell:
    """One run of one cell: its files, its processes and its records."""

    def __init__(self, args, root: str, device: str, env_extra: dict, prelude: str | None):
        self.args, self.root, self.device = args, root, device
        self.spec, self.config, self.traffic = cell_spec(root, args.workload)
        self.run_dir = os.path.join(os.environ.get("TMPDIR") or "/tmp", "portbench")
        self.sock = os.path.join(self.run_dir, "d.sock")
        if len(self.sock.encode()) > SOCKET_MAX:
            raise BenchError(f"the socket path {self.sock} is longer than {SOCKET_MAX} "
                             "bytes: give the run a shorter TMPDIR")
        shutil.rmtree(self.run_dir, ignore_errors=True)
        os.makedirs(self.run_dir)
        self.trace_dir = os.path.join(self.run_dir, "traces") if args.trace else None
        if self.trace_dir:
            os.makedirs(self.trace_dir)
        self.env = child_env(root, self.run_dir, env_extra)
        self.prelude = prelude
        self.flags = list(self.traffic.get("flags", []))
        if device != "cuda":
            self.flags += ["--device", device]
        self.servers = Servers(self.sock, self.env, device, self.trace_dir)
        self.cell_runs = 0

    # -- CLI runs -------------------------------------------------------
    def cli(self, files: list[str], label: str, timed: bool = False) -> dict:
        from child import CLI_CHILD

        d = self.run_dir
        report, child_report = os.path.join(d, "report.json"), os.path.join(d, "child.json")
        for path in (report, child_report):
            if os.path.exists(path):
                os.unlink(path)
        env = {**self.env, "PHYLONIUM_TPU_RUN_REPORT": report}
        if timed and self.prelude:
            env["PORTBENCH_CHILD_PRELUDE"] = self.prelude
        self.watch.begin()
        stolen = host_stolen_s()
        got = self.spawner.run({
            "argv": [sys.executable, "-c", CLI_CHILD, child_report, *self.flags, *files],
            "cwd": d, "env": env, "timeout": CLI_TIMEOUT_S,
            "out": os.path.join(d, "out.txt"), "err": os.path.join(d, "err.txt")})
        with open(os.path.join(d, "out.txt"), errors="replace") as f:
            got["stdout"] = f.read()
        with open(os.path.join(d, "err.txt"), "rb") as f:
            got["stderr"] = f.read()[-2000:].decode(errors="replace")
        child = load_json(child_report) if os.path.exists(child_report) else {}
        got["report"] = load_json(report) if os.path.exists(report) else (
            child.get("passes") or [{}])[-1]
        if child.get("jax"):
            raise BenchError(f"a CLI run loaded {child['jax']}")
        got.update({k: child.get(k, 0.0) for k in ("import_s", "main_s")})
        got["start_s"] = child.get("started", got["spawned"]) - got["spawned"]
        got["exit_s"] = got["exited"] - child.get("ended", got["exited"])
        got["cuda_initialized"] = bool(child.get("cuda_initialized"))
        passes = child.get("passes") or [{}]
        got["main_began"] = child.get("main_began")
        got["process_began"] = passes[0].get("process_began")
        got["process_ended"] = passes[-1].get("process_ended")
        rep = got["report"]
        got["timings"] = rep.get("timings", {})
        launches = (rep.get("devd") or {}).get("launches") or {}
        got["count_launches"] = launches.get("count", 0) + rep.get("kernel_launches", 0)
        got["build_launches"] = launches.get("build", 0) + rep.get("build_kernel_launches", 0)
        got["server_kb"] = self.watch.read()
        got["rss_mb"] = (got["maxrss_kb"] + got["server_kb"]) * 1024 / 1e6
        got["files"] = files
        got["stolen_s"] = host_stolen_s() - stolen
        log(f"{label}: rc {got['rc']}, wall {got['wall']:.4f} s (start {got['start_s']:.4f}, "
            f"imports {got['import_s']:.4f}, cli.main {got['main_s']:.4f}, exit "
            f"{got['exit_s']:.4f}), route {route(rep)}, stream_model "
            f"{json.dumps(rep.get('stream_model'))}, dispatch_model "
            f"{json.dumps(rep.get('dispatch_model'))}, timings {json.dumps(got['timings'])}, "
            f"CLI peak RSS {got['maxrss_kb'] / 1024:.1f} MiB + server "
            f"{got['server_kb'] / 1024:.1f} MiB; CUDA in the CLI {got['cuda_initialized']}; "
            f"CLI CPU {got['cpu_s']:.4f} s; cores stolen by the host {got['stolen_s']:.2f} s")
        if got["rc"] != 0:
            log(f"{label}: stderr ends: {got['stderr']}")
        if got["cuda_initialized"] and self.trace_dir:
            log(f"{label}: the CLI made a CUDA context itself; only the server's kernels "
                "are traced")
        return got

    def store_rate(self) -> float | None:
        path = self.env["PHYLONIUM_TPU_CALIBRATION_FILE"]
        if not os.path.exists(path):
            return None
        return load_json(path).get("link_mb_s")

    # -- the phases -------------------------------------------------------
    def setup(self) -> None:
        import panel

        seed, t = self.args.seed, self.traffic
        self.panel = panel.Panel(self.config["panel"], seed, os.path.join(self.run_dir, "panel"),
                                 period=int((t.get("turnover") or {}).get("period", 0)))
        files = self.panel.files(0)
        os.sync()  # no write-back of the panel inside the window
        log(f"panel: {len(files)} genomes of {self.config['panel']['length']} bases, "
            f"{sum(os.path.getsize(f) for f in files)} bytes of FASTA"
            + (f"; 1/{self.panel.period} of it new in each later run" if self.panel.period
               else ""))
        runs = int(t.get("warmup_runs", 0))
        own = True
        if t["store"] == "learned":
            shape = self.config["panel"]
            n, width = int(shape["genomes"]), int(shape["length"])
            learn = t["learn"]
            own = n * (n - 1) / 2 * width / 1e9 >= learn["static_rule_gbp"]
            if not own:
                # the CLI spawns the server for a panel of its own, which
                # then goes, so that the window's server never held it
                files = panel.write_panel(learn["panel"], seed, os.path.join(self.run_dir, "learn"),
                                          prefix="L", stream=1)
                self.check(self.cli(files, "learning run"))
                shutil.rmtree(os.path.join(self.run_dir, "learn"))
                log(f"learning panel: {self.servers.stop()} server(s) stopped")
        if t["server"] == "warm":
            # up before the cell's first run, which then does not wait for it
            self.servers.start(wait=True)
        if t["store"] == "learned" and own:
            # a learning run of the cell's own panel is one of its warm-up runs
            self.between()
            self.check(self.cli(self.next_files(), "learning run"))
            self.after_run()
            runs -= 1
        for k in range(max(runs, 0)):
            self.between()
            self.check(self.cli(self.next_files(), f"warm-up run {k}"))
            self.after_run()
        if t["store"] == "learned":
            if not self.store_rate():
                raise BenchError("the calibration store learned no copy rate in set-up")
            log(f"store: {json.dumps(load_json(self.env['PHYLONIUM_TPU_CALIBRATION_FILE']))}")

    def next_files(self) -> list[str]:
        """The panel of the cell's next CLI run, its new genomes written."""
        files = self.panel.files(self.cell_runs)
        self.cell_runs += 1
        return files

    def between(self) -> None:
        if self.trace_dir and self.traffic["server"] == "cold":
            self.servers.start(wait=False)

    def after_run(self) -> float:
        if self.traffic["server"] != "cold":
            return 0.0
        t = time.perf_counter()
        self.servers.stop()
        return time.perf_counter() - t

    @staticmethod
    def check(run: dict) -> None:
        if run["rc"] != 0:
            raise BenchError(f"a set-up run exited {run['rc']}: {run['stderr']}")

    def window(self) -> list[dict]:
        runs = []
        t0 = time.perf_counter()
        while not runs or time.perf_counter() - t0 < self.args.seconds:
            t, written = time.perf_counter(), self.panel.written
            files = self.next_files()
            if self.panel.written > written:
                os.sync()
                log(f"between runs: {self.panel.written - written} new genomes written and synced in "
                    f"{time.perf_counter() - t:.4f} s (not counted)")
            self.between()
            runs.append(self.cli(files, f"run {len(runs)}", timed=True))
            spent = self.after_run()
            if spent:
                log(f"between runs: the server stopped in {spent:.4f} s (not counted)")
        return runs

    # -- the whole run ------------------------------------------------------
    def execute(self) -> dict:
        from child import CUDA_CHECK

        check = None
        if self.device == "cuda":
            check = subprocess.Popen([sys.executable, "-c", CUDA_CHECK], stdout=subprocess.PIPE,
                                     text=True, env=self.env)
        self.spawner = Spawner()
        self.watch = ServerWatch(self.servers)
        sampler = None
        try:
            device = {"platform": "cpu", "kind": "cpu", "count": 0}
            if check is not None:
                out, _ = check.communicate()
                card = json.loads(out.strip().splitlines()[-1]) if out.strip() else {}
                if not card.get("available") or card.get("count", 0) < self.spec["chips"]:
                    raise BenchError(f"no CUDA card for the cell: {card}")
                device = {"platform": "gpu", "kind": card["name"], "count": self.spec["chips"]}
                log(f"card: {power_line()}; peaks {HBM_BYTES_S:.4g} B/s, "
                    f"{INT8_OPS_S:.4g} int8 op/s")
                sampler = MemorySampler()
            self.setup()
            setup_s = time.perf_counter() - T0
            log(f"set-up: {setup_s:.4f} s")
            runs = self.window()
            lo, hi = runs[0]["spawned"], runs[-1]["exited"]
            device["memory_peak_bytes"] = max(
                sampler.stop() if sampler else 0,
                max(((r["report"].get("devd") or {}).get("memory_reserved") or 0) for r in runs))
            sampler = None
        finally:
            if sampler:
                sampler.stop()
            self.watch.stop()
            stopped = self.servers.stop()
            self.spawner.close()
        log(f"window: {len(runs)} runs in {hi - lo:.4f} s; {stopped} server(s) stopped")
        return {"runs": runs, "window": (lo, hi), "setup_s": setup_s, "device": device}


def power_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not found"


def judge(runs: list[dict], card: bool) -> tuple[dict, dict, object]:
    """Each window run against the plain reference's answer for its own
    panel: (numbers compared, their limits, the reference's answers)."""
    import reference

    t = time.perf_counter()
    panels = list(dict.fromkeys(tuple(r["files"]) for r in runs))
    want = reference.Matrices([list(p) for p in panels], card=card)
    answers = dict(zip(panels, want.answers))
    log(f"plain reference: {time.perf_counter() - t:.4f} s "
        f"({', '.join(f'{k} {v:.3f}' for k, v in want.seconds.items())}); {len(panels)} "
        f"panel(s), {want.genomes} genomes; reference genome {want.reference}, width "
        f"{want.width}, anchors of {want.threshold} bases or more, {want.homologies} "
        "homologies kept")
    worst, failed = 0, 0
    for k, r in enumerate(runs):
        answer = answers[tuple(r["files"])]
        got = reference.parse_phylip(r["stdout"])
        if got is None or got[0] != answer.names:
            differ = len(answer.names) ** 2
        else:
            differ = reference.cells_differ(got[1], answer.cells)
        exit_ok = (r["rc"] != 0) == answer.exit_nonzero
        if differ or not exit_ok:
            failed += 1
            log(f"run {k}: {differ} cells differ from the reference, exit code {r['rc']}")
        worst = max(worst, differ)
    values = {"cells_differ": worst, "runs_failed": failed}
    limits = {"cells_differ": 0, "runs_failed": 0}
    return values, limits, want


def end_to_end(runs: list[dict], setup_s: float) -> dict:
    """The cell's end-to-end metrics from its window's CLI runs."""
    return {"matrix_s": sum(r["wall"] for r in runs) / len(runs),
            "peak_rss_mb": max(r["rss_mb"] for r in runs),
            "setup_s": setup_s}


def applying(metrics: list[dict], workload: str) -> list[dict]:
    """The metrics that ``workload`` reports."""
    return [m for m in metrics if workload in m.get("workloads", [workload])]


def load_metric(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv: list[str] | None = None, *, device: str = "cuda", env_extra: dict | None = None,
         prelude: str | None = None, root: str = ROOT) -> int:
    parser = argparse.ArgumentParser(prog="portbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = None
    try:
        if not os.path.isdir(os.path.join(root, PROGRAM)):
            raise BenchError(f"the program ({PROGRAM}) is not beside the benchmark in {root}")
        become_subreaper()
        cell = Cell(args, root, device, env_extra or {}, prelude)
        done = cell.execute()
        values, limits, want = judge(done["runs"], device == "cuda")
        kernels, notes = server_kernels(cell.trace_dir) if cell.trace_dir else ([], [])
        loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
        if loaded:
            raise BenchError(f"the harness's process holds {loaded}")
    except BenchError as e:
        log(f"error: {e}")
        return 1
    except Exception:  # noqa: BLE001 — the run ends without a result
        traceback.print_exc()
        return 1
    finally:
        if cell is not None:
            shutil.rmtree(cell.run_dir, ignore_errors=True)
    runs = done["runs"]
    correct = all(values[k] <= limits[k] for k in values)
    metrics = {}
    spec = cell.spec
    if args.trace:
        for note in notes:
            log(f"trace {note}")
        lo, hi = done["window"]
        record = {"runs": runs, "kernels": kernels, "window": (lo, hi),
                  "problem": {"genomes": len(want.answers[0].names), "width": want.width,
                              "query_bases": sum(want.answers[0].lengths)}}
        for m in applying(spec["bench"]["per_layer"], args.workload):
            value = load_metric(m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        done["device"]["busy_s"] = busy(kernels, lo, hi)
        done["device"]["window_s"] = hi - lo
        breakdown = {"device_ops": device_ops(kernels, lo, hi),
                     "idle_gaps": idle_gaps(kernels, runs, lo, hi)}
    else:
        e2e = end_to_end(runs, done["setup_s"])
        for m in applying(spec["bench"]["end_to_end"], args.workload):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(runs), "failed": values["runs_failed"],
              "metrics": metrics, "device": done["device"]}
    if args.trace:
        result["breakdown"] = breakdown
    result["compared"] = {k: {"value": values[k], "limit": limits[k]} for k in values}
    print(json.dumps(result), flush=True)
    for k in values:
        print(f"compared {k} {values[k]} limit {limits[k]}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
