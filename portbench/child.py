"""The code of the processes the harness starts, run with ``python -c``.

Each is a string, so that the process starts with its own directory as
``sys.path[0]`` and never this folder's modules.

- ``CLI_CHILD`` runs the port's CLI through its entry point
  (``python -m phylonium_tpu_torch``: ``__main__.py`` then ``cli.main``) and
  splits its wall into the interpreter's start, the imports, ``cli.main``
  and the exit. Copied from ``chip_smoke.py::_CLI_CHILD``: each pass's
  ``LAST_RUN_INFO``, whether the process imported torch or made a CUDA
  context, and the clock at its first line, after its imports and around
  ``cli.main`` go to the file named by the first argument; added here,
  the wall clock around each pass's ``cli.process`` (the pipeline, after
  the read and the reference pick); the entry point
  then ends the process as it does. ``PORTBENCH_CHILD_PRELUDE`` names a
  file of Python that runs once ``cli`` is imported: the harness's own
  tests plant faults in the window's runs with it, and the harness sets
  it only when a caller asks.
- ``SPAWNER`` starts each CLI child and reads its peak RSS with
  ``os.wait4``. Linux carries a parent's high-water mark into a child it
  forks, so the children come from this small process, started before the
  harness holds anything, and never from the harness. One request a line
  on stdin (argv, cwd, env, out, err, timeout), one reply a line on
  stdout (rc, wall, peak RSS, CPU seconds, the wall clock at spawn and at
  exit). The
  child leads a process group of its own, killed whole at the timeout.
- ``DEVD_TRACE`` runs the port's device server
  (``python -m phylonium_tpu_torch.serve``) inside ``torch.profiler`` with
  CPU and CUDA activities. The server leaves through ``os._exit`` (on
  SIGTERM too), so the wrapper exports the trace there: it replaces
  ``os._exit`` with a function that stops the profiler, writes the chrome
  trace and the clock anchors, then exits. A clock anchor is a
  ``record_function`` range named ``portbench.clock.<i>`` opened at a
  known ``time.time()``: it ties the trace's timestamps to the host's wall
  clock whatever base the profiler uses.
"""

CLI_CHILD = """
import time
started, t0 = time.time(), time.perf_counter()
import json, os, runpy, sys
report, *args = sys.argv[1:]
sys.argv = ["phylonium_tpu_torch", *args]
import phylonium_tpu_torch.cli as cli
from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO
prelude = os.environ.pop("PORTBENCH_CHILD_PRELUDE", None)
if prelude:
    with open(prelude) as f:
        exec(f.read(), {"cli": cli})
passes = []
process, main = cli.process, cli.main
def recorded(*args, **kwargs):
    began = time.time()
    counts = process(*args, **kwargs)
    passes.append({**json.loads(json.dumps(LAST_RUN_INFO)),
                   "process_began": began, "process_ended": time.time()})
    return counts
t1 = time.perf_counter()
def timed(argv=None):
    global main_began
    main_began, t2 = time.time(), time.perf_counter()
    rc = main(argv)
    t3 = time.perf_counter()
    torch = sys.modules.get("torch")
    with open(report, "w") as f:
        json.dump({"rc": rc, "passes": passes,
                   "jax": sorted({m.split(".")[0] for m in sys.modules}
                                 & {"jax", "jaxlib", "flax", "phylonium_tpu"}),
                   "torch": torch is not None,
                   "cuda_initialized": torch is not None and torch.cuda.is_initialized(),
                   "started": started, "import_s": t1 - t0, "main_s": t3 - t2,
                   "main_began": main_began, "ended": time.time()}, f)
    return rc
cli.process, cli.main = recorded, timed
runpy.run_module("phylonium_tpu_torch", run_name="__main__", alter_sys=True)
"""

SPAWNER = """
import json, os, signal, subprocess, sys, threading, time
def kill(proc, timed_out):
    timed_out.append(True)
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except OSError:
        pass
for line in sys.stdin:
    spec = json.loads(line)
    timed_out = []
    with open(spec["out"], "wb") as out, open(spec["err"], "wb") as err:
        spawned, t0 = time.time(), time.perf_counter()
        proc = subprocess.Popen(spec["argv"], stdout=out, stderr=err, cwd=spec["cwd"],
                                env=spec["env"], stdin=subprocess.DEVNULL,
                                start_new_session=True)
        timer = threading.Timer(spec["timeout"], kill, (proc, timed_out))
        timer.start()
        _, status, usage = os.wait4(proc.pid, 0)
        wall, exited = time.perf_counter() - t0, time.time()
        timer.cancel()
    proc.returncode = os.waitstatus_to_exitcode(status)
    print(json.dumps({"rc": proc.returncode, "wall": wall, "maxrss_kb": usage.ru_maxrss,
                      "cpu_s": usage.ru_utime + usage.ru_stime,
                      "spawned": spawned, "exited": exited, "timed_out": bool(timed_out)}),
          flush=True)
"""

DEVD_TRACE = """
import json, os, runpy, sys, time
out, device = sys.argv[1], sys.argv[2]
import torch
from torch.profiler import ProfilerActivity, profile, record_function
activities = [ProfilerActivity.CPU]
if torch.cuda.is_available():
    activities.append(ProfilerActivity.CUDA)
prof = profile(activities=activities)
prof.start()
anchors = []
def anchor():
    with record_function("portbench.clock.%d" % len(anchors)):
        anchors.append(time.time())
anchor()
real_exit = os._exit
def traced_exit(code):
    try:
        anchor()
        prof.stop()
        prof.export_chrome_trace(out + ".json")
        with open(out + ".clock.json", "w") as f:
            json.dump(anchors, f)
    finally:
        sys.stderr.flush()
        real_exit(code)
os._exit = traced_exit
sys.argv = ["phylonium_tpu_torch.serve", "--device", device]
runpy.run_module("phylonium_tpu_torch.serve", run_name="__main__", alter_sys=True)
"""

CUDA_CHECK = """
import json, torch
ok = torch.cuda.is_available()
count = torch.cuda.device_count() if ok else 0
print(json.dumps({"available": ok, "count": count,
                  "name": torch.cuda.get_device_name(0) if count else None}))
"""
