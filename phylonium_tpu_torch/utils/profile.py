"""Phase timings, profiler ranges and the ``--profile`` trace.

Every phase of a run (``index``, ``map``, ``pileup``, ``compare``,
``map+pileup+feed``, ``map+feed``) is timed on the host clock into
``LAST_RUN_INFO["timings"]`` and, under the same name, recorded as a
``torch.profiler.record_function`` range, which costs next to nothing
while no profiler runs. A process that has not imported torch records no
range: it has no profiler to feed, and a phase never imports torch.
``--profile=DIR`` (the one place here that imports torch) runs ``torch.profiler`` around
the pipeline (CPU activity, plus CUDA when the run's device is a card) and
writes one Chrome trace into DIR. A trace that cannot be started or
written is a soft error: the run warns, still prints its matrix and exits
1, as the JAX CLI keeps the matrix when its trace fails.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

from phylonium_tpu_torch.config import PROG
from phylonium_tpu_torch.utils.platform import device_type, loaded

# the range the streamed feeder's worker thread records around each group
# it preps and builds
GROUP_RANGE = "pileup group"


def span(name: str):
    """A ``torch.profiler`` range named ``name`` where this process has
    imported torch (``utils.platform.loaded``), else nothing."""
    torch = loaded("torch")
    if torch is None:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def phase(timings: dict, name: str):
    """Time the body into ``timings[name]`` (seconds) inside a profiler
    range of the same name (``span``)."""
    with span(name):
        t0 = time.perf_counter()
        yield
        timings[name] = time.perf_counter() - t0


@contextlib.contextmanager
def profiled(cfg):
    """Run the body under ``torch.profiler`` when ``cfg.profile_dir`` is
    set, and write its Chrome trace there (the directory is created)."""
    if not cfg.profile_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device_type(cfg.device) == "cuda" and torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        os.makedirs(cfg.profile_dir, exist_ok=True)
        # every thread: the streamed feeder's worker preps and launches
        # the pileup builds
        prof = torch.profiler.profile(
            activities=activities,
            experimental_config=torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True
            ),
        )
        prof.start()
    except Exception as e:  # noqa: BLE001 — a lost trace never costs the matrix
        cfg.soft_error(f"could not start the profiler: {e}")
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.stop()
                stamp = time.strftime("%Y%m%d-%H%M%S")
                path = os.path.join(
                    cfg.profile_dir, f"{PROG}-{stamp}-{os.getpid()}.trace.json"
                )
                prof.export_chrome_trace(path)
                if cfg.verbose:
                    print(f"profiler trace: {path}", file=sys.stderr)
            except Exception as e:  # noqa: BLE001
                cfg.soft_error(f"could not write the profiler trace: {e}")
