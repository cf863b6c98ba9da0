"""Spawn a torch.distributed world of CPU ranks for the port's tests.

Each rank is a fresh ``python -c`` process that joins a gloo world through
a ``file://`` store in the test's temporary directory (no TCP port, so
parallel test workers cannot collide) with a short timeout, and runs
``script`` with ``RANK``, ``SIZE`` and ``ARGS`` bound. Every process is
waited for with a timeout and killed if it overruns.
"""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = """
import sys
RANK, SIZE, STORE = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
ARGS = sys.argv[4:]
from phylonium_tpu_torch.parallel.multihost import initialize_distributed
initialize_distributed("gloo", init_method="file://" + STORE, world_size=SIZE,
                       rank=RANK, timeout=120)
"""

_EPILOGUE = """
import torch.distributed as dist
dist.destroy_process_group()
"""


def spawn_world(script: str, size: int, tmp_path, args=(), timeout: float = 300,
                env_extra: dict | None = None) -> list[tuple[int, str, str]]:
    """Run ``script`` in ``size`` gloo ranks; returns (rc, stdout, stderr)
    a rank, in rank order."""
    store = tmp_path / f"store_{size}_{abs(hash(script)) % 10**8}"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.update(env_extra or {})
    code = _PRELUDE + script + _EPILOGUE
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code, str(rank), str(size), str(store),
             *map(str, args)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=tmp_path, env=env,
        )
        for rank in range(size)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs
