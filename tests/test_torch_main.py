"""The port's entry point, ``python -m phylonium_tpu_torch``.

It is the JAX package's (phylonium_tpu/__main__.py): SystemExit's integer
code passes through (any other code is 1), KeyboardInterrupt exits 130,
a crash exits 1 with its traceback on stderr, and the process leaves
through ``os._exit`` after flushing stdout and stderr, so ``cli.main``
must have written everything before it returns. Each golden case comes
out byte for byte through it (tests/test_torch_cli.py,
``test_port_cli_matches_committed_fixture``); here:

- a usage error and an unknown option exit 1, ``--help`` and
  ``--version`` 0;
- a crash, forced in a child through ``runpy`` with ``cli.main`` patched,
  exits 1 with the traceback and no "terminate called"; SystemExit codes
  and KeyboardInterrupt map as in the JAX entry point; the guard turns a
  clean run that imported torch into 70 and keeps a failing run's code;
- the run report and the ``--profile`` trace are complete on disk once
  the process has exited.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# `python -m phylonium_tpu_torch` with cli.main replaced by argv[1]'s
# statement (which may import torch, return a code or raise)
_PATCHED = """
import runpy, sys
body = sys.argv[1]
sys.argv = ["phylonium_tpu_torch"]
import phylonium_tpu_torch.cli as cli
def patched(argv=None):
    exec(body)
    return 0
cli.main = patched
runpy.run_module("phylonium_tpu_torch", run_name="__main__", alter_sys=True)
"""


def _env(tmp, **extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["HOME"] = str(tmp)
    env.pop("PHYLONIUM_TPU_EXPECT_NO_TORCH", None)
    env.update(extra)
    return env


def _main(args, tmp, **extra):
    return subprocess.run([sys.executable, "-m", "phylonium_tpu_torch", *args],
                          capture_output=True, cwd=tmp, env=_env(tmp, **extra),
                          timeout=300)


def _patched(body, tmp, **extra):
    return subprocess.run([sys.executable, "-c", _PATCHED, body], capture_output=True,
                          cwd=tmp, env=_env(tmp, **extra), timeout=120)


@pytest.fixture
def small_panel(tmp_path):
    rng = np.random.default_rng(9)
    base = rng.integers(0, 4, 3000)
    files = []
    for k in range(3):
        arr = base.copy()
        idx = rng.random(arr.size) < 0.02 * (k + 1)
        arr[idx] = (arr[idx] + rng.integers(1, 4, int(idx.sum()))) % 4
        p = tmp_path / f"M{k}.fasta"
        p.write_bytes(b">M%d\n" % k + bytes(b"ACGT"[c] for c in arr) + b"\n")
        files.append(str(p))
    return files


@pytest.mark.parametrize("args, code, stream", [
    (["one.fasta"], 1, "stderr"),
    (["--bogus", "a.fasta", "b.fasta"], 1, "stderr"),
    (["--help"], 0, "stdout"),
    (["--version"], 0, "stdout"),
], ids=["one-file", "unknown-option", "help", "version"])
def test_usage_and_version_codes(args, code, stream, tmp_path):
    r = _main(args, tmp_path)
    assert r.returncode == code
    text = getattr(r, stream).decode()
    assert ("phylonium-tpu-torch" in text) and text.endswith("\n")
    if code == 0:
        assert r.stderr == b""


def test_a_crash_exits_1_with_its_traceback(tmp_path):
    r = _patched("raise RuntimeError('injected crash')", tmp_path)
    assert r.returncode == 1
    err = r.stderr.decode()
    assert "Traceback (most recent call last)" in err
    assert err.strip().splitlines()[-1] == "RuntimeError: injected crash"
    assert "terminate called" not in err


@pytest.mark.parametrize("body, code", [
    ("raise SystemExit(3)", 3),
    ("raise SystemExit(0)", 0),
    ("raise SystemExit('a message')", 1),
    ("raise KeyboardInterrupt", 130),
    ("return_code = 5; raise SystemExit(return_code)", 5),
], ids=["code-3", "code-0", "message", "interrupt", "computed"])
def test_exit_codes_pass_through(body, code, tmp_path):
    r = _patched(body, tmp_path)
    assert r.returncode == code, r.stderr.decode()[-2000:]
    assert "Traceback" not in r.stderr.decode()


@pytest.mark.parametrize("body, code", [
    ("pass", 0),
    ("import torch", 70),
    ("import torch; raise SystemExit(2)", 2),
], ids=["no-torch", "torch", "torch-and-failure"])
def test_the_guard(body, code, tmp_path):
    r = _patched(body, tmp_path, PHYLONIUM_TPU_EXPECT_NO_TORCH="1")
    assert r.returncode == code
    assert ("PHYLONIUM_TPU_EXPECT_NO_TORCH" in r.stderr.decode()) == body.startswith("import")


def test_stdout_is_flushed_before_the_hard_exit(tmp_path):
    # a buffered write with no newline, to a pipe: only the flush delivers it
    r = _patched("sys.stdout.write('x' * 100000 + 'end')", tmp_path)
    assert r.returncode == 0 and r.stdout == b"x" * 100000 + b"end"


def test_report_and_trace_are_on_disk_at_exit(small_panel, tmp_path):
    report = tmp_path / "report.json"
    trace_dir = tmp_path / "trace"
    r = _main(["--device", "cpu", "--progress=never", "-2", f"--profile={trace_dir}",
               *small_panel], tmp_path, PHYLONIUM_TPU_RUN_REPORT=str(report),
              PHYLONIUM_TPU_STREAM="force")
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert r.stdout.startswith(b"3\n")
    info = json.loads(report.read_text())
    assert info["compare_carrier"] == "torch-cpu" and info["stream_groups"] >= 1
    (trace,) = glob.glob(str(trace_dir / "*.trace.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"index", "map+pileup+feed", "compare"} <= names
