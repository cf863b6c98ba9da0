"""A run of the port that never reaches the card never imports torch.

The port of tests/test_lazy_startup.py: the JAX package imports jax only
where a run reaches the device, and ``PHYLONIUM_TPU_EXPECT_NO_JAX`` turns
a breach into exit 70. The port's rule is the same with torch
(``PHYLONIUM_TPU_EXPECT_NO_TORCH``, phylonium_tpu_torch/__main__.py).
Pytest's own process has loaded torch, so every case runs in a child:

- importing the CLI, the device server's client, the pipeline or the
  FASTA reader leaves ``torch`` out of ``sys.modules``, and so does
  reading the world (``parallel.multihost.world``);
- ``--count-backend host``, plain and with ``-v -v -b 2 --distance ani``,
  under the guard: exit 0, no torch, the JAX CLI's bytes;
- a default ``auto`` run with the CUDA driver's count patched to one card,
  on a panel that the static rule sends to the host: no torch, no CUDA
  context, the JAX CLI's bytes;
- with two cards faked (where 'auto' would count on the local mesh), a
  ``--count-backend host`` run and an ``auto`` run the static rule sends
  to the host, under the guard: no torch, the JAX CLI's bytes;
- a device-server client run on the CPU (one daemon for the module): no
  torch in the CLI process, the same bytes as the in-process run;
- a ``--device cpu`` run under the guard: its matrix, then exit 70.

Every CLI child goes through ``python -m phylonium_tpu_torch``'s entry
point (``runpy``, after wrapping ``cli.main`` to report what it loaded).
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the entry point of `python -m phylonium_tpu_torch`, with cli.main
# wrapped to write what the run loaded into argv[1] just before the entry
# point's guard and os._exit; argv[2], where not "0", patches the CUDA
# driver's count to that many cards
_CHILD = """
import json, runpy, sys
report, one_card, *args = sys.argv[1:]
sys.argv = ["phylonium_tpu_torch", *args]
import phylonium_tpu_torch.cli as cli
from phylonium_tpu_torch.utils import platform
if one_card != "0":
    platform.cuda_device_count = lambda: int(one_card)
main = cli.main
def recorded(argv=None):
    rc = main(argv)
    from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO
    torch = sys.modules.get("torch")
    with open(report, "w") as f:
        json.dump({"rc": rc, "torch": torch is not None, "jax": "jax" in sys.modules,
                   "cuda_initialized": torch is not None and torch.cuda.is_initialized(),
                   "info": LAST_RUN_INFO}, f)
    return rc
cli.main = recorded
runpy.run_module("phylonium_tpu_torch", run_name="__main__", alter_sys=True)
"""


def _env(tmp, **extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # a child that finds a card must not touch the user's calibration store
    env["HOME"] = str(tmp)
    env["PHYLONIUM_TPU_CALIBRATION_FILE"] = str(tmp / "calibration.json")
    for key in ("PHYLONIUM_TPU_DEVD", "PHYLONIUM_TPU_STREAM", "PHYLONIUM_TPU_LOWMEM",
                "PHYLONIUM_TPU_DEVICE_PILEUP", "PHYLONIUM_TPU_AUTO_DEVICE_GBP",
                "PHYLONIUM_TPU_EXPECT_NO_TORCH"):
        env.pop(key, None)
    env.update(extra)
    return env


def _port(args, tmp, one_card=False, cards=0, **extra):
    report = tmp / "child.json"
    if report.exists():
        report.unlink()
    r = subprocess.run(
        [sys.executable, "-c", _CHILD, str(report), str(cards or int(one_card)),
         "--progress=never", *args],
        capture_output=True, cwd=tmp, env=_env(tmp, **extra), timeout=300,
    )
    child = json.loads(report.read_text()) if report.exists() else None
    return r, child


def _jax(args, tmp, **extra):
    r = subprocess.run(
        [sys.executable, "-m", "phylonium_tpu", "--progress=never",
         "--count-backend", "host", *args],
        capture_output=True, cwd=tmp, env=_env(tmp, PHYLONIUM_TPU_DEVD="0", **extra),
        timeout=300,
    )
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    return r.stdout


@pytest.fixture
def small_panel(tmp_path):
    rng = np.random.default_rng(5)
    base = rng.integers(0, 4, 4000)
    files = []
    for k in range(3):
        arr = base.copy()
        idx = rng.random(arr.size) < 0.02 * (k + 1)
        arr[idx] = (arr[idx] + rng.integers(1, 4, int(idx.sum()))) % 4
        p = tmp_path / f"L{k}.fasta"
        p.write_bytes(b">L%d\n" % k + bytes(b"ACGT"[c] for c in arr) + b"\n")
        files.append(str(p))
    return files


_IMPORT = """
import json, sys, importlib
importlib.import_module(sys.argv[1])
from phylonium_tpu_torch.parallel.multihost import world
print(json.dumps({"torch": "torch" in sys.modules, "world": world(),
                  "torch_after": "torch" in sys.modules}))
"""


@pytest.mark.parametrize("module", [
    "phylonium_tpu_torch.cli", "phylonium_tpu_torch.serve.client",
    "phylonium_tpu_torch.core.pipeline", "phylonium_tpu_torch.io.fasta",
])
def test_importing_a_host_module_loads_no_torch(module, tmp_path):
    r = subprocess.run([sys.executable, "-c", _IMPORT, module], capture_output=True,
                       env=_env(tmp_path), timeout=120)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert json.loads(r.stdout) == {"torch": False, "world": [1, 0], "torch_after": False}


@pytest.mark.parametrize("flags", [[], ["-v", "-v", "-b", "2", "--distance", "ani"]],
                         ids=["plain", "verbose-bootstrap-ani"])
def test_host_count_never_imports_torch(flags, small_panel, tmp_path):
    seed = {"PHYLONIUM_TPU_RD_SEED": "7"}
    r, child = _port(["--count-backend", "host", *flags, *small_panel], tmp_path,
                     PHYLONIUM_TPU_EXPECT_NO_TORCH="1", **seed)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert b"torch was imported" not in r.stderr
    assert child["rc"] == 0 and not child["torch"] and not child["jax"]
    assert child["info"]["compare_carrier"] == "host"
    assert r.stdout == _jax([*flags, *small_panel], tmp_path, **seed)
    assert r.stdout.startswith(b"3\n")


def test_auto_run_routed_to_the_host_makes_no_context(small_panel, tmp_path):
    r, child = _port(small_panel, tmp_path, one_card=True,
                     PHYLONIUM_TPU_EXPECT_NO_TORCH="1")
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert child["rc"] == 0 and not child["torch"] and not child["cuda_initialized"]
    info = child["info"]
    # the static rule decided: no copy rate in the empty store
    assert info["compare_carrier"] == "host"
    assert info["dispatch_model"]["link_mb_s"] is None
    assert info["cuda_initialized"] is False and "prewarm" not in info
    assert info["kernel_launches"] == 0 and info["plain_calls"] == 0
    assert r.stdout == _jax(small_panel, tmp_path)


@pytest.mark.parametrize("flags", [["--count-backend", "host"], []], ids=["host", "auto"])
def test_two_cards_host_count_never_imports_torch(flags, small_panel, tmp_path):
    r, child = _port([*flags, *small_panel], tmp_path, cards=2,
                     PHYLONIUM_TPU_EXPECT_NO_TORCH="1")
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert child["rc"] == 0 and not child["torch"] and not child["cuda_initialized"]
    info = child["info"]
    assert info["compare_carrier"] == "host" and "mesh" not in info
    assert "prewarm" not in info
    assert r.stdout == _jax(small_panel, tmp_path)


def test_a_cpu_run_under_the_guard_exits_70_after_its_matrix(small_panel, tmp_path):
    r, child = _port(["--device", "cpu", *small_panel], tmp_path,
                     PHYLONIUM_TPU_EXPECT_NO_TORCH="1")
    assert r.returncode == 70
    assert child["rc"] == 0 and child["torch"]
    assert r.stdout == _jax(small_panel, tmp_path)
    assert r.stderr.decode().strip().splitlines()[-1] == (
        "PHYLONIUM_TPU_EXPECT_NO_TORCH: torch was imported on a run that expected none")


@pytest.fixture(scope="module")
def module_daemon(tmp_path_factory):
    """One CPU daemon for the module, on a socket in a temporary directory."""
    tmp = tmp_path_factory.mktemp("devd")
    sock = str(tmp / "d.sock")
    log = tmp / "d.log"
    env = _env(tmp, PHYLONIUM_TPU_DEVD_SOCK=sock, PHYLONIUM_TPU_DEVD_IDLE_S="600")
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
        assert os.path.exists(sock), "the daemon's socket never appeared"
        yield sock
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=20)
        assert proc.returncode == 0, log.read_text()[-2000:]
        assert not os.path.exists(sock)


def test_device_server_client_never_imports_torch(module_daemon, small_panel, tmp_path):
    args = ["--device", "cpu", "-v", "-v", *small_panel]
    stream = {"PHYLONIUM_TPU_STREAM": "force", "PHYLONIUM_TPU_STREAM_GROUP": "2"}
    served, child = _port(args, tmp_path, PHYLONIUM_TPU_DEVD="1",
                          PHYLONIUM_TPU_DEVD_SOCK=module_daemon,
                          PHYLONIUM_TPU_EXPECT_NO_TORCH="1", **stream)
    assert served.returncode == 0, served.stderr.decode()[-2000:]
    assert child["rc"] == 0 and not child["torch"] and not child["cuda_initialized"]
    info = child["info"]
    assert info["devd"]["socket"] == module_daemon
    assert info["devd"]["launches"]["build_plain"] == 2
    assert info["early_ship"]["taken"] == 2 and info["stream_groups"] == 2
    local, child = _port(args, tmp_path, **stream)
    assert local.returncode == 0 and child["torch"] and "devd" not in child["info"]
    assert served.stdout == local.stdout == _jax(small_panel, tmp_path)
