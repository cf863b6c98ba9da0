"""The torch port's CLI with ``--map-backend hybrid`` on the CPU.

- the ``default``, ``two_pass`` and ``refpos`` golden fixtures are
  reproduced byte for byte (set up as tests/test_golden_fixtures.py does);
- a hybrid run never loads jax and extends anchors through the plain
  PyTorch version;
- a hybrid run whose bitmap op fails exits non-zero and prints no matrix:
  nothing maps on the host in its place;
- mapping checkpoints are reused.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from golden_panel import GOLDEN_CASES, write_panel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "data", "golden")
ACGT = np.frombuffer(b"ACGT", np.uint8)
HYBRID = ["--progress=never", "--device", "cpu", "--map-backend", "hybrid"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run(args, cwd, script=None):
    head = ["-c", script] if script else ["-m", "phylonium_tpu_torch"]
    return subprocess.run(
        [sys.executable, *head, *args],
        capture_output=True, cwd=cwd, env=_env(), timeout=600,
    )


@pytest.fixture(scope="module")
def panel_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden_panel_hybrid")
    return write_panel(str(d)), str(d)


@pytest.fixture
def small_files(tmp_path):
    rng = np.random.default_rng(11)
    base = ACGT[rng.integers(0, 4, 6000)]
    paths = []
    for k in range(3):
        arr = base.copy()
        hit = rng.random(arr.size) < 0.02 * k
        arr[hit] = ACGT[(rng.integers(1, 4, hit.sum()) + arr[hit]) % 4]
        path = tmp_path / f"G{k}.fasta"
        path.write_bytes(b">G%d\n%s\n" % (k, arr.tobytes()))
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("name", ["default", "two_pass", "refpos"])
def test_hybrid_cli_matches_committed_fixture(name, panel_files):
    files, tmp = panel_files
    refpos = os.path.join(tmp, f"refpos_hybrid_{name}.txt")
    args = [refpos if a == "REFPOS_FILE" else a for a in GOLDEN_CASES[name]]
    r = _run([*HYBRID, *args, *files], tmp)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    with open(os.path.join(GOLDEN_DIR, f"{name}.stdout"), "rb") as f:
        assert r.stdout == f.read(), f"stdout diverged from fixture {name}"
    if "REFPOS_FILE" in GOLDEN_CASES[name]:
        with open(refpos, "rb") as f, open(
            os.path.join(GOLDEN_DIR, f"{name}.refpos"), "rb"
        ) as g:
            assert f.read() == g.read()


_PROBE = """
import json, sys
from phylonium_tpu_torch.cli import main
rc = main(sys.argv[1:])
from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO
print(json.dumps({"rc": rc, "jax": "jax" in sys.modules,
                  "info": LAST_RUN_INFO}), file=sys.stderr)
"""


def test_hybrid_cpu_run_is_jax_free(small_files, tmp_path):
    r = _run([*HYBRID, "-v", "-v", *small_files], tmp_path, _PROBE)
    err = r.stderr.decode()
    assert r.returncode == 0, err[-2000:]
    report = json.loads(err.strip().splitlines()[-1])
    assert report["rc"] == 0
    assert report["jax"] is False
    info = report["info"]
    assert info["map_carrier"] == "torch-cpu"
    assert info["extend_plain_calls"] == info["map_rounds"] > 0
    assert info["extend_kernel_launches"] == 0
    assert info["compare_carrier"] == "torch-cpu"
    assert "torch-cpu mapped" in err
    assert r.stdout.decode().splitlines()[0].strip() == str(len(small_files))


_FAILING = """
import sys
from phylonium_tpu_torch.ops import anchor_extend

def broken(*args, **kwargs):
    raise RuntimeError("pt_diagonal_neq: CUDA error 700")

anchor_extend.diagonal_neq = broken
from phylonium_tpu_torch.cli import main
sys.exit(main(sys.argv[1:]))
"""


def test_hybrid_run_whose_extension_fails_exits_nonzero(small_files, tmp_path):
    r = _run([*HYBRID, *small_files], tmp_path, _FAILING)
    assert r.returncode != 0
    assert r.stdout == b""
    assert b"pt_diagonal_neq: CUDA error 700" in r.stderr


def test_hybrid_refuses_cuda_without_a_card(small_files, monkeypatch):
    import torch

    from phylonium_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # host counting needs no device, but hybrid mapping still does
    assert main(["--progress=never", "--map-backend", "hybrid",
                 "--count-backend", "host", *small_files]) == 1


def test_hybrid_reuses_its_checkpoint(small_files, tmp_path, capsys):
    from phylonium_tpu_torch.cli import main
    from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO

    args = [*HYBRID, "--checkpoint", str(tmp_path / "ckpt"), *small_files]
    assert main(args) == 0
    first = capsys.readouterr().out
    assert LAST_RUN_INFO["map_rounds"] > 0
    assert main(args) == 0
    assert capsys.readouterr().out == first
    assert LAST_RUN_INFO["map_rounds"] == 0
    assert LAST_RUN_INFO["extend_plain_calls"] == 0
