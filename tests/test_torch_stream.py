"""The port's streamed feeder and streamed CLI (CPU route).

The feeder builds each group's rows into one [N, W] panel and counts it;
every chunking must count exactly as ``pair_counts_numpy`` does on the
host pileup, and the forced streamed CLI must print what the serial port,
the JAX CLI and the golden fixtures print, byte for byte.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from golden_panel import GOLDEN_CASES, RD_SEED, write_panel
from phylonium_tpu.core.pileup import build_pileup
from phylonium_tpu.ops.match_table import pair_counts_numpy
from phylonium_tpu_torch.core.stream import DeviceRowFeeder
from pileup_cases import panel, write_fasta_panel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "data", "golden")
CPU = torch.device("cpu")


def _feed_all(queries, homologies, ref_len, groups):
    feeder = DeviceRowFeeder(len(queries), ref_len, CPU)
    lo = 0
    for g in groups:
        feeder.feed(queries[lo : lo + g], homologies[lo : lo + g])
        lo += g
    assert lo == len(queries)
    counts = feeder.finish()
    assert feeder.groups == len(groups)
    return counts


@pytest.mark.parametrize(
    "n,length,groups",
    [
        (12, 700, [12]),
        (12, 700, [5, 4, 3]),
        (33, 1500, [32, 1]),
        (40, 257, [7, 13, 11, 9]),
        (530, 600, [256, 256, 18]),  # N > 512: the JAX package's panel path
    ],
)
def test_feeder_counts_equal_numpy(rng, n, length, groups):
    queries, homologies, _ = panel(rng, n, length)
    subs, homs = _feed_all(queries, homologies, length, groups)
    es, eh = pair_counts_numpy(build_pileup(queries, homologies, length))
    np.testing.assert_array_equal(subs, es)
    np.testing.assert_array_equal(homs, eh)


def test_feeder_error_surfaces_in_finish(rng, monkeypatch):
    from phylonium_tpu_torch.ops import pileup_device

    def boom(*args, **kwargs):
        raise RuntimeError("pt_pileup_build: CUDA error 700 (injected)")

    queries, homologies, _ = panel(rng, 8, 256)
    monkeypatch.setattr(pileup_device, "build_packed_rows", boom)
    feeder = DeviceRowFeeder(8, 256, CPU)
    feeder.feed(queries[:5], homologies[:5])
    feeder._q.join()  # the worker has met the error
    # the next feed raises it at once: mapping stops early ...
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        feeder.feed(queries[5:], homologies[5:])
    # ... and finish() raises it too: nothing counts around it
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        feeder.finish()
    assert feeder.groups == 0


def test_feeder_refuses_a_short_panel(rng):
    queries, homologies, _ = panel(rng, 6, 300)
    feeder = DeviceRowFeeder(7, 300, CPU)
    feeder.feed(queries, homologies)
    with pytest.raises(RuntimeError, match="6 rows for 7 genomes"):
        feeder.finish()


def _run(main, args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--progress=never", *args])
    return rc, out.getvalue()


def test_streamed_cli_byte_identical(tmp_path, monkeypatch):
    """Forced streaming in groups of 3 prints what the serial port and
    the JAX CLI print."""
    from phylonium_tpu.cli import main as jax_main
    from phylonium_tpu_torch.cli import main
    from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO

    files = write_fasta_panel(tmp_path, 7, 2600, seed=3, contigs=2)
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "0")
    rc0, serial = _run(main, ["--device", "cpu", *files])
    assert rc0 == 0 and LAST_RUN_INFO["stream_groups"] == 0
    rc1, reference = _run(jax_main, files)
    assert rc1 == 0

    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "3")
    rc2, streamed = _run(main, ["--device", "cpu", *files])
    assert rc2 == 0
    assert streamed == serial == reference
    assert LAST_RUN_INFO["stream_groups"] == 3
    assert LAST_RUN_INFO["build_plain_calls"] == 3
    assert LAST_RUN_INFO["build_kernel_launches"] == 0
    assert LAST_RUN_INFO["compare_carrier"] == "torch-cpu"
    assert "map+pileup+feed" in LAST_RUN_INFO["timings"]


@pytest.fixture(scope="module")
def golden_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden_panel_streamed")
    return write_panel(str(d)), str(d)


# the golden cases that stream: complete deletion and -p need the whole
# homology set before the pileup and keep the serial phases
STREAMED_CASES = [
    name for name, argv in sorted(GOLDEN_CASES.items())
    if "--complete-deletion" not in argv and "-p" not in argv
]


@pytest.mark.parametrize("name", STREAMED_CASES)
def test_streamed_cli_reproduces_golden_fixture(name, golden_files, monkeypatch):
    from phylonium_tpu_torch.cli import main
    from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO

    files, tmp = golden_files
    monkeypatch.chdir(tmp)
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    monkeypatch.setenv("PHYLONIUM_TPU_RD_SEED", str(RD_SEED))
    rc, out = _run(main, ["--device", "cpu", *GOLDEN_CASES[name], *files])
    assert rc == 0
    with open(os.path.join(GOLDEN_DIR, f"{name}.stdout"), "rb") as f:
        assert out.encode() == f.read()
    assert LAST_RUN_INFO["stream_groups"] == 4  # 29 genomes in groups of 8


def test_should_stream_conditions(monkeypatch):
    from phylonium_tpu_torch.config import TorchRunConfig
    from phylonium_tpu_torch.core.pipeline import should_stream

    class FakeRef:
        backend_name = "native"

    ref = FakeRef()
    monkeypatch.delenv("PHYLONIUM_TPU_CALIBRATION_FILE", raising=False)
    # the static rule at 1 Gbp of pair work, whatever the measured default
    monkeypatch.setenv("PHYLONIUM_TPU_AUTO_DEVICE_GBP", "1")
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    assert should_stream(29, 5_000, TorchRunConfig(), ref)
    assert should_stream(29, 5_000, TorchRunConfig(device="cpu"), ref)
    # excluded paths stay serial even when forced
    for excluded in (
        TorchRunConfig(complete_deletion=True),
        TorchRunConfig(print_positions=True),
        TorchRunConfig(count_backend="pallas"),
        TorchRunConfig(count_backend="host"),
        TorchRunConfig(mesh="2,4"),
        TorchRunConfig(checkpoint_dir="/tmp/x"),
        TorchRunConfig(map_backend="hybrid"),
    ):
        assert not should_stream(29, 5_000, excluded, ref)
    ref.backend_name = "numpy"
    assert not should_stream(29, 5_000, TorchRunConfig(), ref)
    ref.backend_name = "native"
    # 0 keeps the serial phases; unset leaves it to the gate, which keeps a
    # small panel serial and the CPU always serial
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "0")
    assert not should_stream(29, 5_000, TorchRunConfig(), ref)
    monkeypatch.delenv("PHYLONIUM_TPU_STREAM")
    assert not should_stream(29, 5_000, TorchRunConfig(), ref)
    assert not should_stream(29, 5_000_000, TorchRunConfig(device="cpu"), ref)
    assert should_stream(29, 5_000_000, TorchRunConfig(), ref)


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


_PROBE = """
import json, sys
from phylonium_tpu_torch.cli import main
rc = main(sys.argv[1:])
from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO
print(json.dumps({"rc": rc, "jax": "jax" in sys.modules,
                  "info": LAST_RUN_INFO}), file=sys.stderr)
"""


def test_streamed_run_is_jax_free(tmp_path):
    files = write_fasta_panel(tmp_path, 5, 3000, seed=8)
    r = subprocess.run(
        [sys.executable, "-c", _PROBE, "--progress=never", "--device=cpu",
         "-v", "-v", *files],
        capture_output=True, cwd=tmp_path, timeout=600,
        env=_env(PHYLONIUM_TPU_STREAM="force", PHYLONIUM_TPU_STREAM_GROUP="2"),
    )
    err = r.stderr.decode()
    assert r.returncode == 0, err[-2000:]
    report = json.loads(err.strip().splitlines()[-1])
    assert report["rc"] == 0
    assert report["jax"] is False
    info = report["info"]
    assert info["stream_groups"] == 3
    assert info["build_plain_calls"] == 3 and info["build_kernel_launches"] == 0
    assert info["compare_carrier"] == "torch-cpu"
    assert "3 stream groups, 0 build launches, 3 build plain calls" in err
    assert r.stdout.decode().splitlines()[0].strip() == "5"


_FAILING = """
import sys
from phylonium_tpu_torch.ops import pileup_device

def broken(*args, **kwargs):
    raise RuntimeError("pt_pileup_build: CUDA error 700")

pileup_device.build_packed_rows = broken
from phylonium_tpu_torch.cli import main
sys.exit(main(sys.argv[1:]))
"""


def test_streamed_run_whose_build_fails_exits_nonzero(tmp_path):
    files = write_fasta_panel(tmp_path, 4, 2000, seed=9)
    r = subprocess.run(
        [sys.executable, "-c", _FAILING, "--progress=never", "--device=cpu",
         *files],
        capture_output=True, cwd=tmp_path, timeout=600,
        env=_env(PHYLONIUM_TPU_STREAM="force", PHYLONIUM_TPU_STREAM_GROUP="2"),
    )
    assert r.returncode != 0
    assert r.stdout == b""
    assert b"pt_pileup_build: CUDA error 700" in r.stderr
