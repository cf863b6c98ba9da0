"""The serial path's device pileup (X2) on the CPU route.

With ``PHYLONIUM_TPU_DEVICE_PILEUP=1`` the port builds the serial path's
pileup on ``--device`` as the packed panel the count reads, through the
streamed feeder and the pileup-build kernel's plain version here. It must
print what the host-pileup port, the JAX CLI and the golden fixtures
print, byte for byte, and its panel must equal the JAX package's
``build_pileup_device`` (XLA on the CPU), packed.
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
from phylonium_tpu_torch.config import ConfigError, TorchRunConfig
from phylonium_tpu_torch.ops import pileup_device, pileup_groups
from phylonium_tpu_torch.ops.states import pack_rows
from pileup_cases import panel, write_fasta_panel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "data", "golden")
CPU = torch.device("cpu")


def _run(main, args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--progress=never", *args])
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def golden_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden_panel_device_pileup")
    return write_panel(str(d)), str(d)


# every golden case but -p, which needs the host matrix
DEVICE_PILEUP_CASES = [
    name for name, argv in sorted(GOLDEN_CASES.items()) if "-p" not in argv
]


def test_device_pileup_cases_are_the_eight_without_p():
    assert len(DEVICE_PILEUP_CASES) == 8
    assert {"complete_deletion", "verbose_cd_2pass"} <= set(DEVICE_PILEUP_CASES)


@pytest.mark.parametrize("name", DEVICE_PILEUP_CASES)
def test_device_pileup_reproduces_golden_fixture(name, golden_files, monkeypatch):
    from phylonium_tpu_torch.cli import main
    from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO

    files, tmp = golden_files
    monkeypatch.chdir(tmp)
    monkeypatch.setenv("PHYLONIUM_TPU_DEVICE_PILEUP", "1")
    monkeypatch.setenv("PHYLONIUM_TPU_RD_SEED", str(RD_SEED))
    rc, out = _run(main, ["--device", "cpu", *GOLDEN_CASES[name], *files])
    assert rc == 0
    with open(os.path.join(GOLDEN_DIR, f"{name}.stdout"), "rb") as f:
        assert out.encode() == f.read()
    # 29 genomes in groups of 8 (effective_group_rows), on the plain route
    assert LAST_RUN_INFO["build_plain_calls"] == 4
    assert LAST_RUN_INFO["build_kernel_launches"] == 0
    assert LAST_RUN_INFO["stream_groups"] == 0
    assert LAST_RUN_INFO["compare_carrier"] == "torch-cpu"
    assert set(LAST_RUN_INFO["timings"]) >= {"index", "map", "pileup", "compare"}


FLAG_CASES = {
    "plain": [],
    "complete_deletion": ["--complete-deletion"],
    "hybrid": ["--map-backend", "hybrid"],
    "hybrid_complete_deletion": ["--map-backend", "hybrid", "--complete-deletion"],
    "checkpoint": ["--checkpoint", "CKPT"],
}


@pytest.mark.parametrize("name", sorted(FLAG_CASES))
def test_device_pileup_cli_equals_serial_and_jax(name, tmp_path, monkeypatch):
    from phylonium_tpu.cli import main as jax_main
    from phylonium_tpu_torch.cli import main
    from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO

    files = write_fasta_panel(tmp_path, 7, 2600, seed=3, contigs=2)
    args = [str(tmp_path / "ckpt") if a == "CKPT" else a for a in FLAG_CASES[name]]
    rc0, serial = _run(main, ["--device", "cpu", *args, *files])
    assert rc0 == 0 and LAST_RUN_INFO["build_plain_calls"] == 0
    # the JAX CLI maps natively: hybrid mapping gives the same homologies
    jax_args = [a for a in args if a not in ("--map-backend", "hybrid")]
    rc1, reference = _run(jax_main, ["--count-backend", "host", *jax_args, *files])
    assert rc1 == 0
    monkeypatch.setenv("PHYLONIUM_TPU_DEVICE_PILEUP", "1")
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "3")
    rc2, device = _run(main, ["--device", "cpu", *args, *files])
    assert rc2 == 0
    assert device == serial == reference
    assert LAST_RUN_INFO["build_plain_calls"] == 3  # 7 genomes in groups of 3
    assert LAST_RUN_INFO["plain_calls"] == 1


def _mapped(tmp_path, map_backend, complete_deletion):
    """A small panel indexed and mapped by the port, as the serial path
    maps it: (queries, homologies, ref_len)."""
    from phylonium_tpu_torch.core.anchor_stats import min_anchor_length
    from phylonium_tpu_torch.core.complete_deletion import complete_delete
    from phylonium_tpu_torch.core.pipeline import map_queries
    from phylonium_tpu_torch.data.sequence import gc_content
    from phylonium_tpu_torch.index.esa import ESAIndex
    from phylonium_tpu_torch.io.fasta import read_genome
    from phylonium_tpu_torch.data.sequence import join

    files = write_fasta_panel(tmp_path, 6, 3000, seed=12, contigs=3)
    queries = [join(read_genome(f)) for f in files]
    ref = ESAIndex(queries[0], backend="native")
    threshold = min_anchor_length(0.025, gc_content(queries[0].nucl), ref.size)
    cfg = TorchRunConfig(device="cpu", map_backend=map_backend, progress="never")
    homologies = map_queries(ref, threshold, queries, cfg)
    if complete_deletion:
        homologies = complete_delete(homologies)
    return [q.as_array() for q in queries], homologies, len(queries[0])


@pytest.mark.parametrize("map_backend", ["native", "hybrid"])
@pytest.mark.parametrize("complete_deletion", [False, True])
def test_panel_equals_jax_build_pileup_device(tmp_path, monkeypatch, map_backend,
                                              complete_deletion):
    from phylonium_tpu.core.pileup import build_pileup
    from phylonium_tpu.ops.pileup_device import build_pileup_device as jax_build

    queries, homologies, ref_len = _mapped(tmp_path, map_backend, complete_deletion)
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "4")
    calls = pileup_device.PLAIN_CALLS
    ours = pileup_device.build_pileup_device(queries, homologies, ref_len, CPU)
    assert pileup_device.PLAIN_CALLS - calls == 2  # 6 genomes in groups of 4
    theirs = np.asarray(jax_build(queries, homologies, ref_len))[:, :ref_len]
    np.testing.assert_array_equal(ours.numpy(), pack_rows(theirs))
    np.testing.assert_array_equal(
        ours.numpy(), pack_rows(build_pileup(queries, homologies, ref_len))
    )


def test_groups_cut_by_the_base_limit_change_no_byte(rng, monkeypatch):
    queries, homologies, ref_len = panel(rng, 9, 700)
    whole = pileup_device.build_pileup_device(queries, homologies, ref_len, CPU)
    lengths = [len(q) for q in queries]
    # a limit of about two and a half queries: groups of two
    monkeypatch.setattr(
        pileup_groups, "_MAX_GROUP_BASES", 2 * ref_len + 1 + 5 * max(lengths) // 2
    )
    bounds = pileup_device.row_groups(lengths, ref_len, 128)
    assert [hi - lo for lo, hi in bounds] == [2, 2, 2, 2, 1]
    calls = pileup_device.PLAIN_CALLS
    cut = pileup_device.build_pileup_device(queries, homologies, ref_len, CPU)
    assert pileup_device.PLAIN_CALLS - calls == len(bounds)
    assert torch.equal(cut, whole)


def test_row_groups_follow_the_jax_rule():
    # no cut below the limit but the row cap; a greedy cut above it
    assert pileup_device.row_groups([5] * 7, 10, 3) == [(0, 3), (3, 6), (6, 7)]
    limit = pileup_groups._MAX_GROUP_BASES - 2 * 10 - 1
    big = limit // 2 + 1
    assert pileup_device.row_groups([big, big, 3, big], 10, 128) == [(0, 1), (1, 3), (3, 4)]
    assert pileup_device.row_groups([limit], 10, 128) == [(0, 1)]
    with pytest.raises(ConfigError, match=f"a {limit + 1}-base query needs the host builder"):
        pileup_device.row_groups([3, limit + 1], 10, 128)


def test_a_query_above_the_limit_exits_1(tmp_path, monkeypatch, capsys):
    from phylonium_tpu_torch.cli import main

    files = write_fasta_panel(tmp_path, 4, 2000, seed=4)
    monkeypatch.setenv("PHYLONIUM_TPU_DEVICE_PILEUP", "1")
    monkeypatch.setattr(pileup_groups, "_MAX_GROUP_BASES", 2 * 2000 + 1 + 1999)
    calls = pileup_device.PLAIN_CALLS
    rc, out = _run(main, ["--device", "cpu", *files])
    assert rc == 1 and out == ""
    err = capsys.readouterr().err
    assert "a 2000-base query needs the host builder" in err
    assert "PHYLONIUM_TPU_DEVICE_PILEUP" in err
    assert pileup_device.PLAIN_CALLS == calls


@pytest.mark.parametrize(
    "args", [["-p", "REFPOS"], ["--count-backend", "host"], ["--count-backend", "numpy"]]
)
def test_host_pileup_kept(args, tmp_path, monkeypatch):
    from phylonium_tpu_torch.cli import main
    from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO

    files = write_fasta_panel(tmp_path, 4, 2000, seed=5)
    args = [str(tmp_path / "refpos.txt") if a == "REFPOS" else a for a in args]
    monkeypatch.setenv("PHYLONIUM_TPU_DEVICE_PILEUP", "1")
    rc, _ = _run(main, ["--device", "cpu", *args, *files])
    assert rc == 0
    assert LAST_RUN_INFO["build_plain_calls"] == 0
    assert LAST_RUN_INFO["build_kernel_launches"] == 0


def test_device_pileup_gate(monkeypatch):
    from phylonium_tpu_torch.core.pipeline import device_pileup

    monkeypatch.setenv("PHYLONIUM_TPU_DEVICE_PILEUP", "1")
    for backend in ("auto", "device", "pallas"):
        assert device_pileup(TorchRunConfig(count_backend=backend))
    assert device_pileup(TorchRunConfig(map_backend="hybrid", checkpoint_dir="x"))
    assert not device_pileup(TorchRunConfig(print_positions=True))
    assert not device_pileup(TorchRunConfig(count_backend="host"))
    monkeypatch.setenv("PHYLONIUM_TPU_DEVICE_PILEUP", "0")
    assert not device_pileup(TorchRunConfig())


_PROBE = """
import json, sys
from phylonium_tpu_torch.cli import main
rc = main(sys.argv[1:])
from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO
print(json.dumps({"rc": rc, "jax": "jax" in sys.modules,
                  "info": LAST_RUN_INFO}), file=sys.stderr)
"""


def test_device_pileup_run_is_jax_free(tmp_path):
    files = write_fasta_panel(tmp_path, 5, 3000, seed=8)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(PHYLONIUM_TPU_DEVICE_PILEUP="1", PHYLONIUM_TPU_STREAM_GROUP="2")
    r = subprocess.run(
        [sys.executable, "-c", _PROBE, "--progress=never", "--device=cpu",
         "-v", "-v", "--complete-deletion", *files],
        capture_output=True, cwd=tmp_path, timeout=600, env=env,
    )
    err = r.stderr.decode()
    assert r.returncode == 0, err[-2000:]
    report = json.loads(err.strip().splitlines()[-1])
    assert report["rc"] == 0 and report["jax"] is False
    info = report["info"]
    assert info["build_plain_calls"] == 3 and info["build_kernel_launches"] == 0
    assert info["stream_groups"] == 0 and info["compare_carrier"] == "torch-cpu"
    assert "0 stream groups, 0 build launches, 3 build plain calls" in err
    assert r.stdout.decode().splitlines()[0].strip() == "5"
