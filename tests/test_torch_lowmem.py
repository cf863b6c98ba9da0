"""The port's low-memory pipeline (CPU route) against the serial port and
the JAX CLI.

``PHYLONIUM_TPU_LOWMEM=force`` runs compact the sequences at read time,
map in capped groups into raw [H, 5] homology arrays and count either
through the streamed feeder (on ``--device cpu``, the plain build and
count) or through the JAX package's windowed host counter
(``--count-backend host``); both must print what the serial run prints,
byte for byte. The feeder's bounded queue blocks ``feed()`` while the
worker lags; it never cancels the device leg.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from phylonium_tpu.core.pileup import build_pileup
from phylonium_tpu.ops.match_table import pair_counts_numpy
from phylonium_tpu_torch.core.stream import MAX_BACKLOG, DeviceRowFeeder
from pileup_cases import panel, write_fasta_panel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(main, args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--progress=never", *args])
    return rc, out.getvalue()


@pytest.mark.parametrize("backend", ["cpu", "host"])
@pytest.mark.parametrize("contigs", [1, 3])
def test_lowmem_cli_byte_identical(tmp_path, monkeypatch, contigs, backend):
    """Forced low-memory runs print what the serial port and the JAX CLI
    print, with 1 and 3 contigs ('!' separators), one and two passes."""
    from phylonium_tpu.cli import main as jax_main
    from phylonium_tpu_torch.cli import main
    from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO

    files = write_fasta_panel(tmp_path, 9, 4800, seed=41 + contigs,
                              contigs=contigs)
    count = ["--count-backend", "host"] if backend == "host" else []
    args = ["--device", "cpu", *count, *files]
    monkeypatch.delenv("PHYLONIUM_TPU_LOWMEM", raising=False)
    rc0, serial = _run(main, args)
    assert rc0 == 0 and "lowmem" not in LAST_RUN_INFO
    rc1, reference = _run(jax_main, [*count, *files])
    assert rc1 == 0
    rc2, serial_2pass = _run(main, ["-2", *args])
    assert rc2 == 0

    monkeypatch.setenv("PHYLONIUM_TPU_LOWMEM", "force")
    rc3, low = _run(main, args)
    assert rc3 == 0
    assert low == serial == reference
    lowmem = LAST_RUN_INFO["lowmem"]
    assert lowmem["group_rows"] == 8 and lowmem["homologies"] > 0
    assert "map+feed" in LAST_RUN_INFO["timings"]
    # the unpacked genomes are mapped where they lie
    assert LAST_RUN_INFO["map_staged_mb"] == 0
    if backend == "host":
        assert LAST_RUN_INFO["compare_carrier"] == "host"
        assert LAST_RUN_INFO["stream_groups"] == 0
        assert LAST_RUN_INFO["build_plain_calls"] == 0
    else:
        assert LAST_RUN_INFO["compare_carrier"] == "torch-cpu"
        assert LAST_RUN_INFO["stream_groups"] == 2  # 9 genomes, 8 a group
        assert LAST_RUN_INFO["build_plain_calls"] == 2
        assert LAST_RUN_INFO["plain_calls"] == 1
    # the second pass re-processes the compacted sequences
    rc4, low_2pass = _run(main, ["-2", *args])
    assert rc4 == 0 and low_2pass == serial_2pass
    if backend == "cpu":
        # the streamed route maps the genomes' bytes in place too
        monkeypatch.delenv("PHYLONIUM_TPU_LOWMEM")
        monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
        rc5, streamed = _run(main, args)
        assert rc5 == 0 and streamed == serial
        assert "lowmem" not in LAST_RUN_INFO and LAST_RUN_INFO["stream_groups"] > 0
        assert LAST_RUN_INFO["map_staged_mb"] == 0


def test_lowmem_is_predicted_from_file_sizes(tmp_path, monkeypatch):
    from phylonium_tpu_torch.cli import _predicts_lowmem
    from phylonium_tpu_torch.config import TorchRunConfig

    files = write_fasta_panel(tmp_path, 3, 1000, seed=2)
    monkeypatch.delenv("PHYLONIUM_TPU_LOWMEM", raising=False)
    assert not _predicts_lowmem(files, TorchRunConfig())
    monkeypatch.setenv("PHYLONIUM_TPU_LOWMEM_BYTES", "2000")
    assert _predicts_lowmem(files, TorchRunConfig())
    assert not _predicts_lowmem(files, TorchRunConfig(count_backend="numpy"))
    monkeypatch.setenv("PHYLONIUM_TPU_LOWMEM", "0")
    assert not _predicts_lowmem(files, TorchRunConfig())
    monkeypatch.setenv("PHYLONIUM_TPU_LOWMEM", "force")
    assert _predicts_lowmem(files, TorchRunConfig())
    assert not _predicts_lowmem([str(tmp_path / "missing.fa")], TorchRunConfig())


def test_full_backlog_blocks_feed(rng, monkeypatch):
    """A slow worker makes feed() wait once MAX_BACKLOG groups are
    queued; nothing is dropped and the counts stay exact."""
    from phylonium_tpu_torch.ops import pileup_device

    gate, started = threading.Event(), threading.Event()
    build = pileup_device.build_packed_rows

    def slow(*args, **kwargs):
        started.set()
        assert gate.wait(60)
        return build(*args, **kwargs)

    monkeypatch.setattr(pileup_device, "build_packed_rows", slow)
    queries, homologies, ref_len = panel(rng, 10, 400)
    feeder = DeviceRowFeeder(10, ref_len, torch.device("cpu"))
    feeder.feed(queries[0:2], homologies[0:2])
    assert started.wait(60)  # the worker holds the first group
    for lo in range(2, 2 + 2 * MAX_BACKLOG, 2):
        feeder.feed(queries[lo : lo + 2], homologies[lo : lo + 2])
    lo = 2 + 2 * MAX_BACKLOG
    blocked = threading.Thread(
        target=feeder.feed, args=(queries[lo : lo + 2], homologies[lo : lo + 2])
    )
    blocked.start()
    blocked.join(0.5)
    assert blocked.is_alive()  # waits for room, is not cancelled
    gate.set()
    blocked.join(60)
    assert not blocked.is_alive()
    for lo in range(lo + 2, 10, 2):
        feeder.feed(queries[lo : lo + 2], homologies[lo : lo + 2])
    subs, homs = feeder.finish()
    assert feeder.groups == 5
    es, eh = pair_counts_numpy(build_pileup(queries, homologies, ref_len))
    np.testing.assert_array_equal(subs, es)
    np.testing.assert_array_equal(homs, eh)


_PROBE = """
import json, sys
from phylonium_tpu_torch.cli import main
rc = main(sys.argv[1:])
from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO
print(json.dumps({"rc": rc, "jax": "jax" in sys.modules,
                  "info": LAST_RUN_INFO}), file=sys.stderr)
"""


def test_lowmem_run_is_jax_free(tmp_path):
    files = write_fasta_panel(tmp_path, 5, 3000, seed=12, contigs=2)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["PHYLONIUM_TPU_LOWMEM"] = "force"
    r = subprocess.run(
        [sys.executable, "-c", _PROBE, "--progress=never", "--device=cpu",
         "-v", "-v", *files],
        capture_output=True, cwd=tmp_path, timeout=600, env=env,
    )
    err = r.stderr.decode()
    assert r.returncode == 0, err[-2000:]
    report = json.loads(err.strip().splitlines()[-1])
    assert report["rc"] == 0 and report["jax"] is False
    info = report["info"]
    assert info["lowmem"]["group_rows"] == 8
    assert info["stream_groups"] == 1 and info["build_plain_calls"] == 1
    assert info["compare_carrier"] == "torch-cpu"
    assert "low-mem, 8 rows a group" in err
    assert r.stdout.decode().splitlines()[0].strip() == "5"
