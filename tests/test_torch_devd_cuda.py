"""The device server on a card (``--device cuda``).

Skips without a CUDA device. Imports nothing of jax, so it runs on a
machine with a card and no jax:

    PHYLONIUM_TPU_TEST_REAL=1 python -m pytest -m cuda tests/test_torch_devd_cuda.py

- a panel shipped to the server and counted there equals, bit for bit,
  the in-process feeder's ``pair_counts_rows``, with the server's build
  and pair-count launches reported;
- the CLI through the server prints the serial run's matrix and never
  initializes CUDA in its own process (a child process's run report).
"""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from phylonium_tpu_torch.core.query_ship import DevdGroup, QueryShipper
from phylonium_tpu_torch.core.stream import DeviceRowFeeder
from phylonium_tpu_torch.ops.pair_count import LAUNCHES_PER_CALL
from phylonium_tpu_torch.serve import client as devd_client
from pileup_cases import panel, write_fasta_panel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def card_daemon(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    tmp = tmp_path_factory.mktemp("devd_cuda")
    sock = str(tmp / "d.sock")
    env = dict(os.environ, PHYLONIUM_TPU_DEVD_SOCK=sock, PHYLONIUM_TPU_DEVD_IDLE_S="600")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    with open(tmp / "d.log", "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "phylonium_tpu_torch.serve", "--device", "cuda"],
            stdout=log, stderr=log, env=env,
        )
    deadline = time.time() + 300
    while time.time() < deadline and not os.path.exists(sock + ".pid"):
        assert proc.poll() is None, (tmp / "d.log").read_text()[-2000:]
        time.sleep(0.1)
    yield sock
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=60) == 0
    assert not os.path.exists(sock)


@pytest.fixture
def devd(card_daemon, monkeypatch):
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD_SOCK", card_daemon)
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "1")
    devd_client._client = None
    yield card_daemon
    if devd_client._client is not None:
        devd_client._client.close()
    devd_client._client = None


@pytest.mark.cuda
def test_a_panel_counted_in_the_server_equals_the_in_process_count(devd):
    rng = np.random.default_rng(17)
    n, length = 21, 40_000
    queries, homologies, _ = panel(rng, n, length)
    card = torch.device("cuda")
    local = DeviceRowFeeder(n, length, card)
    shipper = QueryShipper(n, card, group_rows=8, transport="devd")
    for q in queries:
        shipper.add(q)
    served = DeviceRowFeeder(n, length, card, shipper=shipper, devd=True)
    for lo in range(0, n, 8):
        local.feed(queries[lo:lo + 8], homologies[lo:lo + 8])
        served.feed(queries[lo:lo + 8], homologies[lo:lo + 8])
    want = local.finish()
    got = served.finish()
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert isinstance(shipper.take(0, 8), DevdGroup)
    assert served.taken == 3 and served.repacked == 0
    reply = served.devd_reply
    assert reply["device"] == "cuda:0"
    assert reply["launches"] == {"build": 3, "build_plain": 0,
                                 "count": LAUNCHES_PER_CALL, "count_plain": 0}
    assert reply["memory_reserved"] > 0
    shipper.stop()


@pytest.mark.cuda
def test_the_cli_through_the_server_never_initializes_cuda(devd, tmp_path):
    from phylonium_tpu_torch.cli import main

    files = write_fasta_panel(tmp_path, 12, 30_000, seed=9)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["--progress=never", "--count-backend", "device", *files]) == 0
    report = tmp_path / "report.json"
    env = dict(os.environ, PHYLONIUM_TPU_STREAM="force", PHYLONIUM_TPU_STREAM_GROUP="4",
               PHYLONIUM_TPU_RUN_REPORT=str(report))
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    child = subprocess.run(
        [sys.executable, "-m", "phylonium_tpu_torch", "--progress=never", "-v", "-v", *files],
        capture_output=True, text=True, env=env, timeout=600, cwd=tmp_path,
    )
    assert child.returncode == 0, child.stderr[-3000:]
    assert child.stdout == out.getvalue()
    info = json.loads(report.read_text())
    assert info["cuda_initialized"] is False
    assert info["kernel_launches"] == info["build_kernel_launches"] == 0
    assert info["devd"]["launches"]["build"] == 3
    assert info["devd"]["launches"]["count"] == LAUNCHES_PER_CALL
    assert info["devd"]["socket"] == devd and "device server" in child.stderr
