"""The pod streamed path and the device prewarm on a card.

Skips without a CUDA device. Imports nothing of jax; the reference matrix
is the JAX package's CLI with host counting in a subprocess:

    CXX=g++ PHYLONIUM_TPU_TEST_REAL=1 python -m pytest -m cuda tests/test_torch_stream_mp_cuda.py

- the cells that the pileup-build kernel builds for every rank of
  (n, R) in {(5, 4), (10, 8), (7, 2)} equal the plain build's, padding
  rows included, one launch a group;
- the CLI in a gloo world of 2 rank processes sharing the card takes the
  pod streamed path by the gate, with no environment variable, and rank 0
  prints the JAX package's matrix;
- a fresh CLI process on the card reports its prewarm, and its launch
  counts hold only the run's own launches.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from phylonium_tpu_torch.config import TorchRunConfig
from phylonium_tpu_torch.core.anchor_stats import min_anchor_length
from phylonium_tpu_torch.data.sequence import Sequence, gc_content
from phylonium_tpu_torch.index.esa import ESAIndex
from phylonium_tpu_torch.ops import pair_count, pileup_device
from phylonium_tpu_torch.parallel.mesh import Mesh
from phylonium_tpu_torch.parallel.stream_mp import PodShardFeeder, map_and_feed
from pileup_cases import write_fasta_panel
from torch_world import REPO, spawn_world

ACGT = np.frombuffer(b"ACGT", np.uint8)
LENGTH = 20_001
CASES = [(n, ranks, rank) for n, ranks in [(5, 4), (10, 8), (7, 2)] for rank in range(ranks)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def indexes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    out = {}
    rng = np.random.default_rng(21)
    base = ACGT[rng.integers(0, 4, LENGTH)]
    for n in (5, 7, 10):
        seqs = []
        for k in range(n):
            arr = base.copy()
            idx = np.flatnonzero(rng.random(LENGTH) < 0.006 * k)
            arr[idx] = ACGT[(np.searchsorted(ACGT, arr[idx]) + rng.integers(1, 4, idx.size)) % 4]
            seqs.append(Sequence(f"g{k}", arr.tobytes()))
        ref = ESAIndex(seqs[0], backend="native")
        out[n] = (ref, min_anchor_length(0.025, gc_content(seqs[0].nucl), ref.size), seqs)
    return out


def _cell(indexes, n, ranks, rank, device, group):
    ref, threshold, seqs = indexes[n]
    feeder = PodShardFeeder(n, LENGTH, Mesh((ranks, 1), rank, device, None))
    map_and_feed(ref, threshold, seqs, TorchRunConfig(progress="never"), feeder,
                 group_rows=group)
    return feeder, feeder.cell()


@pytest.mark.cuda
@pytest.mark.parametrize("n,ranks,rank", CASES,
                         ids=[f"n{n}-R{r}-rank{k}" for n, r, k in CASES])
def test_kernel_cell_equals_plain(card, indexes, n, ranks, rank):
    launches = pileup_device.KERNEL_LAUNCHES
    feeder, got = _cell(indexes, n, ranks, rank, card, 2)
    torch.cuda.synchronize()
    assert pileup_device.KERNEL_LAUNCHES - launches == feeder.groups
    _, plain = _cell(indexes, n, ranks, rank, torch.device("cpu"), 2)
    assert got.device == card
    assert torch.equal(got.cpu(), plain)


def _reference(files, cwd) -> str:
    from phylonium_tpu.native.build import ensure_built

    ensure_built()  # once, before the reference CLI's reader threads
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "phylonium_tpu", "--progress=never", "--count-backend",
         "host", *files], capture_output=True, text=True, cwd=cwd, env=env, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


_CLI = """
import json
from phylonium_tpu_torch.cli import main
from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO
rc = main(ARGS)
print(json.dumps({"rc": rc, "info": LAST_RUN_INFO}), file=sys.stderr)
"""


@pytest.mark.cuda
def test_two_ranks_sharing_the_card(card, tmp_path, monkeypatch):
    monkeypatch.delenv("PHYLONIUM_TPU_STREAM", raising=False)
    monkeypatch.delenv("PHYLONIUM_TPU_STREAM_GROUP", raising=False)
    files = write_fasta_panel(tmp_path, 11, 20_000, seed=8, contigs=2)
    outs = spawn_world(_CLI, 2, tmp_path,
                       args=["--progress=never", "--device", "cuda", "-v", "-v", *files])
    reports = []
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} exited {rc}:\n{err[-3000:]}"
        reports.append(json.loads(err.strip().splitlines()[-1])["info"])
        # n_pad 12 over 2 ranks: [0, 6) and [6, 11)
        lo, hi = (0, 6) if rank == 0 else (6, 11)
        assert f"pod stream: process {rank}/2 mapped+fed rows [{lo}, {hi}) of 11" in err
    assert outs[0][1] == _reference(files, tmp_path)
    assert outs[1][1] == ""
    for info in reports:
        assert info["compare_carrier"] == "mesh" and info["mesh"]["shape"] == [2, 1]
        assert info["mesh"]["shard_carrier"] == "cuda-kernel"
        assert info["build_kernel_launches"] == info["stream_groups"] == 1
        assert info["kernel_launches"] == pair_count.LAUNCHES_PER_CALL
        assert info["plain_calls"] == info["build_plain_calls"] == 0
        comm = info["mesh"]["comm"]
        for key in ("gather_recv_bytes", "psum_bytes", "result_gather_recv_bytes"):
            assert comm[f"measured_{key}"] == comm[f"predicted_{key}"], key
        assert info["prewarm"]["launches"] == {"pair_count": 2, "pileup_build": 1}


@pytest.mark.cuda
def test_a_fresh_process_reports_its_prewarm(card, tmp_path):
    files = write_fasta_panel(tmp_path, 4, 20_000, seed=9, contigs=1)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["PHYLONIUM_TPU_RUN_REPORT"] = str(tmp_path / "report.json")
    for key in ("PHYLONIUM_TPU_STREAM", "PHYLONIUM_TPU_DEVICE_PILEUP", "PHYLONIUM_TPU_LOWMEM"):
        env.pop(key, None)
    proc = subprocess.run(
        # the count pinned on the card: 'auto' would send so small a panel
        # to the host, with no prewarm
        [sys.executable, "-m", "phylonium_tpu_torch", "--progress=never", "--count-backend",
         "device", "--device", "cuda", *files],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    info = json.loads((tmp_path / "report.json").read_text())
    prewarm = info["prewarm"]
    assert prewarm["seconds"] > 0 and prewarm["waited"] >= 0
    assert prewarm["launches"] == {"pair_count": pair_count.LAUNCHES_PER_CALL}
    assert info["kernel_launches"] == pair_count.LAUNCHES_PER_CALL
