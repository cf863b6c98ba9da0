"""The port's pod streamed path (parallel/stream_mp.py) on CPU ranks.

Held against the JAX package, with no tolerance (counts are integers,
stdout is bytes):

- the cell that ``PodShardFeeder`` builds for every rank of (n, R) in
  {(5, 4), (10, 8), (7, 2)}, in mapping groups of 1, 3 and 128 rows,
  equals byte for byte the JAX package's ``pack_states`` of its
  ``build_pileup`` over the rank's rows (the JAX package's native
  homologies on the same numpy-seeded genomes), INVALID beyond; the
  block bounds are the JAX package's (its ``sharded_shape``);
- the feeder cuts a group past the build's int32 limit and still builds
  the same cell; a build error raises, and a failed mapping stops the
  worker;
- ``should_stream_mp`` decides as the JAX package's ``_should_stream_mp``
  on a table of configurations, with the world monkeypatched;
- one gloo world of 4 CPU ranks runs the CLI under
  ``PHYLONIUM_TPU_STREAM=force PHYLONIUM_TPU_STREAM_GROUP=1`` over 5
  genomes (rank 3's block is pure padding): rank 0 prints the JAX CLI's
  ``--count-backend numpy`` matrix byte for byte, no line filtered, the
  others print nothing, and each rank's report shows its block, groups,
  the (4, 1) mesh and its collective bytes as predicted.
"""

import contextlib
import io
import json
import types

import jax
import numpy as np
import pytest
import torch

import phylonium_tpu.utils.platform as jax_platform
from phylonium_tpu.config import RunConfig
from phylonium_tpu.core import pipeline as jax_pipeline
from phylonium_tpu.core.anchor_stats import min_anchor_length as jax_min_anchor
from phylonium_tpu.core.pileup import build_pileup as jax_build_pileup
from phylonium_tpu.data.sequence import Sequence as JaxSequence
from phylonium_tpu.data.sequence import gc_content as jax_gc
from phylonium_tpu.index.esa import ESAIndex as JaxIndex
from phylonium_tpu.ops.shapes import _PACKED_PAD, pack_states
from phylonium_tpu.parallel.distributed import sharded_shape as jax_sharded_shape
from phylonium_tpu_torch.config import TorchRunConfig
from phylonium_tpu_torch.core import pipeline
from phylonium_tpu_torch.core.anchor_stats import min_anchor_length
from phylonium_tpu_torch.data.sequence import Sequence, gc_content
from phylonium_tpu_torch.index.esa import ESAIndex
from phylonium_tpu_torch.ops import pileup_device
from phylonium_tpu_torch.parallel.distributed import counts_from_cell
from phylonium_tpu_torch.parallel.mesh import Mesh
from phylonium_tpu_torch.parallel.stream_mp import (
    PodShardFeeder,
    map_and_feed,
    pod_geometry,
)
from torch_world import spawn_world

CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", np.uint8)
LENGTH = 3_001  # odd: the packed rows' last byte holds one state
WORLD_GENOMES = 5
WORLD = 4

PANELS = [(5, 4), (10, 8), (7, 2)]
CELL_CASES = [(n, ranks, rank, group) for n, ranks in PANELS
              for rank in range(ranks) for group in (1, 3, 128)]


def _genomes(n: int, length: int = LENGTH, seed: int = 0) -> list[bytes]:
    """A random base genome and n - 1 mutants at 0.5-6 % (numpy seed)."""
    rng = np.random.default_rng(seed + n)
    base = ACGT[rng.integers(0, 4, length)]
    out = [base.tobytes()]
    for k in range(1, n):
        arr = base.copy()
        idx = np.flatnonzero(rng.random(length) < 0.005 + 0.055 * k / n)
        arr[idx] = ACGT[(np.searchsorted(ACGT, arr[idx]) + rng.integers(1, 4, idx.size)) % 4]
        out.append(arr.tobytes())
    return out


@pytest.fixture(scope="module")
def jax_states():
    """n -> the JAX package's [n, L] pileup: its native index on genome 0,
    its native mapper's homologies."""
    states = {}
    for n, _ in PANELS:
        seqs = [JaxSequence(f"g{k}", g) for k, g in enumerate(_genomes(n))]
        ref = JaxIndex(seqs[0], backend="native")
        threshold = jax_min_anchor(0.025, jax_gc(seqs[0].nucl), ref.size)
        cfg = RunConfig(map_backend="native", progress="never")
        homologies = jax_pipeline.map_queries(ref, threshold, seqs, cfg)
        states[n] = jax_build_pileup([s.as_array() for s in seqs], homologies, LENGTH)
    return states


@pytest.fixture(scope="module")
def port_index():
    """n -> (the port's native index on genome 0, threshold, sequences)."""
    out = {}
    for n, _ in PANELS:
        seqs = [Sequence(f"g{k}", g) for k, g in enumerate(_genomes(n))]
        ref = ESAIndex(seqs[0], backend="native")
        out[n] = (ref, min_anchor_length(0.025, gc_content(seqs[0].nucl), ref.size), seqs)
    return out


def _cell(port_index, n, ranks, rank, group):
    ref, threshold, seqs = port_index[n]
    feeder = PodShardFeeder(n, LENGTH, Mesh((ranks, 1), rank, CPU, None))
    map_and_feed(ref, threshold, seqs, TorchRunConfig(progress="never"), feeder,
                 group_rows=group)
    return feeder, feeder.cell()


@pytest.mark.parametrize("n,ranks,rank,group", CELL_CASES,
                         ids=[f"n{n}-R{r}-rank{k}-g{g}" for n, r, k, g in CELL_CASES])
def test_cell_equals_jax_pack_states(jax_states, port_index, n, ranks, rank, group):
    # the JAX package's row blocks (phylonium_tpu/parallel/stream_mp.py:79-83)
    _, _, _, n_pad, _ = jax_sharded_shape(n, LENGTH, ranks, 1, "xla")
    rows = n_pad // ranks
    lo, hi = rank * rows, min(rank * rows + rows, n)
    geometry = pod_geometry(n, LENGTH, ranks, rank)
    assert (geometry.n_pad, geometry.rows_per_block, geometry.row_lo, geometry.row_hi) == (
        n_pad, rows, lo, hi)

    feeder, cell = _cell(port_index, n, ranks, rank, group)
    width = geometry.width
    assert tuple(cell.shape) == (rows, width)
    if hi > lo:
        want = pack_states(jax_states[n][lo:hi], rows, width)
    else:
        want = np.full((rows, width), _PACKED_PAD, np.uint8)
    np.testing.assert_array_equal(cell.numpy(), want)
    assert feeder.groups == -(-max(hi - lo, 0) // group)


def test_a_group_past_the_int32_limit_is_cut(port_index, monkeypatch):
    n, ranks, rank = 10, 2, 0
    _, whole = _cell(port_index, n, ranks, rank, 128)
    # room for two genomes a build: the one mapping group of 5 becomes 3
    monkeypatch.setattr(pileup_device, "_MAX_GROUP_BASES", 2 * LENGTH + 1 + 2 * LENGTH + 10)
    calls = pileup_device.PLAIN_CALLS
    feeder, cut = _cell(port_index, n, ranks, rank, 128)
    assert feeder.groups == 3 and pileup_device.PLAIN_CALLS - calls == 3
    assert torch.equal(cut, whole)


def test_a_build_error_raises_in_its_rank(port_index, monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("pt_pileup_build: CUDA error 700 (injected)")

    monkeypatch.setattr(pileup_device, "build_packed_rows", boom)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _cell(port_index, 10, 2, 1, 1)


def test_a_failed_mapping_stops_the_worker(port_index, monkeypatch):
    from phylonium_tpu_torch.parallel import stream_mp

    def lost(*args, **kwargs):
        raise OSError("mapper lost (injected)")

    ref, threshold, seqs = port_index[7]
    feeder = PodShardFeeder(7, LENGTH, Mesh((2, 1), 0, CPU, None))
    monkeypatch.setattr(stream_mp, "map_batch_native", lost)
    with pytest.raises(OSError, match="injected"):
        map_and_feed(ref, threshold, seqs, TorchRunConfig(progress="never"), feeder)
    feeder._feeder._worker.join(timeout=10)
    assert not feeder._feeder._worker.is_alive()


def test_counts_from_cell_checks_the_cell():
    mesh = Mesh((1, 1), 0, CPU, None)
    with pytest.raises(ValueError, match=r"holds \[5, 16\]"):
        counts_from_cell(torch.zeros((4, 16), dtype=torch.uint8), 5, 20, mesh)


# the gate: (field overrides, PHYLONIUM_TPU_STREAM, world size, n, device)
_BASE = {"count_backend": "auto", "mesh": "", "complete_deletion": False,
         "print_positions": False, "checkpoint_dir": "", "map_backend": "auto"}
GATE_CASES = {
    "default-cuda": ({}, "", 4, 29, "cuda"),
    "default-cpu": ({}, "", 4, 29, "cpu"),
    "one-group": ({}, "", 4, 8, "cuda"),
    "one-rank": ({}, "", 1, 29, "cuda"),
    "one-rank-forced": ({}, "force", 1, 29, "cpu"),
    "off": ({}, "0", 4, 29, "cuda"),
    "forced-cpu": ({}, "force", 4, 5, "cpu"),
    "native-map": ({"map_backend": "native"}, "", 4, 29, "cuda"),
    "python-map": ({"map_backend": "python"}, "force", 4, 29, "cuda"),
    "hybrid-map": ({"map_backend": "hybrid"}, "", 4, 29, "cuda"),
    "numpy-index": ({"esa": "numpy"}, "force", 4, 29, "cuda"),
    "mesh": ({"mesh": "2,2"}, "force", 4, 29, "cuda"),
    "device-count": ({"count_backend": "device"}, "", 4, 29, "cuda"),
    "pallas-count": ({"count_backend": "pallas"}, "force", 4, 29, "cuda"),
    "host-count": ({"count_backend": "host"}, "force", 4, 29, "cuda"),
    "complete-deletion": ({"complete_deletion": True}, "force", 4, 29, "cuda"),
    "positions": ({"print_positions": True}, "", 4, 29, "cuda"),
    "checkpoint": ({"checkpoint_dir": "ckpt"}, "force", 4, 29, "cuda"),
    "group-env": ({}, "", 4, 29, "cuda"),
}


@pytest.mark.parametrize("name", list(GATE_CASES))
def test_gate_follows_the_jax_gate(name, monkeypatch):
    fields, env, size, n, device = GATE_CASES[name]
    fields = dict(fields)
    ref = types.SimpleNamespace(backend_name=fields.pop("esa", "native"))
    if env:
        monkeypatch.setenv("PHYLONIUM_TPU_STREAM", env)
    else:
        monkeypatch.delenv("PHYLONIUM_TPU_STREAM", raising=False)
    if name == "group-env":
        monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "32")
    else:
        monkeypatch.delenv("PHYLONIUM_TPU_STREAM_GROUP", raising=False)
    # the JAX gate on a pod of one device a process; a CUDA --device is
    # its device platform, a CPU one its cpu_pinned()
    monkeypatch.setattr(jax_pipeline, "_is_multiprocess", lambda: size > 1)
    monkeypatch.setattr(jax, "local_device_count", lambda: 1)
    monkeypatch.setattr(jax_platform, "cpu_pinned", lambda: device == "cpu")
    monkeypatch.setattr(pipeline, "world", lambda: (size, 0))
    want = jax_pipeline._should_stream_mp(n, 1000, RunConfig(**{**_BASE, **fields}), ref)
    got = pipeline.should_stream_mp(TorchRunConfig(**{**_BASE, **fields}, device=device),
                                    ref, n)
    assert got == want, name
    # before the index the port takes the index as native
    if ref.backend_name == "native":
        assert pipeline.should_stream_mp(
            TorchRunConfig(**{**_BASE, **fields}, device=device), None, n) == want


_CLI = """
import json
from phylonium_tpu_torch.cli import main
from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO
rc = main(ARGS)
print(json.dumps({"rc": rc, "info": LAST_RUN_INFO}), file=sys.stderr)
"""


@pytest.fixture(scope="module")
def world_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_stream_mp")
    paths = []
    for k, g in enumerate(_genomes(WORLD_GENOMES, 9_000, seed=5)):
        path = tmp / f"g{k}.fasta"
        path.write_bytes(b">g%d\n" % k + g + b"\n")
        paths.append(str(path))
    return paths, tmp


@pytest.fixture(scope="module")
def expected(world_files):
    from phylonium_tpu.cli import main

    paths, _ = world_files
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["--progress=never", "--count-backend", "numpy", *paths]) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def ranks(world_files):
    paths, tmp = world_files
    args = ["--progress=never", "--device", "cpu", "-v", "-v", *paths]
    outs = spawn_world(_CLI, WORLD, tmp, args=args,
                       env_extra={"PHYLONIUM_TPU_STREAM": "force",
                                  "PHYLONIUM_TPU_STREAM_GROUP": "1"})
    runs = []
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} exited {rc}:\n{err[-3000:]}"
        report = json.loads(err.strip().splitlines()[-1])
        assert report["rc"] == 0
        runs.append({"info": report["info"], "out": out, "err": err})
    return runs


def test_world_rank0_prints_the_jax_matrix(ranks, expected):
    assert ranks[0]["out"] == expected


def test_world_other_ranks_print_nothing(ranks):
    assert [r["out"] for r in ranks[1:]] == ["", "", ""]


@pytest.mark.parametrize("rank", range(WORLD))
def test_world_rank_streams_its_block(ranks, rank):
    r, g = ranks[rank], pod_geometry(WORLD_GENOMES, 9_000, WORLD, rank)
    line = (f"pod stream: process {rank}/{WORLD} mapped+fed rows "
            f"[{g.row_lo}, {g.row_hi}) of {WORLD_GENOMES}")
    assert line in r["err"] and "mapping sharded:" not in r["err"]
    info = r["info"]
    assert info["compare_carrier"] == "mesh" and info["map_carrier"] == "native"
    assert info["mesh"]["shape"] == [WORLD, 1] and info["mesh"]["rank"] == rank
    # groups of one row: one build a real row, none on the padding rank
    assert info["stream_groups"] == g.real_rows == info["build_plain_calls"]
    assert info["build_kernel_launches"] == 0 and info["kernel_launches"] == 0
    assert info["plain_calls"] >= 1
    assert set(info["timings"]) == {"index", "map+feed", "compare"}
    comm = info["mesh"]["comm"]
    for key in ("gather_recv_bytes", "psum_bytes", "result_gather_recv_bytes"):
        assert comm[f"measured_{key}"] == comm[f"predicted_{key}"], key
    assert "prewarm" not in info  # nothing is warmed on the CPU
