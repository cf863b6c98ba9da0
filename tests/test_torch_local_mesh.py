"""The port's counting mesh over one process's local devices.

A process of one rank spans its local devices in a ('rows', 'cols') mesh,
as the JAX package spans its devices (parallel/mesh.py's local mesh). On
the CPU every cell is the CPU: ``utils.platform.local_devices`` patched to
eight CPU cells is the counterpart of the eight virtual devices of
tests/conftest.py. Integers are compared bit for bit:

- ``pair_counts_sharded`` on local meshes (1,2) to (8,1), with ragged N
  and L, a column shard counted in several chunks (``_MAX_WIDTH``
  patched), and N smaller than R, equals the JAX package's
  ``pair_counts_sharded`` on ``make_mesh(shape,
  devices=jax.devices()[:R*C])`` and ``pair_counts_numpy``;
- ``comm_account``: predicted bytes equal measured ones, the same for
  every cell;
- the CLI with ``--mesh 2,4`` on eight patched CPU cells prints every
  golden fixture byte for byte, and the JAX CLI's ``--mesh 2,4`` output
  in process (plain, ``-2``, ``--distance ani``); ``distance_matrix(mesh=
  "2,4")`` equals the JAX API's;
- the dispatch with the CUDA driver's count faked to 2 and to 1 cards,
  without asking torch: ``_mesh_device_count``, ``counts_on_mesh``,
  ``should_stream`` and ``should_lowmem`` decide as the JAX package does;
  ``devd_route``, ``early_ship_eligible``, ``_prewarm_plan`` and
  ``_mesh_cells`` agree with them (two cards: no stream, no shipper, no
  server, the count warmed on both; the JAX shipper would ship and hand
  off late);
- the refusals: unpatched, ``--mesh 2,2 --device cpu`` exits 1 with the
  JAX sentence and no matrix; a cell whose count raises ends the run with
  exit 1 and no matrix.
"""

import contextlib
import io
import itertools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import phylonium_tpu.core.pipeline as jax_pipeline
import phylonium_tpu.utils.platform as jax_platform
from golden_panel import GOLDEN_CASES, RD_SEED, write_panel
from phylonium_tpu.core.lowmem import should_lowmem as jax_lowmem
from phylonium_tpu.ops.match_table import pair_counts_numpy
from phylonium_tpu.parallel.distributed import pair_counts_sharded as jax_sharded
from phylonium_tpu.parallel.mesh import make_mesh as jax_make_mesh
from phylonium_tpu_torch.config import TorchRunConfig
from phylonium_tpu_torch.core import pipeline, query_ship
from phylonium_tpu_torch.ops import pair_count
from phylonium_tpu_torch.ops.states import ROW_ALIGN
from phylonium_tpu_torch.parallel.distributed import (
    LAST_COMM,
    comm_account,
    pair_counts_sharded,
    sharded_shape,
)
from phylonium_tpu_torch.parallel.mesh import make_mesh
from phylonium_tpu_torch.utils import platform
from phylonium_tpu_torch.utils.platform import DeviceName
from test_torch_dispatch import _configs, _Ref, _Shipper, _write_store, jax_constants  # noqa: F401
from test_torch_parallel import _states

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "data", "golden")

SHAPES = [(1, 2), (2, 1), (2, 2), (1, 4), (4, 1), (2, 4), (4, 2), (1, 8), (8, 1)]
CASES = ["ragged", "chunked", "few"]


def _cases():
    """tests/test_torch_parallel.py's panels, and one of fewer genomes
    than most meshes have rows."""
    rng = np.random.default_rng(9)
    few = rng.integers(0, 11, size=(3, 301)).astype(np.uint8)
    return {**_states(), "few": few}


@pytest.fixture
def eight_cpu_cells(monkeypatch):
    """The local devices patched to eight CPU cells."""
    monkeypatch.setattr(platform, "local_devices", lambda name: [DeviceName("cpu")] * 8)


def _jax_counts(states, shape, case):
    devices = jax.devices()[: shape[0] * shape[1]]
    mesh = jax_make_mesh(shape, devices=devices)
    if case == "few":  # small enough for the Pallas kernel in interpret mode
        return jax_sharded(states, mesh, kernel="pallas", interpret=True)
    return jax_sharded(states, mesh, block=128, kernel="xla")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_local_mesh_equals_jax_and_numpy(shape, case, eight_cpu_cells, monkeypatch):
    if case == "chunked":
        monkeypatch.setattr(pair_count, "_MAX_WIDTH", 3 * ROW_ALIGN)  # 32-byte chunks
    states = _cases()[case]
    mesh = make_mesh(shape, "cpu")
    assert mesh.backend == "local" and mesh.shape == shape
    assert len(mesh.devices) == shape[0] * shape[1]
    before = pair_count.PLAIN_CALLS
    got = pair_counts_sharded(states, mesh)
    calls = pair_count.PLAIN_CALLS - before
    for g, w in zip(got, _jax_counts(states, shape, case)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got, pair_counts_numpy(states)):
        np.testing.assert_array_equal(g, w)
    # one plain call a cell and column chunk
    _, lc, _ = sharded_shape(*states.shape, *shape)
    chunks = -(-lc // pair_count._chunk_bytes())
    assert calls == shape[0] * shape[1] * chunks
    assert (chunks > 1) == (case == "chunked")
    assert list(LAST_COMM["seconds"]) == ["cell", "gather", "count", "reduce", "result"]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_comm_account_predicted_equals_measured(shape, eight_cpu_cells):
    for case, states in _cases().items():
        mesh = make_mesh(shape, "cpu")
        pair_counts_sharded(states, mesh)
        comm = comm_account(*states.shape, mesh)
        assert comm["mesh"] == shape and comm["panel"] == states.shape
        for key in ("gather_recv_bytes", "psum_bytes", "result_gather_recv_bytes"):
            assert comm[f"measured_{key}"] == comm[f"predicted_{key}"], (case, key)
        # the rows axis moves the packed panel; every cell took the same
        # share (else the measured side is the list of them)
        assert (comm["predicted_gather_recv_bytes"] > 0) == (shape[0] > 1)
        assert isinstance(LAST_COMM["gather_recv_bytes"], int)


def test_cells_that_share_a_device_share_one_gathered_column(monkeypatch):
    """The row gather copies a column's blocks once a device: the cells of
    one column on one device count against one tensor."""
    from phylonium_tpu_torch.parallel import distributed

    monkeypatch.setattr(platform, "local_devices", lambda name: [DeviceName("cpu")] * 4)
    states = _states()["ragged"]
    mesh = make_mesh((2, 2), "cpu")
    seen = []
    count = distributed._count_cell
    monkeypatch.setattr(distributed, "_count_cell", lambda mine, everyone, n_pad: (
        seen.append(everyone.data_ptr()) or count(mine, everyone, n_pad)))
    got = pair_counts_sharded(states, mesh)
    # cells 0 and 2 hold column 0, cells 1 and 3 column 1
    assert seen[0] == seen[2] and seen[1] == seen[3] and seen[0] != seen[1]
    for g, w in zip(got, pair_counts_numpy(states)):
        np.testing.assert_array_equal(g, w)


# -- the CLI and the API ---------------------------------------------------


@pytest.fixture(scope="module")
def golden_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden_panel_local_mesh")
    return write_panel(str(d)), str(d)


def _main(args):
    from phylonium_tpu_torch.cli import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["--progress=never", *args])
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_mesh_2x4_cli_matches_committed_fixture(name, golden_files, eight_cpu_cells,
                                                monkeypatch, tmp_path):
    files, tmp = golden_files
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PHYLONIUM_TPU_RD_SEED", str(RD_SEED))
    refpos = str(tmp_path / "refpos.txt")
    args = [refpos if a == "REFPOS_FILE" else a for a in GOLDEN_CASES[name]]
    rc, out, err = _main(["--device", "cpu", "--mesh", "2,4", *args, *files])
    assert rc == 0, err[-2000:]
    with open(os.path.join(GOLDEN_DIR, f"{name}.stdout")) as f:
        assert out == f.read()
    if "REFPOS_FILE" in GOLDEN_CASES[name]:
        with open(refpos, "rb") as f, open(os.path.join(GOLDEN_DIR, f"{name}.refpos"),
                                          "rb") as want:
            assert f.read() == want.read()
    info = pipeline.LAST_RUN_INFO
    assert info["compare_carrier"] == "mesh"
    mesh = info["mesh"]
    assert mesh["backend"] == "local" and mesh["shape"] == [2, 4]
    assert mesh["devices"] == ["cpu"] * 8
    assert mesh["launches"] == 0 and mesh["plain_calls"] == 8
    assert info["plain_calls"] == 8 and info["kernel_launches"] == 0


def _panel(tmp_path, n=5, length=9000, seed=13):
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(acgt, length)
    files = []
    for k in range(n):
        arr = base.copy()
        idx = np.flatnonzero(rng.random(length) < 0.015 * k)
        arr[idx] = acgt[(rng.integers(1, 4, idx.size) + idx) % 4]
        path = tmp_path / f"m{k}.fasta"
        path.write_bytes(b">m%d\n" % k + arr.tobytes() + b"\n")
        files.append(str(path))
    return files


@pytest.mark.parametrize("flags", [[], ["-2"], ["--distance", "ani"]],
                         ids=["plain", "two-pass", "ani"])
def test_mesh_2x4_cli_equals_the_jax_cli(flags, eight_cpu_cells, tmp_path, monkeypatch):
    from phylonium_tpu.cli import main as jax_main

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "0")
    files = _panel(tmp_path)
    rc, ours, err = _main(["--device", "cpu", "--mesh", "2,4", "-v", *flags, *files])
    assert rc == 0, err[-2000:]
    assert "mesh carried" not in err  # -v alone prints no phase line
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_main(["--progress=never", "--mesh", "2,4", *flags, *files]) == 0
    assert ours == out.getvalue()
    assert jax_pipeline.LAST_RUN_INFO.get("compare_carrier") == "mesh"


def test_distance_matrix_mesh_equals_the_jax_api(eight_cpu_cells, tmp_path):
    import phylonium_tpu.api as jax_api
    import phylonium_tpu_torch.api as torch_api

    files = _panel(tmp_path, n=4, seed=17)
    ours = torch_api.distance_matrix(files, device="cpu", mesh="2,4")
    assert pipeline.LAST_RUN_INFO["mesh"]["backend"] == "local"
    ref = jax_api.distance_matrix(files, mesh="2,4")
    assert ours.names == ref.names
    assert np.array_equal(ours.counts.substitutions, ref.counts.substitutions)
    assert np.array_equal(ours.counts.homologs, ref.counts.homologs)
    assert np.array_equal(ours.distances, ref.distances, equal_nan=True)


# -- the dispatch with cards faked ----------------------------------------------


@pytest.fixture(params=[2, 1], ids=["two cards", "one card"])
def cards(request, jax_constants, monkeypatch):
    """The CUDA driver's count faked to ``param`` cards, and the JAX
    package's runtime to as many devices with its handshake done; torch's
    own CUDA queries raise, since a decision must not ask them."""
    n = request.param
    monkeypatch.setattr(platform, "cuda_device_count", lambda: n)
    monkeypatch.setattr(jax_pipeline, "_dispatch_devices", lambda: [object()] * n)
    monkeypatch.setattr(jax_platform, "backends_initialized", lambda: True)
    monkeypatch.setattr(jax_pipeline, "_is_multiprocess", lambda: False)

    def asked(*args, **kwargs):
        raise AssertionError("a dispatch decision asked torch for CUDA devices")

    monkeypatch.setattr(torch.cuda, "device_count", asked)
    monkeypatch.setattr(torch.cuda, "is_available", asked)
    return n


_FIELDS = [{}, {"count_backend": "host"}, {"count_backend": "numpy"},
           {"count_backend": "device"}, {"mesh": "2,2"}, {"mesh": "1,1"},
           {"complete_deletion": True}, {"map_backend": "hybrid"}]


def _jax_counts_on_mesh(cfg) -> bool:
    """The JAX ``pair_counts``'s mesh legs (:745-800), past its host pick."""
    if cfg.mesh:
        return jax_pipeline._mesh_device_count(cfg) > 1
    return cfg.count_backend == "auto" and len(jax_pipeline._dispatch_devices()) > 1


def test_mesh_device_count_and_counts_on_mesh(cards):
    for fields in _FIELDS:
        jax_cfg, port_cfg = _configs(**fields)
        assert pipeline._mesh_device_count(port_cfg) == \
            jax_pipeline._mesh_device_count(jax_cfg), fields
        assert pipeline.counts_on_mesh(port_cfg) == _jax_counts_on_mesh(jax_cfg), fields
        # the CPU is one device, whatever the cards
        port_cfg.device = "cpu"
        if not fields.get("mesh"):
            assert pipeline._mesh_device_count(port_cfg) == 0
            assert not pipeline.counts_on_mesh(port_cfg)


def test_should_stream_and_lowmem_decide_as_the_jax_package(cards, jax_constants,
                                                           monkeypatch):
    cases = itertools.product(
        [{}, {"count_backend": "device"}, {"mesh": "2,2"}, {"checkpoint_dir": "/tmp/c"}],
        ["", "0", "force"], [None, False, True], [(29, 5_000_000), (116, 5_000_000),
                                                  (600, 1_000_000)],
        [None, 20_000.0],
    )
    for fields, stream, shipper, (n, ref_len), link in cases:
        monkeypatch.setenv("PHYLONIUM_TPU_STREAM", stream)
        _write_store(jax_constants, link, None, None)
        jax_cfg, port_cfg = _configs(**fields)
        if shipper is not None:
            jax_cfg._query_shipper = _Shipper(shipper)
            port_cfg._query_shipper = _Shipper(shipper)
        want = jax_pipeline._should_stream(n, ref_len, jax_cfg, _Ref("native"))
        got = pipeline.should_stream(n, ref_len, port_cfg, _Ref("native"))
        assert got == want, (cards, fields, stream, shipper, n, ref_len, link)
        for total_bp in (n * ref_len, 3 << 30):
            assert pipeline.should_lowmem(n, total_bp, port_cfg) == \
                jax_lowmem(n, total_bp, jax_cfg), (fields, stream, total_bp)


def test_devd_route_early_ship_and_prewarm_with_cards(cards, monkeypatch, tmp_path):
    """No routing variable, a single process on the faked cards, a panel
    the static rule sends to the card: two cards count on the (1, 2) local
    mesh, so the run neither streams nor ships nor takes the device
    server, and its prewarm warms the count on both cards; one card
    streams through the server. Low memory keeps its one-device feeder on
    the server either way, as the JAX package's low-memory path does."""
    for key in ("PHYLONIUM_TPU_DEVD", "PHYLONIUM_TPU_STREAM", "PHYLONIUM_TPU_LOWMEM"):
        monkeypatch.delenv(key, raising=False)
    cfg = TorchRunConfig(device="cuda")
    n, ref_len = 600, 1_000_000  # 179.7 Gbp of pair work, above the static 134
    names = [str(tmp_path / f"f{k}.fa") for k in range(n)]
    monkeypatch.setattr(os.path, "getsize", lambda name: ref_len)
    mesh = cards > 1
    assert pipeline.counts_on_mesh(cfg) is mesh
    assert pipeline.should_stream(n, ref_len, cfg) is not mesh
    assert pipeline.devd_route(n, ref_len, n * ref_len, cfg) is not mesh
    assert query_ship.early_ship_eligible(cfg, names) is not mesh
    assert pipeline.devd_route(n, ref_len, 3 << 30, cfg) is True  # low memory
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "0")
    assert pipeline._prewarm_plan(n, ref_len, n * ref_len, cfg) == (True, not mesh)
    cells = pipeline._mesh_cells(n, n * ref_len, cfg)
    assert cells == ([DeviceName("cuda", 0), DeviceName("cuda", 1)] if mesh else None)
    assert pipeline._mesh_cells(n, 3 << 30, cfg) is None
    # a panel the dispatch model sends to the host: no prewarm at all
    assert pipeline._prewarm_plan(29, 5_000, 29 * 5_000, cfg) is None


# -- the refusals ---------------------------------------------------------------


def test_mesh_beyond_the_local_devices_is_refused(tmp_path):
    files = _panel(tmp_path, n=3)
    rc, out, err = _main(["--device", "cpu", "--mesh", "2,2", *files])
    assert rc == 1 and out == ""
    assert "--mesh 2,2 needs 4 devices; the runtime has 1" in err
    assert "torchrun --nproc-per-node 4" in err


_FAILING_CELL = """
import runpy, sys
from phylonium_tpu_torch.ops import pair_count
from phylonium_tpu_torch.utils import platform
platform.local_devices = lambda name: [platform.DeviceName("cpu")] * 4
count = pair_count.cross_counts
calls = []
def failing(*args, **kwargs):
    calls.append(1)
    if len(calls) == 3:
        raise RuntimeError("cell 2 failed (injected)")
    return count(*args, **kwargs)
pair_count.cross_counts = failing
sys.argv = ["phylonium_tpu_torch", *sys.argv[1:]]
runpy.run_module("phylonium_tpu_torch", run_name="__main__", alter_sys=True)
"""


def test_a_failing_cell_fails_the_run(tmp_path):
    files = _panel(tmp_path, n=4)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-c", _FAILING_CELL, "--progress=never", "--device", "cpu",
         "--mesh", "2,2", *files],
        capture_output=True, cwd=tmp_path, env=env, timeout=300,
    )
    assert r.returncode == 1
    assert r.stdout == b""
    assert b"cell 2 failed (injected)" in r.stderr
