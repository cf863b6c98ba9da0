"""The port's counting mesh (X3s) in a gloo world of 4 CPU ranks.

One world runs every case and each rank writes its results to a file;
each test reads one case. The reference is the JAX package's
``pair_counts_sharded`` on its 8-device CPU mesh (tests/conftest.py), run
here on the same numpy-seeded states:

- meshes (1, 4), (2, 2) and (4, 1), ragged N and L, and an L whose column
  shard is counted in several chunks (``_MAX_WIDTH`` patched small), bit
  for bit on every rank; (1, 1) in this one process, outside any world;
- ``comm_account``: the predicted bytes equal the bytes the collectives
  passed;
- ``exchange_homologies`` rebuilds the unsplit homology lists;
- ``make_pod_mesh`` on one host is (1, 4) and counts the same matrix;
- in this process: NCCL with more ranks on a host than cards, or with no
  card, and a mesh of another size than the world are ConfigErrors.
"""

import json

import jax
import numpy as np
import pytest

from phylonium_tpu.ops.match_table import pair_counts_numpy
from phylonium_tpu.parallel.distributed import pair_counts_sharded as jax_sharded
from phylonium_tpu.parallel.mesh import make_mesh as jax_make_mesh
from torch_world import spawn_world

SHAPES = [(1, 4), (2, 2), (4, 1)]
CASES = ["ragged", "chunked"]
WORLD = 4


def _states():
    """name -> [N, L] uint8 states: ragged N and L (N not a multiple of the
    rows, L odd), and a wider panel for the chunked count."""
    rng = np.random.default_rng(0)
    ragged = rng.integers(0, 11, size=(5, 4999)).astype(np.uint8)
    ragged[2, 1000:2000] = 10
    chunked = rng.integers(0, 11, size=(7, 1203)).astype(np.uint8)
    return {"ragged": ragged, "chunked": chunked}


def _homologies():
    """Per-query lists of (direction, ir, irp, iq, length) records."""
    rng = np.random.default_rng(3)
    return [rng.integers(0, 1000, size=(int(rng.integers(0, 6)), 5)).tolist()
            for _ in range(11)]


_WORKER = """
import json
import numpy as np
from phylonium_tpu_torch.core.homology import Homology
from phylonium_tpu_torch.ops import pair_count
from phylonium_tpu_torch.ops.states import ROW_ALIGN
from phylonium_tpu_torch.parallel.distributed import comm_account, pair_counts_sharded
from phylonium_tpu_torch.parallel.map_shard import exchange_homologies, owner_of
from phylonium_tpu_torch.parallel.mesh import make_mesh
from phylonium_tpu_torch.parallel.multihost import make_pod_mesh, pair_counts_pod

data = np.load(ARGS[0])
out = {"counts": {}, "comm": {}, "plain_calls": {}}
for shape in [(1, 4), (2, 2), (4, 1)]:
    mesh = make_mesh(shape, "cpu")
    for name in ("ragged", "chunked"):
        states = data[name]
        saved = pair_count._MAX_WIDTH
        if name == "chunked":
            pair_count._MAX_WIDTH = 3 * ROW_ALIGN  # 32-byte column chunks
        before = pair_count.PLAIN_CALLS
        try:
            s, h = pair_counts_sharded(states, mesh)
        finally:
            pair_count._MAX_WIDTH = saved
        key = f"{shape[0]}x{shape[1]}-{name}"
        out["counts"][key] = [s.tolist(), h.tolist()]
        out["plain_calls"][key] = pair_count.PLAIN_CALLS - before
        out["comm"][key] = comm_account(*states.shape, mesh)
lists = json.loads(ARGS[1])
mine = [[Homology(*r) for r in q] if owner_of(j, SIZE) == RANK else None
        for j, q in enumerate(lists)]
got = exchange_homologies(mine, [j for j in range(len(lists)) if owner_of(j, SIZE) == RANK])
out["exchanged"] = [[[h.direction, h.index_reference, h.index_reference_projected,
                      h.index_query, h.length] for h in q] for q in got]
pod = make_pod_mesh(device="cpu")
out["pod_shape"] = list(pod.shape)
s, h = pair_counts_pod(data["ragged"], device="cpu")
out["pod_counts"] = [s.tolist(), h.tolist()]
with open(f"rank{RANK}.json", "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_parallel")
    np.savez(tmp / "states.npz", **_states())
    outs = spawn_world(_WORKER, WORLD, tmp,
                       args=[tmp / "states.npz", json.dumps(_homologies())])
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} exited {rc}:\n{err[-3000:]}"
        assert out == "", f"rank {rank} printed to stdout: {out[:500]}"
    results = []
    for rank in range(WORLD):
        with open(tmp / f"rank{rank}.json") as f:
            results.append(json.load(f))
    return results


def _jax_counts(states, shape):
    devices = jax.devices()[: shape[0] * shape[1]]
    return jax_sharded(states, jax_make_mesh(shape, devices=devices), block=128)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_equals_jax_on_every_rank(world, shape, case):
    states = _states()[case]
    want = _jax_counts(states, shape)
    key = f"{shape[0]}x{shape[1]}-{case}"
    for rank, result in enumerate(world):
        got = [np.array(m, np.int64) for m in result["counts"][key]]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"rank {rank}, {key}")
    # the chunked case counts each shard in several 32-byte column chunks
    if case == "chunked":
        assert all(r["plain_calls"][key] > 1 for r in world)


@pytest.mark.parametrize("case", CASES)
def test_one_by_one_mesh_in_one_process(case, monkeypatch):
    from phylonium_tpu_torch.ops import pair_count
    from phylonium_tpu_torch.ops.states import ROW_ALIGN
    from phylonium_tpu_torch.parallel.distributed import pair_counts_sharded
    from phylonium_tpu_torch.parallel.mesh import make_mesh

    if case == "chunked":
        monkeypatch.setattr(pair_count, "_MAX_WIDTH", 3 * ROW_ALIGN)
    states = _states()[case]
    got = pair_counts_sharded(states, make_mesh((1, 1), "cpu"))
    want = _jax_counts(states, (1, 1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got, pair_counts_numpy(states)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_comm_account_predicted_equals_measured(world, shape):
    for case in CASES:
        key = f"{shape[0]}x{shape[1]}-{case}"
        for rank, result in enumerate(world):
            comm = result["comm"][key]
            assert comm["mesh"] == list(shape)
            for name in ("gather_recv_bytes", "psum_bytes", "result_gather_recv_bytes"):
                assert comm[f"measured_{name}"] == comm[f"predicted_{name}"], (rank, key, name)
            # the rows axis is the one that moves the packed panel
            assert (comm["predicted_gather_recv_bytes"] > 0) == (shape[0] > 1)
            assert comm["predicted_psum_bytes"] > 0


def test_exchange_homologies_equals_unsplit(world):
    want = _homologies()
    for rank, result in enumerate(world):
        assert result["exchanged"] == want, f"rank {rank}"


def test_make_pod_mesh(world):
    want = pair_counts_numpy(_states()["ragged"])
    for result in world:
        # one host: rows default to the host count
        assert result["pod_shape"] == [1, WORLD]
        for g, w in zip(result["pod_counts"], want):
            np.testing.assert_array_equal(np.array(g, np.int64), w)


def test_nccl_with_more_ranks_than_cards_is_a_config_error():
    from phylonium_tpu_torch.config import ConfigError
    from phylonium_tpu_torch.parallel.multihost import _check_nccl

    one_card = {"hosts": ["a", "a", "b", "b"], "gpus": [1, 1, 2, 2]}
    with pytest.raises(ConfigError, match="host a runs 2 ranks on 1 device.*gloo"):
        _check_nccl(one_card)
    _check_nccl({"hosts": ["a", "a", "b", "b"], "gpus": [2, 2, 2, 2]})


def test_nccl_without_a_card_is_a_config_error(monkeypatch):
    import torch

    from phylonium_tpu_torch.config import ConfigError
    from phylonium_tpu_torch.parallel.multihost import initialize_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="gloo"):
        initialize_distributed("nccl", init_method="file:///nonexistent", world_size=1, rank=0)
    with pytest.raises(ConfigError, match="not supported"):
        initialize_distributed("mpi", world_size=1, rank=0)


def test_a_mesh_of_another_size_than_the_world_is_a_config_error():
    from phylonium_tpu_torch.config import ConfigError
    from phylonium_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ConfigError, match="--mesh 2,2 needs 4 devices; the runtime has 1"):
        make_mesh((2, 2), "cpu")
    assert make_mesh(None, "cpu").shape == (1, 1)
