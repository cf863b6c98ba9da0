"""The local counting mesh on a card: K2 in every cell.

Skips without a CUDA device. Imports nothing of jax:

    CXX=g++ PHYLONIUM_TPU_TEST_REAL=1 python -m pytest -m cuda tests/test_torch_local_mesh_cuda.py

- local meshes (2, 2) and (1, 4) with every cell on ``cuda:0``
  (``utils.platform.local_devices`` patched) equal
  ``pair_count.pair_counts_rows`` bit for bit, in one and in several
  column chunks: 2 kernel launches a cell and chunk, no plain call;
- a mesh over ``cuda:0`` and ``cuda:1``, where the machine has two cards.
"""

import numpy as np
import pytest
import torch

from phylonium_tpu_torch.ops import pair_count
from phylonium_tpu_torch.ops.states import ROW_ALIGN, pack_rows, to_device
from phylonium_tpu_torch.parallel.distributed import (
    comm_account,
    pair_counts_sharded,
    sharded_shape,
)
from phylonium_tpu_torch.parallel.mesh import make_mesh
from phylonium_tpu_torch.utils import platform
from phylonium_tpu_torch.utils.platform import DeviceName


def _states(n: int = 29, length: int = 40_001, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    states = rng.integers(0, 11, size=(n, length)).astype(np.uint8)
    states[3, 1000:9000] = 10  # a gap
    return states


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda", 0)


def _one_device(states, card):
    return pair_count.pair_counts_rows(to_device(pack_rows(states), card))


def _count(states, shape, card_devices):
    pair_count.KERNEL_LAUNCHES = 0
    pair_count.PLAIN_CALLS = 0
    mesh = make_mesh(shape, "cuda")
    assert mesh.backend == "local" and mesh.devices == tuple(card_devices)
    got = pair_counts_sharded(states, mesh)
    return mesh, got, pair_count.KERNEL_LAUNCHES, pair_count.PLAIN_CALLS


@pytest.mark.cuda
@pytest.mark.parametrize("chunked", [False, True], ids=["one chunk", "chunked"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_cells_on_one_card_equal_the_one_device_count(shape, chunked, card, monkeypatch):
    cells = shape[0] * shape[1]
    monkeypatch.setattr(platform, "local_devices", lambda name: [DeviceName("cuda", 0)] * cells)
    states = _states()
    want = _one_device(states, card)
    if chunked:
        monkeypatch.setattr(pair_count, "_MAX_WIDTH", 64 * ROW_ALIGN)
    mesh, got, launches, plain = _count(states, shape, [card] * cells)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    _, lc, _ = sharded_shape(*states.shape, *shape)
    chunks = -(-lc // pair_count._chunk_bytes())
    assert (chunks > 1) == chunked
    assert launches == pair_count.LAUNCHES_PER_CALL * cells * chunks and plain == 0
    comm = comm_account(*states.shape, mesh)
    for key in ("gather_recv_bytes", "psum_bytes", "result_gather_recv_bytes"):
        assert comm[f"measured_{key}"] == comm[f"predicted_{key}"]


@pytest.mark.cuda
def test_a_mesh_over_two_cards(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    states = _states(n=37, length=30_011, seed=6)
    want = _one_device(states, card)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    for shape in [(1, 2), (2, 1)]:
        _, got, launches, plain = _count(states, shape, cards)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert launches == 2 * pair_count.LAUNCHES_PER_CALL and plain == 0
