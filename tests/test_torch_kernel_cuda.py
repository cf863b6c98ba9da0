"""The CUDA pair-count kernel against its plain PyTorch version, on a card.

Skips without a CUDA device. Imports nothing of jax, so it runs on a
machine with a card and no jax:

    PHYLONIUM_TPU_TEST_REAL=1 python -m pytest -m cuda tests/test_torch_kernel_cuda.py
"""

import numpy as np
import pytest
import torch

from phylonium_tpu.ops.match_table import pair_counts_numpy
from phylonium_tpu_torch.ops import pair_count
from phylonium_tpu_torch.ops.match_matrix import cross_counts_reference
from phylonium_tpu_torch.ops.states import ROW_ALIGN, pack_rows, to_device

INVALID = 10


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda")


def _states(seed, n, length, invalid_row=None):
    rng = np.random.default_rng(seed)
    states = rng.integers(0, 11, size=(n, length)).astype(np.uint8)
    if invalid_row is not None:
        states[invalid_row] = INVALID
    return states


@pytest.mark.cuda
@pytest.mark.parametrize(
    "na,nb,length", [(2, 2, 1), (65, 65, 2001), (29, 36, 30_001), (130, 7, 999)]
)
def test_kernel_equals_plain(card, na, nb, length):
    a = to_device(pack_rows(_states(na, na, length, 0)), card)
    b = to_device(pack_rows(_states(nb + 50, nb, length)), card)
    launches = pair_count.KERNEL_LAUNCHES
    cases = [(a, b, False), (b, a, False)]
    if na == nb:
        cases.append((a, a, True))
    for x, y, sym in cases:
        m, h = pair_count.cross_counts(x, y, symmetric=sym)
        mr, hr = cross_counts_reference(x, y)
        keep = torch.triu if sym else (lambda t: t)
        assert torch.equal(keep(m.to(torch.int64)), keep(mr))
        assert torch.equal(keep(h.to(torch.int64)), keep(hr))
    assert pair_count.KERNEL_LAUNCHES == launches + pair_count.LAUNCHES_PER_CALL * len(cases)


@pytest.mark.cuda
def test_pair_counts_on_card_equal_numpy(card):
    states = _states(3, 9, 7001, invalid_row=4)
    got = pair_count.pair_counts(states, card)
    want = pair_counts_numpy(states)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


# the tensor-core kernel's edges: one and several 16-row fragments, one
# and several 32- and 64-row warp tiles, one and two 128-row block tiles,
# and a panel of 600; widths of one stage, two stages, and enough stages
# that the columns split over many blocks
EDGE_ROWS = [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129, 600]
EDGE_LENGTHS = [1, 33, 31_999, 200_001]


def _check(x, y, sym):
    m, h = pair_count.cross_counts(x, y, symmetric=sym)
    mr, hr = cross_counts_reference(x, y)
    torch.cuda.synchronize()
    keep = torch.triu if sym else (lambda t: t)
    assert torch.equal(keep(m.to(torch.int64)), keep(mr))
    assert torch.equal(keep(h.to(torch.int64)), keep(hr))


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_ROWS)
def test_kernel_edges_equal_plain(card, n):
    for length in EDGE_LENGTHS:
        if n == 600 and length > 31_999:
            continue  # the production phase of chip_smoke.py covers it
        states = _states(n * 7 + length, n, length, invalid_row=n // 2)
        other = _states(n * 11 + length, n + 7, length)
        a = to_device(pack_rows(states), card)
        b = to_device(pack_rows(other), card)
        for x, y, sym in ((a, a, True), (a, b, False), (b, a, False)):
            _check(x, y, sym)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [17, 129])
def test_kernel_on_a_row_slice(card, n):
    # the streamed feeder counts a slice of a larger resident panel
    panel = to_device(pack_rows(_states(n, n + 40, 9_999, invalid_row=3)), card)
    rows = panel[5 : 5 + n]
    _check(rows, rows, True)
    _check(rows, panel[20:], False)


@pytest.mark.cuda
@pytest.mark.parametrize("max_width", [2 * ROW_ALIGN, 3 * ROW_ALIGN, 100 * ROW_ALIGN])
def test_chunked_counts_equal_unchunked(card, monkeypatch, max_width):
    """Rows counted in column chunks (views at the panel's row stride,
    summed in int64) equal one call, bit for bit."""
    for n, length in ((29, 30_001), (130, 4001)):
        rows = to_device(pack_rows(_states(n + length, n, length, invalid_row=1)), card)
        whole = pair_count.pair_counts_rows(rows)
        with monkeypatch.context() as patch:
            patch.setattr(pair_count, "_MAX_WIDTH", max_width)
            launches = pair_count.KERNEL_LAUNCHES
            chunked = pair_count.pair_counts_rows(rows)
            chunks = -(-rows.shape[1] // pair_count._chunk_bytes())
        assert chunks > 1
        assert pair_count.KERNEL_LAUNCHES - launches == chunks * pair_count.LAUNCHES_PER_CALL
        assert all(np.array_equal(c, w) for c, w in zip(chunked, whole))
