"""The torch port's pair count against the JAX package's kernels.

The JAX side runs as tests/test_pallas_match.py runs it on the CPU: the
Pallas kernels in interpret mode. The port runs its CPU route (the plain
PyTorch version). Counts are integers: every check is exact equality.
"""

import numpy as np
import pytest
import torch

from phylonium_tpu.ops.match_table import pair_counts_numpy
from phylonium_tpu.ops.pallas_match import (
    _PARTNERS,
    cross_counts_pallas,
    pack_states,
    pair_counts_pallas,
    pair_counts_pallas_blocked,
)
from phylonium_tpu_torch.config import ConfigError
from phylonium_tpu_torch.ops import pair_count
from phylonium_tpu_torch.ops.match_matrix import cross_counts_reference, onehot_operands
from phylonium_tpu_torch.ops.match_table import MATCH_PLANES, MATCH_TABLE, PARTNER_MASK
from phylonium_tpu_torch.ops.states import ROW_ALIGN, pack_rows, packed_width
from phylonium_tpu_torch.utils.platform import resolve_device

CPU = torch.device("cpu")
INVALID = 10


def _states(seed, n, length, invalid_row=None):
    rng = np.random.default_rng(seed)
    states = rng.integers(0, 11, size=(n, length)).astype(np.uint8)
    if invalid_row is not None:
        states[invalid_row] = INVALID
    return states


def _equal(got, want):
    return all(np.array_equal(g, w) for g, w in zip(got, want))


def test_partner_mask_matches_pallas_partners():
    for s in range(16):
        partners = tuple(t for t in range(16) if PARTNER_MASK[s] >> t & 1)
        assert partners == (_PARTNERS[s] if s < len(_PARTNERS) else ())
    # forward T matches the reverse '!' (the ASCII complement quirk)
    assert PARTNER_MASK[3] >> 9 & 1


def test_match_planes_rebuild_the_match_table():
    # each class's state and partner masks, as 0/1 vectors over states 0..10
    bits = np.arange(11)
    p = (MATCH_PLANES[:, :1] >> bits) & 1
    q = (MATCH_PLANES[:, 1:] >> bits) & 1
    assert (p.sum(0) <= 1).all()  # a state lies in at most one class
    assert np.array_equal(p.T @ q, MATCH_TABLE)
    # C fwd with G rev and G fwd with C rev: 8 planes, the table's rank
    assert len(MATCH_PLANES) == 8 == np.linalg.matrix_rank(MATCH_TABLE)
    assert sorted(np.flatnonzero(p.sum(0) == 0)) == [INVALID]


def _pallas_cases():
    # the seeds and size draws of test_pallas_match.py, plus an odd
    # length and an all-INVALID row
    cases = []
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(2, 7))
        length = int(rng.integers(100, 1200))
        cases.append((seed, n, length, None))
    cases += [(5, 4, 333, None), (6, 5, 1001, 2), (7, 2, 1, None)]
    return cases


@pytest.mark.parametrize("seed,n,length,invalid_row", _pallas_cases())
def test_pair_counts_equal_pallas_and_numpy(seed, n, length, invalid_row):
    states = _states(seed, n, length, invalid_row)
    ours = pair_count.pair_counts(states, CPU)
    assert _equal(ours, pair_counts_numpy(states))
    assert _equal(ours, pair_counts_pallas(states, block=128, interpret=True))


def test_pair_counts_equal_pallas_blocked():
    states = _states(3, 9, 700)
    want = pair_counts_pallas_blocked(
        states, row_block=4, block=128, interpret=True
    )
    assert _equal(pair_count.pair_counts(states, CPU), want)


@pytest.mark.parametrize("na,nb", [(3, 5), (6, 2)])
def test_cross_counts_equal_cross_counts_pallas(na, nb):
    length = 1234
    a = _states(11, na, length)
    b = _states(12, nb, length)
    width = packed_width(length)
    pa, pb = pack_rows(a), pack_rows(b)
    matches, homs = pair_count.cross_counts(
        torch.from_numpy(pa), torch.from_numpy(pb)
    )
    # the Pallas kernel wants 32-row padded inputs of a block-multiple
    # width; padding rows and columns are packed INVALID
    jw = -(-width // 128) * 128
    jm, jh = cross_counts_pallas(
        pack_states(a, 32, jw), pack_states(b, 32, jw), 128,
        interpret=True, packed=True,
    )
    assert np.array_equal(matches.numpy(), np.asarray(jm)[:na, :nb])
    assert np.array_equal(homs.numpy(), np.asarray(jh)[:na, :nb])


def test_cross_counts_counts_plain_calls():
    rows = torch.from_numpy(pack_rows(_states(4, 3, 50)))
    before = pair_count.PLAIN_CALLS, pair_count.KERNEL_LAUNCHES
    pair_count.cross_counts(rows, rows, symmetric=True)
    assert pair_count.PLAIN_CALLS == before[0] + 1
    assert pair_count.KERNEL_LAUNCHES == before[1]


def test_long_width():
    states = _states(21, 3, 70_000, invalid_row=1)
    assert _equal(pair_count.pair_counts(states, CPU), pair_counts_numpy(states))


def test_pack_rows_aligns_width():
    states = _states(8, 3, 2001)
    packed = pack_rows(states)
    assert packed.shape == (3, 1008)
    assert (packed[:, 1001:] == 0xAA).all()


def test_resolve_device_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == CPU
    with pytest.raises(ConfigError):
        resolve_device("meta")


def test_cross_counts_refuses_bad_inputs():
    rows = torch.from_numpy(pack_rows(_states(9, 4, 100)))
    with pytest.raises(ValueError, match="contiguous"):
        pair_count.cross_counts(rows.t().contiguous().t(), rows)
    with pytest.raises(ValueError, match="uint8"):
        pair_count.cross_counts(rows.to(torch.int32), rows.to(torch.int32))
    with pytest.raises(ValueError, match="multiple of 16"):
        odd = rows[:, :40].contiguous()
        pair_count.cross_counts(odd, odd)
    with pytest.raises(ValueError, match="widths differ"):
        pair_count.cross_counts(rows, rows[:, :32].contiguous())
    with pytest.raises(ValueError, match="one tensor"):
        pair_count.cross_counts(rows, rows.clone(), symmetric=True)


def _onehot_counts(a: torch.Tensor, b: torch.Tensor):
    ops_a, ops_b = onehot_operands(a, b)
    product = ops_a.to(torch.int32) @ ops_b.to(torch.int32).T
    nb = b.shape[0]
    return product[:, :nb].to(torch.int64), product[:, nb:].to(torch.int64)


def _every_state_pair(n_rows: int = 11) -> np.ndarray:
    """Rows whose columns, taken two by two, hold every ordered pair of
    states 0..10 (and the reverse pairs across row swaps)."""
    s, t = np.meshgrid(np.arange(11), np.arange(11), indexing="ij")
    cols = np.stack([s.ravel(), t.ravel()])  # [2, 121]
    rows = np.concatenate([np.roll(cols, k, axis=0) for k in range(n_rows)], axis=0)
    return rows[:n_rows].astype(np.uint8)


@pytest.mark.parametrize(
    "na,nb,length,symmetric",
    [(11, 11, 121, True), (4, 4, 1, True), (6, 6, 333, True),
     (3, 7, 1001, False), (9, 2, 64, False), (5, 5, 2047, False)],
)
def test_onehot_operands_equal_reference_and_pallas(na, nb, length, symmetric):
    if length == 121:
        a = _every_state_pair(na)
    else:
        a = _states(31 + length, na, length, invalid_row=na // 2)
    b = a if symmetric else _states(32 + length, nb, length, invalid_row=0)
    ta = torch.from_numpy(pack_rows(a))
    tb = torch.from_numpy(pack_rows(b))
    matches, homs = _onehot_counts(ta, tb)
    mr, hr = cross_counts_reference(ta, tb)
    assert torch.equal(matches, mr) and torch.equal(homs, hr)
    if symmetric:
        subs, h = pair_counts_pallas(a, block=128, interpret=True)
        off = ~np.eye(na, dtype=bool)
        assert np.array_equal(homs.numpy()[off], h[off])
        assert np.array_equal((homs - matches).numpy()[off], subs[off])
    else:
        jw = -(-packed_width(length) // 128) * 128
        jm, jh = cross_counts_pallas(
            pack_states(a, 32, jw), pack_states(b, 32, jw), 128,
            interpret=True, packed=True,
        )
        assert np.array_equal(matches.numpy(), np.asarray(jm)[:na, :nb])
        assert np.array_equal(homs.numpy(), np.asarray(jh)[:na, :nb])


def test_onehot_operands_shapes_and_values():
    a = torch.from_numpy(pack_rows(_states(40, 3, 50)))
    b = torch.from_numpy(pack_rows(_states(41, 5, 50)))
    ops_a, ops_b = onehot_operands(a, b)
    length = 2 * a.shape[1]
    planes = len(MATCH_PLANES)
    assert ops_a.dtype == ops_b.dtype == torch.int8
    assert ops_a.shape == (3, 9 * length) and ops_b.shape == (10, 9 * length)
    assert set(ops_a.unique().tolist()) <= {0, 1}
    # a state lies in at most one P plane; the Q block has no V plane and
    # the V block nothing else
    assert int(ops_a[:, : planes * length].view(3, planes, length).sum(1).max()) <= 1
    assert not ops_b[:5, planes * length :].any()
    assert not ops_b[5:, : planes * length].any()


# states a row whose packed widths (16, 32, 48, 64, 80 and 96 bytes) fall
# on and between the edges of 16- and 32-byte column chunks
CHUNK_LENGTHS = [1, 32, 33, 64, 65, 97, 129, 190]


@pytest.mark.parametrize("max_width", [2 * ROW_ALIGN, 3 * ROW_ALIGN])
@pytest.mark.parametrize("length", CHUNK_LENGTHS)
def test_chunked_counts_equal_unchunked_and_pallas(monkeypatch, max_width, length):
    """Rows of _MAX_WIDTH bytes or more are counted in column chunks and
    summed in int64: the same counts as one call and as the JAX package's
    pair_counts_pallas."""
    states = _states(50 + length, 5, length, invalid_row=3)
    rows = torch.from_numpy(pack_rows(states))
    whole = pair_count.pair_counts_rows(rows)
    monkeypatch.setattr(pair_count, "_MAX_WIDTH", max_width)
    calls = pair_count.PLAIN_CALLS
    chunked = pair_count.pair_counts_rows(rows)
    step = pair_count._chunk_bytes()
    assert step % ROW_ALIGN == 0 and step < max_width
    assert pair_count.PLAIN_CALLS - calls == -(-rows.shape[1] // step)
    assert _equal(chunked, whole)
    assert all(c.dtype == np.int64 for c in chunked)
    assert _equal(chunked, pair_counts_pallas(states, block=128, interpret=True))
    # a single call still refuses rows it cannot count exactly
    if rows.shape[1] >= max_width:
        with pytest.raises(ValueError, match="column chunks"):
            pair_count.cross_counts(rows, rows, symmetric=True)


def test_cross_counts_takes_column_views():
    """A column chunk is a view at the panel's row stride: counted as its
    contiguous copy is, on the CPU route and by the plain version."""
    a = torch.from_numpy(pack_rows(_states(60, 6, 300)))
    b = torch.from_numpy(pack_rows(_states(61, 4, 300)))
    for lo, hi in ((0, 16), (16, 48), (144, 160)):
        va, vb = a[:, lo:hi], b[:, lo:hi]
        assert va.stride(0) == a.shape[1]
        want = cross_counts_reference(va.contiguous(), vb.contiguous())
        got = pair_count.cross_counts(va, vb)
        assert all(torch.equal(g.to(torch.int64), w) for g, w in zip(got, want))
        assert all(torch.equal(g, w) for g, w in zip(cross_counts_reference(va, vb), want))
        sym = pair_count.cross_counts(va, va, symmetric=True)
        assert torch.equal(sym[1].to(torch.int64), cross_counts_reference(va, va)[1])
    with pytest.raises(ValueError, match="boundary"):
        pair_count.cross_counts(a[:, 8:24], a[:, 8:24])
    odd_stride = torch.zeros((3, 40), dtype=torch.uint8)[:, :16]
    with pytest.raises(ValueError, match="row stride"):
        pair_count.cross_counts(odd_stride, odd_stride)
