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
from phylonium_tpu_torch.ops.match_table import PARTNER_MASK
from phylonium_tpu_torch.ops.states import pack_rows, packed_width
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
