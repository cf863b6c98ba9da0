"""The X5 shard kernel (``pt_diagonal_neq_shard``) on a card.

At the edges of tests/extend_cases.py, with the ``a`` text split into 2, 3
and 4 shards on one card, each shard at the start of its buffer and 5
bytes into it: every shard's words equal its plain version's, and their
OR equals the unsharded kernel (K3) and its plain version. A shard that
owns everything is K3. Skips without a CUDA device; imports nothing of
jax:

    PHYLONIUM_TPU_TEST_REAL=1 python -m pytest -m cuda tests/test_torch_anchor_extend_sharded_cuda.py
"""

import numpy as np
import pytest
import torch

from extend_cases import CASES, texts_on
from phylonium_tpu_torch.ops import anchor_extend, anchor_extend_sharded as aes

TILE = 64


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda")


def _shards_on(device, shards: np.ndarray, shift: int) -> list[torch.Tensor]:
    out = []
    for row in shards:
        buf = torch.zeros(row.size + shift, dtype=torch.uint8, device=device)
        buf[shift:] = torch.from_numpy(row).to(device)
        out.append(buf[shift:])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_shard_kernel_equals_plain_and_k3(card, name, n_shards):
    ha, hb, off_a, off_b, lim_a, lim_b, length = CASES[name](
        np.random.default_rng(sum(map(ord, name))))
    a, b = texts_on(card, ha, hb, 0)
    k3 = anchor_extend.diagonal_neq(a, b, off_a, off_b, lim_a, lim_b, length)
    k3_plain = anchor_extend.diagonal_neq_bits_reference(a, b, off_a, off_b, lim_a, lim_b, length)
    host = aes.shard_text(ha, n_shards, TILE)
    width = host.shape[1] - TILE
    jobs = anchor_extend._job_tensor(a, b, off_a, off_b, lim_a, lim_b)
    for shift in (0, 5):
        shards = _shards_on(card, host, shift)
        merged = None
        for s, shard in enumerate(shards):
            own_end = aes._own_end(s, n_shards, width)
            got = aes._launch(shard, s * width, own_end, b, jobs, length)
            plain = aes.diagonal_neq_shard_reference(shard, s * width, own_end, b, jobs, length)
            torch.cuda.synchronize()
            assert torch.equal(got, plain), f"{name}: shard {s}, shift {shift}"
            merged = got if merged is None else merged | got
        assert torch.equal(merged, k3), f"{name}: {n_shards} shards, shift {shift}"
        launches = aes.KERNEL_LAUNCHES
        whole = aes.diagonal_neq_sharded(shards, [b] * n_shards, off_a, off_b, lim_a,
                                         lim_b, length, [card] * n_shards, TILE)
        assert aes.KERNEL_LAUNCHES - launches == n_shards
        assert torch.equal(whole, k3)
    assert torch.equal(k3, k3_plain)


@pytest.mark.cuda
def test_one_shard_owning_everything_is_k3(card):
    ha, hb, off_a, off_b, lim_a, lim_b, length = CASES["residues_mod_16"](
        np.random.default_rng(1))
    a, b = texts_on(card, ha, hb, 3)
    jobs = anchor_extend._job_tensor(a, b, off_a, off_b, lim_a, lim_b)
    got = aes._launch(a, 0, (1 << 63) - 1, b, jobs, length)
    want = anchor_extend._launch(a, b, jobs, length)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
