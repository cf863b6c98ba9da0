"""The torch port's anchor extension against the JAX package's ops.

The JAX side runs as tests/test_anchor_extend.py and
tests/test_anchor_extend_pallas.py run it on the CPU: the XLA op
``diagonal_neq`` and the Pallas kernel ``diagonal_neq_pallas`` in
interpret mode, over sentinel-padded texts. The port runs its CPU route,
the plain PyTorch version, over the unpadded texts. Bitmaps are compared
bit for bit and extension lengths exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phylonium_tpu.ops.anchor_extend import diagonal_neq as xla_diagonal_neq
from phylonium_tpu.ops.anchor_extend import lce_batch as xla_lce_batch
from phylonium_tpu.ops.anchor_extend import pad_text
from phylonium_tpu.ops.anchor_extend_pallas import (
    diagonal_neq_pallas,
    pad_text2,
)
from phylonium_tpu_torch.ops import anchor_extend
from extend_cases import CASES as EXTEND_CASES


def _texts(seed, n, p, n_b=None):
    rng = np.random.default_rng(seed)
    a = rng.integers(65, 69, n).astype(np.uint8)
    b = a.copy()
    flips = rng.random(n) < p
    b[flips] = ((b[flips] - 65 + 1) % 4 + 65).astype(np.uint8)
    if n_b is not None:
        b = b[:n_b].copy()
    return a, b


def _case(name):
    """(a, b, off_a, off_b, lim_a, lim_b, length) of one named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "random":
        a, b = _texts(1, 6000, 0.03)
        off_a = rng.integers(0, len(a), 24)
        off_b = rng.integers(0, len(b), 24)
        return a, b, off_a, off_b, len(a), len(b), 900
    if name == "unaligned":
        a, b = _texts(2, 4000, 0.05)
        off_a = np.array([1, 255, 257, 1023])
        off_b = np.array([513, 2, 777, 100])
        return a, b, off_a, off_b, len(a), len(b), 1024
    if name == "near_end":  # identical texts; one job starts at the end
        a, b = _texts(3, 1000, 0.0)
        off = np.array([900, 999, 0, 1000, 968])
        return a, b, off, off, len(a), len(b), 512
    if name == "limit_zero":  # per-job limits, one of them 0
        a, b = _texts(4, 3000, 0.04)
        off_a = np.array([0, 17, 1500, 2999, 40])
        off_b = np.array([5, 0, 1499, 100, 2990])
        lim_a = np.array([0, 3000, 1600, 3000, 2000])
        lim_b = np.array([3000, 0, 3000, 2500, 3000])
        return a, b, off_a, off_b, lim_a, lim_b, 700
    if name == "texts_differ":  # b shorter than a; odd length
        a, b = _texts(5, 5000, 0.02, n_b=3001)
        off_a = rng.integers(0, len(a), 9)
        off_b = rng.integers(0, len(b), 9)
        return a, b, off_a, off_b, len(a), len(b), 33
    if name == "one_position":
        a, b = _texts(6, 2000, 0.5)
        off = rng.integers(0, 2000, 7)
        return a, b, off, off[::-1].copy(), len(a), len(b), 1
    raise KeyError(name)


CASES = ["random", "unaligned", "near_end", "limit_zero", "texts_differ",
         "one_position"]


def _port_bits(a, b, off_a, off_b, lim_a, lim_b, length):
    launches = anchor_extend.KERNEL_LAUNCHES
    plain = anchor_extend.PLAIN_CALLS
    words = anchor_extend.diagonal_neq(
        torch.from_numpy(a), torch.from_numpy(b), off_a, off_b, lim_a, lim_b,
        length,
    )
    assert anchor_extend.PLAIN_CALLS == plain + 1
    assert anchor_extend.KERNEL_LAUNCHES == launches
    assert words.dtype == torch.int32
    assert words.shape == (len(off_a), -(-length // 32))
    # bits past `length` in the last word are 0
    tail = anchor_extend.unpack_bits(words, words.shape[1] * 32)[:, length:]
    assert not tail.any()
    return anchor_extend.unpack_bits(words, length)


@pytest.mark.parametrize("tile", [256, 512])
@pytest.mark.parametrize("name", CASES)
def test_plain_bits_equal_xla_and_pallas(name, tile):
    a, b, off_a, off_b, lim_a, lim_b, length = _case(name)
    got = _port_bits(a, b, off_a, off_b, lim_a, lim_b, length)
    off_a32 = np.asarray(off_a, np.int32)
    off_b32 = np.asarray(off_b, np.int32)
    want = xla_diagonal_neq(
        jnp.asarray(pad_text(a, "a", tile)),
        jnp.asarray(pad_text(b, "b", tile)),
        off_a32, off_b32, lim_a, lim_b, length, tile=tile,
    )
    np.testing.assert_array_equal(got, want)
    pallas = diagonal_neq_pallas(
        jnp.asarray(pad_text2(a, "a", tile)),
        jnp.asarray(pad_text2(b, "b", tile)),
        off_a32, off_b32, lim_a, lim_b, length, tile=tile, interpret=True,
    )
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("name", sorted(EXTEND_CASES))
def test_plain_bits_equal_jax_at_the_kernel_edges(name):
    """The edges of csrc/diagonal_neq.cu (tests/extend_cases.py, which the
    card test and chip_smoke.py hold the kernel to): the plain bitmaps
    equal the XLA op's, and the Pallas kernel's in interpret mode where
    the case is small enough for it."""
    a, b, off_a, off_b, lim_a, lim_b, length = EXTEND_CASES[name](
        np.random.default_rng(sum(map(ord, name)))
    )
    got = _port_bits(a, b, off_a, off_b, lim_a, lim_b, length)
    tile = 512
    off_a32 = np.asarray(off_a, np.int32)
    off_b32 = np.asarray(off_b, np.int32)
    want = xla_diagonal_neq(
        jnp.asarray(pad_text(a, "a", tile)), jnp.asarray(pad_text(b, "b", tile)),
        off_a32, off_b32, lim_a, lim_b, length, tile=tile,
    )
    np.testing.assert_array_equal(got, want)
    if len(off_a) * -(-length // tile) <= 100:
        pallas = diagonal_neq_pallas(
            jnp.asarray(pad_text2(a, "a", tile)),
            jnp.asarray(pad_text2(b, "b", tile)),
            off_a32, off_b32, lim_a, lim_b, length, tile=tile, interpret=True,
        )
        np.testing.assert_array_equal(got, pallas)


def test_identical_texts_mismatch_exactly_from_the_limit():
    a, b, off, _, lim_a, lim_b, length = _case("near_end")
    got = _port_bits(a, b, off, off, lim_a, lim_b, length)
    for row, o in zip(got, off):
        inside = max(len(a) - int(o), 0)
        assert not row[:inside].any() and row[inside:].all()


def test_bits_equal_scalar_oracle():
    a, b, off_a, off_b, lim_a, lim_b, length = _case("texts_differ")
    got = _port_bits(a, b, off_a, off_b, lim_a, lim_b, length)
    for k in range(len(off_a)):
        for i in range(length):
            pa, pb = int(off_a[k]) + i, int(off_b[k]) + i
            want = pa >= len(a) or pb >= len(b) or a[pa] != b[pb]
            assert bool(got[k, i]) == want, (k, i)


@pytest.mark.parametrize("length", [1, 31, 32, 33, 77, 1000])
def test_pack_bits_round_trip_and_layout(length):
    rng = np.random.default_rng(length)
    bits = rng.random((3, length)) < 0.5
    words = anchor_extend.pack_bits(torch.from_numpy(bits))
    assert words.shape == (3, -(-length // 32))
    np.testing.assert_array_equal(
        anchor_extend.unpack_bits(words, length), bits
    )
    # bit i % 32 of word i // 32 is position i
    for i in rng.integers(0, length, 20):
        word = int(words[1, i // 32]) & 0xFFFFFFFF
        assert bool(word >> (i % 32) & 1) == bool(bits[1, i])


def test_empty_shapes():
    t = torch.from_numpy(_texts(7, 100, 0.1)[0])
    assert anchor_extend.diagonal_neq(t, t, [0], [0], 100, 100, 0).shape == (1, 0)
    assert anchor_extend.diagonal_neq(t, t, [], [], 100, 100, 64).shape == (0, 2)
    empty = torch.zeros(0, dtype=torch.uint8)
    words = anchor_extend.diagonal_neq(empty, t, [0, 0], [0, 5], 0, 100, 40)
    assert anchor_extend.unpack_bits(words, 40).all()


def test_wrapper_refuses_bad_jobs():
    t = torch.from_numpy(_texts(8, 100, 0.1)[0])
    with pytest.raises(ValueError, match="negative offset"):
        anchor_extend.diagonal_neq(t, t, [-1], [0], 100, 100, 10)
    with pytest.raises(ValueError, match="beyond its text"):
        anchor_extend.diagonal_neq(t, t, [0], [0], 101, 100, 10)
    with pytest.raises(ValueError, match="beyond its text"):
        anchor_extend.diagonal_neq(t, t, [0, 1], [0, 1], 100, [50, 101], 10)
    with pytest.raises(ValueError, match="one offset per job"):
        anchor_extend.diagonal_neq(t, t, [0, 1], [0], 100, 100, 10)
    with pytest.raises(ValueError, match="uint8"):
        anchor_extend.diagonal_neq(t.to(torch.int32), t, [0], [0], 100, 100, 8)
    with pytest.raises(ValueError, match="length"):
        anchor_extend.diagonal_neq(t, t, [0], [0], 100, 100, -1)


def _lce_oracle(a, b, oa, ob, cap):
    m = min(cap, len(a) - oa, len(b) - ob)
    t = 0
    while t < m and a[oa + t] == b[ob + t]:
        t += 1
    return t


def _lce_case(name):
    """The cases of tests/test_anchor_extend.py's lce_batch tests."""
    if name.startswith("random"):
        rng = np.random.default_rng(12345)
        a, b = _texts(9, 5000, 0.02)
        nb = 64
        off_a = rng.integers(0, len(a), nb).astype(np.int32)
        off_b = rng.integers(0, len(b), nb).astype(np.int32)
        cap = np.minimum(
            rng.integers(0, len(a), nb).astype(np.int32),
            np.minimum(len(a) - off_a, len(b) - off_b),
        ).astype(np.int32)
        return a, b, off_a, off_b, cap, int(name.split("_")[1])
    if name == "long_identical_run":
        rng = np.random.default_rng(12345)
        a = rng.integers(65, 69, 20000).astype(np.uint8)
        b = a.copy()
        b[0] = a[0] ^ 1
        return (a, b, np.array([0, 1, 100], np.int32),
                np.array([0, 1, 101], np.int32),
                np.array([20000, 19999, 15000], np.int32), 2048)
    if name == "zero_cap":
        a, b = _texts(10, 1000, 0.02)
        return (a, b, np.array([0, 5], np.int32), np.array([0, 5], np.int32),
                np.array([0, 0], np.int32), 2048)
    raise KeyError(name)


@pytest.mark.parametrize(
    "name", ["random_128", "random_512", "long_identical_run", "zero_cap"]
)
def test_lce_batch_equals_jax(name):
    a, b, off_a, off_b, cap, tile = _lce_case(name)
    got = anchor_extend.lce_batch(
        torch.from_numpy(a), torch.from_numpy(b), off_a, off_b, cap
    )
    want = xla_lce_batch(
        jnp.asarray(pad_text(a, "a", tile)),
        jnp.asarray(pad_text(b, "b", tile)),
        off_a, off_b, cap, tile=tile,
    )
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = [
        _lce_oracle(a, b, int(x), int(y), int(c))
        for x, y, c in zip(off_a, off_b, cap)
    ]
    np.testing.assert_array_equal(got.numpy(), oracle)


def test_lce_batch_stops_at_the_text_end():
    a, b = _texts(11, 500, 0.0)  # identical: only the ends stop a run
    got = anchor_extend.lce_batch(
        torch.from_numpy(a), torch.from_numpy(b[:300]),
        [0, 250, 450], [0, 250, 100], [1000, 1000, 1000],
    )
    assert got.tolist() == [300, 50, 0]
