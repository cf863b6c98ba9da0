"""The port's sharded-text extension (X5) on the CPU, against the JAX package.

- ``shard_text`` is byte-equal to the JAX package's;
- ``diagonal_neq_sharded`` over ``[cpu] * S`` shards, S in {2, 4, 8},
  equals the JAX package's ``diagonal_neq_sharded`` on its 8-device CPU
  mesh and the port's unsharded ``diagonal_neq``, with offsets that
  straddle shard boundaries by -3, -1, 0 and +1 bytes, and with limits
  that force mismatches (as tests/test_anchor_extend_sharded.py);
- the CLI with ``PHYLONIUM_TPU_SHARDED_EXTEND=1 --map-backend hybrid`` and
  ``shard_devices`` patched to 4 CPU devices prints the default run's
  matrix byte for byte, and every bitmap call is split 4 ways.
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from phylonium_tpu.ops.anchor_extend import pad_text
from phylonium_tpu.ops.anchor_extend_sharded import (
    diagonal_neq_sharded as jax_sharded,
    shard_text as jax_shard_text,
)
from phylonium_tpu_torch.ops import anchor_extend, anchor_extend_sharded as aes

ACGT = np.frombuffer(b"ACGT", np.uint8)
CPU = torch.device("cpu")


def _jax_mesh(n):
    return jax.sharding.Mesh(np.array(jax.devices()[:n]), ("x",))


def _unpack(words, length):
    return anchor_extend.unpack_bits(words, length)


@pytest.mark.parametrize("n,n_shards,tile", [(40_000, 2, 256), (40_256, 4, 256),
                                             (7, 3, 64), (3001, 8, 2048)])
def test_shard_text_equals_jax(n, n_shards, tile):
    rng = np.random.default_rng(n)
    text = pad_text(ACGT[rng.integers(0, 4, n)], "a", tile)
    np.testing.assert_array_equal(
        aes.shard_text(text, n_shards, tile), jax_shard_text(text, n_shards, tile)
    )


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_matches_jax_and_unsharded(n_shards):
    rng = np.random.default_rng(12345)
    tile = 256
    n_a, n_b = 40_000, 20_000
    a_text = ACGT[rng.integers(0, 4, n_a)]
    # correlated texts so long matches cross shard boundaries
    b_text = a_text[5_000 : 5_000 + n_b].copy()
    flip = rng.random(n_b) < 0.01
    b_text[flip] = ACGT[(np.searchsorted(ACGT, b_text[flip]) + 1) % 4]
    a_pad, b_pad = pad_text(a_text, "a", tile), pad_text(b_text, "b", tile)
    length, n_jobs = 4096, 64
    width = -(-a_pad.shape[0] // n_shards)
    boundary = np.array([s * width + d for s in range(1, n_shards) for d in (-3, -1, 0, 1)])
    boundary = boundary[(boundary >= 0) & (boundary < n_a)]
    off_a = np.concatenate([boundary, rng.integers(0, n_a, n_jobs - boundary.size)])
    off_b = rng.integers(0, n_b, n_jobs)
    lim_a = np.full(n_jobs, n_a)
    lim_b = np.full(n_jobs, n_b)

    want = jax_sharded(jax_shard_text(a_pad, n_shards, tile), b_pad,
                       off_a.astype(np.int32), off_b.astype(np.int32),
                       lim_a.astype(np.int32), lim_b.astype(np.int32),
                       length, _jax_mesh(n_shards), tile)
    calls = aes.PLAIN_CALLS
    got = aes.diagonal_neq_sharded(
        aes.shard_text(a_pad, n_shards, tile), torch.from_numpy(b_text),
        off_a, off_b, lim_a, lim_b, length, [CPU] * n_shards, tile,
    )
    assert aes.PLAIN_CALLS - calls == n_shards
    np.testing.assert_array_equal(_unpack(got, length), want)
    unsharded = anchor_extend.diagonal_neq(
        torch.from_numpy(a_text), torch.from_numpy(b_text),
        off_a, off_b, lim_a, lim_b, length,
    )
    assert torch.equal(got, unsharded)


def test_limits_force_mismatch():
    rng = np.random.default_rng(5)
    tile = 128
    a_text = ACGT[rng.integers(0, 4, 3000)]
    b_text = a_text.copy()  # identical: only limits make mismatches
    a_pad, b_pad = pad_text(a_text, "a", tile), pad_text(b_text, "b", tile)
    off = np.array([2900, 0, 1500, 1499])
    lim_a = np.array([3000, 100, 1600, 3000])
    lim_b = np.array([3000, 3000, 1550, 1520])
    want = jax_sharded(jax_shard_text(a_pad, 4, tile), b_pad, off.astype(np.int32),
                       off.astype(np.int32), lim_a.astype(np.int32),
                       lim_b.astype(np.int32), 256, _jax_mesh(4), tile)
    got = aes.diagonal_neq_sharded(
        aes.shard_text(a_pad, 4, tile), torch.from_numpy(b_text), off, off,
        lim_a, lim_b, 256, [CPU] * 4, tile,
    )
    np.testing.assert_array_equal(_unpack(got, 256), want)


def test_shard_reference_owns_each_word_once():
    """The shards' rows are disjoint and their OR is the unsharded row."""
    rng = np.random.default_rng(9)
    a = ACGT[rng.integers(0, 4, 5000)]
    b = ACGT[rng.integers(0, 4, 5000)]
    shards = aes.shard_text(a, 3, 64)
    width = shards.shape[1] - 64
    jobs = torch.tensor([[0, 1660, width - 1, 4990], [3, 40, 7, 100],
                         [5000] * 4, [5000] * 4], dtype=torch.int64)
    rows = [aes.diagonal_neq_shard_reference(
        torch.from_numpy(shards[s]), s * width, aes._own_end(s, 3, width),
        torch.from_numpy(b), jobs, 700) for s in range(3)]
    for s in range(3):
        for t in range(s + 1, 3):
            assert not (rows[s] & rows[t]).any()
    want = anchor_extend.diagonal_neq(torch.from_numpy(a), torch.from_numpy(b),
                                      jobs[0].numpy(), jobs[1].numpy(), 5000, 5000, 700)
    assert torch.equal(rows[0] | rows[1] | rows[2], want)


def test_bad_arguments_raise():
    a = np.zeros(100, np.uint8)
    shards = aes.shard_text(a, 2, 64)
    b = torch.zeros(50, dtype=torch.uint8)
    with pytest.raises(ValueError, match="tile"):
        aes.diagonal_neq_sharded(aes.shard_text(a, 2, 16), b, [0], [0], 100, 50, 8,
                                 [CPU] * 2, 16)
    with pytest.raises(ValueError, match="3 devices"):
        aes.diagonal_neq_sharded(shards, b, [0], [0], 100, 50, 8, [CPU] * 3, 64)
    with pytest.raises(ValueError, match="lim_a"):
        aes.diagonal_neq_sharded(shards, b, [0], [0], 101, 50, 8, [CPU] * 2, 64)


def _panel(tmp_path):
    rng = np.random.default_rng(17)
    base = ACGT[rng.integers(0, 4, 4000)]
    files = []
    for k, p in enumerate([0.0, 0.02, 0.06]):
        arr = base.copy()
        idx = rng.random(arr.size) < p
        arr[idx] = ACGT[(np.searchsorted(ACGT, arr[idx]) + rng.integers(1, 4, int(idx.sum()))) % 4]
        path = tmp_path / f"g{k}.fasta"
        path.write_bytes(b">g%d\n" % k + arr.tobytes() + b"\n")
        files.append(str(path))
    return files


def test_sharded_extension_through_cli(tmp_path, monkeypatch):
    from phylonium_tpu_torch.cli import main

    files = _panel(tmp_path)

    def run(extra):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(["--progress=never", "--device", "cpu", *extra, *files])
        return rc, out.getvalue()

    rc0, want = run([])
    assert rc0 == 0
    calls = []
    real = aes.diagonal_neq_sharded

    def counting(*args, **kwargs):
        calls.append(len(args[-2]))  # the devices the text was split over
        return real(*args, **kwargs)

    monkeypatch.setattr(aes, "diagonal_neq_sharded", counting)
    monkeypatch.setattr(aes, "shard_devices", lambda device: [device] * 4)
    monkeypatch.setenv("PHYLONIUM_TPU_SHARDED_EXTEND", "1")
    plain = aes.PLAIN_CALLS
    rc1, got = run(["--map-backend", "hybrid"])
    assert rc1 == 0
    assert got == want
    assert calls, "the sharded extension never ran"
    assert all(n == 4 for n in calls)
    assert aes.PLAIN_CALLS - plain == 4 * len(calls)
