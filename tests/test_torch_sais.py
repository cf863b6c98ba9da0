"""The port's parallel SA-IS against the JAX package's serial one.

``phylonium_tpu_torch.native.build_sa`` sorts the suffixes of a byte
string under OpenMP: blocks of the induce passes gathered and placed by
several threads, the linear stages in chunks. A suffix array is unique,
so at every thread count it must equal, byte for byte, the array of the
JAX package's untouched serial SA-IS (and a plain sort of the suffixes
where the text is short). The texts: random bases; a genome followed by
its own copy (repeats half the text long); long homopolymer runs; the
index's doubled text with '!' and '#' separators; bytes with NULs, the
widened path. The sizes: short, around the one-thread cutoff (16,384),
and 3 M bytes, where two recursion levels and many blocks run.
"""

import functools

import numpy as np
import pytest

import phylonium_tpu.native as j_native
import phylonium_tpu_torch.native as t_native

ACGT = np.frombuffer(b"ACGT", np.uint8)
COMP = np.zeros(256, np.uint8)
COMP[list(b"ACGT!")] = list(b"TGCA!")

THREADS = (1, 2, 8)
# the text and its sentinel reach the cutoff at 16,383 bytes
SIZES = (1, 2, 3, 1000, 2000, 16382, 16383, 16384, 3_000_000)
KINDS = ("random", "copy", "homopolymer", "doubled", "nul")


def _text(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng([n, KINDS.index(kind)])
    bases = ACGT[rng.integers(0, 4, n)]
    if kind == "random":
        return bases
    if kind == "copy":
        half = bases[: (n + 1) // 2]
        return np.concatenate([half, half])[:n]
    if kind == "homopolymer":
        for at in rng.integers(0, n, max(1, n // 500)):
            bases[at : at + int(rng.integers(1, 400))] = ACGT[rng.integers(0, 4)]
        return bases
    if kind == "doubled":
        half = bases[: n // 2].copy()
        half[:: max(2, n // 7)] = ord("!")
        return np.concatenate([half, np.frombuffer(b"#", np.uint8), COMP[half[::-1]]])[:n]
    bases[rng.integers(0, n, max(1, n // 50))] = 0
    return bases


@functools.lru_cache(maxsize=1)
def _serial(kind: str, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The text and the JAX package's serial suffix array of it (the
    thread counts of one text run in a row)."""
    text = _text(kind, n)
    return text, j_native.build_sa(text)


@pytest.fixture
def threads():
    """Sets the native thread count; all cores again afterwards."""
    yield t_native.set_threads
    t_native.set_threads(t_native.num_procs())


@pytest.mark.parametrize("nt", THREADS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", SIZES)
def test_parallel_sais_equals_serial(nt, kind, n, threads):
    text, expected = _serial(kind, n)
    threads(nt)
    got = t_native.build_sa(text)
    assert got.dtype == np.int64 and got.shape == (len(text),)
    assert np.array_equal(got, expected)
    if n <= 2000:
        raw = text.tobytes()
        assert got.tolist() == sorted(range(n), key=lambda i: raw[i:])
