"""The port's batch mapper reads each genome where it lies.

``NativeESA.map_queries`` hands the native mapper one pointer and one
length a genome. A C-contiguous ``uint8`` array is mapped in place; any
other array is copied alone and counted in ``staged_bytes``. Each case
maps a panel with the port's mapper, interleaved chains and the scalar
loop (``PHYLONIUM_TPU_MAP_ILP=0``), and with the JAX package's, which
stages the chunk into one buffer, and requires the raw homology rows to
be equal, genome by genome.
"""

import ctypes
import mmap
import time

import numpy as np
import pytest

import phylonium_tpu.data.sequence as j_seq
import phylonium_tpu.index.esa as j_esa
import phylonium_tpu.native as j_native
from phylonium_tpu_torch.core.anchor_stats import min_anchor_length
from phylonium_tpu_torch.data.sequence import Sequence, gc_content
from phylonium_tpu_torch.index.esa import ESAIndex

ACGT = np.frombuffer(b"ACGT", np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")
LENGTH = 6000
GENOMES = 34  # past one chunk of PHYLONIUM_TPU_MAP_BATCH=32
PROT_NONE = 0


def _panel(seed: int = 5) -> list[bytes]:
    """A base genome, mutants at 0.5-4 %, and drafts of two contigs
    joined by '!', the second reverse-complemented."""
    rng = np.random.default_rng(seed)
    base = ACGT[rng.integers(0, 4, LENGTH)]
    out = [base.tobytes()]
    for k in range(1, GENOMES):
        arr = base.copy()
        hit = rng.random(LENGTH) < 0.005 * (1 + k % 8)
        arr[hit] = ACGT[(np.searchsorted(ACGT, arr[hit]) + rng.integers(1, 4, hit.sum())) % 4]
        seq = arr.tobytes()
        if k % 5 == 0:
            half = LENGTH // 2
            seq = seq[:half] + b"!" + seq[half:][::-1].translate(COMP)
        out.append(seq)
    return out


@pytest.fixture(scope="module")
def indexes():
    """The port's and the JAX package's native index of the panel's first
    genome, and the anchor threshold. The JAX package's build writes its
    library in place, so a worker may find it truncated while another
    writes it: wait for that build."""
    for _ in range(120):
        try:
            j_native.get_lib()
            break
        except OSError as exc:
            error = exc
            time.sleep(1)
    else:
        raise error
    genomes = _panel()
    subject = Sequence("G0", genomes[0])
    ref = ESAIndex(subject, backend="native")
    theirs = j_esa.ESAIndex(j_seq.Sequence("G0", genomes[0]), backend="native")
    threshold = min_anchor_length(0.025, gc_content(subject.nucl), ref.size)
    return ref._native, theirs._native, threshold, genomes


class _Guarded:
    """Genomes each ending on the last byte before a ``PROT_NONE`` page of
    this process's own memory, so that a read past any of them faults."""

    def __init__(self):
        self._maps: list[mmap.mmap] = []
        self._libc = ctypes.CDLL(None, use_errno=True)
        self._libc.mprotect.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]

    def array(self, data: bytes) -> np.ndarray:
        page = mmap.PAGESIZE
        body = -(-max(len(data), 1) // page) * page
        mm = mmap.mmap(-1, body + page)
        addr = ctypes.addressof(ctypes.c_char.from_buffer(mm))
        if self._libc.mprotect(addr + body, page, PROT_NONE) != 0:
            raise OSError(ctypes.get_errno(), "mprotect")
        self._maps.append(mm)
        arr = np.ctypeslib.as_array(
            (ctypes.c_uint8 * len(data)).from_address(addr + body - len(data))
        )
        arr[:] = np.frombuffer(data, np.uint8)
        return arr

    def close(self) -> None:
        for mm in self._maps:
            mm.close()
        self._maps.clear()


def _queries(case: str, genomes: list[bytes], guard: _Guarded):
    """(queries, bytes the port's wrapper must stage) for ``case``."""
    if case == "compacted":
        # as core/lowmem.py unpacks a group
        seqs = [Sequence(f"Q{k}", g) for k, g in enumerate(genomes)]
        for s in seqs:
            s.compact()
        assert all(s.compacted for s in seqs)
        return [s.as_array() for s in seqs], 0
    if case == "bytes":
        return [np.frombuffer(g, np.uint8) for g in genomes], 0
    if case == "staged":
        queries, staged = [], 0
        for k, g in enumerate(genomes):
            arr = np.frombuffer(g, np.uint8)
            if k % 3 == 0:
                arr = np.repeat(arr, 2)[::2]  # strided
                staged += arr.size
            elif k % 3 == 1:
                arr = arr.astype(np.int64)
                staged += arr.size
            queries.append(arr)
        return queries, staged
    if case == "short":
        cut = [g if k % 4 else g[: k % 15] for k, g in enumerate(genomes)]
        cut[1] = b""
        return [np.frombuffer(g, np.uint8) for g in cut], 0
    assert case == "guard"
    cut = [g if k % 6 else g[-(1 + k % 16):] for k, g in enumerate(genomes)]
    cut[2] = b""
    return [guard.array(g) for g in cut], 0


@pytest.mark.parametrize("batch", ["0", "32"])
@pytest.mark.parametrize("case", ["compacted", "bytes", "staged", "short", "guard"])
def test_map_in_place_equals_jax_and_scalar(indexes, monkeypatch, case, batch):
    ours, theirs, threshold, genomes = indexes
    monkeypatch.setenv("PHYLONIUM_TPU_MAP_BATCH", batch)
    guard = _Guarded()
    try:
        queries, staged = _queries(case, genomes, guard)
        before = ours.staged_bytes
        monkeypatch.delenv("PHYLONIUM_TPU_MAP_ILP", raising=False)
        got = ours.map_queries(queries, threshold, raw=True)
        assert ours.staged_bytes - before == staged
        assert (staged > 0) == (case == "staged")
        monkeypatch.setenv("PHYLONIUM_TPU_MAP_ILP", "0")
        scalar = ours.map_queries(queries, threshold, raw=True)
        monkeypatch.delenv("PHYLONIUM_TPU_MAP_ILP")
        want = theirs.map_queries(
            [np.array(q, dtype=np.uint8) for q in queries], threshold, raw=True
        )
        del queries
    finally:
        guard.close()
    assert len(got) == len(scalar) == len(want) == GENOMES
    assert sum(len(h) for h in got) > GENOMES // 2
    for k, (g, s, w) in enumerate(zip(got, scalar, want)):
        assert g.shape[1:] == (5,), k
        assert np.array_equal(g, w), k
        assert np.array_equal(s, w), k
