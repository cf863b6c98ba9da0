"""The CUDA diagonal-mismatch kernel against its plain version, on a card.

Skips without a CUDA device. Imports nothing of jax, so it runs on a
machine with a card and no jax:

    PHYLONIUM_TPU_TEST_REAL=1 python -m pytest -m cuda tests/test_torch_anchor_extend_cuda.py
"""

import numpy as np
import pytest
import torch

from phylonium_tpu.config import RunConfig
from phylonium_tpu.core.anchor_stats import min_anchor_length
from phylonium_tpu.core.filter import filter_overlaps_max
from phylonium_tpu.core.pipeline import map_queries as host_map_queries
from phylonium_tpu.data.sequence import Sequence, gc_content, revcomp
from phylonium_tpu.index.esa import ESAIndex
from phylonium_tpu_torch.core.hybrid_map import hybrid_map_queries
from phylonium_tpu_torch.ops import anchor_extend
from extend_cases import CASES as EXTEND_CASES, texts_on

ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda")


def _mutant(rng, base, p):
    arr = base.copy()
    hit = rng.random(arr.size) < p
    arr[hit] = ACGT[(np.searchsorted(ACGT, arr[hit]) + rng.integers(1, 4, hit.sum())) % 4]
    return arr


@pytest.mark.cuda
@pytest.mark.parametrize(
    "na,nb,jobs,length",
    [(1000, 1000, 1, 1), (5000, 3001, 9, 33), (6000, 6000, 300, 900),
     (100_000, 90_000, 17, 1 << 16), (1 << 20, 1 << 20, 4, (1 << 19) + 5)],
)
def test_kernel_equals_plain(card, na, nb, jobs, length):
    rng = np.random.default_rng(na + jobs)
    a = ACGT[rng.integers(0, 4, na)]
    b = _mutant(rng, a, 0.03)[:nb]
    off_a = rng.integers(0, na + 1, jobs)
    off_b = rng.integers(0, nb + 1, jobs)
    off_a[0], off_b[-1] = na, nb  # at the text end
    lim_a = rng.integers(0, na + 1, jobs)
    lim_a[jobs // 2] = 0
    lim_b = np.full(jobs, nb)
    ta = torch.from_numpy(a).to(card)
    tb = torch.from_numpy(b).to(card)
    launches = anchor_extend.KERNEL_LAUNCHES
    got = anchor_extend.diagonal_neq(ta, tb, off_a, off_b, lim_a, lim_b, length)
    torch.cuda.synchronize()
    assert anchor_extend.KERNEL_LAUNCHES == launches + 1
    want = anchor_extend.diagonal_neq_bits_reference(
        ta, tb, off_a, off_b, lim_a, lim_b, length
    )
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("name", sorted(EXTEND_CASES))
def test_kernel_equals_plain_at_the_edges(card, name, shift):
    """tests/extend_cases.py on the card; with ``shift`` > 0 the texts
    start 3 and 13 bytes into their buffers, so the 16-byte loads that
    cover a text's first bytes would begin before it and the kernel must
    take its byte path there."""
    a, b, off_a, off_b, lim_a, lim_b, length = EXTEND_CASES[name](
        np.random.default_rng(sum(map(ord, name)))
    )
    texts = texts_on(card, a, b, shift)
    launches = anchor_extend.KERNEL_LAUNCHES
    got = anchor_extend.diagonal_neq(*texts, off_a, off_b, lim_a, lim_b, length)
    want = anchor_extend.diagonal_neq_bits_reference(
        *texts, off_a, off_b, lim_a, lim_b, length
    )
    torch.cuda.synchronize()
    assert anchor_extend.KERNEL_LAUNCHES == launches + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_identical_texts_mismatch_from_the_limit(card):
    text = torch.from_numpy(ACGT[np.random.default_rng(1).integers(0, 4, 1000)]).to(card)
    off = np.array([900, 999, 0, 1000, 968])
    bits = anchor_extend.unpack_bits(
        anchor_extend.diagonal_neq(text, text, off, off, 1000, 1000, 512), 512
    )
    for row, o in zip(bits, off):
        inside = max(1000 - int(o), 0)
        assert not row[:inside].any() and row[inside:].all()


@pytest.mark.cuda
def test_hybrid_on_card_equals_native(card):
    rng = np.random.default_rng(200)
    base = ACGT[rng.integers(0, 4, 200_000)]
    genomes = [base.tobytes()]
    for p in (0.005, 0.02, 0.05):
        genomes.append(_mutant(rng, base, p).tobytes())
    draft = bytearray(genomes[-1])
    draft[60_000:90_000] = revcomp(bytes(draft[60_000:90_000]))
    genomes.append(bytes(draft[:100_000]) + b"!" + bytes(draft[100_000:]))
    subject = Sequence("S0", genomes[0])
    queries = [Sequence(f"S{k}", g) for k, g in enumerate(genomes)]
    ref = ESAIndex(subject)
    thr = min_anchor_length(0.025, gc_content(subject.nucl), ref.size)

    launches = anchor_extend.KERNEL_LAUNCHES
    plain = anchor_extend.PLAIN_CALLS
    raw = hybrid_map_queries(ref, thr, [q.as_array() for q in queries], card)
    assert anchor_extend.KERNEL_LAUNCHES > launches
    assert anchor_extend.PLAIN_CALLS == plain
    got = []
    for hv in raw:
        hv.sort(key=lambda h: h.start())
        got.append(filter_overlaps_max(hv))
    want = host_map_queries(
        ref, thr, queries, RunConfig(progress="never", map_backend="native")
    )

    def tuples(hv):
        return [(h.direction, h.index_reference, h.index_reference_projected,
                 h.index_query, h.length) for h in hv]

    assert [tuples(h) for h in got] == [tuples(h) for h in want]
