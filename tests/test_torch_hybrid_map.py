"""The torch port's hybrid mapper against the JAX package's and the oracle.

Every case of tests/test_hybrid_map.py, one parametrised case each: the
port's ``hybrid_map_queries`` on the CPU (the plain bitmap version) must
give the homology tuples of the JAX package's ``hybrid_map_queries``
(its XLA op on the CPU) and of the chain-loop oracle
``anchor_homologies``, raw and through the overlap filter.
"""

import numpy as np
import pytest
import torch

from phylonium_tpu.core.anchor_stats import min_anchor_length
from phylonium_tpu.core.anchors import anchor_homologies
from phylonium_tpu.core.filter import filter_overlaps_max
from phylonium_tpu.core.hybrid_map import _TILE
from phylonium_tpu.core.hybrid_map import (
    hybrid_map_queries as jax_hybrid_map_queries,
)
from phylonium_tpu.data.sequence import Sequence, gc_content, revcomp
from phylonium_tpu.index.esa import ESAIndex
from phylonium_tpu_torch.config import ConfigError
from phylonium_tpu_torch.core.hybrid_map import hybrid_map_queries
from phylonium_tpu_torch.ops import anchor_extend

CPU = torch.device("cpu")


def _as_tuples(hv):
    return [
        (h.direction, h.index_reference, h.index_reference_projected,
         h.index_query, h.length)
        for h in hv
    ]


def _setup(subject_bytes, query_bytes_list):
    subject = Sequence("S", subject_bytes)
    ref = ESAIndex(subject)
    thr = min_anchor_length(0.025, gc_content(subject.nucl), ref.size)
    queries = [Sequence(f"Q{k}", qb) for k, qb in enumerate(query_bytes_list)]
    return ref, thr, queries


def _check_parity(subject_bytes, query_bytes_list, chunk=1 << 12):
    ref, thr, queries = _setup(subject_bytes, query_bytes_list)
    oracle = [anchor_homologies(ref, thr, q) for q in queries]
    arrays = [q.as_array() for q in queries]
    plain = anchor_extend.PLAIN_CALLS
    stats = {}
    got = hybrid_map_queries(ref, thr, arrays, CPU, chunk=chunk, stats=stats)
    assert anchor_extend.PLAIN_CALLS - plain == stats["rounds"]
    jax_got = jax_hybrid_map_queries(ref, thr, arrays, chunk=chunk)
    assert [_as_tuples(h) for h in got] == [_as_tuples(h) for h in oracle]
    assert [_as_tuples(h) for h in got] == [_as_tuples(h) for h in jax_got]
    for hv, want in zip(got, oracle):
        hv.sort(key=lambda h: h.start())
        want.sort(key=lambda h: h.start())
        assert _as_tuples(filter_overlaps_max(hv)) == _as_tuples(
            filter_overlaps_max(want)
        )


def _case(name, rng, make_genome, make_mutant):
    """(subject, queries, chunk) of one case of tests/test_hybrid_map.py."""
    if name == "substitutions_only":
        base = make_genome(rng, 8000)
        qs = [base, make_mutant(base, 0.02, rng), make_mutant(base, 0.08, rng)]
        return base, qs, 1 << 12
    if name == "identical_sequence":
        base = make_genome(rng, 3000)
        return base, [base], 1 << 12
    if name == "revcomp_segment":
        base = make_genome(rng, 6000)
        q = bytearray(make_mutant(base, 0.01, rng))
        q[2000:3500] = revcomp(bytes(q[2000:3500]))
        return base, [bytes(q)], 1 << 12
    if name == "contig_separators":
        base = make_genome(rng, 6000)
        m = make_mutant(base, 0.01, rng)
        q = m[:2000] + b"!" + m[2000:4100] + b"!" + m[4100:]
        return base[:3000] + b"!" + base[3000:], [q], 1 << 12
    if name == "unrelated_and_insert":
        base = make_genome(rng, 5000)
        insert = make_genome(rng, 1500)
        q = make_mutant(base[:2500], 0.02, rng) + insert + make_mutant(
            base[2500:], 0.02, rng
        )
        return base, [q, make_genome(rng, 4000)], 1 << 12
    if name == "rearrangement":
        base = make_genome(rng, 6000)
        m = make_mutant(base, 0.015, rng)
        return base, [m[3000:] + m[:3000]], 1 << 12
    if name.startswith("chunk_"):
        base = make_genome(rng, 4000)
        return base, [make_mutant(base, 0.03, rng)], int(name[6:])
    if name == "short_and_empty":
        base = make_genome(rng, 1000)
        return base, [base[:50], base[400:420]], 1 << 12
    raise KeyError(name)


CASES = [
    "substitutions_only", "identical_sequence", "revcomp_segment",
    "contig_separators", "unrelated_and_insert", "rearrangement",
    "chunk_256", "chunk_1024", f"chunk_{1 << 15}", "short_and_empty",
]


@pytest.mark.parametrize("name", CASES)
def test_hybrid_equals_jax_and_oracle(name, rng, make_genome, make_mutant):
    subject, queries, chunk = _case(name, rng, make_genome, make_mutant)
    _check_parity(subject, queries, chunk=chunk)


@pytest.mark.parametrize("seed", [101, 202, 303, 404])
def test_hybrid_structural_sweep(seed):
    """The structural seeds of tests/test_hybrid_map.py."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = acgt[rng.integers(0, 4, 4000)].tobytes()

    def mutate(s, p):
        arr = np.frombuffer(s, np.uint8).copy()
        idx = np.flatnonzero(rng.random(arr.size) < p)
        arr[idx] = acgt[
            (np.searchsorted(acgt, arr[idx]) + rng.integers(1, 4, idx.size))
            % 4
        ]
        return arr.tobytes()

    queries = []
    for _ in range(4):
        g = mutate(base, float(rng.uniform(0.005, 0.08)))
        k = int(rng.integers(0, 3))
        if k == 1:  # inversion
            lo = int(rng.integers(0, 2000))
            hi = lo + int(rng.integers(200, 1500))
            g = g[:lo] + revcomp(g[lo:hi]) + g[hi:]
        elif k == 2:  # translocation + contig split
            cut = int(rng.integers(500, 3500))
            g = g[cut:] + b"!" + g[:cut]
        queries.append(g)
    _check_parity(base, queries, chunk=int(rng.choice([512, 4096])))


def test_hybrid_query_groups_beyond_int32(rng, make_genome, make_mutant):
    """A chunk near 2^31 leaves room for two queries per group: the
    groups map as one batch would, and progress counts across them."""
    base = make_genome(rng, 2000)
    raw = [make_mutant(base, p, rng) for p in (0.01, 0.03, 0.05)]
    ref, thr, queries = _setup(base, raw)
    chunk = (1 << 31) - 1 - _TILE - 4500  # 4500 bases per group
    seen = []
    stats = {}
    got = hybrid_map_queries(
        ref, thr, [q.as_array() for q in queries], CPU, chunk=chunk,
        progress=seen.append, stats=stats,
    )
    want = [anchor_homologies(ref, thr, q) for q in queries]
    assert [_as_tuples(h) for h in got] == [_as_tuples(h) for h in want]
    assert seen == sorted(seen) and seen[-1] == len(queries)
    assert stats["rounds"] >= 2  # at least one per group


def test_hybrid_refuses_inputs_beyond_int32(rng, make_genome):
    base = make_genome(rng, 3000)
    ref, thr, queries = _setup(base, [base])
    with pytest.raises(ConfigError, match="reference of 6001 bases"):
        hybrid_map_queries(
            ref, thr, [queries[0].as_array()], CPU,
            chunk=(1 << 31) - 1 - _TILE - 6000,
        )
    big = _setup(make_genome(rng, 1000), [base])
    with pytest.raises(ConfigError, match="a 3000-base query"):
        hybrid_map_queries(
            big[0], big[1], [big[2][0].as_array()], CPU,
            chunk=(1 << 31) - 1 - _TILE - 2500,
        )


def test_hybrid_through_process_equals_native(rng, make_genome, make_mutant):
    """The port's process() with --map-backend hybrid on the CPU gives the
    counts of its default (native) mapping."""
    from phylonium_tpu_torch.config import TorchRunConfig
    from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO, process

    base = make_genome(rng, 5000)
    queries = [
        Sequence("a", base),
        Sequence("b", make_mutant(base, 0.03, rng)),
        Sequence("c", make_mutant(base, 0.07, rng)),
    ]
    hybrid = TorchRunConfig(progress="never", map_backend="hybrid",
                            device="cpu")
    got = process(queries[0], queries, hybrid)
    info = dict(LAST_RUN_INFO)
    want = process(queries[0], queries, TorchRunConfig(progress="never",
                                                       device="cpu"))
    np.testing.assert_array_equal(got.substitutions, want.substitutions)
    np.testing.assert_array_equal(got.homologs, want.homologs)
    assert info["map_carrier"] == "torch-cpu"
    assert info["extend_plain_calls"] == info["map_rounds"] > 0
    assert info["extend_kernel_launches"] == 0
    assert {"map_host", "map_device"} <= set(info["timings"])
    assert LAST_RUN_INFO["map_carrier"] == "native"
    assert LAST_RUN_INFO["map_rounds"] == 0
