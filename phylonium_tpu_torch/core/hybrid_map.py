"""Hybrid mapping: the host chain state machine + diagonal bitmaps on a device.

The port of the JAX package's ``hybrid_map_queries``
(phylonium_tpu/core/hybrid_map.py:243-388). The chain state machine,
``_Machine``, is jax-free host code and is imported as it is: it walks
each query's anchor chain and blocks whenever it needs the mismatch
positions of one diagonal, ``request = (d, start)``. This module runs
every machine until it blocks, answers all blocked machines with one
``diagonal_neq`` call on ``device`` (the CUDA kernel on a card, the plain
PyTorch version on the CPU), unpacks each row on the host and feeds it
back, in lockstep rounds until every machine has finished.

The reference text and the concatenated queries go to the device once per
group of queries. Homology lists are identical to the JAX package's
hybrid mapper, to its Python oracle (core/anchors.py) and to its native
mapper.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from phylonium_tpu.core.homology import Homology
from phylonium_tpu.core.hybrid_map import _TILE, DEFAULT_CHUNK, _Machine
from phylonium_tpu.index.esa import ESAIndex
from phylonium_tpu_torch.config import ConfigError
from phylonium_tpu_torch.ops import anchor_extend


def _text_on(text: np.ndarray, device: torch.device) -> torch.Tensor:
    # a copy: the index text is a read-only view of its bytes
    return torch.from_numpy(np.array(text, dtype=np.uint8)).to(device)


def hybrid_map_queries(
    ref: ESAIndex,
    threshold: int,
    queries: list[np.ndarray],
    device: torch.device,
    chunk: int = DEFAULT_CHUNK,
    progress=None,
    stats: dict | None = None,
) -> list[list[Homology]]:
    """Map every query; diagonal bitmaps batched across queries.

    Returns raw (unsorted, unfiltered) homology lists per query, like
    core/anchors.anchor_homologies. ``stats``, when given, gains
    ``rounds`` (device calls), ``device_s`` (bitmap calls and their copy
    to the host) and ``host_s`` (the state machines, unpacking included).
    """
    if stats is not None:
        for key in ("rounds", "device_s", "host_s"):
            stats.setdefault(key, 0)
    # the JAX package addresses both texts with int32 offsets and refuses
    # inputs beyond that; the port computes positions in 64 bits but
    # keeps the same bounds, texts and query groups
    max_i32 = (1 << 31) - 1 - chunk - _TILE
    if ref.size > max_i32:
        raise ConfigError(
            "hybrid map backend addresses the index with int32 offsets; "
            f"reference of {ref.size} bases needs the native backend"
        )
    if queries and max(len(q) for q in queries) > max_i32:
        raise ConfigError(
            "hybrid map backend addresses queries with int32 offsets; "
            f"a {max(len(q) for q in queries)}-base query needs the "
            "native backend"
        )
    if sum(len(q) for q in queries) > max_i32:
        out: list[list[Homology]] = []
        group: list[np.ndarray] = []
        group_bases = 0
        for q in queries + [None]:
            if q is None or (group and group_bases + len(q) > max_i32):
                base = len(out)
                out.extend(hybrid_map_queries(
                    ref, threshold, group, device, chunk,
                    progress=None if progress is None
                    else lambda d, b=base: progress(b + d),
                    stats=stats,
                ))
                group, group_bases = [], 0
            if q is not None:
                group.append(q)
                group_bases += len(q)
        return out

    s_dev = _text_on(ref.S, device)
    lengths = np.array([len(q) for q in queries], np.int64)
    bases = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    q_dev = _text_on(
        np.concatenate(queries) if queries else np.zeros(0, np.uint8), device
    )

    machines = [_Machine(ref, q, threshold) for q in queries]
    nq = len(machines)
    active = list(range(nq))
    host_s = device_s = 0.0
    rounds = 0
    t0 = time.perf_counter()
    while active:
        blocked = [k for k in active if not machines[k].run()]
        if progress is not None:
            progress(nq - len(blocked))
        if not blocked:
            break
        diag = np.array([machines[k].request[0] for k in blocked], np.int64)
        start = np.array([machines[k].request[1] for k in blocked], np.int64)
        # a row is `chunk` long, or ends at position qlen when that comes
        # first: a request starts at or before qlen, and qlen is past the
        # query's limit, so the row's last bit is the mismatch that stops
        # every run there. The machine never reads past it, so the
        # homologies are those of full rows, and a short query's rows do
        # not drag hundreds of thousands of past-the-end positions along.
        need = np.clip(lengths[blocked] - start + 1, 1, chunk)
        length = int(need.max())
        t1 = time.perf_counter()
        host_s += t1 - t0
        words = anchor_extend.diagonal_neq(
            s_dev, q_dev, diag + start, bases[blocked] + start,
            ref.size, bases[blocked] + lengths[blocked], length,
        ).cpu()
        t0 = time.perf_counter()
        device_s += t0 - t1
        rounds += 1
        rows = anchor_extend.unpack_bits(words, length)
        for slot, k in enumerate(blocked):
            machines[k].feed(rows[slot, : need[slot]])
        active = blocked
    host_s += time.perf_counter() - t0
    if stats is not None:
        stats["rounds"] += rounds
        stats["device_s"] += device_s
        stats["host_s"] += host_s
    return [m.hv for m in machines]
