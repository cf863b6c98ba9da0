"""Hybrid mapping: the host chain state machine + diagonal bitmaps on a device.

The port of the JAX package's ``hybrid_map_queries``
(phylonium_tpu/core/hybrid_map.py:243-388). The chain state machine,
``_Machine``, with ``DEFAULT_CHUNK`` and ``_TILE``, is a copy of that
module's host code (:37-241), which the port carries instead of
importing (exact oracle semantics, src/process.cxx:245-295): it walks
each query's anchor chain and blocks whenever it needs the mismatch
positions of one diagonal, ``request = (d, start)``. This module runs
every machine until it blocks, answers all blocked machines with one
``diagonal_neq`` call on ``device`` (the CUDA kernel on a card, the plain
PyTorch version on the CPU), unpacks each row on the host and feeds it
back, in lockstep rounds until every machine has finished.

The reference text and the concatenated queries go to the device once per
group of queries. With ``PHYLONIUM_TPU_SHARDED_EXTEND=1`` and more than one
local device of ``device``'s type, the reference text goes as shards, one
a device, and each round's bitmaps come from
``ops.anchor_extend_sharded.diagonal_neq_sharded`` (X5), equal bit for
bit. Homology lists are identical to the JAX package's hybrid mapper, to
its Python oracle (core/anchors.py) and to its native mapper.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from phylonium_tpu_torch.config import ConfigError
from phylonium_tpu_torch.core.homology import Homology
from phylonium_tpu_torch.index.esa import ESAIndex
from phylonium_tpu_torch.ops import anchor_extend, anchor_extend_sharded

# query-positions fetched per (query, diagonal) device request
DEFAULT_CHUNK = 1 << 19
_TILE = 2048


class _NeedBitmap(Exception):
    """Raised inside a machine when it blocks on diagonal data."""


class _Machine:
    """Chain state machine for one query (exact oracle semantics)."""

    __slots__ = (
        "ref", "q", "qlen", "threshold", "border", "SA", "hv",
        "prev_q", "prev_s", "prev_len", "merged",
        "cursor", "open_seg", "diag", "mm", "fs", "fe",
        "request", "done",
    )

    def __init__(self, ref: ESAIndex, q: np.ndarray, threshold: int):
        self.ref = ref
        self.q = q
        self.qlen = len(q)
        self.threshold = threshold
        self.border = ref.size // 2
        self.SA = ref.SA
        self.hv: list[Homology] = []
        self.prev_q = 0
        self.prev_s = 0
        self.prev_len = 0
        self.merged = False
        self.cursor = 0
        self.open_seg = Homology.at(0, 0)
        # cached mismatch positions for one diagonal, covering [fs, fe)
        self.diag: int | None = None
        self.mm: np.ndarray | None = None
        self.fs = 0
        self.fe = 0
        self.request: tuple[int, int] | None = None
        self.done = False

    # -- diagonal bitmap cache ------------------------------------------

    def _next_mm(self, d: int, p: int) -> int:
        """First mismatch position >= p on diagonal d (query coords)."""
        if self.diag != d or p < self.fs or p >= self.fe:
            self.request = (d, p)
            raise _NeedBitmap
        i = int(np.searchsorted(self.mm, p))
        if i == len(self.mm):
            # run extends past coverage; extend it (fe <= qlen here:
            # covered fetches always mark position qlen as a mismatch)
            self.request = (d, self.fe)
            raise _NeedBitmap
        return int(self.mm[i])

    def feed(self, row: np.ndarray) -> None:
        d, start = self.request
        mm = (start + np.flatnonzero(row)).astype(np.int64)
        if d == self.diag and start == self.fe:
            self.mm = np.concatenate([self.mm, mm])
        else:
            self.diag = d
            self.mm = mm
            self.fs = start
        self.fe = start + len(row)
        self.request = None

    # -- chain events (oracle semantics, src/process.cxx:245-295) -------

    def _accept_seed(self, seed_s: int, seed_len: int) -> None:
        end_S = self.prev_s + self.prev_len
        end_Q = self.prev_q + self.prev_len
        if (
            seed_s > end_S
            and self.cursor - end_Q == seed_s - end_S
            and (seed_s < self.border) == (self.prev_s < self.border)
        ):
            self.open_seg.extend(self.cursor - end_Q + seed_len)
            self.merged = True
        else:
            if self.merged or self.prev_len // 2 >= self.threshold:
                self.open_seg.reverse_eh(self.border)
                self.hv.append(self.open_seg)
            self.open_seg = Homology.at(
                seed_s, self.cursor, seed_len
            )
            self.merged = False
        self.prev_q = self.cursor
        self.prev_s = seed_s
        self.prev_len = seed_len

    def _probe_diagonal(self):
        """Lucky anchor via the diagonal bitmap; None = failed/inapplicable."""
        advance = self.cursor - self.prev_q
        gap = advance - self.prev_len
        diag_s = self.prev_s + advance
        if diag_s >= self.ref.size or gap > self.threshold:
            return None
        d = self.prev_s - self.prev_q
        nm = self._next_mm(d, self.cursor)
        seed_len = nm - self.cursor
        if seed_len >= self.threshold:
            return diag_s, seed_len
        return None

    def _consume_runs(self) -> None:
        """Batch-apply consecutive lucky successes along the diagonal.

        After any success, the next probe is at ``last end + 1`` with
        gap 1; its LCP is the gap to the next mismatch.  All such steps
        until the first sub-threshold run are right anchors (except a
        single possible '#'-border crossing, handled as the left anchor
        it is) — applied here without per-step Python/device work.
        """
        thr = self.threshold
        while True:
            p0 = self.cursor
            if p0 >= self.qlen:
                return
            d = self.prev_s - self.prev_q
            if d + p0 >= self.ref.size:
                return
            self._next_mm(d, p0)  # ensure coverage (may raise)
            i0 = int(np.searchsorted(self.mm, p0))
            M = self.mm[i0:]
            if len(M) == 0:
                return  # re-handled via _next_mm on the next diagonal probe
            p_arr = np.empty(len(M), np.int64)
            p_arr[0] = p0
            p_arr[1:] = M[:-1] + 1
            runs = M - p_arr
            ok = (
                (runs >= thr)
                & (d + p_arr < self.ref.size)
                & (p_arr < self.qlen)
            )
            n_ok = int(np.argmin(ok)) if not ok.all() else len(ok)
            if n_ok == 0:
                return
            # '#'-border crossing: s-positions increase, so the side
            # flips at most once; steps before the flip are right
            # anchors, the flip step is a left anchor.
            side0 = self.prev_s < self.border
            sides = (d + p_arr[:n_ok]) < self.border
            flip = (
                int(np.argmax(sides != side0))
                if bool((sides != side0).any())
                else n_ok
            )
            b = min(n_ok, flip) if flip > 0 else 0
            if b > 0:
                # right-anchor batch [0, b)
                end_Q = self.prev_q + self.prev_len
                self.open_seg.extend(int(M[b - 1]) - end_Q)
                self.merged = True
                self.prev_q = int(p_arr[b - 1])
                self.prev_s = d + int(p_arr[b - 1])
                self.prev_len = int(runs[b - 1])
                self.cursor = int(M[b - 1]) + 1
            if b < n_ok:
                # the border-crossing step: left anchor
                self.cursor = int(p_arr[b])
                self._accept_seed(d + int(p_arr[b]), int(runs[b]))
                self.cursor += int(runs[b]) + 1
            elif b < len(ok):
                return  # next step's run is sub-threshold -> slow path
            # else: coverage exhausted; loop refetches via _next_mm

    def _finish(self) -> None:
        if self.prev_len >= self.qlen:
            # identical-sequence special case (src/process.cxx:284-287)
            self.open_seg = Homology.at(self.prev_s, 0, self.qlen)
        if self.merged or self.prev_len // 2 >= self.threshold:
            self.open_seg.reverse_eh(self.border)
            self.hv.append(self.open_seg)

    def run(self) -> bool:
        """Advance until finished (True) or blocked on a bitmap (False)."""
        if self.done:
            return True
        try:
            while self.cursor < self.qlen:
                res = self._probe_diagonal()
                if res is not None:
                    ts, tl = res
                    self._accept_seed(ts, tl)
                    self.cursor += tl + 1
                    self._consume_runs()
                else:
                    l, i, j = self.ref.longest_match(
                        self.q, self.cursor, self.qlen - self.cursor
                    )
                    tl = max(l, 0)
                    if i == j and tl >= self.threshold:
                        self._accept_seed(int(self.SA[i]), tl)
                        self.cursor += tl + 1
                        self._consume_runs()
                    else:
                        self.cursor += tl + 1
            self._finish()
            self.done = True
            return True
        except _NeedBitmap:
            return False



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

    lengths = np.array([len(q) for q in queries], np.int64)
    bases = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    q_dev = _text_on(
        np.concatenate(queries) if queries else np.zeros(0, np.uint8), device
    )
    # PHYLONIUM_TPU_SHARDED_EXTEND=1 splits the index text across every
    # local device of ``device``'s type (ops/anchor_extend_sharded.py, as
    # the JAX package's hybrid mapper does over its devices); the shards
    # and the query copies are placed once for all rounds
    shard_devs = None
    if os.environ.get("PHYLONIUM_TPU_SHARDED_EXTEND") == "1":
        devices = anchor_extend_sharded.shard_devices(device)
        if len(devices) > 1:
            shard_devs = devices
            s_shards = anchor_extend_sharded.place(
                anchor_extend_sharded.shard_text(ref.S, len(devices), _TILE), devices
            )
            q_copies = anchor_extend_sharded.place(q_dev, devices)
    if shard_devs is None:
        s_dev = _text_on(ref.S, device)

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
        if shard_devs is None:
            words = anchor_extend.diagonal_neq(
                s_dev, q_dev, diag + start, bases[blocked] + start,
                ref.size, bases[blocked] + lengths[blocked], length,
            )
        else:
            words = anchor_extend_sharded.diagonal_neq_sharded(
                s_shards, q_copies, diag + start, bases[blocked] + start,
                ref.size, bases[blocked] + lengths[blocked], length,
                shard_devs, _TILE,
            )
        words = words.cpu()
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
