"""Low-memory pipeline: map and count without the [N, L] matrix.

The port of the JAX package's ``map_count_lowmem``
(phylonium_tpu/core/lowmem.py). When the panel is large
(``should_lowmem``: panel bytes above ``PHYLONIUM_TPU_LOWMEM_BYTES``,
default 2 GB, or ``PHYLONIUM_TPU_LOWMEM=force``), the CLI keeps every
sequence 2-bit compacted, and this pipeline maps in memory-capped groups
(``group_rows_for``), unpacking one group at a time and keeping each
genome's homologies as the native mapper's raw [H, 5] int64 rows.

- ``--count-backend host`` counts with the windowed host counter
  (``pair_counts_windowed``), which builds column windows of the pileup
  on the fly;
- every other count backend feeds each group to the streamed feeder
  (core/stream.py), which builds the packed rows on ``cfg.device``; the
  host never holds the pileup.

Spans (utils/profile.py): ``lowmem`` over the loop (``attrs``: the
mapping ``groups``, ``group_rows``, ``compact_mb``, the compacted panel
the CLI holds, and ``unpacked_peak_mb``, the most unpacked bytes alive at
once: the group being mapped, the groups in the feeder's queue and the
one its worker holds; the native mapper reads the group where it lies),
and in it a ``lowmem.group`` a group (``lo``, ``rows``, ``bases``)
holding ``lowmem.unpack``, ``lowmem.map`` (``staged_mb``: what the
native mapper had to copy, 0 where every genome is a C-contiguous
``uint8`` array) and ``lowmem.feed``, the wait to hand the group to the
feeder.

Through the device server (``serve.client.devd_enabled``: by default on
a card in a single process) the feeder sends each group to the server,
which builds and counts the panel there, and this process imports no
torch and makes no CUDA context; ``info`` then carries the server's
count time, ``devd_count_s`` (JAX :263-304).

The JAX pipeline raced the two and cancelled the device leg when its
queue passed two groups. Here the feeder's queue is bounded at two
groups (``stream.MAX_BACKLOG``) and ``feed()`` blocks while it is full:
memory stays bounded and the device still carries the count.

``lowmem_budget``, ``should_lowmem``, ``group_rows_for``,
``pair_counts_windowed`` and the window helpers are a copy of the JAX
package's (phylonium_tpu/core/lowmem.py), which the port carries instead
of importing. Like the JAX package's, ``should_lowmem`` keeps a world of
several ranks on the serial mesh route (parallel/).
"""

from __future__ import annotations

import os
import threading
import weakref

import numpy as np

from phylonium_tpu_torch.config import RunConfig, TorchRunConfig
from phylonium_tpu_torch.core.map_native import map_batch_native
from phylonium_tpu_torch.core.pileup import INVALID, N_BASE
from phylonium_tpu_torch.core.stream import DeviceRowFeeder, effective_group_rows
from phylonium_tpu_torch.data.sequence import Sequence
from phylonium_tpu_torch.native import pair_counts_range
from phylonium_tpu_torch.parallel.multihost import world
from phylonium_tpu_torch.serve.client import devd_enabled
from phylonium_tpu_torch.utils import profile
from phylonium_tpu_torch.utils.platform import carrier, check_device, resolve_device
from phylonium_tpu_torch.utils.profile import phase
from phylonium_tpu_torch.utils.progress import ProgressBar

# default panel-bytes threshold: above this the full byte pipeline
# would not fit this host class comfortably
_DEFAULT_BYTES = 2 << 30

# host column-window width cap (bytes of one [N, W] chunk)
_WINDOW_BYTES = 256 << 20


def lowmem_budget() -> int:
    raw = os.environ.get("PHYLONIUM_TPU_LOWMEM_BYTES")
    if raw in (None, "", "force", "0"):
        return _DEFAULT_BYTES
    try:
        return int(float(raw))
    except ValueError:
        return _DEFAULT_BYTES


def should_lowmem(n: int, total_bp: int, cfg: RunConfig, ref=None) -> bool:
    """Engage the bounded-memory pipeline?  Deterministic in the run's
    inputs (no clock, no link state) so -2 second passes and re-runs
    decide identically."""
    env = os.environ.get("PHYLONIUM_TPU_LOWMEM", "")
    if env == "0":
        return False
    if cfg.count_backend not in ("auto", "host") or cfg.mesh:
        return False
    if cfg.complete_deletion or cfg.print_positions or cfg.checkpoint_dir:
        return False
    if cfg.map_backend not in ("auto", "native"):
        return False
    if ref is not None and ref.backend_name != "native":
        return False
    if world()[0] > 1:
        return False
    if env == "force":
        return True
    return total_bp > lowmem_budget()


def group_rows_for(n: int, avg_len: int) -> int:
    """Mapping-group size capped so one group's unpacked bytes stay
    within ~1/16 of the budget (the feeder may hold two more groups in
    its bounded queue and a third in its worker)."""
    cap = max(4, int(lowmem_budget() // 16) // max(avg_len, 1))
    return max(4, min(effective_group_rows(n), cap))


def _window_slices(hv: np.ndarray):
    """Precompute per-genome sorted interval columns for windowing."""
    if not len(hv):
        z = np.zeros(0, np.int64)
        return z, z, z, z, z
    d, irp, iq, ln = hv[:, 0], hv[:, 2], hv[:, 3], hv[:, 4]
    keep = ln > 0
    d, irp, iq, ln = d[keep], irp[keep], iq[keep], ln[keep]
    order = np.argsort(irp, kind="stable")
    # disjoint intervals sorted by start => ends sorted too
    return (
        irp[order], (irp + ln)[order], iq[order], ln[order], d[order]
    )


def build_window(
    queries: list[Sequence],
    pre: list,
    c0: int,
    c1: int,
    out: np.ndarray,
) -> None:
    """Fill ``out`` ([N, c1-c0] uint8) with pileup states for reference
    columns [c0, c1) — bit-identical to
    ``build_pileup(...)[:, c0:c1]`` (core/pileup.build_pileup_row
    semantics, clipped to the window)."""
    out[:] = INVALID
    for g, (starts, ends, iqs, lens, dirs) in enumerate(pre):
        if not len(starts):
            continue
        i0 = int(np.searchsorted(ends, c0, side="right"))
        i1 = int(np.searchsorted(starts, c1, side="left"))
        seq = queries[g]
        for k in range(i0, i1):
            s, e = int(starts[k]), int(ends[k])
            cs, ce = max(s, c0), min(e, c1)
            if cs >= ce:
                continue
            iq = int(iqs[k])
            if dirs[k]:  # REVERSE: column c reads query iq + (e-1-c)
                codes = seq.codes_slice(iq + e - ce, iq + e - cs)
                out[g, cs - c0 : ce - c0] = codes[::-1] + N_BASE
            else:
                codes = seq.codes_slice(iq + cs - s, iq + ce - s)
                out[g, cs - c0 : ce - c0] = codes


def pair_counts_windowed(
    queries: list[Sequence],
    harrs: list[np.ndarray],
    ref_len: int,
    poll=None,
    progress=None,
) -> tuple[np.ndarray, np.ndarray] | None:
    """All-pairs (substitutions, homologs) without ever materializing
    the [N, ref_len] matrix: build one column window at a time from the
    compacted queries + interval arrays and run the native counting
    kernel on it.  ``poll`` aborts between windows (returns None)."""
    n = len(queries)
    subs = np.zeros((n, n), dtype=np.int64)
    homs = np.zeros((n, n), dtype=np.int64)
    window = max(1 << 16, (_WINDOW_BYTES // max(n, 1)) & ~4095)
    pre = [_window_slices(hv) for hv in harrs]
    chunk = np.empty((n, min(window, max(ref_len, 1))), dtype=np.uint8)
    for c0 in range(0, max(ref_len, 1), window):
        if poll is not None and poll():
            return None
        c1 = min(c0 + window, ref_len)
        view = chunk[:, : c1 - c0]
        build_window(queries, pre, c0, c1, view)
        pair_counts_range(
            np.ascontiguousarray(view), 0, c1 - c0, subs, homs
        )
        if progress is not None:
            progress(c1 / max(ref_len, 1))
    return subs, homs


class _Unpacked:
    """Unpacked bytes alive: added as the loop unpacks a compacted genome,
    taken off when its last holder (the loop, the feeder's queue or its
    worker) drops it; ``peak``, the most at once."""

    def __init__(self):
        self.live = self.peak = 0
        self._lock = threading.Lock()

    def add(self, arr: np.ndarray) -> None:
        owner = arr.base if isinstance(arr.base, np.ndarray) else arr
        with self._lock:
            self.live += owner.nbytes
            self.peak = max(self.peak, self.live)
        weakref.finalize(owner, self._drop, owner.nbytes).atexit = False

    def _drop(self, nbytes: int) -> None:
        with self._lock:
            self.live -= nbytes


def map_count_lowmem(
    ref, threshold: int, queries: list[Sequence], cfg: TorchRunConfig
) -> tuple[np.ndarray, np.ndarray, dict, dict]:
    """Map in capped groups, then count on the device or the host.

    Returns (subs, homs, timings, info): ``timings`` holds ``map+feed``
    and ``compare``; ``info`` the carrier, the group size, the number of
    homologies and, on the device, the feeder and its groups. The CLI's
    early shipper (``cfg._query_shipper``), which took the compacted
    genomes at read time, sets the group size and feeds the feeder.
    """
    n = len(queries)
    ref_len = len(ref.subject)
    avg_len = max(1, sum(len(q) for q in queries) // max(n, 1))
    shipper = cfg._query_shipper
    # the early shipper's group boundaries win (its groups were sized
    # from file sizes at read time; matching them keeps every take() a
    # boundary hit)
    group = shipper.group_rows if shipper is not None else group_rows_for(n, avg_len)
    feeder = None
    if cfg.count_backend != "host":
        devd = devd_enabled(cfg.device)
        device = check_device(cfg.device) if devd else resolve_device(cfg.device)
        feeder = DeviceRowFeeder(n, ref_len, device, shipper=shipper, devd=devd)
    elif shipper is not None:
        shipper.cancel()  # the windowed host count builds nothing

    timings: dict = {}
    harrs: list = [None] * n
    unpacked = _Unpacked()
    bar = ProgressBar(f"Mapping {n} sequences", n, enabled=cfg.progress_enabled)
    with phase(timings, "map+feed"), profile.span("lowmem", attrs={
        "groups": -(-n // group), "group_rows": group,
        "compact_mb": sum(q.nbytes for q in queries) / 1e6,
    }) as loop:
        try:
            for lo in range(0, n, group):
                hi = min(lo + group, n)
                with profile.span("lowmem.group", attrs={"lo": lo, "rows": hi - lo}) as g:
                    with profile.span("lowmem.unpack"):
                        batch = [queries[j].as_array() for j in range(lo, hi)]
                    for j in range(lo, hi):
                        if queries[j].compacted:  # else a view of the genome's bytes
                            unpacked.add(batch[j - lo])
                    g.note("bases", sum(a.nbytes for a in batch))
                    with profile.span("lowmem.map") as m:
                        staged = ref._native.staged_bytes
                        out = map_batch_native(ref._native, batch, threshold, bar, lo,
                                               raw=True)
                        m.note("staged_mb", (ref._native.staged_bytes - staged) / 1e6)
                    harrs[lo:hi] = out
                    if feeder is not None:
                        # blocks while MAX_BACKLOG groups wait for the worker
                        with profile.span("lowmem.feed"):
                            feeder.feed(batch, out)
                    bar.update(hi)
                    del batch  # the feeder's queue holds the group until it is built
        except BaseException:
            if feeder is not None:
                feeder.cancel()
            raise
        loop.note("unpacked_peak_mb", unpacked.peak / 1e6)
        bar.finish()

    num_comparisons = (n * n - n) // 2
    cbar = ProgressBar(
        "Comparing the sequences", num_comparisons,
        enabled=cfg.progress_enabled,
    )
    info = {
        "group_rows": group,
        "homologies": int(sum(len(h) for h in harrs)),
    }
    with phase(timings, "compare"):
        if feeder is None:
            subs, homs = pair_counts_windowed(
                queries, harrs, ref_len,
                progress=lambda f: cbar.update(int(f * num_comparisons)),
            )
            info["carrier"] = "host"
        else:
            subs, homs = feeder.finish()
            info["carrier"] = carrier(feeder.device)
            info["groups"] = feeder.groups
            info["feeder"] = feeder
            if feeder.devd_count_s is not None:
                info["devd_count_s"] = feeder.devd_count_s
    cbar.finish()
    return subs, homs, timings, info
