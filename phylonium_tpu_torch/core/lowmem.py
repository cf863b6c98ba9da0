"""Low-memory pipeline: map and count without the [N, L] matrix.

The port of the JAX package's ``map_count_lowmem``
(phylonium_tpu/core/lowmem.py). When the panel is large
(``should_lowmem``, imported: panel bytes above
``PHYLONIUM_TPU_LOWMEM_BYTES``, default 2 GB, or
``PHYLONIUM_TPU_LOWMEM=force``), the CLI keeps every sequence 2-bit
compacted, and this pipeline maps in memory-capped groups
(``group_rows_for``, imported), unpacking one group at a time and keeping
each genome's homologies as the native mapper's raw [H, 5] int64 rows.

- ``--count-backend host`` counts with the JAX package's windowed host
  counter (``pair_counts_windowed``), which builds column windows of the
  pileup on the fly;
- every other count backend feeds each group to the streamed feeder
  (core/stream.py), which builds the packed rows on ``cfg.device``; the
  host never holds the pileup.

The JAX pipeline raced the two and cancelled the device leg when its
queue passed two groups. Here the feeder's queue is bounded at two
groups (``stream.MAX_BACKLOG``) and ``feed()`` blocks while it is full:
memory stays bounded and the device still carries the count.
"""

from __future__ import annotations

import time

import numpy as np

from phylonium_tpu.core.lowmem import group_rows_for, pair_counts_windowed
from phylonium_tpu.core.map_native import map_batch_native
from phylonium_tpu.data.sequence import Sequence
from phylonium_tpu.utils.progress import ProgressBar
from phylonium_tpu_torch.config import TorchRunConfig
from phylonium_tpu_torch.core.stream import DeviceRowFeeder
from phylonium_tpu_torch.utils.platform import carrier, resolve_device


def map_count_lowmem(
    ref, threshold: int, queries: list[Sequence], cfg: TorchRunConfig
) -> tuple[np.ndarray, np.ndarray, dict, dict]:
    """Map in capped groups, then count on the device or the host.

    Returns (subs, homs, timings, info): ``timings`` holds ``map+feed``
    and ``compare``; ``info`` the carrier, the group size, the number of
    homologies and, on the device, the feeder's groups.
    """
    n = len(queries)
    ref_len = len(ref.subject)
    avg_len = max(1, sum(len(q) for q in queries) // max(n, 1))
    group = group_rows_for(n, avg_len)
    feeder = None
    if cfg.count_backend != "host":
        device = resolve_device(cfg.device)
        feeder = DeviceRowFeeder(n, ref_len, device)

    timings: dict = {}
    harrs: list = [None] * n
    bar = ProgressBar(f"Mapping {n} sequences", n, enabled=cfg.progress_enabled)
    t0 = time.perf_counter()
    try:
        for lo in range(0, n, group):
            hi = min(lo + group, n)
            batch = [queries[j].as_array() for j in range(lo, hi)]
            out = map_batch_native(ref._native, batch, threshold, bar, lo, raw=True)
            harrs[lo:hi] = out
            if feeder is not None:
                feeder.feed(batch, out)
            bar.update(hi)
            del batch  # the feeder's queue holds the group until it is built
    except BaseException:
        if feeder is not None:
            feeder.cancel()
        raise
    bar.finish()
    timings["map+feed"] = time.perf_counter() - t0

    num_comparisons = (n * n - n) // 2
    cbar = ProgressBar(
        "Comparing the sequences", num_comparisons,
        enabled=cfg.progress_enabled,
    )
    t0 = time.perf_counter()
    info = {
        "group_rows": group,
        "homologies": int(sum(len(h) for h in harrs)),
    }
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
    timings["compare"] = time.perf_counter() - t0
    cbar.finish()
    return subs, homs, timings, info
