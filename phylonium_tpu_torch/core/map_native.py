"""Shared native-mapper progress plumbing.

The C++/OpenMP batch mapper (`native/__init__.py` ``map_queries``) runs
an entire batch inside one foreign call, so live per-query progress (the
reference updates its bar in-loop, src/process.cxx:445-456) needs a poll
thread relaying the mapper's atomic counter to the bar while the call
runs.  Both consumers — the one-shot mapping phase
(core/pipeline.map_queries) and the streamed map→feed loop
(core/stream.map_pileup_streamed) — share this helper instead of each
owning a copy of the thread dance.

A copy of the JAX package's ``phylonium_tpu/core/map_native.py``: the port carries
its own host layer and imports nothing of that package.
"""

from __future__ import annotations

import threading

import numpy as np


def map_batch_native(
    native, batch, threshold: int, bar, base: int, raw: bool = False
):
    """Map ``batch`` with the native mapper, relaying its atomic
    per-query counter to ``bar`` (offset by ``base`` completed queries)
    for the duration of the call.  Returns the mapper's output list
    (``raw=True``: per-genome [H, 5] int64 arrays for the low-memory
    pipeline instead of Homology objects).
    """
    counter = np.zeros(1, dtype=np.int64)
    stop = threading.Event()

    def relay():
        while not stop.wait(0.1):
            bar.update(base + int(counter[0]))

    poller = None
    if bar.enabled:
        poller = threading.Thread(
            target=relay, daemon=True, name="map-progress"
        )
        poller.start()
    try:
        return native.map_queries(
            batch, threshold, progress_out=counter, raw=raw
        )
    finally:
        stop.set()
        if poller is not None:
            poller.join()
