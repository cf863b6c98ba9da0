"""Live stderr progress bars.

Same redraw format as the reference's mapping/compare bars
(src/process.cxx:425-461,535-553): carriage-return redraws of
``{label}: {pct:5.1f}% ({done}/{total})`` ending in ``, done.``.
Updates arrive from worker threads (the native mapper's poll thread,
the compare race) — drawing is locked and monotone.

A copy of the JAX package's ``phylonium_tpu/utils/progress.py``: the port carries
its own host layer and imports nothing of that package.
"""

from __future__ import annotations

import sys
import threading


class ProgressBar:
    def __init__(self, label: str, total: int, enabled: bool = True):
        self.label = label
        self.total = max(int(total), 1)
        self.enabled = enabled
        self._done = -1
        self._lock = threading.Lock()
        self._finished = False
        if enabled:
            self.update(0)

    def update(self, done: int) -> None:
        if not self.enabled:
            return
        done = min(int(done), self.total)
        with self._lock:
            if done <= self._done or self._finished:
                return  # monotone; late stragglers never move it back
            self._done = done
            pct = 100.0 * done / self.total
            prefix = "\r" if done else ""
            sys.stderr.write(
                f"{prefix}{self.label}: {pct:5.1f}% ({done}/{self.total})"
            )
            sys.stderr.flush()

    def finish(self) -> None:
        if not self.enabled:
            return
        self.update(self.total)
        with self._lock:
            if self._finished:
                return
            self._finished = True
            sys.stderr.write(", done.\n")
            sys.stderr.flush()
