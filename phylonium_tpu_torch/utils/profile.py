"""Spans on the host's wall clock, phase timings and the ``--profile`` trace.

The port's one span recorder. A span is a named stretch of work with a
``start`` and an ``end`` in seconds since the epoch (``time.time_ns``, the
host's ``CLOCK_REALTIME``, which the CLI and the device server share, so
that both processes' spans and a profiler's clock anchors lie on one
axis), an ``id``, the ``parent`` id (the span that caused it), the
``process`` that recorded it (``cli`` or ``devd``), the ``thread``'s name
and a small dict of ``attrs`` (counts, bytes, a group's ``lo``).

Spans are kept in memory, one :class:`Recorder` a run, and written only
with the run report (``LAST_RUN_INFO["spans"]``). A CLI run records where
something reads them: a run report (``PHYLONIUM_TPU_RUN_REPORT``),
``--profile``, ``-v -v`` or ``PHYLONIUM_TPU_DEBUG`` (decided once a run,
by ``run``); otherwise ``span()`` returns one shared no-op and
nothing is recorded. The device server records a run's spans only for
requests that carry the client's span id, and hands them back in its
``finish`` reply (serve/daemon.py).

A span opened where no parent is named takes the innermost span open on
its thread, else the run's root. Work handed to another thread through a
queue (the feeder's groups, the server's builds) names the span that
queued it as its parent and carries ``attrs["queued"]``: it starts after
its parent started, but may end after it. Every other span lies inside its
parent.

``timed()`` is a span that always measures, for the durations the program
itself uses (each phase's ``timings`` entry, the device server's count,
the ``PHYLONIUM_TPU_DEBUG`` lines); it is recorded like ``span()`` where a
recorder is on. Where torch is loaded, a recorded span also opens a
``torch.profiler.record_function`` range of its name, so that a
``--profile`` trace and the device server's profiler trace show the
spans beside the kernels. A process that has not imported torch opens no
range: a span never imports torch.

``phase(timings, name)`` times a phase of the pipeline (``index``,
``map``, ``pileup``, ``compare``, ``map+pileup+feed``, ``map+feed``) into
``timings[name]``, the duration of its span.

``--profile=DIR`` (the one place here that imports torch) runs
``torch.profiler`` around the pipeline (CPU activity, plus CUDA when the
run's device is a card) and writes one Chrome trace into DIR, with two
clock anchors: ranges named ``phylonium_tpu_torch.clock.<i>`` opened at a
known ``time.time()``, whose wall times the trace's metadata holds under
``phylonium_tpu_torch.clock``, so that the trace's timestamps map onto the
spans' clock. A trace that cannot be started or written is a soft error:
the run warns, still prints its matrix and exits 1, as the JAX CLI keeps
the matrix when its trace fails.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import threading
import time

from phylonium_tpu_torch.config import PROG
from phylonium_tpu_torch.utils.platform import device_type, loaded

# the span the streamed feeder's worker thread records around each group
# it preps and builds (or sends to the device server)
GROUP_RANGE = "feed.group"

# the spans that tile a ``process`` span where its phases leave gaps
PROCESS_REST = "process.rest"

# the clock anchors of a --profile trace, and their key in its metadata
CLOCK_RANGE = "phylonium_tpu_torch.clock"

_ids = itertools.count(1)
_local = threading.local()  # .stack: the thread's open spans; .recorder
_OFF = object()  # a thread that records nothing, whatever the process does
_recorder = None  # the CLI run's recorder, while a run records


class Recorder:
    """One run's closed spans, each a dict, in memory.

    ``process`` names the recording process in every span (``cli`` or
    ``devd``); past ``cap`` spans the rest are counted in ``dropped``.
    ``pass_no`` (the CLI's second pass of ``-2``) goes into the ``attrs``
    of every span opened while it is set."""

    def __init__(self, process: str, cap: int | None = None):
        self.process = process
        self.prefix = process[0]
        self.cap = cap
        self.spans: list[dict] = []
        self.dropped = 0
        self.pass_no: int | None = None
        self.root: Span | None = None

    def add(self, record: dict) -> None:
        if self.cap is not None and len(self.spans) >= self.cap:
            self.dropped += 1
            return
        self.spans.append(record)

    def adopt(self, records) -> None:
        """Spans another process recorded for this run (the device server's,
        from its ``finish`` reply)."""
        for record in records or ():
            if self.pass_no is not None:
                record.setdefault("attrs", {})["pass"] = self.pass_no
            self.add(record)

    def take(self) -> tuple[list[dict], int]:
        """(the spans so far, how many were dropped), both then cleared."""
        spans, dropped = self.spans, self.dropped
        self.spans, self.dropped = [], 0
        return spans, dropped

    def report(self) -> list[dict]:
        """Every span of the run for its report: the closed ones, and the
        root as it stands, ended now."""
        spans = list(self.spans)
        if self.root is not None and self.root.end is None:
            spans.append(self.root.record(end=time.time_ns()))
        return spans


class Span:
    """One span; a context manager. ``seconds`` is its duration once closed."""

    __slots__ = ("name", "start", "end", "id", "parent", "attrs", "thread",
                 "_rec", "_range", "_rest", "_kids")

    def __init__(self, name: str, parent, attrs, rec, start=None, rest=None):
        self.name = name
        self.start = start
        self.end = None
        self.attrs = dict(attrs) if attrs else {}
        self._rec = rec
        self._range = None
        self._rest = rest
        self._kids: list[tuple[int, int]] = []
        self.thread = None
        if rec is None:
            self.id = self.parent = None
            return
        self.id = f"{rec.prefix}{next(_ids)}"
        if parent is None:
            stack = getattr(_local, "stack", None)
            if stack:
                parent = stack[-1].id
            elif rec.root is not None:
                parent = rec.root.id
        self.parent = parent
        if rec.pass_no is not None:
            self.attrs["pass"] = rec.pass_no

    def __enter__(self) -> "Span":
        rec = self._rec
        if rec is not None:
            self.thread = threading.current_thread().name
            stack = getattr(_local, "stack", None)
            if stack is None:
                stack = _local.stack = []
            stack.append(self)
            torch = loaded("torch")
            if torch is not None:
                self._range = torch.profiler.record_function(self.name)
                self._range.__enter__()
        if self.start is None:
            self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.time_ns()
        _local.last = self
        rec = self._rec
        if rec is not None:
            if self._range is not None:
                self._range.__exit__(*exc)
                self._range = None
            stack = _local.stack
            if stack and stack[-1] is self:
                stack.pop()
            if stack and stack[-1]._rest:
                stack[-1]._kids.append((self.start, self.end))
            if self._rest:
                self._tile(rec)
            rec.add(self.record())
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def elapsed(self) -> float:
        """Seconds since the span opened."""
        return (time.time_ns() - self.start) / 1e9

    def note(self, key: str, value) -> None:
        self.attrs[key] = value

    def record(self, end: int | None = None) -> dict:
        return {"name": self.name, "start": self.start / 1e9,
                "end": (self.end if end is None else end) / 1e9, "id": self.id,
                "parent": self.parent, "process": self._rec.process,
                "thread": self.thread, "attrs": self.attrs}

    def _tile(self, rec: Recorder) -> None:
        """Record a ``_rest`` span over each stretch of this span that no
        child on its own thread covers, so that they tile it."""
        at, gaps = self.start, []
        for start, end in sorted(self._kids):
            if start > at:
                gaps.append((at, start))
            at = max(at, end)
        if self.end > at:
            gaps.append((at, self.end))
        for start, end in gaps:
            rest = Span(self._rest, self.id, None, rec, start=start)
            rest.thread, rest.end = self.thread, end
            rec.add(rest.record())


class _Noop:
    """The span of a process that records nothing: one shared object that
    does nothing and allocates nothing."""

    __slots__ = ()
    id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, key, value) -> None:
        pass


_NOOP = _Noop()


def recorder() -> Recorder | None:
    """This thread's recorder, or None where it records nothing."""
    rec = getattr(_local, "recorder", None)
    if rec is None:
        return _recorder
    return None if rec is _OFF else rec


def span(name: str, parent=None, attrs=None, start=None, rest=None):
    """A span named ``name`` where this thread records, else the shared
    no-op. ``parent``: the causing span's id where it is not the thread's
    open span; ``start``: an earlier ``time.time_ns()``; ``rest``: the
    name of the spans that tile what its children on its thread leave."""
    rec = recorder()
    if rec is None:
        return _NOOP
    return Span(name, parent, attrs, rec, start, rest)


def timed(name: str, parent=None, attrs=None) -> Span:
    """A span that measures its duration whether or not this thread
    records."""
    return Span(name, parent, attrs, recorder())


def current_id():
    """The id of the innermost span open on this thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1].id if stack else None


def last_closed() -> Span | None:
    """The span this thread closed last (a ``span`` that recorded, or a
    ``timed``): the request span of a ``DevdClient.request`` just made."""
    return getattr(_local, "last", None)


@contextlib.contextmanager
def recording(rec: Recorder | None):
    """Record this thread's spans into ``rec`` (None: record nothing),
    whatever the process records; the device server's threads."""
    was = getattr(_local, "recorder", None)
    _local.recorder = _OFF if rec is None else rec
    try:
        yield rec
    finally:
        _local.recorder = was


@contextlib.contextmanager
def run(cfg, began_ns: int):
    """A CLI run: where something reads its spans (a run report,
    ``--profile``, ``-v -v`` or ``PHYLONIUM_TPU_DEBUG``), its recorder and
    its root span ``run`` (from ``began_ns``, the start of ``cli.main``),
    for the run's every thread; else nothing is recorded."""
    global _recorder
    if not (os.environ.get("PHYLONIUM_TPU_RUN_REPORT") or cfg.profile_dir
            or cfg.verbose >= 2 or os.environ.get("PHYLONIUM_TPU_DEBUG")):
        yield None
        return
    rec = Recorder("cli")
    rec.root = root = Span("run", None, None, rec, start=began_ns)
    _recorder = rec
    try:
        with root:
            yield rec
    finally:
        _recorder = None


@contextlib.contextmanager
def second_pass():
    """Mark the spans opened in the body with ``attrs["pass"] = 2`` (the
    second pass of ``-2``), and the server's spans adopted meanwhile."""
    rec = recorder()
    if rec is None:
        yield
        return
    rec.pass_no = 2
    try:
        yield
    finally:
        rec.pass_no = None


@contextlib.contextmanager
def phase(timings: dict, name: str):
    """Time the body, which gets the span, into ``timings[name]``
    (seconds), the duration of its span."""
    with timed(name) as s:
        yield s
    timings[name] = s.seconds


@contextlib.contextmanager
def profiled(cfg):
    """Run the body under ``torch.profiler`` when ``cfg.profile_dir`` is
    set, and write its Chrome trace there (the directory is created), with
    a clock anchor at each end."""
    if not cfg.profile_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device_type(cfg.device) == "cuda" and torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    anchors: list[float] = []

    def anchor() -> None:
        with torch.profiler.record_function(f"{CLOCK_RANGE}.{len(anchors)}"):
            anchors.append(time.time())

    try:
        os.makedirs(cfg.profile_dir, exist_ok=True)
        # every thread: the streamed feeder's worker preps and launches
        # the pileup builds
        prof = torch.profiler.profile(
            activities=activities,
            experimental_config=torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True
            ),
        )
        prof.start()
        anchor()
    except Exception as e:  # noqa: BLE001 — a lost trace never costs the matrix
        cfg.soft_error(f"could not start the profiler: {e}")
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                anchor()
                prof.add_metadata_json(CLOCK_RANGE, json.dumps(anchors))
                prof.stop()
                stamp = time.strftime("%Y%m%d-%H%M%S")
                path = os.path.join(
                    cfg.profile_dir, f"{PROG}-{stamp}-{os.getpid()}.trace.json"
                )
                prof.export_chrome_trace(path)
                if cfg.verbose:
                    print(f"profiler trace: {path}", file=sys.stderr)
            except Exception as e:  # noqa: BLE001
                cfg.soft_error(f"could not write the profiler trace: {e}")
