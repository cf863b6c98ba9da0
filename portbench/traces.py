"""The yardstick's arithmetic: published peaks, roofline bounds, interval
unions, and the reading of the device server's profiler traces.

Copied from ``chip_smoke.py`` (``bound``, the H100 SXM peaks,
``interval_union``) and rewritten without it. The bounds are worked out
from the problem, never from what the program reports:

- the pair count reads the nibble-packed panel once (``N * W / 2`` bytes)
  and writes two int32 ``[N, N]`` matrices, and does
  ``2 * (planes + 1) * N (N + 1) / 2 * W`` int8 tensor-core operations:
  one multiply-add a cell and column for each of phylonium's match planes
  (states that share a partner set share one, derived from
  the match rule in ``planes``: 8, since forward C shares its partners
  with reverse G, and forward G with reverse C) and one for the validity
  plane;
- the pileup build reads the panel's 2-bit codes once (a quarter byte a
  base of every genome) and writes the packed rows (``N * W / 2`` bytes).

``W`` is the width of the reference genome that the plain reference picks,
so a kernel that does the same count another way is held to the same work.
"""

from __future__ import annotations

import glob
import json
import os

from reference import match

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense):
# HBM bandwidth and int8 tensor-core operations
HBM_BYTES_S = 3.35e12
INT8_OPS_S = 1979e12


def bound_s(bytes_moved: float, int8_ops: float = 0.0) -> float:
    """The least time: bytes over the memory rate or operations over
    their peak rate, whichever is larger."""
    return max(bytes_moved / HBM_BYTES_S, int8_ops / INT8_OPS_S)


def planes() -> int:
    """phylonium's match planes: classes of pileup states (base of
    A C G T ! on either strand) that match the same set of states."""
    return len({frozenset(t for t in range(10) if match(s, t)) for s in range(10)})


def count_bound_s(n: int, width: int) -> float:
    cells = n * (n + 1) // 2
    return bound_s(n * width / 2 + 2 * 4 * n * n, 2 * (planes() + 1) * cells * width)


def build_bound_s(n: int, width: int, query_bases: int) -> float:
    return bound_s(query_bases / 4 + n * width / 2)


def interval_union(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if a < hi and b > lo]


def server_kernels(directory: str) -> tuple[list[tuple[str, float, float]], list[str]]:
    """Every device kernel in the traced servers' traces under
    ``directory``: (name, start, end) in seconds of the host's wall
    clock, and a note for each trace read."""
    kernels, notes = [], []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        if path.endswith(".clock.json"):
            continue
        clock = path[: -len(".json")] + ".clock.json"
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        with open(clock) as f:
            walls = json.load(f)
        anchors = {e["name"]: e["ts"] for e in events
                   if e.get("ph") == "X" and str(e.get("name", "")).startswith("portbench.clock.")}
        offsets = [walls[int(name.rsplit(".", 1)[1])] * 1e6 - ts for name, ts in anchors.items()]
        if not offsets:
            notes.append(f"{os.path.basename(path)}: no clock anchor, not read")
            continue
        offset = sum(offsets) / len(offsets)
        drift = max(offsets) - min(offsets)
        found = [(e["name"], (e["ts"] + offset) / 1e6, (e["ts"] + e["dur"] + offset) / 1e6)
                 for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
        kernels += found
        notes.append(f"{os.path.basename(path)}: {len(found)} kernels, {len(offsets)} "
                     f"clock anchors {drift / 1e3:.3f} ms apart")
    return kernels, notes


def busy(kernels, lo: float, hi: float) -> float:
    return interval_union(clip([(a, b) for _, a, b in kernels], lo, hi))


def device_ops(kernels, lo: float, hi: float, top: int = 10) -> list[list]:
    """The kernels that took most device time in [lo, hi], by name."""
    totals: dict[str, float] = {}
    for name, a, b in kernels:
        if a < hi and b > lo:
            totals[name] = totals.get(name, 0.0) + min(b, hi) - max(a, lo)
    return [[name, s] for name, s in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]


def phases(run: dict) -> list[tuple[str, float, float]]:
    """One CLI run's pieces on the wall clock: startup, the read (and the
    reference pick) before the pipeline, the run report's timed phases
    laid back to back from the pipeline's start, the rest of the pipeline
    that no phase times, the print after it, and the exit."""
    start, main_start = run["spawned"], run["main_began"]
    out = [("startup", start, main_start), ("read", main_start, run["process_began"])]
    t = run["process_began"]
    for name, s in run["timings"].items():
        out.append((name, t, t + s))
        t += s
    out.append(("untimed", t, run["process_ended"]))
    out.append(("print", run["process_ended"], main_start + run["main_s"]))
    out.append(("exit", main_start + run["main_s"], run["exited"]))
    return out


def idle_gaps(kernels, runs: list[dict], lo: float, hi: float, top: int = 10) -> list[list]:
    """The longest stretches of [lo, hi] with no kernel on the device,
    each named by the CLI run and the piece of it where it began."""
    spans = sorted(clip([(a, b) for _, a, b in kernels], lo, hi))
    gaps, reach = [], lo
    for a, b in spans:
        if a > reach:
            gaps.append((reach, a))
        reach = max(reach, b)
    if hi > reach:
        gaps.append((reach, hi))
    pieces = [(f"run{k}.{name}", a, b) for k, r in enumerate(runs) for name, a, b in phases(r)]

    def label(t: float) -> str:
        for name, a, b in pieces:
            if a <= t < b:
                return name
        return "between runs"

    gaps.sort(key=lambda g: g[0] - g[1])
    return [[label(a), b - a] for a, b in gaps[:top]]
