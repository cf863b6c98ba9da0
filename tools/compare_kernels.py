#!/usr/bin/env python3
"""Time earlier builds of the pileup-build and diagonal-mismatch kernels
against the current ones, on one card, in one process.

    python3 tools/compare_kernels.py OLD_PILEUP_BUILD.cu OLD_DIAGONAL_NEQ.cu

Each OLD source is that kernel's file as an earlier commit has it, with
the same C entry point (``pt_pileup_build``, ``pt_diagonal_neq``), written
outside the package:

    git show <commit>:phylonium_tpu_torch/csrc/pileup_build.cu > chipcheck/old_pileup_build.cu
    git show <commit>:phylonium_tpu_torch/csrc/diagonal_neq.cu > chipcheck/old_diagonal_neq.cu
    python3 tools/compare_kernels.py chipcheck/old_pileup_build.cu chipcheck/old_diagonal_neq.cu

The old sources are built with nvcc (the package's flags) into a library
of their own, the current ones as the package builds them, and both
builds' ``ptxas`` reports (registers, spills, shared memory) are printed.
At the main path's shapes, each old kernel is checked equal to the new
one byte for byte, then both are timed by CUDA events (``chip_smoke.
time_ms``) in the order old, new, new, old, beside the plain version's
time and the bound:

- the pileup build on one mapped group of each production path: 29 x 5 Mbp
  (a streamed group of the 116 x 5 Mbp panel) and 128 x 1 Mbp (a
  low-memory group of the 1000 x 1 Mbp panel), mapped by the native
  mapper, also checked against the host pileup;
- the diagonal bitmaps at 128 jobs x 2^19 (the anchor-extension micro)
  and 8 jobs x 2^19 (a hybrid mapping round).

Prints one line per timing, the card's name and power limit, and a JSON
summary as the last line. Needs a CUDA card and nvcc; the host mapper
needs a C++ compiler with OpenMP, which it picks as ``chip_smoke.py``
does.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ENTRY_POINTS = ("pt_pileup_build", "pt_diagonal_neq")
BUILD_SHAPES = [(29, 5_000_000, 116), (128, 1_000_000, 1000)]


def ptxas_lines(log: str) -> list[str]:
    keep = ("Compiling entry", "registers", "spill", "smem")
    return [line.strip() for line in log.splitlines() if any(k in line for k in keep)]


def build_old(sources: list[str], directory: str) -> tuple[ctypes.CDLL, str]:
    """The old sources as one library, bound as the package binds its own."""
    from phylonium_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    objects, logs = [], []
    for k, src in enumerate(sources):
        obj = os.path.join(directory, f"old{k}.o")
        logs.append(_build._run([nvcc, *_build.NVCC_FLAGS, "-c", src, "-o", obj]))
        objects.append(obj)
    path = os.path.join(directory, "libold_kernels.so")
    _build._run([nvcc, "-shared", "-o", path, *objects])
    old, new = ctypes.CDLL(path), _build.load()
    for name in ENTRY_POINTS:
        getattr(old, name).restype = ctypes.c_int
        getattr(old, name).argtypes = getattr(new, name).argtypes
    return old, "".join(logs)


def turns(label: str, run_old, run_new, reps: int) -> dict:
    """Old, new, new, old; ms per call of each."""
    import chip_smoke

    times = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        fn = run_old if which == "old" else run_new
        ms = chip_smoke.time_ms(fn, runs=3, reps=reps)
        times[which].append(ms)
        print(f"  {label}: {which} {ms:.4f} ms", flush=True)
    return times


def compare_build(device, old) -> list[dict]:
    import torch

    import chip_smoke
    from phylonium_tpu_torch.core.pileup import build_pileup
    from phylonium_tpu_torch.ops import pileup_device
    from phylonium_tpu_torch.ops.shapes import pack_states
    from phylonium_tpu_torch.ops.states import packed_width

    summary = []
    for rows, length, seed in BUILD_SHAPES:
        queries, homologies, ref_len = chip_smoke.mapped_group(rows, length, seed)
        inputs = pileup_device.prepare_group(queries, homologies, ref_len)
        t = [torch.from_numpy(a).to(device) for a in inputs]
        words, intervals, overlay = t[0], t[1], tuple(t[2:])
        width = packed_width(ref_len)
        outs = {k: torch.empty((rows, width), dtype=torch.uint8, device=device)
                for k in ("old", "new", "plain")}

        def run_old():
            pileup_device._launch(words, intervals, overlay, ref_len, outs["old"], lib=old)

        def run_new():
            pileup_device._launch(words, intervals, overlay, ref_len, outs["new"])

        run_old()
        run_new()
        pileup_device._plain(words, intervals, overlay, ref_len, outs["plain"])
        torch.cuda.synchronize()
        host = torch.from_numpy(pack_states(build_pileup(queries, homologies, ref_len),
                                            rows, width))
        if not (torch.equal(outs["old"], outs["new"]) and torch.equal(outs["new"], outs["plain"])
                and torch.equal(outs["new"].cpu(), host)):
            raise AssertionError(f"pileup_build: old, new, plain or host differ at {rows} x {length}")
        label = f"pileup_build {rows} x {length}"
        times = turns(label, run_old, run_new, reps=5)
        plain_ms = chip_smoke.time_ms(
            lambda: pileup_device._plain(words, intervals, overlay, ref_len, outs["plain"]))
        read = sum(x.numel() * x.element_size() for x in t)
        bound_ms, bound_by = chip_smoke.bound(read + rows * width)
        summary.append(report(label, times, plain_ms, bound_ms, bound_by,
                              records=int(intervals.shape[1]), overlay=int(overlay[1].numel())))
        del t, words, intervals, overlay, outs
        torch.cuda.empty_cache()
    return summary


def compare_extend(device, old) -> list[dict]:
    import torch

    import chip_smoke
    from phylonium_tpu_torch.ops import anchor_extend

    chunk = chip_smoke.CHUNK
    summary = []
    for name, (x, y, oa, ob, la, lb) in chip_smoke.extend_shapes(device).items():
        jobs = anchor_extend._job_tensor(x, y, oa, ob, la, lb)
        got_old = anchor_extend._launch(x, y, jobs, chunk, lib=old)
        got_new = anchor_extend._launch(x, y, jobs, chunk)
        plain = anchor_extend._plain(x, y, jobs, chunk)
        torch.cuda.synchronize()
        if not (torch.equal(got_old, got_new) and torch.equal(got_new, plain)):
            raise AssertionError(f"diagonal_neq: old, new or plain differ at {name}")
        label = f"diagonal_neq {len(oa)} x {chunk} ({name})"
        times = turns(label, lambda: anchor_extend._launch(x, y, jobs, chunk, lib=old),
                      lambda: anchor_extend._launch(x, y, jobs, chunk), reps=20)
        plain_ms = chip_smoke.time_ms(lambda: anchor_extend._plain(x, y, jobs, chunk), reps=5)
        bound_ms, bound_by = chip_smoke.extend_bound(jobs, oa, ob, la, lb)
        summary.append(report(label, times, plain_ms, bound_ms, bound_by))
    torch.cuda.empty_cache()
    return summary


def report(label, times, plain_ms, bound_ms, bound_by, **extra) -> dict:
    new = statistics.mean(times["new"])
    speedup = statistics.mean(times["old"]) / new
    print(f"  {label}: old == new == plain; new is {speedup:.2f}x the old kernel's "
          f"speed; plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), "
          f"new at {100 * bound_ms / new:.1f} % of it", flush=True)
    return {"shape": label, "old_ms": times["old"], "new_ms": times["new"],
            "speedup": speedup, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "share_of_bound": bound_ms / new, **extra}


def main() -> int:
    import torch

    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_kernels: torch finds no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke
    from phylonium_tpu_torch.ops import _build
    from phylonium_tpu_torch.utils.platform import nvidia_smi_line

    native = chip_smoke.port_host_library()
    print(f"  host library built with {native['compiler']}", flush=True)
    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        old, old_log = build_old(sys.argv[1:], tmp)
        print("  new build:", flush=True)
        for line in ptxas_lines(_build.BUILD_INFO["ptxas"]):
            print(f"    {line}", flush=True)
        print("  old build:", flush=True)
        for line in ptxas_lines(old_log):
            print(f"    {line}", flush=True)
        summary = compare_build(device, old) + compare_extend(device, old)
    print(nvidia_smi_line().splitlines()[0], flush=True)
    print(json.dumps({"compare_kernels": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
