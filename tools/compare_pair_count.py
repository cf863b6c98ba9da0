#!/usr/bin/env python3
"""Time another build of the pair-count kernel against the current one.

    python3 tools/compare_pair_count.py OLD_SOURCE.cu

OLD_SOURCE.cu is a pair_count.cu with the same C interface
(``pt_set_partner_mask``, ``pt_cross_counts``), for example an earlier
commit's, written outside the package:

    git show <commit>:phylonium_tpu_torch/csrc/pair_count.cu > chipcheck/old.cu

Both are built with nvcc (the package's flags), checked equal to each
other on the card, and timed by CUDA events at the main path's shapes,
29 x 5 Mbp and 600 x 1 Mbp, in the order old, new, new, old. Prints one
line per timing, the card's name and power limit, and a JSON summary as
the last line. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SHAPES = [(29, 5_000_000, 1), (600, 1_000_000, 2)]


def build_old(source: str, directory: str) -> ctypes.CDLL:
    from phylonium_tpu_torch.ops import _build

    lib = os.path.join(directory, "libold_pair_count.so")
    obj = os.path.join(directory, "old.o")
    nvcc = _build._nvcc()
    _build._run([nvcc, *_build.NVCC_FLAGS, "-c", source, "-o", obj])
    _build._run([nvcc, "-shared", "-o", lib, obj])
    old = ctypes.CDLL(lib)
    old.pt_cross_counts.restype = ctypes.c_int
    old.pt_cross_counts.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p,
    ]
    old.pt_set_partner_mask.restype = ctypes.c_int
    old.pt_set_partner_mask.argtypes = [ctypes.c_void_p]
    return old


def main() -> int:
    import numpy as np
    import torch

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_pair_count: torch finds no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke
    from phylonium_tpu_torch.ops import pair_count
    from phylonium_tpu_torch.ops.match_table import PARTNER_MASK
    from phylonium_tpu_torch.ops.states import pack_rows, to_device
    from phylonium_tpu_torch.utils.platform import nvidia_smi_line

    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        old = build_old(sys.argv[1], tmp)
        if old.pt_set_partner_mask(PARTNER_MASK.ctypes.data):
            raise RuntimeError("old pt_set_partner_mask failed")

        def old_counts(rows):
            n = rows.shape[0]
            m = torch.zeros((n, n), dtype=torch.int32, device=device)
            h = torch.zeros_like(m)
            err = old.pt_cross_counts(
                rows.data_ptr(), rows.stride(0), n, rows.data_ptr(),
                rows.stride(0), n, rows.shape[1], m.data_ptr(), h.data_ptr(),
                1, torch.cuda.current_stream(device).cuda_stream,
            )
            if err:
                raise RuntimeError(f"old pt_cross_counts: CUDA error {err}")
            return m, h

        def new_counts(rows):
            return pair_count._launch(rows, rows, True)

        summary = []
        for n, length, seed in SHAPES:
            states = chip_smoke.random_states(np.random.default_rng(seed), n, length)
            rows = to_device(pack_rows(states), device)
            del states
            mo, ho = old_counts(rows)
            mn, hn = new_counts(rows)
            torch.cuda.synchronize()
            if not (torch.equal(torch.triu(mo), torch.triu(mn))
                    and torch.equal(torch.triu(ho), torch.triu(hn))):
                raise AssertionError(f"old and new kernels differ at {n} x {length}")
            del mo, ho, mn, hn
            times = {"old": [], "new": []}
            for which in ("old", "new", "new", "old"):
                fn = old_counts if which == "old" else new_counts
                ms = chip_smoke.time_ms(lambda: fn(rows), runs=3, reps=3)
                times[which].append(ms)
                print(f"  {n} x {length}: {which} {ms:.4f} ms", flush=True)
            speedup = statistics.mean(times["old"]) / statistics.mean(times["new"])
            print(f"  {n} x {length}: old == new; new is {speedup:.2f}x the old "
                  "kernel's speed", flush=True)
            summary.append({"n": n, "length": length, "old_ms": times["old"],
                            "new_ms": times["new"], "speedup": speedup})
            del rows
            torch.cuda.empty_cache()
    print(nvidia_smi_line().splitlines()[0], flush=True)
    print(json.dumps({"compare_pair_count": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
