"""build_roofline: the pileup rows built on the card
(``csrc/pileup_build.cu``) against their roofline, in percent: the least
time of the window's builds (``traces.build_bound_s`` of the problem, once
a run that built on the card) over the device time of the kernels named
below. Nothing when the window's traces hold none of them."""

from traces import build_bound_s

KERNELS = ("pileup_build_kernel",)


def read(run: dict):
    lo, hi = run["window"]
    seconds = sum(b - a for name, a, b in run["kernels"]
                  if any(k in name for k in KERNELS) and lo <= a and b <= hi)
    built = sum(1 for r in run["runs"] if r["build_launches"])
    if seconds <= 0 or not built:
        return None
    p = run["problem"]
    return 100.0 * built * build_bound_s(p["genomes"], p["width"], p["query_bases"]) / seconds
