"""count_roofline: the panel's pair count (``csrc/pair_count.cu``) against
its roofline, in percent: the least time of the window's counts
(``traces.count_bound_s`` of the problem, once a run that counted on the
card) over the device time of the kernels named below. Nothing when the
window's traces hold none of them."""

from traces import count_bound_s

KERNELS = ("pair_mma_kernel",)


def read(run: dict):
    lo, hi = run["window"]
    seconds = sum(b - a for name, a, b in run["kernels"]
                  if any(k in name for k in KERNELS) and lo <= a and b <= hi)
    counted = sum(1 for r in run["runs"] if r["count_launches"])
    if seconds <= 0 or not counted:
        return None
    p = run["problem"]
    return 100.0 * counted * count_bound_s(p["genomes"], p["width"]) / seconds
