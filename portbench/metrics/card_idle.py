"""card_idle: the share of the window, from the first CLI run's spawn to
the last one's exit, in which no kernel ran on the card, in percent; the
kernels are those of the traced processes that used the card. Nothing
when the traces hold no kernel."""

from traces import busy


def read(run: dict):
    if not run["kernels"]:
        return None
    lo, hi = run["window"]
    return 100.0 * (1.0 - busy(run["kernels"], lo, hi) / (hi - lo))
