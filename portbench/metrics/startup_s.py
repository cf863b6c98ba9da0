"""startup_s: a CLI run's interpreter start, imports and exit, in seconds,
the mean over the window's runs (the child wrapper's clocks)."""


def read(run: dict):
    runs = run["runs"]
    return sum(r["start_s"] + r["import_s"] + r["exit_s"] for r in runs) / len(runs)
