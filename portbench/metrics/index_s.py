"""index_s: the run report's ``index`` phase, in seconds, the mean over
the window's runs."""


def read(run: dict):
    found = [r["timings"]["index"] for r in run["runs"] if "index" in r["timings"]]
    return sum(found) / len(found) if found else None
