"""compare_s: the run report's ``compare`` phase, in seconds, the mean over
the window's runs; on the device server's route, the client's wait for
the server's ``finish``."""


def read(run: dict):
    found = [r["timings"]["compare"] for r in run["runs"] if "compare" in r["timings"]]
    return sum(found) / len(found) if found else None
