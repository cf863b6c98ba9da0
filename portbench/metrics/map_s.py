"""map_s: the route's mapping phase from the run report, in seconds, the
mean over the window's runs: ``map+pileup+feed`` (streamed),
``map+feed`` (low memory) or ``map`` (serial), whichever the run wrote."""

KEYS = ("map+pileup+feed", "map+feed", "map")


def read(run: dict):
    found = []
    for r in run["runs"]:
        key = next((k for k in KEYS if k in r["timings"]), None)
        if key is None:
            return None
        found.append(r["timings"][key])
    return sum(found) / len(found) if found else None
