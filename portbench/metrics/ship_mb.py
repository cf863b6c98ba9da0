"""ship_mb: the MB of 2-bit query codes the early shipper copied to the
device server a run, the mean over the window's runs (run report
``early_ship``'s ``mb``; pieces the server's cache held ship 0 bytes).
Nothing when no run shipped through the shipper."""


def read(run: dict):
    found = [s["mb"] for s in (r["report"].get("early_ship") for r in run["runs"]) if s]
    return sum(found) / len(found) if found else None
