"""cache_hit_share: the share of the early shipper's pieces that the device
server's content cache already held (0 bytes shipped), in percent, over
all of the window's runs: run report ``early_ship``'s ``cache_hits`` over
its ``groups``. Nothing when no run shipped through the shipper."""


def read(run: dict):
    ships = [r["report"].get("early_ship") for r in run["runs"]]
    pieces = sum(s["groups"] for s in ships if s)
    if not pieces:
        return None
    return 100.0 * sum(s["cache_hits"] for s in ships if s) / pieces
