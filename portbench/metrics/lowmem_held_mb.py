"""lowmem_held_mb: the genomes the CLI holds on the low-memory route, in
MB: the compacted panel (``compact_mb``) plus the most unpacked bytes
alive at once (``unpacked_peak_mb``: the group being mapped, the groups in
the feeder's queue and the one its worker holds), both ``attrs`` of the
``lowmem`` span in each run report (``spans``), the highest over the
window's runs. Nothing where no report holds such a span."""

NAME, PROCESS = "lowmem", "cli"


def read(run: dict):
    found = []
    for r in run["runs"]:
        for s in r["report"].get("spans") or ():
            if s["name"] == NAME and s["process"] == PROCESS:
                attrs = s.get("attrs") or {}
                if "compact_mb" in attrs and "unpacked_peak_mb" in attrs:
                    found.append(attrs["compact_mb"] + attrs["unpacked_peak_mb"])
    return max(found) if found else None
