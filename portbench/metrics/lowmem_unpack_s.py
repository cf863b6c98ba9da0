"""lowmem_unpack_s: the low-memory route's unpacking of each mapping group
from the 2-bit packs the CLI keeps: the sum of its ``lowmem.unpack`` spans
a run, in seconds, the mean over the window's runs (the program's spans
in each run report, ``spans``, on the host's wall clock). Nothing where
no report holds such a span."""

NAME, PROCESS = "lowmem.unpack", "cli"


def read(run: dict):
    found = []
    for r in run["runs"]:
        spans = [s for s in r["report"].get("spans") or ()
                 if s["name"] == NAME and s["process"] == PROCESS]
        if spans:
            found.append(sum(s["end"] - s["start"] for s in spans))
    return sum(found) / len(found) if found else None
