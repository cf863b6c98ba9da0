"""prep_s: the feeder's host prep of its groups: the sum of its
``feed.prep`` spans a run (interval records and overlay; the 2-bit codes
where the shipper did not park them), in seconds, the mean over the
window's runs (the program's spans in each run report, ``spans``, on the
host's wall clock). Nothing where no report holds such a span."""

NAME, PROCESS = "feed.prep", "cli"


def read(run: dict):
    found = []
    for r in run["runs"]:
        spans = [s for s in r["report"].get("spans") or ()
                 if s["name"] == NAME and s["process"] == PROCESS]
        if spans:
            found.append(sum(s["end"] - s["start"] for s in spans))
    return sum(found) / len(found) if found else None
