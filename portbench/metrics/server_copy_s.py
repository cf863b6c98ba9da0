"""server_copy_s: the device server's host-to-card copies: the sum of
its ``devd.copy`` spans a run (each pinned copy of a piece's words or a
group's records), in seconds, the mean over the window's runs (the
program's spans in each run report, ``spans``, on the host's wall
clock). Nothing where no report holds such a span."""

NAME, PROCESS = "devd.copy", "devd"


def read(run: dict):
    found = []
    for r in run["runs"]:
        spans = [s for s in r["report"].get("spans") or ()
                 if s["name"] == NAME and s["process"] == PROCESS]
        if spans:
            found.append(sum(s["end"] - s["start"] for s in spans))
    return sum(found) / len(found) if found else None
