"""lowmem_feed_wait_s: the low-memory route's wait to hand each mapped
group to the feeder, whose queue blocks while ``MAX_BACKLOG`` groups
wait for its worker: the sum of its ``lowmem.feed`` spans a run, in
seconds, the mean over the window's runs (the program's spans in each run
report, ``spans``, on the host's wall clock). Nothing where no report
holds such a span."""

NAME, PROCESS = "lowmem.feed", "cli"


def read(run: dict):
    found = []
    for r in run["runs"]:
        spans = [s for s in r["report"].get("spans") or ()
                 if s["name"] == NAME and s["process"] == PROCESS]
        if spans:
            found.append(sum(s["end"] - s["start"] for s in spans))
    return sum(found) / len(found) if found else None
