"""lock_wait_s: the CLI's waits for its one connection to the device
server (the shipper's and the feeder's requests serialize under one
lock), in seconds, the mean over the window's runs of the sum of
``attrs.lock_wait_s`` over the client's ``devd.<op>`` spans in each run
report. Nothing where no report holds such a span."""


def read(run: dict):
    found = []
    for r in run["runs"]:
        waits = [s["attrs"]["lock_wait_s"] for s in r["report"].get("spans") or ()
                 if s["process"] == "cli" and s["name"].startswith("devd.")
                 and "lock_wait_s" in s["attrs"]]
        if waits:
            found.append(sum(waits))
    return sum(found) / len(found) if found else None
