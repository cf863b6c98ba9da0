"""read_s: the CLI's FASTA read and reference pick, before the pipeline,
in seconds, the mean over the window's runs: from the start of
``cli.main`` to the start of ``cli.process`` (the child wrapper's wall
clock; the run report has no ``read`` phase)."""


def read(run: dict):
    found = [r["process_began"] - r["main_began"] for r in run["runs"]
             if r.get("process_began") and r.get("main_began")]
    return sum(found) / len(found) if found else None
