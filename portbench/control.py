"""The readings a cell's limits are set from: the program's and the
control's, seed by seed, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds <n>,<n>,... [--seconds <s>]
    python3 portbench/control.py --workload <cell> --seeds <n>,<n>,... --control-only

For each seed: the cell's set-up and a short window (one CLI run unless
``--seconds`` asks for more), then the plain reference. It prints, a
line a seed, the numbers ``run.py`` compares (``cells_differ``, the most
cells of any window run that differ from the reference's float64 matrix,
and ``runs_failed``) and the control's ``cells_differ``: the reference's
own matrix with the estimator computed in float32, the nearest precision
below the configuration's. A sound program's readings set the lower end
of a limit, the control's the upper; ``run.py``'s own runs never run this.
The control needs no program: ``--control-only`` reads it alone, on the
panel of the window's first run, for many seeds at little cost.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import panel
import reference
import run


def control_only(workload: str, seed: int) -> dict:
    _, config, traffic = run.cell_spec(run.ROOT, workload)
    directory = os.path.join(os.environ.get("TMPDIR") or "/tmp", "portbench-control")
    shutil.rmtree(directory, ignore_errors=True)
    try:
        files = panel.Panel(config["panel"], seed, directory,
                            period=int((traffic.get("turnover") or {}).get("period", 0))).files(1)
        want = reference.matrix(files, card=True)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return {"seed": seed,
            "control_cells_differ": reference.cells_differ(want.control_cells, want.cells),
            "cells": len(want.names) ** 2 - len(want.names)}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="portbench/control.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=0.0)
    parser.add_argument("--control-only", action="store_true")
    args = parser.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.control_only:
        rows = [control_only(args.workload, seed) for seed in seeds]
        for row in rows:
            print(json.dumps(row), flush=True)
        print(json.dumps({"workload": args.workload, "seeds": len(rows),
                          "control_fails_on": sum(r["control_cells_differ"] > 0 for r in rows),
                          "upper_cells_differ": min(r["control_cells_differ"] for r in rows)}),
              flush=True)
        return 0
    run.become_subreaper()
    rows = []
    for seed in seeds:
        cell_args = argparse.Namespace(workload=args.workload, seed=seed,
                                       seconds=args.seconds, trace=0)
        cell = run.Cell(cell_args, run.ROOT, "cuda", {}, None)
        try:
            done = cell.execute()
            values, _, want = run.judge(done["runs"], True)
        finally:
            shutil.rmtree(cell.run_dir, ignore_errors=True)
        row = {"seed": seed, **values,
               "control_cells_differ": min(reference.cells_differ(a.control_cells, a.cells)
                                           for a in want.answers),
               "cells": len(want.answers[0].names) ** 2 - len(want.answers[0].names)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    worst = max(r["cells_differ"] for r in rows)
    least = min(r["control_cells_differ"] for r in rows)
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "lower_cells_differ": worst, "upper_cells_differ": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
