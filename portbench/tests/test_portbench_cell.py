"""Whole cells of the harness on the CPU, at a tiny size.

The harness runs as on the card, less its look for a card: a tiny
configuration and three traffic mixes in a checkout of their own (the
program linked in), the port's CLI routed to a device server on the CPU
(``PHYLONIUM_TPU_DEVD=1``, ``PHYLONIUM_TPU_STREAM=force``). A sound run is
correct, keeps its socket and store under its own ``TMPDIR`` and leaves no
server behind; a run with the timed path broken underneath (a fault
planted in the window's CLI processes) comes out not correct; the float32 control
differs from the float64 reference.
"""

import json
import os
import re
import shutil

import pytest

import panel
import reference
import run as harness

TINY = {"genomes": 8, "length": 60000, "divergence_low": 0.01, "divergence_span": 0.04,
        "draft_contigs": 3, "draft_inversion": 5000}
CPU_ROUTE = {"PHYLONIUM_TPU_DEVD": "1", "PHYLONIUM_TPU_STREAM": "force",
             "PHYLONIUM_TPU_STREAM_GROUP": "3"}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]

FAULTS = {
    # an answer altered where it is produced: one distance of the matrix
    "answer": """
import phylonium_tpu_torch.io.phylip as phylip
plain = phylip.format_matrix
def altered(names, dist, ani):
    dist = dist.copy()
    dist[0, 1] *= 1.01
    return plain(names, dist, ani)
phylip.format_matrix = altered
""",
    # half of the batch left out: each homology cut to its first half
    # before the rows are built and counted
    "half": """
import phylonium_tpu_torch.core.stream as stream
mapped = stream.map_batch_native
def halved(*args, **kwargs):
    out = mapped(*args, **kwargs)
    for homologies in out:
        for h in homologies:
            h.length -= h.length // 2
    return out
stream.map_batch_native = halved
""",
    # a step that returns its state unchanged: the counts as they start
    "stale": """
from phylonium_tpu_torch.model.evo import EvoCounts
def unchanged(subject, queries, cfg):
    return EvoCounts.zeros(len(queries))
cli.process = unchanged
""",
}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A checkout with the tiny cells, the real metrics and the program."""
    root = tmp_path_factory.mktemp("checkout")
    os.makedirs(root / "portbench" / "configs")
    os.makedirs(root / "portbench" / "traffic")
    os.symlink(os.path.join(harness.ROOT, harness.PROGRAM), root / harness.PROGRAM)
    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    cells = ["tiny.warm", "tiny.cold", "tiny.turnover"]
    bench["configs"] = [{"name": "tiny", "source": "test", "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [
        {"name": "tiny.warm", "config": "tiny", "traffic": "warm", "chips": 1, "why": "test"},
        {"name": "tiny.cold", "config": "tiny", "traffic": "cold", "chips": 1, "why": "test"},
        {"name": "tiny.turnover", "config": "tiny", "traffic": "turnover", "chips": 1,
         "why": "test"}]
    for m in bench["per_layer"]:
        m["workloads"] = cells
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    json.dump({"panel": TINY}, open(root / "portbench" / "configs" / "tiny.json", "w"))
    for server in ("warm", "cold"):
        json.dump({"store": "fresh", "server": server, "warmup_runs": 1, "flags": []},
                  open(root / "portbench" / "traffic" / f"{server}.json", "w"))
    json.dump({"store": "fresh", "server": "warm", "warmup_runs": 1, "turnover": {"period": 3},
               "flags": []}, open(root / "portbench" / "traffic" / "turnover.json", "w"))
    return str(root)


def run_cell(checkout, tmp_path, capsys, cell="tiny.warm", trace=0, fault=None, seed=3_000_000_007):
    os.environ["TMPDIR"] = str(tmp_path)
    prelude = None
    if fault:
        prelude = str(tmp_path / "fault.py")
        with open(prelude, "w") as f:
            f.write(FAULTS[fault])
    try:
        rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "2",
                           "--trace", str(trace)],
                          device="cpu", env_extra=CPU_ROUTE, prelude=prelude, root=checkout)
    finally:
        os.environ.pop("TMPDIR")
    out, err = capsys.readouterr()
    return rc, out, err


def servers_named(err: str) -> set[int]:
    return {int(p) for p in re.findall(r"devd\(pid (\d+),", err)}


@pytest.mark.parametrize("cell,trace", [("tiny.warm", 0), ("tiny.warm", 1), ("tiny.cold", 0),
                                        ("tiny.turnover", 0)])
def test_a_sound_run_is_correct_and_leaves_nothing(checkout, tmp_path, capsys, cell, trace):
    rc, out, err = run_cell(checkout, tmp_path, capsys, cell, trace)
    assert rc == 0, err[-3000:]
    result = json.loads(out.strip().splitlines()[-1])
    assert list(result)[:5] == KEYS and list(result)[-1] == "compared"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    want = ({"startup_s", "read_s", "index_s", "map_s", "compare_s", "cache_hit_share",
             "ship_mb"} if trace else {"matrix_s", "peak_rss_mb", "setup_s"})
    assert set(result["metrics"]) == want
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"]) and "breakdown" in result
        # the same panel again on a warm server: every piece a cache hit
        assert result["metrics"]["cache_hit_share"]["value"] == 100.0
        assert result["metrics"]["ship_mb"]["value"] == 0.0
    assert err.rstrip().splitlines()[-2:] == ["compared cells_differ 0 limit 0",
                                             "compared runs_failed 0 limit 0"]
    # the run's socket and store were under its TMPDIR, which it cleaned
    assert not os.path.exists(tmp_path / "portbench")
    pids = servers_named(err)
    assert pids and not any(harness.pid_alive(p) for p in pids)
    if cell == "tiny.cold":
        assert len(pids) == result["attempted"] + 1  # every run spawned its own
    else:
        assert len(pids) == 1  # the server set-up started
    if cell == "tiny.turnover":
        # each window run held new genomes, and was judged against its own panel
        assert err.count("new genomes written") == result["attempted"]
        assert f"{result['attempted']} panel(s)" in err


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(checkout, tmp_path, capsys, fault):
    rc, out, err = run_cell(checkout, tmp_path, capsys, fault=fault)
    assert rc == 0, err[-3000:]
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is False and result["failed"] == result["attempted"]
    assert result["compared"]["cells_differ"]["value"] > 0


def test_the_float32_control_differs(tmp_path):
    """At a size a test holds: 16 genomes of 200 kbp, 0.2 % to 2 %."""
    shape = {**TINY, "genomes": 16, "length": 200_000, "divergence_low": 0.002,
             "divergence_span": 0.018}
    files = panel.write_panel(shape, 3_000_000_123, str(tmp_path / "panel"))
    want = reference.matrix(files, workers=4)
    assert reference.cells_differ(want.control_cells, want.cells) > 0
    shutil.rmtree(tmp_path / "panel")
