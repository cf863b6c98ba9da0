"""``--profile=DIR`` and ``PHYLONIUM_TPU_RUN_REPORT`` in the port's CLI.

A ``--device cpu --profile=DIR`` run writes one Chrome trace into DIR
holding a range for each phase of ``LAST_RUN_INFO["timings"]`` (and the
streamed feeder's worker ranges), prints what a run without it prints,
and loads no jax. A trace that cannot be written warns, still prints the
matrix and exits 1. The run report is the JAX CLI's: ``LAST_RUN_INFO`` as
JSON after the matrix; a report that cannot be written warns only.
"""

import collections
import contextlib
import glob
import io
import json
import os
import subprocess
import sys

import pytest

from pileup_cases import write_fasta_panel
from phylonium_tpu_torch.utils.profile import GROUP_RANGE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, sys
from phylonium_tpu_torch.cli import main
rc = main(sys.argv[1:])
from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO
print(json.dumps({"rc": rc, "jax": "jax" in sys.modules,
                  "info": LAST_RUN_INFO}), file=sys.stderr)
"""


def _probe(args, cwd, **env_extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra)
    r = subprocess.run(
        [sys.executable, "-c", _PROBE, "--progress=never", "--device=cpu", *args],
        capture_output=True, cwd=cwd, timeout=600, env=env,
    )
    err = r.stderr.decode()
    report = json.loads(err.strip().splitlines()[-1])
    return r, report, err


def _ranges(trace_dir):
    """(name -> count of user ranges, thread ids of each name) of the one
    trace in ``trace_dir``."""
    (path,) = glob.glob(os.path.join(trace_dir, "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = collections.Counter()
    threads = collections.defaultdict(set)
    for e in events:
        if e.get("cat") == "user_annotation":
            names[e["name"]] += 1
            threads[e["name"]].add(e["tid"])
    return names, threads


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("profile_panel")
    return write_fasta_panel(d, 5, 3000, seed=8, contigs=2), d


def test_profile_writes_phase_ranges_and_keeps_stdout(files):
    paths, tmp = files
    plain, _, _ = _probe(paths, tmp)
    assert plain.returncode == 0
    trace_dir = tmp / "trace"
    r, report, _ = _probe([f"--profile={trace_dir}", *paths], tmp)
    assert r.returncode == 0 and report["rc"] == 0
    assert report["jax"] is False
    assert r.stdout == plain.stdout
    names, _ = _ranges(trace_dir)
    for name in ("index", "map", "pileup", "compare"):
        assert names[name] == 1, names
    assert set(report["info"]["timings"]) <= set(names)


def test_profile_covers_both_passes(files):
    paths, tmp = files
    trace_dir = tmp / "trace_2pass"
    r, report, _ = _probe(["-2", "--profile", str(trace_dir), *paths], tmp)
    assert r.returncode == 0 and report["rc"] == 0
    names, _ = _ranges(trace_dir)
    passes = names["index"]
    assert passes in (1, 2)  # 1 when the pass-1 reference is the central one
    assert names["map"] == names["pileup"] == names["compare"] == passes


@pytest.mark.parametrize(
    "env,phases",
    [({"PHYLONIUM_TPU_DEVICE_PILEUP": "1"}, ("index", "map", "pileup", "compare")),
     ({"PHYLONIUM_TPU_STREAM": "force"}, ("index", "map+pileup+feed", "compare")),
     ({"PHYLONIUM_TPU_LOWMEM": "force"}, ("index", "map+feed", "compare"))],
    ids=["device_pileup", "streamed", "lowmem"],
)
def test_profile_records_the_feeder_worker(files, env, phases):
    """The device-pileup, streamed and low-memory paths: their phases, and
    one range per group recorded on the feeder's worker thread."""
    paths, tmp = files
    trace_dir = tmp / f"trace_{'_'.join(env)}"
    r, report, _ = _probe([f"--profile={trace_dir}", *paths], tmp,
                          PHYLONIUM_TPU_STREAM_GROUP="2", **env)
    assert r.returncode == 0 and report["rc"] == 0
    names, threads = _ranges(trace_dir)
    for name in phases:
        assert names[name] == 1, names
    info = report["info"]
    assert names[GROUP_RANGE] == info["build_plain_calls"] > 0
    assert threads[GROUP_RANGE].isdisjoint(threads["index"])


def test_unwritable_profile_dir_is_a_soft_error(files):
    paths, tmp = files
    blocker = tmp / "not_a_dir"
    blocker.write_text("")
    plain, _, _ = _probe(paths, tmp)
    r, report, err = _probe([f"--profile={blocker}", *paths], tmp)
    assert report["rc"] == 1
    assert "could not start the profiler" in err
    assert r.stdout == plain.stdout


def test_run_report(files, tmp_path):
    paths, tmp = files
    report_path = tmp_path / "report.json"
    r, probe, _ = _probe(paths, tmp, PHYLONIUM_TPU_RUN_REPORT=str(report_path))
    assert r.returncode == 0
    info = json.loads(report_path.read_text())
    assert info["compare_carrier"] == "torch-cpu"
    assert {"index", "map", "pileup", "compare"} <= set(info["timings"])
    assert info == probe["info"]


def test_unwritable_run_report_only_warns(files, tmp_path, monkeypatch):
    from phylonium_tpu_torch.cli import main

    paths, _ = files
    monkeypatch.setenv("PHYLONIUM_TPU_RUN_REPORT", str(tmp_path / "no" / "such" / "r.json"))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["--progress=never", "--device", "cpu", *paths])
    assert rc == 0
    assert out.getvalue().splitlines()[0].strip() == "5"
    assert "could not write run report" in err.getvalue()


def test_mesh_still_refused(files, capsys):
    from phylonium_tpu_torch.cli import main

    paths, _ = files
    assert main(["--progress=never", "--device", "cpu", "--mesh", "2,1", *paths]) == 1
    assert "--mesh 2,1 needs 2 devices; the runtime has 1" in capsys.readouterr().err
