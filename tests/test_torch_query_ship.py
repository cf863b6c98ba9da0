"""The port's early query shipper (core/query_ship.py) on the CPU route.

- The shipped words, ``bases`` and ``seps`` equal, byte for byte, the JAX
  ``QueryShipper``'s groups (as tests/test_stream.py builds them) and the
  port's ``group_payload``, for raw genomes; ``add_seq`` on compacted
  genomes equals the JAX ``_payload_from_compacted``; a group cut by
  ``row_groups`` ships as the feeder cuts it.
- ``take`` on a boundary miss, ``cancel``, and a worker error that the
  feeder's ``finish()`` raises.
- CLI runs under ``PHYLONIUM_TPU_STREAM=force --device cpu``: the golden
  cases that stream, the low-memory path and ``-2``, each printing the
  golden fixture's bytes (or the JAX CLI's), with every fed group taken
  resident and none repacked; pass 2 of ``-2`` takes the groups pass 1
  shipped, packing none again.
- The calibration file holds ``map_gbps`` after a run.
"""

import contextlib
import io
import json
import os
import threading

import numpy as np
import pytest
import torch

from golden_panel import GOLDEN_CASES, RD_SEED, write_panel
from phylonium_tpu.core.pileup import build_pileup
from phylonium_tpu.data.sequence import Sequence as JaxSequence
from phylonium_tpu.ops.match_table import pair_counts_numpy
from phylonium_tpu_torch.core import query_ship
from phylonium_tpu_torch.core.query_ship import QueryShipper
from phylonium_tpu_torch.core.stream import DeviceRowFeeder
from phylonium_tpu_torch.data.sequence import Sequence
from phylonium_tpu_torch.ops import pileup_device
from phylonium_tpu_torch.ops.pileup_prep import group_payload
from pileup_cases import panel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "data", "golden")
CPU = torch.device("cpu")


def _words(resident) -> np.ndarray:
    return resident.words.numpy().view(np.uint32)


def test_shipped_groups_equal_the_jax_shippers(rng, monkeypatch):
    from phylonium_tpu.core.query_ship import QueryShipper as JaxShipper

    n, length = 13, 900
    queries, _, _ = panel(rng, n, length)
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "5")
    ours, theirs = QueryShipper(n, CPU), JaxShipper(n)
    assert ours.group_rows == theirs.group_rows == 5
    for q in queries:
        ours.add(q)
        theirs.add(q)
    # groups: [0,5) [5,10) [10,13); take() waits for queued groups
    for lo in (0, 5, 10):
        hi = min(lo + 5, n)
        got = ours.take(lo, hi)
        assert got is not None and got.event is None
        packed, bases, seps = theirs.take(lo, hi)
        assert np.array_equal(_words(got), np.asarray(packed))
        assert np.array_equal(got.bases, bases) and np.array_equal(got.seps, seps)
        ep, eb, es = group_payload(queries[lo:hi])
        assert _words(got).tobytes() == ep.tobytes()
        assert np.array_equal(got.bases, eb) and np.array_equal(got.seps, es)
    assert ours.shipped_groups() == 3
    assert ours.shipped_bytes() == sum(group_payload(queries[lo:lo + 5])[0].nbytes
                                       for lo in (0, 5, 10))
    assert ours.achieved_mb_s() is None  # no copy timed on the CPU
    assert ours.drain(10.0)
    ours.stop()
    theirs.cancel()


def test_compacted_genomes_ship_their_own_packs(rng, monkeypatch):
    from phylonium_tpu.core.query_ship import _payload_from_compacted as jax_payload

    queries, homologies, ref_len = panel(rng, 9, 700)
    ours = [Sequence(f"g{k}", q.tobytes()) for k, q in enumerate(queries)]
    theirs = [JaxSequence(f"g{k}", q.tobytes()) for k, q in enumerate(queries)]
    for s in ours + theirs:
        s.compact()
    shipper = QueryShipper(9, CPU, group_rows=4)
    for s in ours:
        shipper.add_seq(s)
    for lo, hi in ((0, 4), (4, 8), (8, 9)):
        got = shipper.take(lo, hi)
        packed, bases, seps, _key = jax_payload(theirs[lo:hi])
        assert _words(got).tobytes() == packed.tobytes()
        assert np.array_equal(got.bases, bases) and np.array_equal(got.seps, seps)
    # a feeder on the unpacked bytes builds the host pileup's counts from them
    feeder = DeviceRowFeeder(9, ref_len, CPU, shipper=shipper)
    for lo in range(0, 9, 4):
        feeder.feed([s.as_array() for s in ours[lo:lo + 4]], homologies[lo:lo + 4])
    subs, homs = feeder.finish()
    es, eh = pair_counts_numpy(build_pileup(queries, homologies, ref_len))
    assert np.array_equal(subs, es) and np.array_equal(homs, eh)
    assert (feeder.taken, feeder.repacked) == (3, 0)
    shipper.stop()


def test_a_group_cut_by_row_groups_ships_as_the_feeder_cuts_it(rng, monkeypatch):
    queries, homologies, ref_len = panel(rng, 10, 600)
    lengths = [len(q) for q in queries]
    # an int32 limit that cuts each 5-genome group in two or three
    limit = 3 * max(lengths)
    monkeypatch.setattr(pileup_device, "_MAX_GROUP_BASES", limit + 2 * ref_len + 1)
    # the file-size bound of the reference's length: above the real one
    bound = ref_len + 40
    cuts = [(lo + a, lo + b) for lo in (0, 5)
            for a, b in pileup_device.row_groups(lengths[lo:lo + 5], bound, 5)]
    assert len(cuts) > 2
    shipper = QueryShipper(10, CPU, group_rows=5, ref_len_bound=bound)
    for q in queries:
        shipper.add(q)
    for lo, hi in cuts:
        got = shipper.take(lo, hi)
        assert got is not None
        assert _words(got).tobytes() == group_payload(queries[lo:hi])[0].tobytes()
    assert shipper.take(0, 5) is None  # the uncut group was never shipped
    feeder = DeviceRowFeeder(10, ref_len, CPU, shipper=shipper)
    for lo in (0, 5):
        feeder.feed(queries[lo:lo + 5], homologies[lo:lo + 5])
    subs, homs = feeder.finish()
    es, eh = pair_counts_numpy(build_pileup(queries, homologies, ref_len))
    assert np.array_equal(subs, es) and np.array_equal(homs, eh)
    assert feeder.groups == feeder.taken == len(cuts) and feeder.repacked == 0
    shipper.stop()


def test_boundary_miss_and_cancel(rng):
    queries, homologies, ref_len = panel(rng, 10, 700)
    shipper = QueryShipper(10, CPU, group_rows=4)
    for q in queries[:4]:
        shipper.add(q)
    assert shipper.take(0, 4) is not None
    assert shipper.take(1, 5) is None and shipper.take(0, 3) is None  # misses
    shipper.cancel()
    for q in queries[4:]:
        shipper.add(q)  # ignored after cancel
    assert shipper.take(4, 8) is None
    assert shipper.take(0, 4) is not None  # shipped groups stay takeable
    assert shipper.drain(0.1)  # all it queued before the cancel shipped
    assert shipper.shipped_groups() == 1
    feeder = DeviceRowFeeder(10, ref_len, CPU, shipper=shipper)
    for lo in range(0, 10, 4):
        feeder.feed(queries[lo:lo + 4], homologies[lo:lo + 4])
    subs, homs = feeder.finish()
    es, eh = pair_counts_numpy(build_pileup(queries, homologies, ref_len))
    assert np.array_equal(subs, es) and np.array_equal(homs, eh)
    assert (feeder.taken, feeder.repacked) == (1, 2)
    assert feeder.ship_account() == {"groups": 1, "mb": 0.0, "mb_s": None,
                                     "taken": 1, "repacked": 2, "cache_hits": 0}


class Injected(RuntimeError):
    pass


def test_a_worker_error_is_raised_by_the_feeders_finish(rng, monkeypatch):
    queries, homologies, ref_len = panel(rng, 8, 500)
    err = Injected("pinned allocation failed (injected)")
    calls = []

    def failing(items):
        calls.append(len(items))
        if len(calls) == 2:
            raise err
        return group_payload(items)

    monkeypatch.setattr(query_ship, "group_payload", failing)
    shipper = QueryShipper(8, CPU, group_rows=4)
    for q in queries:
        shipper.add(q)
    assert not shipper.drain(10.0)
    assert shipper.error() is err
    feeder = DeviceRowFeeder(8, ref_len, CPU, shipper=shipper)
    for lo in (0, 4):
        feeder.feed(queries[lo:lo + 4], homologies[lo:lo + 4])
    with pytest.raises(Injected) as raised:
        feeder.finish()
    assert raised.value is err
    shipper.stop()


def test_take_waits_for_a_queued_group(rng, monkeypatch):
    queries, _, _ = panel(rng, 4, 300)
    gate = threading.Event()

    def slow(items):
        assert gate.wait(60)
        return group_payload(items)

    monkeypatch.setattr(query_ship, "group_payload", slow)
    shipper = QueryShipper(4, CPU, group_rows=4)
    for q in queries:
        shipper.add(q)
    got = []
    taker = threading.Thread(target=lambda: got.append(shipper.take(0, 4)))
    taker.start()
    taker.join(0.3)
    assert taker.is_alive()  # waits, does not miss
    gate.set()
    taker.join(60)
    assert not taker.is_alive() and got[0] is not None
    shipper.stop()


def _run(main, args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--progress=never", *args])
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def golden_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden_panel_shipped")
    return write_panel(str(d)), str(d)


def _passes(monkeypatch):
    """Record LAST_RUN_INFO after each pass of the CLI's pipeline."""
    import phylonium_tpu_torch.cli as cli
    from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO

    passes = []
    process = cli.process

    def recorded(*args, **kwargs):
        counts = process(*args, **kwargs)
        passes.append(json.loads(json.dumps(LAST_RUN_INFO)))
        return counts

    monkeypatch.setattr(cli, "process", recorded)
    return passes


@pytest.mark.parametrize("name,env", [
    ("default", {}),
    ("dist_ani", {}),
    ("two_pass", {}),
    ("default", {"PHYLONIUM_TPU_LOWMEM": "force"}),
    ("two_pass", {"PHYLONIUM_TPU_LOWMEM": "force"}),
], ids=["default", "dist_ani", "two_pass", "lowmem", "lowmem_two_pass"])
def test_shipped_cli_reproduces_golden_fixture(name, env, golden_files, monkeypatch):
    from phylonium_tpu_torch.cli import main

    files, tmp = golden_files
    monkeypatch.chdir(tmp)
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    monkeypatch.setenv("PHYLONIUM_TPU_RD_SEED", str(RD_SEED))
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    packs = []

    def counted(items):
        packs.append(len(items))
        return group_payload(items)

    monkeypatch.setattr(query_ship, "group_payload", counted)
    passes = _passes(monkeypatch)
    rc, out = _run(main, ["--device", "cpu", *GOLDEN_CASES[name], *files])
    assert rc == 0
    with open(os.path.join(GOLDEN_DIR, f"{name}.stdout"), "rb") as f:
        assert out.encode() == f.read()
    assert len(passes) == (2 if "-2" in GOLDEN_CASES[name] else 1)
    groups = 4  # 29 genomes in groups of 8
    for info in passes:
        assert info["stream_groups"] == groups
        assert info["early_ship"]["groups"] == groups
        assert info["early_ship"]["taken"] == groups
        assert info["early_ship"]["repacked"] == 0
        assert info["early_ship"]["mb_s"] is None  # no copy on the CPU
        assert ("lowmem" in info) == bool(env)
    # pass 2 took the groups pass 1 shipped: each was packed once
    assert len(packs) == (0 if env else groups)  # compacted genomes reuse their packs


def test_shipped_two_pass_equals_the_jax_cli(tmp_path, monkeypatch):
    """A panel whose second pass picks another reference: pass 2 builds from
    the groups shipped before pass 1, and the output is the JAX CLI's."""
    from phylonium_tpu.cli import main as jax_main
    from phylonium_tpu_torch.cli import main
    from pileup_cases import write_fasta_panel

    files = write_fasta_panel(tmp_path, 11, 3000, seed=21, contigs=2)
    rc0, reference = _run(jax_main, ["-2", *files])
    assert rc0 == 0
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "4")
    passes = _passes(monkeypatch)
    rc, out = _run(main, ["-2", "--device", "cpu", *files])
    assert rc == 0 and out == reference
    assert len(passes) == 2
    for info in passes:
        assert info["early_ship"] == {"groups": 3, "mb": 0.0, "mb_s": None,
                                      "taken": 3, "repacked": 0, "cache_hits": 0}


def test_run_records_map_rate_and_the_run_report_fields(tmp_path, monkeypatch):
    """The calibration file in tmp_path holds map_gbps after a run (the
    0.2 s noise floor lowered for a small panel), and the run report
    carries the snapshot the gates read."""
    from phylonium_tpu_torch.cli import main
    from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO
    from phylonium_tpu_torch.utils import calibration
    from pileup_cases import write_fasta_panel

    path = tmp_path / "calibration.json"
    monkeypatch.setenv("PHYLONIUM_TPU_CALIBRATION_FILE", str(path))
    monkeypatch.setattr(calibration, "_MIN_SECONDS", 0.0)
    files = write_fasta_panel(tmp_path, 9, 2400, seed=17)
    for stream in ("0", "force"):
        monkeypatch.setenv("PHYLONIUM_TPU_STREAM", stream)
        rc, _ = _run(main, ["--device", "cpu", *files])
        assert rc == 0
        data = json.loads(path.read_text())
        assert data["map_gbps"] > 0
        assert LAST_RUN_INFO["calibration"]["map_gbps"] > 0
    assert data["samples"]["map_gbps"] == 2
    assert "link_mb_s" not in data  # the CPU copies nothing
