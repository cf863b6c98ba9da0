"""The early query shipper and the feeder it serves, on a card.

Skips without a CUDA device. Imports nothing of jax, so it runs on a
machine with a card and no jax:

    PHYLONIUM_TPU_TEST_REAL=1 python -m pytest -m cuda tests/test_torch_query_ship_cuda.py

- the shipped words on the card equal the host pack (``group_payload``),
  for raw and compacted genomes, and a copy of at least 4 MB records its
  rate in the calibration store;
- a shipped feeder's panel equals, byte for byte, one built without the
  shipper, with one pileup-build launch a group and every group taken;
- the shipped CLI on the card prints the serial run's matrix.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from phylonium_tpu_torch.core.query_ship import QueryShipper
from phylonium_tpu_torch.core.stream import DeviceRowFeeder
from phylonium_tpu_torch.data.sequence import Sequence
from phylonium_tpu_torch.ops import pileup_device
from phylonium_tpu_torch.ops.pileup_prep import group_payload
from phylonium_tpu_torch.utils import calibration
from pileup_cases import panel, write_fasta_panel


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_resident_words_equal_the_host_pack(card, tmp_path, monkeypatch):
    path = tmp_path / "calibration.json"
    monkeypatch.setenv("PHYLONIUM_TPU_CALIBRATION_FILE", str(path))
    rng = np.random.default_rng(5)
    queries, _, _ = panel(rng, 9, 3000)
    big = [rng.choice(np.frombuffer(b"ACGT", np.uint8), 3_000_000) for _ in range(6)]
    shipper = QueryShipper(15, card, group_rows=9, store=calibration.for_device(card))
    for q in queries + big:
        shipper.add(q)
    for lo, hi, group in ((0, 9, queries), (9, 15, big)):
        got = shipper.take(lo, hi)
        assert got.words.device.type == "cuda" and got.event is not None
        want = group_payload(group)[0]
        assert got.words.cpu().numpy().tobytes() == want.tobytes()
    # the 6 x 3 Mbp group is 4.5 MB of codes: above the 4 MB noise floor
    assert json.loads(path.read_text())["link_mb_s"] > 0
    assert shipper.achieved_mb_s() > 0
    shipper.stop()

    seqs = [Sequence(f"g{k}", q.tobytes()) for k, q in enumerate(queries)]
    for s in seqs:
        s.compact()
    compacted = QueryShipper(9, card, group_rows=5)
    for s in seqs:
        compacted.add_seq(s)
    for lo, hi in ((0, 5), (5, 9)):
        got = compacted.take(lo, hi)
        packs = np.concatenate([s._packed for s in seqs[lo:hi]])
        assert got.words.cpu().numpy().view(np.uint8)[: len(packs)].tobytes() == packs.tobytes()
    compacted.stop()


@pytest.mark.cuda
def test_a_shipped_feeder_builds_the_unshipped_panel(card):
    queries, homologies, ref_len = panel(np.random.default_rng(6), 20, 5000)
    shipper = QueryShipper(20, card, group_rows=6)
    for q in queries:
        shipper.add(q)
    panels = []
    for ship in (None, shipper):
        launches = pileup_device.KERNEL_LAUNCHES
        feeder = DeviceRowFeeder(20, ref_len, card, shipper=ship)
        for lo in range(0, 20, 6):
            feeder.feed(queries[lo:lo + 6], homologies[lo:lo + 6])
        panels.append(feeder.built().cpu())
        assert pileup_device.KERNEL_LAUNCHES - launches == feeder.groups == 4
        if ship is not None:
            assert (feeder.taken, feeder.repacked) == (4, 0)
    assert torch.equal(panels[0], panels[1])
    shipper.stop()


@pytest.mark.cuda
def test_shipped_cli_on_the_card(card, tmp_path, monkeypatch):
    from phylonium_tpu_torch.cli import main
    from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO

    monkeypatch.setenv("PHYLONIUM_TPU_CALIBRATION_FILE", str(tmp_path / "c.json"))
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "0")  # in process: this process ships
    files = write_fasta_panel(tmp_path, 11, 4000, seed=12, contigs=2)
    outs = []
    for stream in ("0", "force"):
        monkeypatch.setenv("PHYLONIUM_TPU_STREAM", stream)
        monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "4")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["--progress=never", "--device", "cuda", *files]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    ship = LAST_RUN_INFO["early_ship"]
    assert ship["groups"] == ship["taken"] == LAST_RUN_INFO["build_kernel_launches"] == 3
    assert ship["repacked"] == 0 and LAST_RUN_INFO["compare_carrier"] == "cuda-kernel"
