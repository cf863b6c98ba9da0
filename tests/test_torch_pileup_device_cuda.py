"""The CUDA pileup-build kernel, and the feeder around it, on a card.

Skips without a CUDA device. Imports nothing of jax, so it runs on a
machine with a card and no jax:

    PHYLONIUM_TPU_TEST_REAL=1 python -m pytest -m cuda tests/test_torch_pileup_device_cuda.py
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from phylonium_tpu.core.pileup import build_pileup
from phylonium_tpu.ops.match_table import pair_counts_numpy
from phylonium_tpu.ops.shapes import pack_states
from phylonium_tpu_torch.core.stream import DeviceRowFeeder
from phylonium_tpu_torch.ops import pair_count, pileup_device
from phylonium_tpu_torch.ops.states import pack_rows, packed_width
from pileup_cases import EDGE_CASES, panel, write_fasta_panel


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda")


def _on(device, queries, homologies, ref_len):
    inputs = pileup_device.prepare_group(queries, homologies, ref_len)
    tensors = [torch.from_numpy(a).to(device) for a in inputs]
    return tensors[0], tensors[1], tuple(tensors[2:])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_kernel_equals_plain_and_host(card, name):
    queries, homologies, ref_len = EDGE_CASES[name](np.random.default_rng(3))
    words, intervals, overlay = _on(card, queries, homologies, ref_len)
    rows, width = len(queries), packed_width(ref_len)
    got = torch.empty((rows, width), dtype=torch.uint8, device=card)
    plain = torch.empty_like(got)
    launches = pileup_device.KERNEL_LAUNCHES
    pileup_device.build_packed_rows(words, intervals, overlay, ref_len, got)
    pileup_device.build_packed_rows_reference(
        words, intervals, overlay, ref_len, plain
    )
    torch.cuda.synchronize()
    assert pileup_device.KERNEL_LAUNCHES == launches + 1
    assert torch.equal(got, plain)
    want = pack_states(build_pileup(queries, homologies, ref_len), rows, width)
    assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_kernel_writes_only_its_row_slice(card):
    queries, homologies, ref_len = panel(np.random.default_rng(4), 5, 1001)
    words, intervals, overlay = _on(card, queries, homologies, ref_len)
    full = torch.full((12, packed_width(ref_len)), 7, dtype=torch.uint8,
                      device=card)
    pileup_device.build_packed_rows(words, intervals, overlay, ref_len,
                                    full[6:11])
    want = torch.full_like(full, 7)
    pileup_device.build_packed_rows_reference(
        words, intervals, overlay, ref_len, want[6:11]
    )
    torch.cuda.synchronize()
    assert torch.equal(full, want)


@pytest.mark.cuda
def test_kernel_writes_only_its_row_slice_across_tiles(card):
    """A group whose records cross the kernel's tile edges, written at row
    offset 3 of a larger panel: the rows outside it keep their bytes."""
    queries, homologies, ref_len = EDGE_CASES["records_across_tile_edges"](
        np.random.default_rng(8)
    )
    words, intervals, overlay = _on(card, queries, homologies, ref_len)
    rows = len(queries)
    full = torch.full((rows + 5, packed_width(ref_len)), 7, dtype=torch.uint8,
                      device=card)
    want = full.clone()
    pileup_device.build_packed_rows(words, intervals, overlay, ref_len,
                                    full[3 : 3 + rows])
    pileup_device.build_packed_rows_reference(
        words, intervals, overlay, ref_len, want[3 : 3 + rows]
    )
    torch.cuda.synchronize()
    assert torch.equal(full, want)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [0, 5, 16 + 3])
def test_kernel_at_widths_off_the_16_byte_grid(card, extra):
    """Rows of l2 + ``extra`` bytes in one buffer, so rows start off a
    16-byte boundary and the kernel stores byte by byte there; the tile
    count's ragged end falls elsewhere in each row."""
    queries, homologies, ref_len = EDGE_CASES["records_across_tile_edges"](
        np.random.default_rng(9)
    )
    words, intervals, overlay = _on(card, queries, homologies, ref_len)
    width = -(-ref_len // 2) + extra
    got = torch.full((len(queries), width), 7, dtype=torch.uint8, device=card)
    want = got.clone()
    pileup_device.build_packed_rows(words, intervals, overlay, ref_len, got)
    pileup_device.build_packed_rows_reference(
        words, intervals, overlay, ref_len, want
    )
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_feeder_on_card_counts_equal_numpy(card):
    queries, homologies, ref_len = panel(np.random.default_rng(5), 12, 700)
    feeder = DeviceRowFeeder(12, ref_len, card)
    for lo, hi in ((0, 5), (5, 9), (9, 12)):
        feeder.feed(queries[lo:hi], homologies[lo:hi])
    subs, homs = feeder.finish()
    assert feeder.groups == 3
    es, eh = pair_counts_numpy(build_pileup(queries, homologies, ref_len))
    assert np.array_equal(subs, es) and np.array_equal(homs, eh)


def _cli(args):
    from phylonium_tpu_torch.cli import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--progress=never", "--device", "cuda", *args])
    return rc, out.getvalue()


@pytest.mark.cuda
def test_streamed_and_lowmem_cli_on_card(card, tmp_path, monkeypatch):
    from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO

    files = write_fasta_panel(tmp_path, 7, 20_000, seed=6, contigs=2)
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "0")  # in process: this process builds
    rc, serial = _cli(files)
    assert rc == 0
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "3")
    rc, streamed = _cli(files)
    assert rc == 0 and streamed == serial
    assert LAST_RUN_INFO["stream_groups"] == 3
    assert LAST_RUN_INFO["build_kernel_launches"] == 3
    assert LAST_RUN_INFO["build_plain_calls"] == 0
    assert LAST_RUN_INFO["kernel_launches"] == pair_count.LAUNCHES_PER_CALL
    monkeypatch.delenv("PHYLONIUM_TPU_STREAM")
    monkeypatch.delenv("PHYLONIUM_TPU_STREAM_GROUP")
    monkeypatch.setenv("PHYLONIUM_TPU_LOWMEM", "force")
    rc, low = _cli(files)
    assert rc == 0 and low == serial
    assert LAST_RUN_INFO["compare_carrier"] == "cuda-kernel"
    assert LAST_RUN_INFO["build_kernel_launches"] == LAST_RUN_INFO["stream_groups"] == 1


def _mapped_complete_deletion(tmp_path):
    """A small panel of drafts mapped natively by the port, after
    complete deletion: (queries, homologies, ref_len)."""
    from phylonium_tpu_torch.core.anchor_stats import min_anchor_length
    from phylonium_tpu_torch.core.complete_deletion import complete_delete
    from phylonium_tpu_torch.core.map_native import map_batch_native
    from phylonium_tpu_torch.data.sequence import gc_content, join
    from phylonium_tpu_torch.index.esa import ESAIndex
    from phylonium_tpu_torch.io.fasta import read_genome
    from phylonium_tpu_torch.utils.progress import ProgressBar

    files = write_fasta_panel(tmp_path, 11, 20_000, seed=7, contigs=3)
    genomes = [join(read_genome(f)) for f in files]
    ref = ESAIndex(genomes[0], backend="native")
    threshold = min_anchor_length(0.025, gc_content(genomes[0].nucl), ref.size)
    queries = [g.as_array() for g in genomes]
    bar = ProgressBar("", len(queries), enabled=False)
    homologies = complete_delete(
        map_batch_native(ref._native, queries, threshold, bar, 0)
    )
    return queries, homologies, len(genomes[0])


@pytest.mark.cuda
def test_device_pileup_panel_equals_plain_and_host(card, tmp_path, monkeypatch):
    """The serial path's device pileup (X2) through the kernel, with
    complete-deletion homologies: equal to the plain route's panel and to
    the host pileup, packed; one launch a group."""
    queries, homologies, ref_len = _mapped_complete_deletion(tmp_path)
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "4")
    launches = pileup_device.KERNEL_LAUNCHES
    got = pileup_device.build_pileup_device(queries, homologies, ref_len, card)
    assert pileup_device.KERNEL_LAUNCHES - launches == 3
    plain = pileup_device.build_pileup_device(
        queries, homologies, ref_len, torch.device("cpu")
    )
    assert torch.equal(got.cpu(), plain)
    host = pack_rows(build_pileup(queries, homologies, ref_len))
    assert np.array_equal(got.cpu().numpy(), host)


@pytest.mark.cuda
def test_device_pileup_cli_on_card(card, tmp_path, monkeypatch):
    from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO

    files = write_fasta_panel(tmp_path, 7, 20_000, seed=6, contigs=2)
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "0")  # in process: this process builds
    # the count pinned on the card: 'auto' would send so small a panel to
    # the host, and X2 builds only for a count on the card
    for flags in (["--count-backend", "device"],
                  ["--count-backend", "device", "--complete-deletion"]):
        monkeypatch.delenv("PHYLONIUM_TPU_DEVICE_PILEUP", raising=False)
        rc, serial = _cli([*flags, *files])
        assert rc == 0 and LAST_RUN_INFO["build_kernel_launches"] == 0
        monkeypatch.setenv("PHYLONIUM_TPU_DEVICE_PILEUP", "1")
        monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "3")
        rc, device = _cli([*flags, *files])
        assert rc == 0 and device == serial
        assert LAST_RUN_INFO["build_kernel_launches"] == 3
        assert LAST_RUN_INFO["build_plain_calls"] == 0
        assert LAST_RUN_INFO["compare_carrier"] == "cuda-kernel"
        assert LAST_RUN_INFO["kernel_launches"] == pair_count.LAUNCHES_PER_CALL
