"""The port's pileup build (plain PyTorch route) against the JAX package.

The same host prep (``phylonium_tpu.ops.pileup_prep``) feeds the JAX
package's XLA program (``dispatch_build_packed``, on the CPU) and the
port's ``build_packed_rows`` on a CPU tensor; both must equal, byte for
byte, ``pack_states(build_pileup(...))`` at the port's aligned width.

The three routes that fill a ``DevicePanel`` (the in-process feeder, the
device server's pass, ``build_pileup_device``) give the host pileup's
packed bytes and counts for the same groups; ``ops.states.to_device``'s
timed copy on the CPU.
"""

import numpy as np
import pytest
import torch

from phylonium_tpu_torch.config import ConfigError
from phylonium_tpu.core.pileup import INVALID, build_pileup
from phylonium_tpu.ops.match_table import pair_counts_numpy
from phylonium_tpu.ops.pileup_device import dispatch_build_packed
from phylonium_tpu.ops.pileup_prep import build_overlay, group_payload, prep_intervals
from phylonium_tpu.ops.shapes import pack_states
from phylonium_tpu_torch.core.query_ship import QueryShipper
from phylonium_tpu_torch.core.stream import DeviceRowFeeder
from phylonium_tpu_torch.ops import pair_count, pileup_device
from phylonium_tpu_torch.ops.shapes import _PACKED_PAD
from phylonium_tpu_torch.ops.states import pack_rows, packed_width, to_device
from phylonium_tpu_torch.serve import daemon
from pileup_cases import ACGT, EDGE_CASES, panel, raw

CPU = torch.device("cpu")


def _port_rows(queries, homologies, ref_len, pad_rows=0):
    """The port's plain build of one group, plus ``pad_rows`` record-less
    rows, into a fresh [rows, W] tensor."""
    packed, bases, seps = group_payload(queries)
    intervals = prep_intervals(homologies, bases, ref_len, pad_rows)
    overlay = build_overlay(intervals, queries, bases, seps, ref_len)
    rows = intervals.shape[0]
    out = torch.zeros((rows, packed_width(ref_len)), dtype=torch.uint8)
    offsets, cols, vals = pileup_device.sort_overlay(overlay, rows)
    before = pileup_device.PLAIN_CALLS, pileup_device.KERNEL_LAUNCHES
    pileup_device.build_packed_rows(
        torch.from_numpy(packed.view(np.int32)), torch.from_numpy(intervals),
        tuple(map(torch.from_numpy, (offsets, cols, vals))), ref_len, out,
    )
    assert (pileup_device.PLAIN_CALLS, pileup_device.KERNEL_LAUNCHES) == (
        before[0] + 1, before[1])
    return out.numpy(), (packed, intervals, overlay)


def _check_against_jax_and_host(queries, homologies, ref_len, pad_rows=0,
                                host_homologies=None):
    got, (packed, intervals, overlay) = _port_rows(
        queries, homologies, ref_len, pad_rows
    )
    width = packed_width(ref_len)
    rows = len(queries) + pad_rows
    jax_rows = np.asarray(dispatch_build_packed(
        packed, intervals, overlay, ref_len, -(-ref_len // 2), width
    ))
    np.testing.assert_array_equal(got, jax_rows)
    states = build_pileup(queries, host_homologies or homologies, ref_len)
    np.testing.assert_array_equal(got, pack_states(states, rows, width))


@pytest.mark.parametrize("ref_len,pad_rows", [(301, 0), (700, 3), (2600, 1)])
def test_plain_build_equals_jax_and_host(rng, ref_len, pad_rows):
    queries, homologies, _ = panel(rng, 7, ref_len)
    _check_against_jax_and_host(queries, homologies, ref_len, pad_rows)


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_plain_build_edge_cases(rng, name):
    """The edge shapes the card holds the kernel to (chip_smoke.py phase
    9, tests/test_torch_pileup_device_cuda.py): the tilings at every
    alignment mod 16 with separators, a zero-length record mid-list,
    overlay entries on both nibbles of a byte, empty rows, 1 and 300
    rows."""
    _check_against_jax_and_host(*EDGE_CASES[name](rng))


def test_plain_build_raw_homology_arrays(rng):
    queries, homologies, _ = panel(rng, 9, 900)
    _check_against_jax_and_host(
        queries, [raw(hv) for hv in homologies], 900,
        host_homologies=homologies,
    )


@pytest.mark.parametrize("ref_len", [1, 2, 33])
def test_plain_build_all_empty_rows(rng, ref_len):
    """Rows without records are INVALID in both nibbles, at every width."""
    queries = [rng.choice(ACGT, 50).astype(np.uint8) for _ in range(3)]
    got, _ = _port_rows(queries, [[], [], []], ref_len, pad_rows=2)
    assert got.shape == (5, packed_width(ref_len))
    assert (got == INVALID | INVALID << 4).all()
    _check_against_jax_and_host(queries, [[], [], []], ref_len)


def test_plain_build_writes_only_its_row_slice(rng):
    """A group's rows land in a slice of a larger panel; the other rows
    keep what they held."""
    queries, homologies, ref_len = panel(rng, 4, 513)
    want, _ = _port_rows(queries, homologies, ref_len)
    inputs = pileup_device.prepare_group(queries, homologies, ref_len)
    panel_rows = torch.full((9, packed_width(ref_len)), 7, dtype=torch.uint8)
    pileup_device.build_packed_rows(
        *(torch.from_numpy(a) for a in inputs[:2]),
        tuple(torch.from_numpy(a) for a in inputs[2:]), ref_len,
        panel_rows[3:7],
    )
    np.testing.assert_array_equal(panel_rows[3:7].numpy(), want)
    assert (panel_rows[:3] == 7).all() and (panel_rows[7:] == 7).all()


def test_plain_build_writes_only_its_row_slice_across_tiles(rng):
    """The card test's tile-crossing group (records across the kernel's
    tile edges) written at row offset 3 of a larger panel."""
    queries, homologies, ref_len = EDGE_CASES["records_across_tile_edges"](rng)
    want, _ = _port_rows(queries, homologies, ref_len)
    inputs = pileup_device.prepare_group(queries, homologies, ref_len)
    rows = len(queries)
    panel_rows = torch.full((rows + 5, packed_width(ref_len)), 7, dtype=torch.uint8)
    pileup_device.build_packed_rows(
        *(torch.from_numpy(a) for a in inputs[:2]),
        tuple(torch.from_numpy(a) for a in inputs[2:]), ref_len,
        panel_rows[3 : 3 + rows],
    )
    np.testing.assert_array_equal(panel_rows[3 : 3 + rows].numpy(), want)
    assert (panel_rows[:3] == 7).all() and (panel_rows[3 + rows :] == 7).all()


@pytest.mark.parametrize("extra", [0, 5, 16 + 3])
def test_plain_build_at_widths_off_the_16_byte_grid(rng, extra):
    """Rows of l2 + ``extra`` bytes, as the card test builds them: equal to
    the JAX program and the host pileup at that width."""
    queries, homologies, ref_len = EDGE_CASES["records_across_tile_edges"](rng)
    width = -(-ref_len // 2) + extra
    packed, bases, seps = group_payload(queries)
    intervals = prep_intervals(homologies, bases, ref_len)
    overlay = build_overlay(intervals, queries, bases, seps, ref_len)
    out = torch.zeros((len(queries), width), dtype=torch.uint8)
    pileup_device.build_packed_rows(
        torch.from_numpy(packed.view(np.int32)), torch.from_numpy(intervals),
        tuple(map(torch.from_numpy,
                  pileup_device.sort_overlay(overlay, len(queries)))),
        ref_len, out,
    )
    jax_rows = np.asarray(dispatch_build_packed(
        packed, intervals, overlay, ref_len, -(-ref_len // 2), width
    ))
    np.testing.assert_array_equal(out.numpy(), jax_rows)
    states = build_pileup(queries, homologies, ref_len)
    np.testing.assert_array_equal(out.numpy(), pack_states(states, len(queries), width))


def test_tiling_constants_match_the_kernel_source():
    """TILE_BYTES, RECORD_CHUNK and OVERLAY_CHUNK, from which the edge
    cases are built, are the kernel's own constants."""
    import pathlib
    import re

    src = (pathlib.Path(pileup_device.__file__).parent.parent / "csrc"
           / "pileup_build.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);", src).group(1))

    assert constant("kThreads") * constant("kBytesPerThread") == pileup_device.TILE_BYTES
    assert constant("kRecChunk") == pileup_device.RECORD_CHUNK
    assert constant("kOverlayChunk") == pileup_device.OVERLAY_CHUNK


def test_overlay_is_sorted_per_row():
    orow = np.array([2, 0, 2, 1 << 30, 0, 2], np.int32)
    ocol = np.array([9, 4, 1, 0, 3, 5], np.int32)
    oval = np.array([1, 2, 3, 0, 4, 5], np.uint8)
    offsets, cols, vals = pileup_device.sort_overlay((orow, ocol, oval), 3)
    assert offsets.tolist() == [0, 2, 2, 5]
    assert cols.tolist() == [3, 4, 1, 5, 9]
    assert vals.tolist() == [4, 2, 3, 5, 1]


class _Huge:
    def __len__(self):
        return 1 << 31


def test_int32_guard_refuses_a_huge_group():
    with pytest.raises(ConfigError, match="device pileup group exceeds int32 "
                       "indexing; use smaller row groups"):
        pileup_device.prepare_group([_Huge()], [[]], 1000)


def test_wrapper_refuses_bad_inputs(rng):
    queries, homologies, _ = panel(rng, 2, 100)
    inputs = pileup_device.prepare_group(queries, homologies, 100)
    words, intervals = (torch.from_numpy(a) for a in inputs[:2])
    overlay = tuple(torch.from_numpy(a) for a in inputs[2:])
    with pytest.raises(ValueError, match="fewer than 50"):
        pileup_device.build_packed_rows(
            words, intervals, overlay, 100, torch.zeros((2, 49), dtype=torch.uint8)
        )
    with pytest.raises(ValueError, match="intervals must be"):
        pileup_device.build_packed_rows(
            words, intervals, overlay, 100, torch.zeros((3, 64), dtype=torch.uint8)
        )
    with pytest.raises(ValueError, match="words must be"):
        pileup_device.build_packed_rows(
            words.to(torch.int64), intervals, overlay, 100,
            torch.zeros((2, 64), dtype=torch.uint8),
        )


# -- the three routes that fill a panel ----------------------------------------

# 13 genomes in groups of 5, 5 and 3
_GROUPS = ((0, 5), (5, 10), (10, 13))


def _by_feeder(queries, homologies, ref_len, monkeypatch):
    """The in-process feeder with three padding rows; its first group
    taken from the shipper's resident piece, the other two fed off the
    shipper's boundaries and packed here."""
    n = len(queries)
    shipper = QueryShipper(n, CPU, group_rows=5)
    for q in queries:
        shipper.add(q)
    feeder = DeviceRowFeeder(n, ref_len, CPU, rows=n + 3, shipper=shipper)
    for lo, hi in ((0, 5), (5, 9), (9, 13)):
        feeder.feed(queries[lo:hi], homologies[lo:hi])
    rows = feeder.built().numpy().copy()
    subs, homs = feeder.finish()
    shipper.stop()
    assert (feeder.groups, feeder.taken, feeder.repacked) == (3, 1, 2)
    assert feeder.panel.rows_built == n
    return rows, subs, homs


def _by_server(queries, homologies, ref_len, monkeypatch):
    """The device server's pass on a CPU ``_State``, driven through
    ``daemon._handle``: the first group's words parked by ``qgroup``, the
    other groups' words sent with them."""
    state = daemon._State(CPU)
    n = len(queries)
    packed, bases, seps = group_payload(queries[0:5])
    reply, _ = daemon._handle(state, {"op": "qgroup", "run": "r", "gidx": 0},
                              [packed.view(np.int32)])
    assert reply == {"ok": True, "seconds": None}
    for lo, hi in _GROUPS:
        header = {"op": "group", "run": "r", "gen": 1, "lo": lo, "rows": hi - lo,
                  "n": n, "ref_len": ref_len}
        if lo == 0:
            header["gidx"] = 0
            _, *arrays = pileup_device.prepare_group(
                queries[lo:hi], homologies[lo:hi], ref_len, resident=(None, bases, seps))
        else:
            words, *arrays = pileup_device.prepare_group(
                queries[lo:hi], homologies[lo:hi], ref_len)
            arrays.append(words)
        assert daemon._handle(state, header, arrays)[0] == {"ok": True}
    state.runs["r"].queue.join()
    rows = state.runs["r"].current.panel.ready().numpy().copy()
    reply, (subs, homs) = daemon._handle(state, {"op": "finish", "run": "r", "gen": 1,
                                                  "n": n}, [])
    assert reply["ok"]
    assert reply["launches"] == {"build": 0, "build_plain": 3, "count": 0, "count_plain": 1}
    return rows, subs, homs


def _by_pileup_device(queries, homologies, ref_len, monkeypatch):
    """The serial path's device pileup, in groups of 5."""
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM_GROUP", "5")
    before = pileup_device.PLAIN_CALLS
    rows = pileup_device.build_pileup_device(queries, homologies, ref_len, CPU)
    assert pileup_device.PLAIN_CALLS - before == 3
    subs, homs = pair_count.pair_counts_rows(rows)
    return rows.numpy(), subs, homs


@pytest.mark.parametrize("build", [_by_feeder, _by_server, _by_pileup_device],
                         ids=["feeder", "server", "build_pileup_device"])
def test_every_panel_route_gives_the_host_panel(rng, build, monkeypatch):
    """The same groups through each route into a ``DevicePanel``: the packed
    host pileup byte for byte (padding rows INVALID in both nibbles) and
    ``pair_counts_numpy``'s counts (padding rows count nothing)."""
    queries, homologies, ref_len = panel(rng, 13, 700)
    n = len(queries)
    rows, subs, homs = build(queries, homologies, ref_len, monkeypatch)
    np.testing.assert_array_equal(rows[:n], pack_rows(build_pileup(queries, homologies,
                                                                   ref_len)))
    assert (rows[n:] == _PACKED_PAD).all()
    es, eh = pair_counts_numpy(build_pileup(queries, homologies, ref_len))
    np.testing.assert_array_equal(subs[:n, :n], es)
    np.testing.assert_array_equal(homs[:n, :n], eh)
    assert not subs[n:].any() and not homs[n:].any()
    assert not subs[:, n:].any() and not homs[:, n:].any()


def test_the_timed_copy_on_the_cpu():
    """A CPU copy is the host tensor: untimed, and timed with no seconds
    and no event."""
    array = np.arange(10, dtype=np.int32)
    plain = to_device(array, CPU)
    tensor, seconds, event = to_device(array, CPU, timed=True)
    assert plain.device == tensor.device == CPU
    assert tensor.numpy().tolist() == plain.numpy().tolist() == list(range(10))
    assert seconds is None and event is None
