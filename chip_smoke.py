#!/usr/bin/env python3
"""Smoke run of the torch port (phylonium_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --devd-turns PAIRS   # phases 1-2, then only the
                                               # default route (the device
                                               # server) against in-process
    python3 chip_smoke.py --startup-turns PAIRS --parent DIR
                                               # phases 1-2, then phase 21's
                                               # (a), (c), (d) against the
                                               # parent commit's tree in DIR

Phases, each printed with its wall time; any failure ends the run with a
non-zero exit and no result line:

1. describe the card (needs torch.cuda.is_available()); build the port's
   native host library, whose build picks a C++ compiler with OpenMP
   (``$CXX``, else g++) and keys the library by sources, flags, compiler
   and CPU (``phylonium_tpu_torch/native/build.py``), and the JAX
   package's with the same compiler;
2. build the CUDA kernels from phylonium_tpu_torch/csrc with nvcc;
3. hold the pair-count kernel against its plain PyTorch version, bit for
   bit, at edge shapes (tiny and ragged N, odd L, all-INVALID rows,
   symmetric and rectangular calls);
4. the same at the main path's production shapes, 29 x 5 Mbp and
   600 x 1 Mbp, also against ``torch._int_mm`` on the one-hot operands
   (the library yardstick), with the kernel's, the plain version's and
   the library call's times and the kernel's bound; and one count of the
   29 x 5 Mbp rows in column chunks (``_MAX_WIDTH`` patched to a few
   ``ROW_ALIGN``s), equal bit for bit to the one-call count;
5. hold the diagonal-mismatch kernel against its plain PyTorch version,
   word for word, at edge shapes (lengths 1 to 2^19, unaligned offsets
   and offsets at the text end, a limit of 0, 1 and 300 jobs, identical
   texts) and at the kernel's own edges of tests/extend_cases.py (offsets
   at all 16 x 16 residues mod 16, lengths 1, 31, 32, 33 and 2^19 + 5, an
   end inside a word, texts shorter than one 16-byte load, more jobs than
   one grid row), each with the texts at the start of their buffers and
   3 and 13 bytes into them;
6. the same at its production shapes, 128 jobs x 2^19 over a 5 Mbp
   genome's doubled text and 8 jobs x 2^19 of a hybrid round, with both
   times and the bound of each;
7. end to end: an eco29-shaped panel (29 genomes x 5 Mbp) through the
   port's CLI on the card, whose PHYLIP output must equal, byte for byte,
   the JAX package's CLI with host counting (a jax-free subprocess);
8. end to end with hybrid mapping: an outbreak-shaped panel (8 genomes x
   5 Mbp at 0.2-2 %) through the port's CLI with ``--map-backend hybrid``
   on the card, byte for byte against the same reference CLI (native
   mapping, host counting);
9. hold the pileup-build kernel against its plain PyTorch version, byte
   for byte, at edge shapes (ref_len 1 and 2, odd and even lengths,
   records at every alignment, reverse records, separators, a row with no
   records, overlay entries on both nibbles of a byte, groups of 1 and
   300 rows, records across the kernel's tile edges and longer than a
   tile, more records and overlay entries in a span than it stages at
   once, records at the ends of the query codes, and a write into a row
   slice of a larger panel);
10. the same at its production shapes, one streamed group of the
    116 x 5 Mbp panel (29 rows) and one low-memory group of the
    1000 x 1 Mbp panel (128 rows), mapped by the native mapper, with both
    times, the bytes written per second and the bound;
11. streamed end to end: a 116 x 5 Mbp eco29-shaped panel through the
    port's CLI with ``PHYLONIUM_TPU_STREAM=force``, byte for byte against
    the port's serial run (which phase 7 holds against the JAX package),
    in the order serial, streamed, streamed, serial, with both runs'
    phase timings;
12. the serial path's device pileup (X2) end to end: the 29 x 5 Mbp
    panel through the port's CLI with ``PHYLONIUM_TPU_DEVICE_PILEUP=1``,
    plain and with ``--complete-deletion``, each byte for byte against the
    JAX package's CLI with host counting and the same flags, one build
    launch a group; then the host pileup and X2 timed in turns (host, X2,
    X2, host) in this process at 29 x 5 Mbp, with each run's phase
    timings;
13. ``--profile``: the 29 x 5 Mbp panel with ``--profile=DIR`` and X2 on
    the card; the trace must hold the phase ranges and one device event
    for each pair-count and pileup-build launch, the prewarm's included;
    prints the card's busy time (the union of device kernel intervals), the
    traced wall and the idle share, and whether the feeder worker's ranges
    are in the trace;
14. low-memory end to end: a 1000 x 1 Mbp panel through the port's CLI
    with ``PHYLONIUM_TPU_LOWMEM=force`` and with the serial pipeline, each
    in a child process whose peak RSS is printed, byte for byte;
15. the X5 shard kernel (``pt_diagonal_neq_shard``): at the edges of
    tests/extend_cases.py split into 2, 3 and 4 shards, each shard's words
    against its plain version and their OR against the unsharded kernel
    (K3); then at phase 6's production shapes, 128 x 2^19 and 8 x 2^19 over
    a 5 Mbp genome's doubled text in 4 shards on the card, word for word
    against the plain version and K3, with the times and the bound;
16. hybrid mapping with X5: phase 8's 8 x 5 Mbp panel through the port's
    CLI with ``PHYLONIUM_TPU_SHARDED_EXTEND=1`` and ``shard_devices``
    patched to four shards on the card, byte for byte against the
    reference CLI, every round through the shard kernel;
17. the counting mesh (X3s): the per-rank pair count at the 2 x 2 mesh's
    cell shape of the 29 x 5 Mbp panel against its plain version and
    ``torch._int_mm``, with times and bound; a 1-rank NCCL world (a child
    process) counting 600 x 1 Mbp with ``pair_counts_sharded``, equal to
    ``pair_counts_rows``; then a gloo world of 4 rank processes sharing
    the card runs the 29 x 5 Mbp panel through the port's CLI with
    ``--mesh 2,2``: rank 0's stdout must equal phase 7's JAX host-counted
    output byte for byte, the other ranks print nothing, and each rank's
    phase timings, pair-count launches and collective bytes (predicted and
    measured) are printed;
18. the pod streamed path (``parallel/stream_mp.py``): the pileup-build
    kernel at one rank's group (8 x 5 Mbp) and the pair count at the
    (4, 1) mesh's cell of the 29 x 5 Mbp panel, each against its plain
    version, with times and bound; then the 29 x 5 Mbp panel through the
    port's CLI without ``--mesh`` in 4 gloo rank processes sharing the
    card, in turns by the default gate (pod streamed), with
    ``PHYLONIUM_TPU_STREAM=0`` (the serial pod route) and with
    ``PHYLONIUM_TPU_STREAM_GROUP=4``: rank 0 byte for byte against
    phase 7's reference, the others silent, every streamed rank one build
    launch a group of its block and its pair-count launches, no plain
    call, collective bytes as predicted, each rank's phases and compare
    steps and each world's wall printed; the first 5 genomes in 4 ranks
    under ``PHYLONIUM_TPU_STREAM=force`` (the last rank's block pure
    padding) against the reference CLI on those files; and a fresh
    single-process CLI child's device prewarm, its seconds and the run's
    wait for it;
19. the 'auto' dispatch: the dispatch model's constants on the card's
    machine, in turns on the host pileup of phase 11's panel (the host
    count against the card's serial count from 8 to 464 rows, equal bit
    for bit; the work above which the card wins; the host count's Gbp/s
    at 29 and 116 rows; the native mapper's rate; at 29 rows the serial
    route's pack, copy and resident count); one 29 x 5 Mbp group shipped
    by the early query shipper, its words on the card equal to the host
    pack and its pileup-build kernel's panel equal, byte for byte, to the
    unshipped one, with the kernel's time and the feeder's host prep with
    and without the resident codes; then the port's CLI in this process
    (``PHYLONIUM_TPU_DEVD=0``) with no other routing variable on one
    calibration store that starts empty: 3 x 100 kbp,
    29 x 5 Mbp, 116 x 5 Mbp and 600 x 1 Mbp by the static rule, then
    29 x 5 Mbp, 116 x 5 Mbp and 3 x 100 kbp by the measured models, each
    byte for byte against the JAX package's CLI with host counting, with
    the store it read, the models' decisions and the route: no launch on
    the host route, every fed group taken from the shipper (none
    repacked), one build launch a group and one count call when streamed;
20. the device server (``serve/``, ``PHYLONIUM_TPU_DEVD=1``), every run a
    CLI child process and every daemon on a socket in the phase's
    directory: phase 11's 116 x 5 Mbp panel under
    ``PHYLONIUM_TPU_STREAM=force``, a cold run that spawns the daemon (4
    groups shipped, 0 hits), then two warm runs through it (4 hits, 0
    bytes; phase 22 and ``--devd-turns`` hold the routes against each
    other); the 29 x 5 Mbp panel with ``-2`` (pass 2 built from the
    pieces pass 1 parked) and under
    ``PHYLONIUM_TPU_LOWMEM=force``; every run byte for byte against the
    JAX package's CLI with host counting, the daemon's build and
    pair-count launches reported, and no devd run's CLI process
    initializing CUDA; each run's wall, ``devd_count_s``, the client's
    wait for ``finish`` (the devd tail of ``_stream_predicts_win``), cache
    hits, MB shipped and the daemon's ``memory_reserved``; then, at 6 x
    200 kbp, an injected poison (exit 1, the server named, the daemon
    gone, the next run right) and a daemon SIGKILLed after its first
    ``group`` reply (non-zero exit, no matrix, no hang); no daemon
    outlives the phase;
21. lazy startup: CLI children through the port's entry point (``python
    -m phylonium_tpu_torch``), each wall split into start, imports,
    ``cli.main`` and exit: (a) the 29 x 5 Mbp panel with no routing
    variable on an empty calibration store (the static rule counts it on
    the host) and (b) with ``--count-backend host``; (c) the 116 x 5 Mbp
    panel through a warm device server (after the cold run that spawned
    it); all under ``PHYLONIUM_TPU_EXPECT_NO_TORCH=1``, none importing
    torch or initializing CUDA; (d) the same panel in process
    (``PHYLONIUM_TPU_DEVD=0``), streamed: one X1 launch a
    group and one pair-count call, no plain call; every run byte for byte
    against the JAX package's host count; then ``python -X importtime`` of
    the CLI, torch and the device modules;
22. the default route: an in-process run of the 29 x 5 Mbp panel fills a
    calibration store with a copy rate; then the 116 x 5 Mbp panel with no
    routing variable on that store, cold (the run spawns the daemon on a
    socket in the phase's directory) and warm (it reuses it), both under
    ``PHYLONIUM_TPU_EXPECT_NO_TORCH=1``: the server's branch of the stream
    model decides, the daemon launches X1 once a group and the pair count
    once, the CLI makes no CUDA context; then, the daemon stopped, the
    panel with ``PHYLONIUM_TPU_DEVD=0`` in process; each byte for byte
    against the JAX package's host count;
23. no daemon left: no live pidfile and no live daemon in a socket's log
    under the script's directories, and none on the card's default socket
    that was not there when the script started;
24. the local counting mesh (a process of one rank spanning its cards,
    here cells on the one card with ``utils.platform.local_devices``
    patched): (a) ``pair_counts_sharded`` on local meshes (2, 2) at
    29 x 5 Mbp, (1, 4) and (2, 2) at 600 x 1 Mbp, each bit for bit against
    ``pair_counts_rows``, K2 twice a cell, collective bytes as predicted,
    in turns mesh, one device, one device, mesh with each step's wall;
    (b) the port's CLI in this process with ``--mesh 2,2`` on four cells on
    the card at 29 x 5 Mbp, byte for byte against phase 7's reference, the
    run report's mesh backend "local", 8 pair-count launches, no plain
    call; (c) 'auto' with the CUDA driver's count and the local devices
    patched to two cells, on phase 19's 600 x 1 Mbp panel with the default
    route on an empty store: the serial route onto the (1, 2) local mesh,
    no stream group, no shipper, no device server, byte for byte against
    the JAX package's host count; (d) unpatched, in a child, ``--mesh 2,2``
    on the one card exits 1 with the JAX package's sentence and an empty
    stdout; each part's time.

Each phase runs with a calibration store of its own in a temporary
directory (``PHYLONIUM_TPU_CALIBRATION_FILE``); the phases that drive one
route pin it (``--count-backend device``, ``PHYLONIUM_TPU_STREAM``), since
'auto' routes by the dispatch model. A single-process run on the card
sends its streamed and low-memory work to the device server by default,
so every run meant in process pins ``PHYLONIUM_TPU_DEVD=0``
(``IN_PROCESS``: the runs in this process, ``run_child``'s children, the
in-process sides of phases 20 to 22 and of the turns), and every run that
may take the server has its socket in a directory of the script's own.

The last lines are the kernel table as JSON (per kernel: launches on its
main path, the largest error, the kernel's, the plain version's and the
library call's times, and ``bound_ms``, the least time the card could take
for the same work: bytes moved over 3.35 TB/s or operations over their
peak rate, whichever is larger), the card's name and power limit as
nvidia-smi prints them, and the device JSON. Everything the port runs
here, host layer included, is the port's own: the only use of the JAX
package is its CLI in a subprocess, as the reference output.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

KERNEL_SOURCE = "phylonium_tpu_torch/csrc/pair_count.cu"
# the TPU kernels it replaces: _count_kernel_packed (N <= 512) and
# _cross_kernel_packed (the N > 512 panels)
REPLACES = "phylonium_tpu/ops/pallas_match.py:108"
ALSO_REPLACES = "phylonium_tpu/ops/pallas_match.py:217"

EXTEND_SOURCE = "phylonium_tpu_torch/csrc/diagonal_neq.cu"
# the Pallas kernel's body, and the XLA op the JAX hybrid mapper calls
EXTEND_REPLACES = "phylonium_tpu/ops/anchor_extend_pallas.py:46"
EXTEND_ALSO_REPLACES = "phylonium_tpu/ops/anchor_extend.py:114"
CHUNK = 1 << 19  # the hybrid mapper's request length (DEFAULT_CHUNK)

BUILD_SOURCE = "phylonium_tpu_torch/csrc/pileup_build.cu"
# the XLA program of the streamed feeder, and its build core
BUILD_REPLACES = "phylonium_tpu/ops/pileup_device.py:198"
BUILD_ALSO_REPLACES = "phylonium_tpu/ops/pileup_device.py:124"

SHARD_REPLACES = "phylonium_tpu/ops/anchor_extend_sharded.py:58"
SHARDS = 4  # X5's shards on the one card
SHARD_TILE = 2048  # the hybrid mapper's halo (core/hybrid_map.py _TILE)

MESH_REPLACES = "phylonium_tpu/parallel/distributed.py:34"

INVALID = 10

# the collective byte counts of parallel/distributed.py's comm_account
_COMM_KEYS = ("gather_recv_bytes", "psum_bytes", "result_gather_recv_bytes")


@contextlib.contextmanager
def phase(name: str):
    """Time a phase; its runs read and write a calibration store of their
    own, in a temporary directory, so no phase's routes depend on another's
    or on the machine's history."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_calibration_") as tmp, \
            env_set(PHYLONIUM_TPU_CALIBRATION_FILE=os.path.join(tmp, "calibration.json")):
        yield
    print(f"phase {name}: ok in {time.perf_counter() - t0:.3f} s", flush=True)


def port_host_library() -> dict:
    """Build (or load) the port's native host library: its build picks
    the compiler (``$CXX`` if it builds OpenMP code, else g++) and keys
    the file by sources, flags, compiler and CPU. Returns its BUILD_INFO."""
    from phylonium_tpu_torch.native import build as native_build

    native_build.ensure_built()
    return dict(native_build.BUILD_INFO)


def reference_env() -> dict:
    """The environment of a JAX-package subprocess: the repo on the path,
    and CXX set to the compiler the port's build picked, since the JAX
    package's own build runs ``$CXX -fopenmp`` as it is."""
    from phylonium_tpu_torch.native import build as native_build

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CXX"] = native_build.BUILD_INFO["compiler"]
    # the JAX package's store holds its own keys' meaning: keep it beside
    # the phase's, never in it
    store = env.get("PHYLONIUM_TPU_CALIBRATION_FILE")
    if store:
        env["PHYLONIUM_TPU_CALIBRATION_FILE"] = store + ".reference"
    return env


def build_reference_host_library() -> str:
    """Build the JAX package's native host library in one process.

    That library is compiled in place at first use, and the reference CLI
    first uses it from several FASTA reader threads at once: on a fresh
    checkout each thread starts its own compiler on the same output file,
    and one of them can load the file while another is still writing it
    ("file too short"). Building it here first leaves the CLI nothing to
    build. Returns the library's path.
    """
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "from phylonium_tpu.native.build import ensure_built\n"
         "print(ensure_built())\n"
         "sys.exit('jax' in sys.modules)\n"],
        capture_output=True, text=True, cwd=REPO, env=reference_env(), timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"reference host library build exited {proc.returncode}: "
            f"{proc.stderr[-2000:]}"
        )
    return proc.stdout.strip()


def random_states(rng, n: int, length: int, invalid: float = 0.2):
    """[n, length] uint8 states 0..9 with about ``invalid`` INVALID."""
    import numpy as np

    draw = rng.integers(0, 100, size=(n, length), dtype=np.uint8)
    states = draw % INVALID
    states[draw < round(100 * invalid)] = INVALID
    return states


def compare(kernel, plain, symmetric: bool) -> int:
    """Max |kernel - plain| over the defined cells; raises if not 0."""
    import torch

    diff = (kernel.to(torch.int64) - plain).abs()
    if symmetric:  # only tiles on or above the diagonal are defined
        diff = torch.triu(diff)
    err = int(diff.max().item()) if diff.numel() else 0
    if err:
        raise AssertionError(f"kernel disagrees with the plain version: {err}")
    return err


def check_edges(device, seed: int = 7) -> int:
    """Kernel == plain at ragged shapes; returns the max abs error (0)."""
    import numpy as np
    import torch

    from phylonium_tpu_torch.ops import pair_count
    from phylonium_tpu_torch.ops.match_matrix import cross_counts_reference
    from phylonium_tpu_torch.ops.states import pack_rows, to_device

    rng = np.random.default_rng(seed)
    worst = 0
    # odd lengths; 2001 states pack to 1001 bytes, not a multiple of 16
    for n, length in [(2, 2001), (29, 2001), (33, 2001), (64, 2001),
                      (65, 2001), (600, 2001), (29, 300_001), (2, 1)]:
        states = random_states(rng, n, length)
        states[n // 2] = INVALID  # one all-INVALID row
        other = random_states(rng, n + 7, length)
        a = to_device(pack_rows(states), device)
        b = to_device(pack_rows(other), device)
        for x, y, sym in ((a, a, True), (a, b, False), (b, a, False)):
            m, h = pair_count.cross_counts(x, y, symmetric=sym)
            mr, hr = cross_counts_reference(x, y)
            if device.type == "cuda":
                torch.cuda.synchronize()
            worst = max(worst, compare(m, mr, sym), compare(h, hr, sym))
        print(f"  edge N={n} L={length}: kernel == plain", flush=True)
    return worst


# about 10 ms of the card's clock: long enough for the host to queue a
# timed run's calls behind it
HOLD_CYCLES = 20_000_000


def time_ms(fn, runs: int = 3, reps: int = 1) -> float:
    """One warm run, then the median of ``runs`` timed by CUDA events,
    each over ``reps`` calls back to back; returns ms per call.

    Each run starts behind a spin kernel (``torch.cuda._sleep``) that holds
    the card while the host queues the calls, so the events time the
    card's work even where one call is shorter than its launch on the host
    (a hybrid round's diagonal_neq is a few microseconds)."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


# Published peaks of one H100 SXM at 700 W (the on-chip measurement
# guide's table): HBM bandwidth and dense int8 tensor-core operations.
HBM_BYTES_S = 3.35e12
INT8_TENSOR_OPS_S = 1979e12


def bound(bytes_moved: float, int8_ops: float = 0.0) -> tuple[float, str]:
    """(ms, resource): the larger of bytes over the memory rate and int8
    tensor-core operations over their peak rate. The byte-compare kernels
    pass bytes alone: no operation of theirs has a rate that could decide."""
    by_bytes = 1e3 * bytes_moved / HBM_BYTES_S
    by_ops = 1e3 * int8_ops / INT8_TENSOR_OPS_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def span_bytes(offsets, limits, length: int) -> int:
    """Bytes of one text that jobs reading [offset, min(offset + length,
    limit)) touch, each byte counted once however many jobs read it."""
    import numpy as np

    start = np.asarray(offsets, np.int64)
    end = np.minimum(start + length, np.broadcast_to(np.asarray(limits, np.int64), start.shape))
    keep = end > start
    order = np.argsort(start[keep], kind="stable")
    start, end = start[keep][order], end[keep][order]
    if not start.size:
        return 0
    reach = np.maximum.accumulate(end)
    before = np.concatenate((start[:1], reach[:-1]))
    return int(np.sum(reach - np.maximum(start, before)))


def int_mm_ms(rows, check) -> float:
    """``torch._int_mm`` on the one-hot operands of ``rows`` (the library
    yardstick): rows padded to the multiples it asks for, operands on the
    card before the clock starts; checks [matches | homs] against ``check``."""
    import torch

    from phylonium_tpu_torch.ops.match_matrix import onehot_operands

    n = rows.shape[0]
    ops_a, ops_b = onehot_operands(rows, rows)
    pad_a = max(24, -(-n // 8) * 8) - n  # more than 16 rows, a multiple of 8
    pad_b = -(-2 * n // 8) * 8 - 2 * n
    ops_a = torch.nn.functional.pad(ops_a, (0, 0, 0, pad_a))
    ops_b = torch.nn.functional.pad(ops_b, (0, 0, 0, pad_b))
    out = torch._int_mm(ops_a, ops_b.T)
    matches, homs = check
    if not (torch.equal(out[:n, :n].to(torch.int64), matches)
            and torch.equal(out[:n, n : 2 * n].to(torch.int64), homs)):
        raise AssertionError("torch._int_mm on the one-hot operands disagrees")
    del out
    ms = time_ms(lambda: torch._int_mm(ops_a, ops_b.T))
    del ops_a, ops_b
    torch.cuda.empty_cache()
    return ms


def check_chunked(rows) -> dict:
    """``pair_counts_rows`` with ``_MAX_WIDTH`` patched to 3 ROW_ALIGNs,
    so the rows are counted in 32-byte column chunks (views at the
    panel's row stride, summed in int64): equal, bit for bit, to the
    one-call count of the same rows."""
    import numpy as np

    from phylonium_tpu_torch.ops import pair_count
    from phylonium_tpu_torch.ops.states import ROW_ALIGN

    whole = pair_count.pair_counts_rows(rows)
    saved = pair_count._MAX_WIDTH
    pair_count._MAX_WIDTH = 3 * ROW_ALIGN
    try:
        chunk = pair_count._chunk_bytes()
        launches = pair_count.KERNEL_LAUNCHES
        t0 = time.perf_counter()
        chunked = pair_count.pair_counts_rows(rows)
        seconds = time.perf_counter() - t0
        launches = pair_count.KERNEL_LAUNCHES - launches
    finally:
        pair_count._MAX_WIDTH = saved
    chunks = -(-rows.shape[1] // chunk)
    if launches != chunks * pair_count.LAUNCHES_PER_CALL:
        raise AssertionError(f"{launches} launches for {chunks} chunks")
    if not all(np.array_equal(c, w) for c, w in zip(chunked, whole)):
        raise AssertionError("the chunked count differs from the one-call count")
    print(f"  chunked N={rows.shape[0]} width={rows.shape[1]} bytes: {chunks} "
          f"chunks of {chunk} bytes ({launches} launches, {seconds:.3f} s) == "
          "one call, bit for bit", flush=True)
    return {"chunks": chunks, "chunk_bytes": chunk, "seconds": seconds}


def check_production(device, n: int, length: int, seed: int,
                     chunked: bool = False) -> dict:
    """Kernel == plain at a production shape, with the kernel's, the plain
    version's and torch._int_mm's times, and the bound; with ``chunked``,
    also the chunked count of the same rows (``check_chunked``)."""
    import numpy as np

    from phylonium_tpu_torch.ops import pair_count
    from phylonium_tpu_torch.ops.match_matrix import cross_counts_reference
    from phylonium_tpu_torch.ops.match_table import MATCH_PLANES
    from phylonium_tpu_torch.ops.states import pack_rows, to_device

    import torch

    states = random_states(np.random.default_rng(seed), n, length)
    t0 = time.perf_counter()
    packed = pack_rows(states)
    pack_ms = 1e3 * (time.perf_counter() - t0)
    del states
    t0 = time.perf_counter()
    rows = to_device(packed, device)
    torch.cuda.synchronize()
    copy_ms = 1e3 * (time.perf_counter() - t0)
    del packed
    m, h = pair_count.cross_counts(rows, rows, symmetric=True)
    mr, hr = cross_counts_reference(rows, rows)
    err = max(compare(m, mr, True), compare(h, hr, True))
    del m, h
    library_ms = int_mm_ms(rows, (mr, hr))
    del mr, hr
    ms = time_ms(lambda: pair_count.cross_counts(rows, rows, symmetric=True))
    plain_ms = time_ms(lambda: cross_counts_reference(rows, rows))
    if chunked:
        check_chunked(rows)
    # the upper triangle with its diagonal, one multiply-add a cell and
    # column for each match plane (states that share a partner set share
    # one) and one for validity; the packed rows read once, two int32
    # [n, n] outputs written
    cells = n * (n + 1) // 2
    macs = len(MATCH_PLANES) + 1
    bound_ms, bound_by = bound(rows.numel() + 2 * 4 * n * n, 2 * macs * cells * length)
    print(
        f"  production N={n} L={length}: kernel == plain == torch._int_mm; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, torch._int_mm "
        f"{library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{100 * bound_ms / ms:.1f} % of the bound; host pack {pack_ms:.3f} ms, "
        f"pinned copy to the card {copy_ms:.3f} ms", flush=True,
    )
    return {"n": n, "length": length, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err}


def extend_compare(a, b, off_a, off_b, lim_a, lim_b, length: int) -> int:
    """Max |kernel bit - plain bit| of one call; raises if not 0."""
    import numpy as np
    import torch

    from phylonium_tpu_torch.ops import anchor_extend

    kernel = anchor_extend.diagonal_neq(a, b, off_a, off_b, lim_a, lim_b, length)
    plain = anchor_extend.diagonal_neq_bits_reference(
        a, b, off_a, off_b, lim_a, lim_b, length
    )
    torch.cuda.synchronize()
    if kernel.shape != plain.shape:
        raise AssertionError(
            f"diagonal_neq kernel gave {tuple(kernel.shape)} words, the "
            f"plain version {tuple(plain.shape)}"
        )
    diff = np.unpackbits((kernel ^ plain).cpu().numpy().view(np.uint8))
    err = int(diff.max()) if diff.size else 0
    if err:
        raise AssertionError(
            f"diagonal_neq kernel disagrees with the plain version: "
            f"{int(diff.sum())} bits differ, length {length}, "
            f"{len(off_a)} jobs"
        )
    return err


def random_text(rng, n: int):
    import numpy as np

    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]


def mutate_text(rng, text, p: float):
    import numpy as np

    acgt = np.frombuffer(b"ACGT", np.uint8)
    out = text.copy()
    hit = np.flatnonzero(rng.random(text.size) < p)
    out[hit] = acgt[(np.searchsorted(acgt, out[hit]) + rng.integers(1, 4, hit.size)) % 4]
    return out


def check_extend_edges(device, seed: int = 11) -> int:
    """diagonal_neq kernel == plain at ragged shapes; returns 0."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    a_host = random_text(rng, 1_200_001)
    b_host = mutate_text(rng, a_host, 0.03)[:1_000_003]
    a = torch.from_numpy(a_host).to(device)
    b = torch.from_numpy(b_host).to(device)
    na, nb = a.numel(), b.numel()
    worst = 0
    for length in (1, 31, 32, 33, 900, CHUNK):
        for jobs in (1, 300):
            off_a = rng.integers(0, na + 1, jobs)
            off_b = rng.integers(0, nb + 1, jobs)
            off_a[0], off_b[-1] = na, nb  # at the text end
            off_a[jobs // 3] = na - 5     # near it, unaligned
            lim_a = np.full(jobs, na)
            lim_a[jobs // 2] = 0          # a limit of 0
            lim_b = rng.integers(0, nb + 1, jobs)
            worst = max(worst, extend_compare(a, b, off_a, off_b, lim_a, lim_b, length))
        print(f"  extend edge length={length}, 1 and 300 jobs: kernel == plain",
              flush=True)
    # identical texts: mismatch exactly from the limit on
    from phylonium_tpu_torch.ops import anchor_extend

    off = np.array([0, 999_000, na - 1, na, 12_345, 7])
    worst = max(worst, extend_compare(a, a, off, off, na, na, 4096))
    bits = anchor_extend.unpack_bits(
        anchor_extend.diagonal_neq(a, a, off, off, na, na, 4096), 4096
    )
    for row, o in zip(bits, off):
        inside = min(max(na - int(o), 0), 4096)
        if row[:inside].any() or not row[inside:].all():
            raise AssertionError(f"identical texts: wrong bits at offset {o}")
    print("  extend edge identical texts: mismatch exactly from the limit",
          flush=True)
    # the kernel's own edges (tests/extend_cases.py), with the texts at the
    # start of their buffers and 3 and 13 bytes into them
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from extend_cases import CASES, texts_on

    for name, make in CASES.items():
        ha, hb, off_a, off_b, lim_a, lim_b, length = make(
            np.random.default_rng(sum(map(ord, name))))
        for shift in (0, 3):
            texts = texts_on(device, ha, hb, shift)
            worst = max(worst, extend_compare(*texts, off_a, off_b, lim_a, lim_b, length))
        print(f"  extend edge {name} ({len(off_a)} jobs x {length}, texts at "
              "offsets 0 and 3/13 of their buffers): kernel == plain", flush=True)
    return worst


def extend_shapes(device, seed: int = 12) -> dict:
    """The diagonal_neq kernel's two production shapes, name -> (a, b,
    off_a, off_b, lim_a, lim_b) with the texts on ``device``: the
    anchor-extension micro's (128 jobs over a 5 Mbp genome's doubled text)
    and a hybrid round's (8 queries of 5 Mbp, one request each)."""
    import numpy as np
    import torch

    from phylonium_tpu_torch.data.sequence import revcomp

    rng = np.random.default_rng(seed)
    genome = random_text(rng, 5_000_000)
    doubled = np.frombuffer(
        genome.tobytes() + b"#" + revcomp(genome.tobytes()), np.uint8
    ).copy()
    a = torch.from_numpy(doubled).to(device)
    # the micro: 128 jobs x 2^19 at linspace offsets (bench.py:736-740),
    # here against a 1%-mutated copy so the bits are not all 0
    b = torch.from_numpy(mutate_text(rng, doubled, 0.01)).to(device)
    off = np.linspace(0, doubled.size - CHUNK - 1, 128).astype(np.int64)
    shapes = {"micro": (a, b, off, off, doubled.size, doubled.size)}
    # a hybrid round: 8 queries of 5 Mbp, one request each
    queries = np.concatenate([mutate_text(rng, genome, 0.002 + 0.0025 * k) for k in range(8)])
    q = torch.from_numpy(queries).to(device)
    bases = np.arange(8, dtype=np.int64) * genome.size
    start = rng.integers(0, genome.size - CHUNK, 8)
    diag = rng.integers(-1000, 1000, 8)
    shapes["hybrid"] = (a, q, np.clip(diag + start, 0, None), bases + start,
                        doubled.size, bases + genome.size)
    return shapes


def extend_bound(jobs_dev, oa, ob, la, lb) -> tuple[float, str]:
    """The bound of one diagonal_neq call of CHUNK positions: the text
    spans its jobs read, each byte once (the micro's jobs overlap), the
    job records read, and CHUNK bits a job written."""
    read = (span_bytes(oa, la, CHUNK) + span_bytes(ob, lb, CHUNK)
            + jobs_dev.numel() * jobs_dev.element_size())
    return bound(read + len(oa) * CHUNK / 8)


def check_extend_production(device) -> dict:
    """diagonal_neq kernel == plain at its two production shapes, with
    both times and the bound of each."""
    from phylonium_tpu_torch.ops import anchor_extend

    out = {}
    for name, (x, y, oa, ob, la, lb) in extend_shapes(device).items():
        err = extend_compare(x, y, oa, ob, la, lb, CHUNK)
        # time the launch and the plain computation alone: the wrapper's
        # host checks and the jobs' copy to the card stay outside
        jobs_dev = anchor_extend._job_tensor(x, y, oa, ob, la, lb)
        ms = time_ms(lambda: anchor_extend._launch(x, y, jobs_dev, CHUNK), reps=20)
        plain_ms = time_ms(lambda: anchor_extend._plain(x, y, jobs_dev, CHUNK), reps=5)
        jobs = len(oa)
        gbp_s = jobs * CHUNK / (ms * 1e-3) / 1e9
        bound_ms, bound_by = extend_bound(jobs_dev, oa, ob, la, lb)
        print(f"  extend production {name} {jobs} x {CHUNK}: kernel == plain; "
              f"kernel {ms:.4f} ms ({gbp_s:.1f} Gbp/s, "
              f"{2 * jobs * CHUNK / (ms * 1e-3) / 1e9:.1f} GB/s of text read), "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})",
              flush=True)
        out[name] = {"jobs": jobs, "ms": ms, "plain_ms": plain_ms, "gbp_s": gbp_s,
                     "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}
    return out


def eco29_panel(n: int = 29, length: int = 5_000_000, seed: int = 29,
                low: float = 0.01, span: float = 0.05):
    """The eco29-shaped panel of bench.py's simulate_panel: a base genome,
    n-1 substitution mutants at ``low``..``low + span`` (1%..6%), the last
    one a draft assembly in 5 contigs with a 500 kb inversion. Yields each
    genome's contig list, one genome live at a time."""
    import numpy as np

    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    code = np.zeros(256, np.uint8)
    code[acgt] = np.arange(4, dtype=np.uint8)
    ref = rng.choice(acgt, length)
    yield [ref.tobytes()]
    for k in range(1, n):
        arr = ref.copy()
        hit = np.flatnonzero(rng.random(length) < low + span * (k - 1) / max(n - 2, 1))
        arr[hit] = acgt[(code[arr[hit]] + rng.integers(1, 4, hit.size)) % 4]
        if k < n - 1:
            yield [arr.tobytes()]
    draft = bytearray(arr.tobytes())
    third = length // 3
    inv = min(500_000, length // 6)
    draft[third : third + inv] = bytes(draft[third : third + inv])[::-1].translate(
        bytes.maketrans(b"ACGT", b"TGCA")
    )
    contig = length // 5
    yield [bytes(draft[i * contig : (i + 1) * contig]) for i in range(5)]


def write_fasta(panel, directory: str) -> list[str]:
    files = []
    for k, contigs in enumerate(panel):
        path = os.path.join(directory, f"S{k:03d}.fasta")
        with open(path, "wb") as f:
            for ci, contig in enumerate(contigs):
                f.write(b">S%03d_c%d\n" % (k, ci))
                f.write(b"\n".join(contig[i : i + 80] for i in range(0, len(contig), 80)))
                f.write(b"\n")
        files.append(path)
    return files


# The in-process route, pinned: a single-process run on a card sends its
# streamed and low-memory work to the device server by default
IN_PROCESS = {"PHYLONIUM_TPU_DEVD": "0"}


def run_port_cli(args: list[str]) -> tuple[int, str]:
    """The port's CLI in this process, on the in-process route."""
    from phylonium_tpu_torch.cli import main as port_main

    buf = io.StringIO()
    with env_set(**IN_PROCESS), contextlib.redirect_stdout(buf):
        rc = port_main(args)
    return rc, buf.getvalue()


def run_reference_cli(args: list[str], cwd: str) -> bytes:
    """The JAX package's CLI with host counting, in a subprocess that
    fails if it loads jax."""
    env = reference_env()
    env["PHYLONIUM_TPU_EXPECT_NO_JAX"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "phylonium_tpu", "--count-backend", "host", *args],
        capture_output=True, cwd=cwd, env=env, timeout=900,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"reference CLI exited {proc.returncode}: {proc.stderr.decode()[-2000:]}"
        )
    return proc.stdout


def check_phylip(text: str, n: int) -> None:
    import math

    lines = text.splitlines()
    if int(lines[0]) != n or len(lines) != n + 1:
        raise AssertionError(f"expected a {n}-row PHYLIP matrix")
    for line in lines[1:]:
        cells = [float(v) for v in line.split()[1:]]
        if len(cells) != n or not all(math.isfinite(v) for v in cells):
            raise AssertionError(f"bad PHYLIP row: {line[:200]}")


def end_to_end(device_name: str, files: list[str], tmp: str) -> dict:
    """The eco29-shaped panel in ``files`` through the port's CLI on the
    card, byte for byte against the reference CLI."""
    from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO
    from phylonium_tpu_torch.ops import pair_count

    n = len(files)
    # the serial device route, pinned: 'auto' routes by the dispatch model
    # (phase 19)
    args = ["--progress=never", "--count-backend", "device", "--device", device_name, *files]
    pair_count.KERNEL_LAUNCHES = 0
    pair_count.PLAIN_CALLS = 0
    t0 = time.perf_counter()
    rc, ours = run_port_cli(args)
    wall = time.perf_counter() - t0
    launches = pair_count.KERNEL_LAUNCHES
    info = dict(LAST_RUN_INFO)
    if rc != 0:
        raise RuntimeError(f"port CLI exited {rc}")
    check_phylip(ours, n)
    t0 = time.perf_counter()
    reference = run_reference_cli(["--progress=never", *files], tmp)
    ref_wall = time.perf_counter() - t0
    if ours.encode() != reference:
        raise AssertionError("port output differs from the JAX package's")
    if "jax" in sys.modules:
        raise AssertionError("the port's run imported jax")
    timings = info["timings"]
    print(
        f"  e2e, {n} genomes: byte-identical to the JAX package's host "
        f"count; carrier {info['compare_carrier']}, {launches} kernel "
        f"launches, wall {wall:.3f} s (reference CLI {ref_wall:.3f} s), "
        f"phases {json.dumps(timings)}", flush=True,
    )
    return {"launches": launches, "carrier": info["compare_carrier"],
            "plain_calls": pair_count.PLAIN_CALLS, "reference": reference}


def end_to_end_hybrid(device_name: str, n: int = 8, length: int = 5_000_000) -> dict:
    """An outbreak-shaped panel through the port's CLI with hybrid mapping
    on the card, byte for byte against the reference CLI."""
    from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO
    from phylonium_tpu_torch.ops import anchor_extend, pair_count

    with tempfile.TemporaryDirectory(prefix="chip_smoke_hybrid_") as tmp:
        panel = eco29_panel(n, length, seed=8, low=0.002, span=0.018)
        files = write_fasta(panel, tmp)
        args = ["--progress=never", "--map-backend", "hybrid", "--count-backend",
                "device", "--device", device_name, *files]
        anchor_extend.KERNEL_LAUNCHES = 0
        anchor_extend.PLAIN_CALLS = 0
        pair_count.KERNEL_LAUNCHES = 0
        pair_count.PLAIN_CALLS = 0
        t0 = time.perf_counter()
        rc, ours = run_port_cli(args)
        wall = time.perf_counter() - t0
        launches = anchor_extend.KERNEL_LAUNCHES
        plain = anchor_extend.PLAIN_CALLS
        info = dict(LAST_RUN_INFO)
        if rc != 0:
            raise RuntimeError(f"port CLI exited {rc}")
        check_phylip(ours, n)
        t0 = time.perf_counter()
        reference = run_reference_cli(["--progress=never", *files], tmp)
        ref_wall = time.perf_counter() - t0
    if ours.encode() != reference:
        raise AssertionError("hybrid output differs from the JAX package's")
    if "jax" in sys.modules:
        raise AssertionError("the port's hybrid run imported jax")
    if info["map_carrier"] != "cuda-kernel":
        raise AssertionError(f"mapping carried by {info['map_carrier']}")
    if launches < 1 or info["extend_kernel_launches"] != launches:
        raise AssertionError("hybrid mapping launched no diagonal_neq kernel")
    if plain or info["extend_plain_calls"]:
        raise AssertionError("hybrid mapping called the plain version")
    if pair_count.KERNEL_LAUNCHES < 1 or pair_count.PLAIN_CALLS:
        raise AssertionError("the hybrid run did not count on the kernel")
    timings = info["timings"]
    print(
        f"  hybrid e2e {n} x {length}: byte-identical to the JAX package's "
        f"native-mapped host count; map carrier {info['map_carrier']}, "
        f"{launches} extend launches in {info['map_rounds']} rounds, "
        f"{pair_count.KERNEL_LAUNCHES} pair-count launches, wall {wall:.3f} s "
        f"(reference CLI {ref_wall:.3f} s), phases {json.dumps(timings)}",
        flush=True,
    )
    return {"launches": launches, "rounds": info["map_rounds"],
            "timings": timings, "wall": wall, "reference": reference}


def build_inputs(device, queries, homologies, ref_len):
    """One group's host prep, copied to ``device``: (words, intervals,
    overlay) as ``pileup_device.build_packed_rows`` takes them."""
    import torch

    from phylonium_tpu_torch.ops import pileup_device

    inputs = pileup_device.prepare_group(queries, homologies, ref_len)
    t = [torch.from_numpy(a).to(device) for a in inputs]
    return t[0], t[1], tuple(t[2:])


def build_compare(got, plain, what: str) -> int:
    """Max |kernel byte - plain byte|; raises if not 0."""
    import torch

    torch.cuda.synchronize()
    diff = (got.to(torch.int16) - plain.to(torch.int16)).abs()
    err = int(diff.max().item()) if diff.numel() else 0
    if err:
        raise AssertionError(
            f"pileup_build kernel disagrees with the plain version at {what}: "
            f"{int((diff > 0).sum())} bytes differ"
        )
    return err


def check_build_edges(device, seed: int = 13) -> int:
    """pileup_build kernel == plain, byte for byte, at the edge shapes of
    tests/pileup_cases.py, and into a row slice of a larger panel."""
    import numpy as np
    import torch

    from phylonium_tpu_torch.ops import pileup_device
    from phylonium_tpu_torch.ops.states import packed_width

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from pileup_cases import EDGE_CASES

    rng = np.random.default_rng(seed)
    worst = 0
    for name, make in EDGE_CASES.items():
        queries, homologies, ref_len = make(rng)
        words, intervals, overlay = build_inputs(device, queries, homologies, ref_len)
        shape = (len(queries), packed_width(ref_len))
        got = torch.empty(shape, dtype=torch.uint8, device=device)
        plain = torch.empty_like(got)
        pileup_device.build_packed_rows(words, intervals, overlay, ref_len, got)
        pileup_device.build_packed_rows_reference(words, intervals, overlay, ref_len, plain)
        worst = max(worst, build_compare(got, plain, name))
        print(f"  build edge {name} ({shape[0]} x {ref_len}, "
              f"{intervals.shape[1]} records a row, {overlay[1].numel()} "
              f"overlay entries): kernel == plain", flush=True)
    # a group written at row offset 5 of a 17-row panel; the rest untouched
    queries, homologies, ref_len = EDGE_CASES["odd_ref_len_301"](rng)
    words, intervals, overlay = build_inputs(device, queries, homologies, ref_len)
    rows = len(queries)
    got = torch.full((17, packed_width(ref_len)), 7, dtype=torch.uint8, device=device)
    plain = got.clone()
    pileup_device.build_packed_rows(words, intervals, overlay, ref_len, got[5 : 5 + rows])
    pileup_device.build_packed_rows_reference(
        words, intervals, overlay, ref_len, plain[5 : 5 + rows]
    )
    worst = max(worst, build_compare(got, plain, "a row slice at offset 5"))
    print(f"  build edge: {rows} rows into rows 5..{4 + rows} of a 17-row panel: "
          "kernel == plain, other rows untouched", flush=True)
    return worst


def mapped_group(rows: int, length: int, seed: int):
    """An eco29-shaped group of ``rows`` genomes mapped onto the first by
    the native mapper: (queries, homologies, ref_len)."""
    import numpy as np

    from phylonium_tpu_torch.config import RunConfig
    from phylonium_tpu_torch.core.anchor_stats import min_anchor_length
    from phylonium_tpu_torch.core.map_native import map_batch_native
    from phylonium_tpu_torch.data.sequence import Sequence, gc_content
    from phylonium_tpu_torch.index.esa import ESAIndex
    from phylonium_tpu_torch.utils.progress import ProgressBar

    queries = [np.frombuffer(b"!".join(c), np.uint8)
               for c in eco29_panel(rows, length, seed)]
    subject = Sequence("S000", queries[0].tobytes())
    ref = ESAIndex(subject, backend="native")
    threshold = min_anchor_length(
        RunConfig().anchor_p_value, gc_content(subject.nucl), ref.size
    )
    bar = ProgressBar("", rows, enabled=False)
    homologies = map_batch_native(ref._native, queries, threshold, bar, 0)
    return queries, homologies, length


def check_build_production(device, rows: int, length: int, seed: int) -> dict:
    """pileup_build kernel == plain (and == the host pileup, packed) on one
    mapped group, with the host prep, copy, kernel and plain times."""
    import torch

    from phylonium_tpu_torch.core.pileup import build_pileup
    from phylonium_tpu_torch.ops.shapes import pack_states
    from phylonium_tpu_torch.ops import pileup_device
    from phylonium_tpu_torch.ops.states import packed_width

    queries, homologies, ref_len = mapped_group(rows, length, seed)
    t0 = time.perf_counter()
    inputs = pileup_device.prepare_group(queries, homologies, ref_len)
    prep_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    t = [torch.from_numpy(a).pin_memory().to(device, non_blocking=True) for a in inputs]
    torch.cuda.synchronize()
    copy_ms = 1e3 * (time.perf_counter() - t0)
    words, intervals, overlay = t[0], t[1], tuple(t[2:])
    width = packed_width(ref_len)
    got = torch.empty((rows, width), dtype=torch.uint8, device=device)
    plain = torch.empty_like(got)
    pileup_device.build_packed_rows(words, intervals, overlay, ref_len, got)
    pileup_device.build_packed_rows_reference(words, intervals, overlay, ref_len, plain)
    err = build_compare(got, plain, f"{rows} x {length}")
    host = pack_states(build_pileup(queries, homologies, ref_len), rows, width)
    if not torch.equal(got.cpu(), torch.from_numpy(host)):
        raise AssertionError(f"pileup_build differs from the host pileup at {rows} x {length}")
    ms = time_ms(lambda: pileup_device._launch(words, intervals, overlay, ref_len, got), reps=5)
    plain_ms = time_ms(lambda: pileup_device._plain(words, intervals, overlay, ref_len, plain))
    written = rows * width
    gb_s = written / (ms * 1e-3) / 1e9
    # the group's codes, records and overlay read once, the rows written
    read = sum(x.numel() * x.element_size() for x in t)
    bound_ms, bound_by = bound(read + written)
    print(
        f"  build production {rows} x {length}: kernel == plain == host pileup; "
        f"{intervals.shape[1]} records a row (max), {overlay[1].numel()} overlay "
        f"entries, {4 * words.numel()} bytes of 2-bit codes; kernel {ms:.4f} ms "
        f"({written} bytes written, {gb_s:.1f} GB/s), plain {plain_ms:.4f} ms; "
        f"bound {bound_ms:.4f} ms ({bound_by}); "
        f"host prep {prep_ms:.3f} ms, pinned copy to the card {copy_ms:.3f} ms",
        flush=True,
    )
    return {"rows": rows, "length": length, "ms": ms, "plain_ms": plain_ms,
            "gb_s": gb_s, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err}


@contextlib.contextmanager
def env_set(**values):
    """Set environment variables (None unsets) for the body only."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def zero_counts() -> None:
    from phylonium_tpu_torch.ops import (
        anchor_extend,
        anchor_extend_sharded,
        pair_count,
        pileup_device,
    )

    for module in (anchor_extend, anchor_extend_sharded, pair_count, pileup_device):
        module.KERNEL_LAUNCHES = 0
        module.PLAIN_CALLS = 0


def port_run(args: list[str], **env) -> dict:
    """One in-process run of the port's CLI with ``env`` set: its stdout,
    wall, phase timings, LAST_RUN_INFO and the launches and plain calls of
    the count and the build, counted from 0 for this run."""
    from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO
    from phylonium_tpu_torch.ops import pair_count, pileup_device

    with env_set(**env):
        zero_counts()
        t0 = time.perf_counter()
        rc, out = run_port_cli(args)
        wall = time.perf_counter() - t0
        counts = {
            "build_launches": pileup_device.KERNEL_LAUNCHES,
            "build_plain": pileup_device.PLAIN_CALLS,
            "count_launches": pair_count.KERNEL_LAUNCHES,
            "count_plain": pair_count.PLAIN_CALLS,
        }
    if rc != 0:
        raise RuntimeError(f"port CLI exited {rc} with {env}")
    info = dict(LAST_RUN_INFO)
    return {"out": out, "wall": wall, "counts": counts, "info": info,
            "timings": info["timings"]}


def end_to_end_streamed(device_name: str, files: list[str]) -> dict:
    """The 116 x 5 Mbp panel streamed and serial through the port's CLI,
    in the order serial, streamed, streamed, serial; byte for byte."""
    from phylonium_tpu_torch.core.stream import effective_group_rows
    from phylonium_tpu_torch.ops import pair_count

    n = len(files)
    groups = -(-n // effective_group_rows(n))
    runs = []
    # streamed: forced (with the early shipper it engages); serial: the
    # device count pinned
    pins = {"serial": ["--count-backend", "device"], "streamed": []}
    for mode in ("serial", "streamed", "streamed", "serial"):
        args = ["--progress=never", *pins[mode], "--device", device_name, *files]
        r = port_run(args, PHYLONIUM_TPU_STREAM="force" if mode == "streamed" else "0",
                     PHYLONIUM_TPU_STREAM_GROUP=None, PHYLONIUM_TPU_DEVICE_PILEUP=None)
        check_phylip(r["out"], n)
        runs.append({**r, "mode": mode, "groups": r["info"]["stream_groups"]})
    if any(r["out"] != runs[0]["out"] for r in runs):
        raise AssertionError("streamed output differs from the serial run's")
    if "jax" in sys.modules:
        raise AssertionError("the streamed run imported jax")
    for r in runs:
        c = r["counts"]
        want_build = groups if r["mode"] == "streamed" else 0
        ship = r["info"].get("early_ship")
        if r["mode"] == "streamed" and (not ship or ship["taken"] != groups
                                        or ship["repacked"]):
            raise AssertionError(f"streamed run's early ship: {ship}")
        if (c["build_launches"] != want_build or c["build_plain"]
                or c["count_launches"] != pair_count.LAUNCHES_PER_CALL or c["count_plain"]
                or r["groups"] != want_build):
            raise AssertionError(
                f"{r['mode']} run: {c}, {r['groups']} groups; expected "
                f"{want_build} build launches, 0 plain calls, one count call"
            )
    print(f"  streamed e2e, {n} genomes: byte-identical to the serial run; "
          f"{groups} groups of {effective_group_rows(n)}, {groups} build "
          f"launches, 0 build plain calls, {pair_count.LAUNCHES_PER_CALL} "
          "pair-count launches (one call) each", flush=True)
    for r in runs:
        print(f"  {r['mode']:8s} wall {r['wall']:.3f} s, phases "
              f"{json.dumps(r['timings'])}, early ship "
              f"{json.dumps(r['info'].get('early_ship'))}", flush=True)
    streamed = [r for r in runs if r["mode"] == "streamed"]
    return {"launches": streamed[0]["counts"]["build_launches"],
            "runs": [{k: r[k] for k in ("mode", "wall", "timings")} for r in runs]}


def end_to_end_device_pileup(device_name: str, files: list[str], tmp: str,
                             timed: list[tuple[list[str], list[str]]]) -> dict:
    """The serial path's device pileup (X2) on the card.

    The panel in ``files`` through the port's CLI with
    ``PHYLONIUM_TPU_DEVICE_PILEUP=1``, plain and with
    ``--complete-deletion``, each byte for byte against the reference CLI
    with the same flags, one build launch a group and one count call.
    Then each (flags, panel) of ``timed`` runs in turns host, X2, X2, host
    in this process; all four outputs equal."""
    from phylonium_tpu_torch.core.stream import effective_group_rows
    from phylonium_tpu_torch.ops import pair_count

    n = len(files)
    groups = -(-n // effective_group_rows(n))
    checked = {}
    for flags in ([], ["--complete-deletion"]):
        args = ["--progress=never", *flags, "--count-backend", "device", "--device",
                device_name, *files]
        r = port_run(args, PHYLONIUM_TPU_DEVICE_PILEUP="1", PHYLONIUM_TPU_STREAM=None,
                     PHYLONIUM_TPU_STREAM_GROUP=None)
        check_phylip(r["out"], n)
        reference = run_reference_cli(["--progress=never", *flags, *files], tmp)
        if r["out"].encode() != reference:
            raise AssertionError(f"X2 output with {flags} differs from the JAX package's")
        c, info = r["counts"], r["info"]
        if (c["build_launches"] != groups or c["build_plain"]
                or info["build_kernel_launches"] != groups
                or c["count_launches"] != pair_count.LAUNCHES_PER_CALL or c["count_plain"]
                or info["compare_carrier"] != "cuda-kernel" or info["stream_groups"]):
            raise AssertionError(f"X2 run with {flags}: {c}, {info}")
        name = " ".join(flags) or "plain"
        checked[name] = r
        print(f"  X2 e2e {n} genomes ({name}): byte-identical to the JAX package's "
              f"host count with the same flags; {c['build_launches']} build launches "
              f"({groups} groups), 0 build plain calls, {c['count_launches']} "
              f"pair-count launches; wall {r['wall']:.3f} s, phases "
              f"{json.dumps(r['timings'])}", flush=True)
    if "jax" in sys.modules:
        raise AssertionError("the X2 run imported jax")
    turns = {}
    for flags, panel in timed:
        label = " ".join([f"{len(panel)} genomes", *flags])
        args = ["--progress=never", *flags, "--count-backend", "device", "--device",
                device_name, *panel]
        runs = []
        for mode in ("host", "X2", "X2", "host"):
            r = port_run(args, PHYLONIUM_TPU_DEVICE_PILEUP="1" if mode == "X2" else None,
                         PHYLONIUM_TPU_STREAM=None, PHYLONIUM_TPU_STREAM_GROUP=None)
            want = -(-len(panel) // effective_group_rows(len(panel))) if mode == "X2" else 0
            if r["counts"]["build_launches"] != want or r["counts"]["build_plain"]:
                raise AssertionError(f"{mode} run, {label}: {r['counts']}")
            runs.append({**r, "mode": mode})
        if any(r["out"] != runs[0]["out"] for r in runs):
            raise AssertionError(f"X2 output differs from the host pileup's, {label}")
        for r in runs:
            print(f"  {label} {r['mode']:4s} wall {r['wall']:.3f} s, "
                  f"phases {json.dumps(r['timings'])}", flush=True)
        turns[label] = [{k: r[k] for k in ("mode", "wall", "timings")} for r in runs]
    return {"launches": checked["plain"]["counts"]["build_launches"],
            "out": checked["plain"]["out"], "turns": turns}


def interval_union(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def profile_run(device_name: str, files: list[str], tmp: str, expect_out: str) -> dict:
    """The panel through the port's CLI with ``--profile=DIR`` and X2 on
    the card: the trace must hold each phase range once and one device
    event per pair-count and pileup-build launch, the run's and the
    prewarm's. Returns the card's busy
    time (union of device kernel intervals) within the traced phases, the
    traced wall (start of ``index`` to end of ``compare``) and the idle
    share."""
    from phylonium_tpu_torch.utils.profile import GROUP_RANGE

    trace_dir = os.path.join(tmp, "profile")
    args = ["--progress=never", f"--profile={trace_dir}", "--count-backend", "device",
            "--device", device_name, *files]
    r = port_run(args, PHYLONIUM_TPU_DEVICE_PILEUP="1", PHYLONIUM_TPU_STREAM=None,
                 PHYLONIUM_TPU_STREAM_GROUP=None)
    if r["out"] != expect_out:
        raise AssertionError("the profiled run's output differs from the unprofiled run's")
    (path,) = glob.glob(os.path.join(trace_dir, "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    ranges = {}
    for e in spans:
        if e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(e)
    for name in ("index", "map", "pileup", "compare"):
        if len(ranges.get(name, [])) != 1:
            raise AssertionError(f"trace holds {len(ranges.get(name, []))} '{name}' ranges")
    kernels = [e for e in spans if e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError("the trace holds no device events")
    pair = [e for e in kernels if "pair_mma_kernel" in e["name"]]
    build = [e for e in kernels if "pileup_build_kernel" in e["name"]]
    # the run's launches, and the prewarm thread's, which the run's counts
    # leave out
    warm = r["info"]["prewarm"]["launches"]
    want_pair = r["counts"]["count_launches"] + warm.get("pair_count", 0)
    want_build = r["counts"]["build_launches"] + warm.get("pileup_build", 0)
    if len(pair) != want_pair or len(build) != want_build:
        raise AssertionError(
            f"trace holds {len(pair)} pair-count and {len(build)} pileup-build "
            f"kernels for {want_pair} and {want_build} launches (prewarm's included)"
        )
    start = ranges["index"][0]["ts"]
    end = ranges["compare"][0]["ts"] + ranges["compare"][0]["dur"]
    busy_us = interval_union(
        (max(e["ts"], start), min(e["ts"] + e["dur"], end)) for e in kernels
        if e["ts"] < end and e["ts"] + e["dur"] > start
    )
    wall_us = end - start
    workers = {e["tid"] for e in ranges.get(GROUP_RANGE, [])}
    main_tid = ranges["index"][0]["tid"]
    result = {
        "busy_ms": busy_us / 1e3, "wall_s": wall_us / 1e6,
        "idle": 1 - busy_us / wall_us, "kernels": len(kernels),
        "pair_count_ms": sum(e["dur"] for e in pair) / 1e3,
        "pileup_build_ms": sum(e["dur"] for e in build) / 1e3,
        "worker_ranges": len(ranges.get(GROUP_RANGE, [])),
        "worker_on_own_thread": bool(workers) and main_tid not in workers,
    }
    print(f"  profile {len(files)} genomes with X2: trace {os.path.basename(path)} "
          f"({os.path.getsize(path)} bytes) holds the phase ranges, {len(pair)} "
          f"pair-count and {len(build)} pileup-build kernel events (prewarm's "
          f"{json.dumps(warm)} included), "
          f"{len(kernels)} device kernels in all; card busy {result['busy_ms']:.3f} ms "
          f"of a traced wall of {result['wall_s']:.3f} s (idle "
          f"{100 * result['idle']:.3f} %); pair count {result['pair_count_ms']:.3f} ms, "
          f"pileup build {result['pileup_build_ms']:.3f} ms on the card; "
          f"{result['worker_ranges']} '{GROUP_RANGE}' ranges from the feeder's "
          f"worker thread (own thread: {result['worker_on_own_thread']}); "
          f"phases {json.dumps(r['timings'])}", flush=True)
    return result


_CHILD = """
import json, sys
from phylonium_tpu_torch.cli import main
rc = main(sys.argv[1:])
from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO
print(json.dumps({"rc": rc, "jax": "jax" in sys.modules,
                  "info": LAST_RUN_INFO}), file=sys.stderr)
sys.exit(rc)
"""


# A child's ru_maxrss starts at its parent's high-water mark (Linux
# carries the memory map's peak across fork and exec), and this process
# has held gigabytes by now. So each CLI child is started by a small
# launcher process, whose own peak is tens of MB, and the launcher reads
# the child's peak with os.wait4.
_LAUNCHER = """
import json, os, subprocess, sys, time
spec = json.loads(sys.argv[1])
with open(spec["out"], "wb") as out, open(spec["err"], "wb") as err:
    t0 = time.perf_counter()
    proc = subprocess.Popen(spec["argv"], stdout=out, stderr=err, cwd=spec["cwd"])
    _, status, usage = os.wait4(proc.pid, 0)
print(json.dumps({"rc": os.waitstatus_to_exitcode(status),
                  "wall": time.perf_counter() - t0,
                  "maxrss_kb": usage.ru_maxrss}))
"""


def run_child(args: list[str], cwd: str, env_extra: dict, timeout: float = 600) -> dict:
    """The port's CLI in a child process, on the in-process route; returns
    its stdout, its LAST_RUN_INFO, its wall and its peak RSS
    (``os.wait4``)."""
    import signal

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(IN_PROCESS)
    env.update(env_extra)
    spec = {"argv": [sys.executable, "-c", _CHILD, *args], "cwd": cwd,
            "out": os.path.join(cwd, "child.out"),
            "err": os.path.join(cwd, "child.err")}
    # a process group of its own, so that a timeout stops the launcher and
    # the child together
    launcher = subprocess.Popen(
        [sys.executable, "-c", _LAUNCHER, json.dumps(spec)],
        stdout=subprocess.PIPE, cwd=cwd, env=env, start_new_session=True,
    )
    try:
        report, _ = launcher.communicate(timeout=timeout)
    finally:
        if launcher.returncode is None:
            os.killpg(launcher.pid, signal.SIGKILL)
            launcher.wait()
    with open(spec["err"], "rb") as f:
        stderr = f.read().decode(errors="replace")
    if launcher.returncode != 0:
        raise RuntimeError(f"launcher exited {launcher.returncode}")
    usage = json.loads(report)
    if usage["rc"] != 0:
        raise RuntimeError(f"child CLI exited {usage['rc']}: {stderr[-2000:]}")
    info = json.loads(stderr.strip().splitlines()[-1])
    with open(spec["out"], "rb") as f:
        stdout = f.read()
    return {"out": stdout, "info": info["info"], "jax": info["jax"],
            "wall": usage["wall"], "rss_mb": usage["maxrss_kb"] / 1024}


def end_to_end_lowmem(device_name: str, n: int = 1000, length: int = 1_000_000) -> dict:
    """The 1000 x 1 Mbp panel through the low-memory pipeline and the
    serial one, each in a child process; byte for byte, peak RSS of each."""
    from phylonium_tpu_torch.core.lowmem import group_rows_for
    from phylonium_tpu_torch.ops.pair_count import LAUNCHES_PER_CALL

    group = group_rows_for(n, length)
    groups = -(-n // group)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lowmem_") as tmp:
        files = write_fasta(eco29_panel(n, length, seed=1000), tmp)
        args = ["--progress=never", "--device", device_name, *files]
        low = run_child(args, tmp, {"PHYLONIUM_TPU_LOWMEM": "force"})
        serial = run_child(["--count-backend", "device", *args], tmp,
                           {"PHYLONIUM_TPU_LOWMEM": "0"})
    if low["out"] != serial["out"]:
        raise AssertionError("low-memory output differs from the serial run's")
    check_phylip(low["out"].decode(), n)
    info = low["info"]
    if low["jax"] or serial["jax"]:
        raise AssertionError("a child run imported jax")
    if (info.get("lowmem", {}).get("group_rows") != group
            or info["compare_carrier"] != "cuda-kernel"
            or info["build_kernel_launches"] != groups
            or info["stream_groups"] != groups
            or info["build_plain_calls"] or info["plain_calls"]
            or info["kernel_launches"] != LAUNCHES_PER_CALL):
        raise AssertionError(f"the low-memory run was not device-carried: {info}")
    if "lowmem" in serial["info"] or serial["info"]["kernel_launches"] != LAUNCHES_PER_CALL:
        raise AssertionError(f"the serial run took another path: {serial['info']}")
    print(f"  low-memory e2e {n} x {length}: byte-identical to the serial run; "
          f"{groups} groups of {group}, {groups} build launches, 0 plain calls, "
          f"carrier {info['compare_carrier']}; early ship "
          f"{json.dumps(info.get('early_ship'))}", flush=True)
    for name, r in (("low-mem", low), ("serial", serial)):
        print(f"  {name:8s} peak RSS {r['rss_mb']:.1f} MB, wall {r['wall']:.3f} s, "
              f"phases {json.dumps(r['info']['timings'])}", flush=True)
    return {"group_rows": group, "groups": groups,
            "rss_mb": {"lowmem": low["rss_mb"], "serial": serial["rss_mb"]},
            "wall": {"lowmem": low["wall"], "serial": serial["wall"]}}


def bits_differ(x, y, what: str) -> int:
    """0 when the word tensors ``x`` and ``y`` are equal; raises otherwise."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    if x.shape != y.shape:
        raise AssertionError(f"{what}: {tuple(x.shape)} words against {tuple(y.shape)}")
    diff = int(np.unpackbits((x ^ y).cpu().numpy().view(np.uint8)).sum())
    if diff:
        raise AssertionError(f"{what}: {diff} bits differ")
    return 0


def check_shard_edges(device, tile: int = 64) -> int:
    """The shard kernel at tests/extend_cases.py's edges in 2, 3 and 4
    shards: each shard's words == its plain version's, their OR == K3."""
    import numpy as np

    from phylonium_tpu_torch.ops import anchor_extend, anchor_extend_sharded as aes

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from extend_cases import CASES, texts_on

    for name, make in CASES.items():
        ha, hb, off_a, off_b, lim_a, lim_b, length = make(
            np.random.default_rng(sum(map(ord, name))))
        a, b = texts_on(device, ha, hb, 0)
        jobs = anchor_extend._job_tensor(a, b, off_a, off_b, lim_a, lim_b)
        k3 = anchor_extend._launch(a, b, jobs, length)
        for n_shards in (2, 3, 4):
            host = aes.shard_text(ha, n_shards, tile)
            width = host.shape[1] - tile
            merged = None
            for s, shard in enumerate(aes.place(host, [device] * n_shards)):
                own_end = aes._own_end(s, n_shards, width)
                got = aes._launch(shard, s * width, own_end, b, jobs, length)
                plain = aes.diagonal_neq_shard_reference(shard, s * width, own_end, b,
                                                         jobs, length)
                bits_differ(got, plain, f"{name}, shard {s} of {n_shards}")
                merged = got if merged is None else merged | got
            bits_differ(merged, k3, f"{name}, {n_shards} shards against K3")
        print(f"  shard edge {name} ({len(off_a)} jobs x {length}) in 2, 3 and 4 "
              "shards: kernel == plain, OR == K3", flush=True)
    return 0


def check_shard_production(device) -> dict:
    """The shard kernel at phase 6's two production shapes, the doubled
    5 Mbp text in SHARDS shards on ``device``: the merged words == the plain
    version's == K3's, with the sharded call's, the plain version's and
    K3's times and the bound (K3's plus the merge's words)."""
    from phylonium_tpu_torch.ops import anchor_extend, anchor_extend_sharded as aes

    out = {}
    devices = [device] * SHARDS
    for name, (x, y, oa, ob, la, lb) in extend_shapes(device).items():
        host = aes.shard_text(x.cpu().numpy(), SHARDS, SHARD_TILE)
        width = host.shape[1] - SHARD_TILE
        shards = aes.place(host, devices)
        jobs_dev = anchor_extend._job_tensor(x, y, oa, ob, la, lb)
        args = (shards, [y] * SHARDS, [jobs_dev] * SHARDS, CHUNK, width)
        got = aes.merge(*args, aes._launch)
        plain = aes.merge(*args, aes.diagonal_neq_shard_reference)
        k3 = anchor_extend._launch(x, y, jobs_dev, CHUNK)
        err = max(bits_differ(got, plain, f"shard production {name} against plain"),
                  bits_differ(got, k3, f"shard production {name} against K3"))
        del got, plain, k3
        ms = time_ms(lambda: aes.merge(*args, aes._launch), reps=20)
        plain_ms = time_ms(lambda: aes.merge(*args, aes.diagonal_neq_shard_reference), reps=2)
        k3_ms = time_ms(lambda: anchor_extend._launch(x, y, jobs_dev, CHUNK), reps=20)
        jobs = len(oa)
        k3_bound, _ = extend_bound(jobs_dev, oa, ob, la, lb)
        merge_bytes = (SHARDS - 1) * jobs * (CHUNK // 32) * 4
        bound_ms, bound_by = bound(k3_bound * 1e-3 * HBM_BYTES_S + merge_bytes)
        print(f"  shard production {name} {jobs} x {CHUNK} in {SHARDS} shards of "
              f"{width} bytes: kernel == plain == K3; sharded call ({SHARDS} launches "
              f"and the OR) {ms:.4f} ms, plain {plain_ms:.3f} ms, unsharded K3 "
              f"{k3_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}; K3's "
              f"{k3_bound:.4f} ms and {merge_bytes} merge bytes)", flush=True)
        out[name] = {"jobs": jobs, "ms": ms, "plain_ms": plain_ms, "k3_ms": k3_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}
    return out


def end_to_end_hybrid_sharded(device_name: str, reference: bytes, n: int = 8,
                              length: int = 5_000_000) -> dict:
    """Phase 8's panel with the index text in SHARDS shards on the card
    (X5): byte for byte against the reference CLI's output, every round
    through the shard kernel."""
    from phylonium_tpu_torch.ops import anchor_extend_sharded as aes

    with tempfile.TemporaryDirectory(prefix="chip_smoke_x5_") as tmp:
        files = write_fasta(eco29_panel(n, length, seed=8, low=0.002, span=0.018), tmp)
        args = ["--progress=never", "--map-backend", "hybrid", "--count-backend", "device",
                "--device", device_name, *files]
        saved = aes.shard_devices
        aes.shard_devices = lambda device: [device] * SHARDS
        try:
            r = port_run(args, PHYLONIUM_TPU_SHARDED_EXTEND="1", PHYLONIUM_TPU_STREAM=None,
                         PHYLONIUM_TPU_DEVICE_PILEUP=None)
        finally:
            aes.shard_devices = saved
        launches = aes.KERNEL_LAUNCHES
    info = r["info"]
    if r["out"].encode() != reference:
        raise AssertionError("the X5 hybrid output differs from the JAX package's")
    if "jax" in sys.modules:
        raise AssertionError("the X5 hybrid run imported jax")
    if (launches < SHARDS or launches % SHARDS or info["shard_kernel_launches"] != launches
            or info["shard_plain_calls"] or info["extend_kernel_launches"]
            or info["extend_plain_calls"]):
        raise AssertionError(f"X5 hybrid run: {launches} shard launches, {info}")
    print(f"  X5 hybrid e2e {n} x {length}, index text in {SHARDS} shards on the card: "
          f"byte-identical to the JAX package's native-mapped host count; "
          f"{launches} shard launches in {info['map_rounds']} rounds, 0 unsharded "
          f"launches; wall {r['wall']:.3f} s, phases {json.dumps(r['timings'])}",
          flush=True)
    return {"launches": launches, "rounds": info["map_rounds"], "wall": r["wall"]}


def int_mm_rect_ms(a, b, check) -> float:
    """``torch._int_mm`` on the one-hot operands of ``a`` against ``b``,
    padded to the multiples it asks for; checked against ``check``."""
    import torch

    from phylonium_tpu_torch.ops.match_matrix import onehot_operands

    na, nb = a.shape[0], b.shape[0]
    ops_a, ops_b = onehot_operands(a, b)
    pad_a = max(24, -(-na // 8) * 8) - na
    pad_b = -(-2 * nb // 8) * 8 - 2 * nb
    ops_a = torch.nn.functional.pad(ops_a, (0, 0, 0, pad_a))
    ops_b = torch.nn.functional.pad(ops_b, (0, 0, 0, pad_b))
    out = torch._int_mm(ops_a, ops_b.T)
    matches, homs = check
    if not (torch.equal(out[:na, :nb].to(torch.int64), matches)
            and torch.equal(out[:na, nb : 2 * nb].to(torch.int64), homs)):
        raise AssertionError("torch._int_mm on the shard's one-hot operands disagrees")
    del out
    ms = time_ms(lambda: torch._int_mm(ops_a, ops_b.T))
    del ops_a, ops_b
    torch.cuda.empty_cache()
    return ms


def check_mesh_shard(device, n: int = 29, length: int = 5_000_000,
                     shape: tuple[int, int] = (2, 2), seed: int = 17) -> dict:
    """The pair count at the cell shape rank (0, 0) of a ``shape`` mesh
    gives it on an ``n`` x ``length`` panel: its row block against the
    gathered rows of its column shard, non-symmetric; kernel == plain ==
    ``torch._int_mm``, with times and the bound of that work."""
    import numpy as np

    from phylonium_tpu_torch.ops import pair_count
    from phylonium_tpu_torch.ops.match_matrix import cross_counts_reference
    from phylonium_tpu_torch.ops.match_table import MATCH_PLANES
    from phylonium_tpu_torch.ops.shapes import pack_states
    from phylonium_tpu_torch.ops.states import to_device
    from phylonium_tpu_torch.parallel.distributed import sharded_shape

    rows, cols = shape
    n_pad, lc, l_pad = sharded_shape(n, length, rows, cols)
    nr = n_pad // rows
    packed = pack_states(random_states(np.random.default_rng(seed), n, length), n_pad, l_pad)
    mine = to_device(np.ascontiguousarray(packed[:nr, :lc]), device)
    everyone = to_device(np.ascontiguousarray(packed[:, :lc]), device)
    del packed
    m, h = pair_count.cross_counts(mine, everyone, symmetric=False)
    mr, hr = cross_counts_reference(mine, everyone)
    err = max(compare(m, mr, False), compare(h, hr, False))
    library_ms = int_mm_rect_ms(mine, everyone, (mr, hr))
    del m, h, mr, hr
    ms = time_ms(lambda: pair_count.cross_counts(mine, everyone, symmetric=False))
    plain_ms = time_ms(lambda: cross_counts_reference(mine, everyone))
    # every cell of the block, one multiply-add a cell and state for each
    # match plane and one for validity, over the shard's real states; the
    # two operands read once, two int32 [nr, n_pad] outputs written
    real_rows = min(nr, n)
    states_per_row = -(-length // cols)
    macs = len(MATCH_PLANES) + 1
    bound_ms, bound_by = bound(mine.numel() + everyone.numel() + 2 * 4 * nr * n_pad,
                               2 * macs * real_rows * n * states_per_row)
    print(f"  mesh shard {rows}x{cols} of {n} x {length}: [{nr}, {lc}] x [{n_pad}, {lc}] "
          f"bytes, kernel == plain == torch._int_mm; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, torch._int_mm {library_ms:.3f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}), {100 * bound_ms / ms:.1f} % of the bound", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "cell": [nr, lc]}


_NCCL_CHILD = """
import json, sys, time
import numpy as np
import torch
import torch.distributed as dist
from chip_smoke import random_states
from phylonium_tpu_torch.ops import pair_count
from phylonium_tpu_torch.ops.states import pack_rows, to_device
from phylonium_tpu_torch.parallel.distributed import (
    LAST_COMM,
    comm_account,
    pair_counts_sharded,
)
from phylonium_tpu_torch.parallel.mesh import make_mesh
from phylonium_tpu_torch.parallel.multihost import initialize_distributed

initialize_distributed(sys.argv[4], init_method="file://" + sys.argv[1], world_size=1,
                       rank=0, timeout=300)
n, length = int(sys.argv[2]), int(sys.argv[3])
states = random_states(np.random.default_rng(2), n, length)
mesh = make_mesh((1, 1), sys.argv[5])
pair_count.KERNEL_LAUNCHES = 0
t0 = time.perf_counter()
got = pair_counts_sharded(states, mesh)
sharded_s = time.perf_counter() - t0
launches = pair_count.KERNEL_LAUNCHES
first_steps = dict(LAST_COMM["seconds"])
# a second call: the communicators are up now
t0 = time.perf_counter()
again = pair_counts_sharded(states, mesh)
again_s = time.perf_counter() - t0
t0 = time.perf_counter()
want = pair_count.pair_counts_rows(to_device(pack_rows(states), mesh.device))
rows_s = time.perf_counter() - t0
print(json.dumps({
    "equal": all(np.array_equal(g, w) for g, w in zip(got, want))
             and all(np.array_equal(g, w) for g, w in zip(again, want)),
    "again_s": again_s, "steps": first_steps, "steps_again": LAST_COMM["seconds"],
    "backend": mesh.backend, "device": str(mesh.device), "launches": launches,
    "sharded_s": sharded_s, "rows_s": rows_s,
    "comm": comm_account(n, length, mesh), "jax": "jax" in sys.modules,
}))
dist.destroy_process_group()
"""

_RANK_CHILD = """
import json, sys
from phylonium_tpu_torch.parallel.multihost import initialize_distributed

rank, size, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
initialize_distributed("gloo", init_method="file://" + store, world_size=size,
                       rank=rank, timeout=600)
from phylonium_tpu_torch.cli import main
from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO
rc = main(sys.argv[4:])
print(json.dumps({"rc": rc, "jax": "jax" in sys.modules, "info": LAST_RUN_INFO}),
      file=sys.stderr)
import torch.distributed as dist
dist.destroy_process_group()
sys.exit(rc)
"""


def run_ranks(code: str, argvs: list[list[str]], cwd: str, timeout: float) -> list[dict]:
    """One child process an argv, all started together, each in a process
    group of its own; returns each one's exit code, stdout and stderr.
    Every child is stopped before this returns."""
    import signal

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs, files = [], []
    try:
        for k, argv in enumerate(argvs):
            out = open(os.path.join(cwd, f"rank{k}.out"), "wb")
            err = open(os.path.join(cwd, f"rank{k}.err"), "wb")
            files += [out, err]
            procs.append(subprocess.Popen([sys.executable, "-c", code, *argv], cwd=cwd,
                                          env=env, stdout=out, stderr=err,
                                          start_new_session=True))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        for f in files:
            f.close()
    results = []
    for k, p in enumerate(procs):
        with open(os.path.join(cwd, f"rank{k}.out"), "rb") as f:
            out = f.read()
        with open(os.path.join(cwd, f"rank{k}.err"), "rb") as f:
            err = f.read().decode(errors="replace")
        results.append({"rc": p.returncode, "out": out, "err": err})
    return results


def mesh_nccl(n: int = 600, length: int = 1_000_000, backend: str = "nccl",
              device_name: str = "cuda") -> dict:
    """pair_counts_sharded in a 1-rank NCCL world (a child process) at
    ``n`` x ``length``: equal to pair_counts_rows, bit for bit."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        (r,) = run_ranks(_NCCL_CHILD, [[os.path.join(tmp, "store"), str(n), str(length),
                                        backend, device_name]], tmp, timeout=600)
    if r["rc"] != 0:
        raise RuntimeError(f"the NCCL child exited {r['rc']}: {r['err'][-3000:]}")
    result = json.loads(r["out"].decode().strip().splitlines()[-1])
    comm = result["comm"]
    if (not result["equal"] or result["jax"] or result["backend"] != backend
            or result["launches"] < 1
            or any(comm[f"measured_{k}"] != comm[f"predicted_{k}"] for k in _COMM_KEYS)):
        raise AssertionError(f"the 1-rank NCCL world: {result}")
    print(f"  1-rank {backend} world, {n} x {length}: pair_counts_sharded == "
          f"pair_counts_rows bit for bit on {result['device']}; {result['launches']} "
          f"pair-count launches; sharded {result['sharded_s']:.3f} s (steps "
          f"{json.dumps(result['steps'])}), again {result['again_s']:.3f} s (steps "
          f"{json.dumps(result['steps_again'])}), one-device {result['rows_s']:.3f} s "
          f"(host pack and copy included); collective bytes {json.dumps(comm)}",
          flush=True)
    return result


def rank_world(args: list[str], size: int, reference: bytes, what: str,
               **env) -> tuple[list[dict], list[dict], float]:
    """The port's CLI with ``args`` in a gloo world of ``size`` rank
    processes sharing the card, with ``env`` set (None unsets): rank 0's
    stdout must be ``reference`` byte for byte and the other ranks print
    nothing. Returns each rank's exit code, stdout and stderr, each rank's
    report (its LAST_RUN_INFO) and the world's wall, start-up included."""
    with env_set(**env), tempfile.TemporaryDirectory(prefix="chip_smoke_world_") as tmp:
        store = os.path.join(tmp, "store")
        t0 = time.perf_counter()
        ranks = run_ranks(_RANK_CHILD, [[str(k), str(size), store, *args]
                                        for k in range(size)], tmp, timeout=900)
        wall = time.perf_counter() - t0
    reports = []
    for k, r in enumerate(ranks):
        if r["rc"] != 0:
            raise RuntimeError(f"{what}: rank {k} exited {r['rc']}: {r['err'][-3000:]}")
        reports.append(json.loads(r["err"].strip().splitlines()[-1]))
    if ranks[0]["out"] != reference:
        raise AssertionError(f"{what}: rank 0's output differs from the JAX package's")
    if any(r["out"] for r in ranks[1:]):
        raise AssertionError(f"{what}: a rank other than 0 printed to stdout")
    if any(rep["jax"] for rep in reports):
        raise AssertionError(f"{what}: a rank imported jax")
    return ranks, reports, wall


def mesh_world(files: list[str], reference: bytes, shape: tuple[int, int] = (2, 2),
               device_name: str = "cuda") -> dict:
    """The panel in ``files`` through the port's CLI with ``--mesh R,C`` in a
    gloo world of R*C rank processes sharing the card: rank 0's stdout ==
    ``reference`` byte for byte, the other ranks print nothing, every rank
    counted on the mesh with the kernel."""
    import torch

    size = shape[0] * shape[1]
    args = ["--progress=never", "-v", "-v", "--device", device_name, "--mesh",
            f"{shape[0]},{shape[1]}", *files]
    ranks, reports, wall = rank_world(args, size, reference, "the mesh run")
    from phylonium_tpu_torch.utils.platform import carrier

    want_carrier = carrier(torch.device(device_name))
    # the kernel's launches on a card; its plain version's calls on the CPU
    ran, other = (("kernel_launches", "plain_calls") if want_carrier == "cuda-kernel"
                  else ("plain_calls", "kernel_launches"))
    launches = 0
    for k, (r, rep) in enumerate(zip(ranks, reports)):
        info = rep["info"]
        mesh, comm = info.get("mesh", {}), info.get("mesh", {}).get("comm", {})
        line = f"mapping sharded: process {k}/{size} mapped"
        if (rep["jax"] or info["compare_carrier"] != "mesh" or mesh["rank"] != k
                or mesh["shape"] != list(shape) or mesh["backend"] != "gloo"
                or mesh["shard_carrier"] != want_carrier or info[ran] < 1
                or info[other] or line not in r["err"]
                or any(comm[f"measured_{key}"] != comm[f"predicted_{key}"]
                       for key in _COMM_KEYS)):
            raise AssertionError(f"rank {k}: {info}")
        launches += info[ran]
        mapped = r["err"][r["err"].index(line):].splitlines()[0]
        steps = ", ".join(f"{key} {v:.4f}" for key, v in mesh["seconds"].items())
        print(f"  rank {k} ({mesh['device']}): {mapped}; {info[ran]} "
              f"pair-count launches; phases {json.dumps(info['timings'])}; compare's "
              f"steps (s): {steps}; bytes "
              f"predicted/measured: gather {comm['predicted_gather_recv_bytes']}/"
              f"{comm['measured_gather_recv_bytes']}, all_reduce "
              f"{comm['predicted_psum_bytes']}/{comm['measured_psum_bytes']}, result "
              f"gather {comm['predicted_result_gather_recv_bytes']}/"
              f"{comm['measured_result_gather_recv_bytes']}", flush=True)
    print(f"  --mesh {shape[0]},{shape[1]} e2e, {len(files)} genomes in {size} gloo ranks "
          f"sharing the card: rank 0 byte-identical to the JAX package's host count, "
          f"the others silent; {launches} pair-count launches in all; wall {wall:.3f} s "
          "(rank start-up included)", flush=True)
    return {"launches": launches, "wall": wall,
            "ranks": [rep["info"]["timings"] for rep in reports]}


# what the runs of the pod streamed phase leave unset, unless a run sets it
_PATH_ENV = dict.fromkeys(("PHYLONIUM_TPU_STREAM", "PHYLONIUM_TPU_STREAM_GROUP",
                           "PHYLONIUM_TPU_DEVICE_PILEUP", "PHYLONIUM_TPU_LOWMEM"))


def pod_run(files: list[str], reference: bytes, label: str, streamed: bool,
            size: int = 4, device_name: str = "cuda", **env) -> dict:
    """One run of the panel in ``files`` through the port's CLI without
    ``--mesh`` in ``size`` gloo ranks sharing the card, with ``env`` set.

    Rank 0 byte for byte against ``reference``, the others silent. A
    ``streamed`` run must have taken the pod streamed path on every rank:
    its ``pod stream:`` line, the (size, 1) mesh, one pileup-build launch a
    group of its block, pair-count launches, no plain call (on the CPU:
    the plain calls in their place), and the collective bytes as
    predicted. Otherwise the serial pod route: the map split's line and no
    build. Prints each rank's phases, compare steps and prewarm, and the
    world's wall."""
    import torch

    from phylonium_tpu_torch.parallel.stream_mp import pod_geometry, stream_group_rows
    from phylonium_tpu_torch.utils.platform import carrier

    want_carrier = carrier(torch.device(device_name))
    # the kernels' launches on a card; their plain versions' calls on the CPU
    kinds = ("kernel_launches", "plain_calls")
    ran, other = kinds if want_carrier == "cuda-kernel" else kinds[::-1]
    args = ["--progress=never", "-v", "-v", "--device", device_name, *files]
    with env_set(**{**_PATH_ENV, **env}):
        group = stream_group_rows()
        ranks, reports, wall = rank_world(args, size, reference, f"pod {label} run")
    n = len(files)
    build = count = 0
    for k, (r, rep) in enumerate(zip(ranks, reports)):
        info = rep["info"]
        mesh = info["mesh"]
        comm = mesh["comm"]
        g = pod_geometry(n, comm["panel"][1], size, k)
        groups = -(-g.real_rows // group)
        line = (f"pod stream: process {k}/{size} mapped+fed rows "
                f"[{g.row_lo}, {g.row_hi}) of {n}" if streamed
                else f"mapping sharded: process {k}/{size} mapped")
        ok = (info["compare_carrier"] == "mesh" and mesh["rank"] == k
              and mesh["shard_carrier"] == want_carrier and line in r["err"]
              and info[ran] >= 1 and not info[other] and not info[f"build_{other}"]
              and all(comm[f"measured_{key}"] == comm[f"predicted_{key}"]
                      for key in _COMM_KEYS))
        if streamed:
            ok = (ok and mesh["shape"] == [size, 1] and "mapping sharded:" not in r["err"]
                  and info[f"build_{ran}"] == info["stream_groups"] == groups)
        else:
            ok = ok and "pod stream:" not in r["err"] and info[f"build_{ran}"] == 0
        if not ok:
            raise AssertionError(f"pod {label} run, rank {k}: {info}")
        build += info[f"build_{ran}"]
        count += info[ran]
        steps = ", ".join(f"{key} {v:.4f}" for key, v in mesh["seconds"].items())
        print(f"  {label}, rank {k} ({mesh['device']}, mesh {mesh['shape']}): rows "
              f"[{g.row_lo}, {g.row_hi}); {info[f'build_{ran}']} build and {info[ran]} "
              f"pair-count {ran.replace('_', ' ')}; phases {json.dumps(info['timings'])}; "
              f"compare's steps (s): {steps}; gathered "
              f"{comm['measured_gather_recv_bytes']} bytes; prewarm "
              f"{json.dumps(info.get('prewarm'))}", flush=True)
    print(f"  pod {label}, {n} genomes in {size} gloo ranks sharing the card: rank 0 "
          f"byte-identical to the JAX package's host count, the others silent; "
          f"{build} build and {count} pair-count {ran.replace('_', ' ')} in all; wall "
          f"{wall:.3f} s (rank start-up included)", flush=True)
    return {"build_launches": build, "count_launches": count, "wall": wall,
            "ranks": [rep["info"]["timings"] for rep in reports]}


def pod_streamed(files: list[str], reference: bytes, tmp: str) -> dict:
    """The pod streamed path in 4 gloo ranks sharing the card: the panel by
    the default gate, on the serial pod route (``PHYLONIUM_TPU_STREAM=0``)
    and in groups of 4 rows, in turns; then the first 5 genomes under
    ``force``, the last rank's block pure padding, against the reference CLI
    on those files."""
    runs = {
        "streamed (gate)": pod_run(files, reference, "streamed (gate)", True),
        "serial route": pod_run(files, reference, "serial route", False,
                                PHYLONIUM_TPU_STREAM="0"),
        "streamed, groups of 4": pod_run(files, reference, "streamed, groups of 4", True,
                                         PHYLONIUM_TPU_STREAM_GROUP="4"),
    }
    few = files[:5]
    few_reference = run_reference_cli(["--progress=never", *few], tmp)
    runs["5 genomes, forced"] = pod_run(few, few_reference, "5 genomes, forced", True,
                                        PHYLONIUM_TPU_STREAM="force")
    gate = runs["streamed (gate)"]
    return {"build_launches": gate["build_launches"],
            "count_launches": gate["count_launches"],
            "walls": {label: r["wall"] for label, r in runs.items()}}


def fresh_prewarm(files: list[str], tmp: str) -> dict:
    """The serial CLI on the card in a fresh child process: its prewarm's
    seconds (context, library load, two pair-count launches) and the
    seconds the run waited for it at its first device step."""
    from phylonium_tpu_torch.ops.pair_count import LAUNCHES_PER_CALL

    r = run_child(["--progress=never", "--count-backend", "device", "--device", "cuda",
                   *files], tmp, {k: "" for k in _PATH_ENV})
    info = r["info"]
    prewarm = info.get("prewarm")
    if (r["jax"] or not prewarm or prewarm["launches"] != {"pair_count": LAUNCHES_PER_CALL}
            or info["kernel_launches"] != LAUNCHES_PER_CALL):
        raise AssertionError(f"the fresh process's prewarm: {info}")
    print(f"  fresh process, {len(files)} genomes: prewarm {prewarm['seconds']:.3f} s "
          f"on its thread, the run waited {prewarm['waited']:.4f} s for it; launches "
          f"{json.dumps(prewarm['launches'])} (not in the run's "
          f"{info['kernel_launches']}); phases {json.dumps(info['timings'])}; wall "
          f"{r['wall']:.3f} s", flush=True)
    return {**prewarm, "wall": r["wall"], "timings": info["timings"]}


# what an 'auto' run leaves unset: its routes are the dispatch model's
_AUTO_ENV = dict.fromkeys(_PATH_ENV.keys() | {"PHYLONIUM_TPU_LOWMEM_BYTES",
                                              "PHYLONIUM_TPU_AUTO_DEVICE_GBP"})


def host_ms(fn, runs: int = 3) -> float:
    """Median host-clock ms of ``runs`` calls of ``fn``, each ended by a
    synchronize (for work whose result the host waits for)."""
    import torch

    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def panel_pileup(files: list[str]):
    """The port's host pileup of the panel in ``files``, the first genome
    the reference, mapped by the native mapper: (states, map seconds,
    query bases)."""
    from phylonium_tpu_torch.config import RunConfig
    from phylonium_tpu_torch.core.anchor_stats import min_anchor_length
    from phylonium_tpu_torch.core.map_native import map_batch_native
    from phylonium_tpu_torch.core.pileup import build_pileup
    from phylonium_tpu_torch.data.sequence import gc_content, join
    from phylonium_tpu_torch.index.esa import ESAIndex
    from phylonium_tpu_torch.io.fasta import read_genome
    from phylonium_tpu_torch.utils.progress import ProgressBar

    queries = [join(read_genome(f)).as_array() for f in files]
    subject = join(read_genome(files[0]))
    ref = ESAIndex(subject, backend="native")
    threshold = min_anchor_length(
        RunConfig().anchor_p_value, gc_content(subject.nucl), ref.size
    )
    t0 = time.perf_counter()
    homologies = map_batch_native(ref._native, queries, threshold,
                                  ProgressBar("", len(queries), enabled=False), 0)
    map_s = time.perf_counter() - t0
    states = build_pileup(queries, homologies, len(subject))
    return states, map_s, sum(len(q) for q in queries)


def dispatch_constants(device, files: list[str]) -> dict:
    """The card's numbers of the dispatch model, in turns in this process.

    On the host pileup of the panel in ``files`` (116 eco29-shaped
    genomes of 5 Mbp; its rows stacked again past 116, to 464): the host count
    (``pair_counts_host``, whose speed depends on the data: random states
    run it some 50x slower) and the card's serial count
    (``pair_counts``: host pack and pinned staging, copy, kernels, result
    fetch) at n of 8 to 464, in the order host, card, card, host, equal
    bit for bit; the host count's Gbp/s at 29 and 116; the pair work above
    which the card wins (interpolated in log time between the last n
    where the host wins and the next, where the card does); the native mapper's
    query Gbp/s on the panel; and at 29 rows the serial route's parts: the
    pack and staging (bases a second), the copy (MB/s, CUDA events) and
    the resident count, launch and fetch (the tail)."""
    import numpy as np
    import torch

    from phylonium_tpu_torch.ops import pair_count
    from phylonium_tpu_torch.ops.bitplane_host import pair_counts_host
    from phylonium_tpu_torch.ops.states import pack_rows

    states, map_s, total_bp = panel_pileup(files)
    length = states.shape[1]
    states = np.concatenate([states] * 4)
    pair_counts_host(states[:2])  # warm: the native library, the context,
    pair_count.pair_counts(states[:2], device)  # the kernel's first launch
    sweep = []
    for n in (8, 16, 29, 48, 64, 96, 116, 160, 232, 348, 464):
        panel = states[:n]
        times = {"host": [], "card": []}
        results = {}
        for turn in ("host", "card", "card", "host"):
            t0 = time.perf_counter()
            results[turn] = (pair_counts_host(panel) if turn == "host"
                             else pair_count.pair_counts(panel, device))
            times[turn].append(time.perf_counter() - t0)
        if not all(np.array_equal(a, b) for a, b in zip(results["host"], results["card"])):
            raise AssertionError(f"host and card counts differ at {n} x {length}")
        work = n * (n - 1) / 2 * length / 1e9
        row = {"n": n, "work_gbp": work, "host_s": statistics.mean(times["host"]),
               "card_s": statistics.mean(times["card"])}
        sweep.append(row)
        print(f"  compare {n} x {length} ({work:.3f} Gbp of pair work): host "
              f"{row['host_s']:.4f} s ({work / row['host_s']:.2f} Gbp/s), card serial "
              f"{row['card_s']:.4f} s, in turns host, card, card, host; equal", flush=True)
    # the upper crossing: the last n where the host wins before the card
    # does (the host's rate grows with n, so the card's serial count can
    # also win at the smallest panels, by a few ms)
    crossing = None
    for a, b in zip(sweep, sweep[1:]):
        if a["host_s"] <= a["card_s"] and b["host_s"] > b["card_s"]:
            la = np.log(a["host_s"] / a["card_s"])
            lb = np.log(b["host_s"] / b["card_s"])
            crossing = float(a["work_gbp"] * (b["work_gbp"] / a["work_gbp"]) ** (la / (la - lb)))
    # the serial route's parts at 29 rows
    panel = states[:29]
    pack_ms = host_ms(lambda: torch.from_numpy(pack_rows(panel)).pin_memory())
    staged = torch.from_numpy(pack_rows(panel)).pin_memory()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    copies = []
    for _ in range(3):
        start.record()
        rows = staged.to(device, non_blocking=True)
        end.record()
        end.synchronize()
        copies.append(start.elapsed_time(end))
    copy_ms = statistics.median(copies)
    tail_ms = host_ms(lambda: pair_count.pair_counts_rows(rows))
    serial_ms = host_ms(lambda: pair_count.pair_counts(panel, device))
    by_n = {row["n"]: row for row in sweep}
    out = {
        "host_compare_gbps_29": by_n[29]["work_gbp"] / by_n[29]["host_s"],
        "host_compare_gbps_116": by_n[116]["work_gbp"] / by_n[116]["host_s"],
        "crossing_gbp": crossing,
        "map_gbps": total_bp / 1e9 / map_s,
        "pack_bps": 29 * length / (pack_ms / 1e3),
        "link_mb_s": staged.numel() / 1e6 / (copy_ms / 1e3),
        "tail_s": tail_ms / 1e3,
        "serial_s": serial_ms / 1e3,
        "sweep": sweep,
    }
    print(f"  dispatch constants: host compare {out['host_compare_gbps_29']:.2f} Gbp/s "
          f"at 29 x {length}, {out['host_compare_gbps_116']:.2f} at 116 x {length}; "
          f"host and card serial compare cross at {crossing} Gbp of pair work; native "
          f"mapping {out['map_gbps']:.4f} query Gbp/s ({len(files)} genomes in "
          f"{map_s:.3f} s); at 29 x {length}: pack and pinned staging {pack_ms:.3f} ms "
          f"({out['pack_bps']:.4g} bases/s), copy {copy_ms:.3f} ms "
          f"({out['link_mb_s']:.1f} MB/s), resident count (launch and fetch, the tail) "
          f"{tail_ms:.3f} ms; the serial count whole {serial_ms:.3f} ms", flush=True)
    del rows, staged
    torch.cuda.empty_cache()
    return out


def shipped_group(device, rows: int = 29, length: int = 5_000_000, seed: int = 116) -> dict:
    """One mapped group shipped by the early query shipper: its words on
    the card equal the host pack; the feeder's host prep with and without
    them; the pileup-build kernel on the resident words, byte for byte the
    unshipped build, with its time and bound."""
    import torch

    from phylonium_tpu_torch.core.query_ship import QueryShipper
    from phylonium_tpu_torch.ops import pileup_device
    from phylonium_tpu_torch.ops.pileup_prep import group_payload
    from phylonium_tpu_torch.ops.states import packed_width

    queries, homologies, ref_len = mapped_group(rows, length, seed)
    shipper = QueryShipper(rows, device, group_rows=rows)
    try:
        for q in queries:
            shipper.add(q)
        resident = shipper.take(0, rows)
    finally:
        shipper.stop()
    if resident.words.cpu().numpy().tobytes() != group_payload(queries)[0].tobytes():
        raise AssertionError("the shipped words differ from the host pack")
    t0 = time.perf_counter()
    full = pileup_device.prepare_group(queries, homologies, ref_len)
    full_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    shipped = pileup_device.prepare_group(queries, homologies, ref_len,
                                          resident=resident[:3])
    shipped_ms = 1e3 * (time.perf_counter() - t0)
    width = packed_width(ref_len)
    built = []
    for inputs in (full, shipped):
        t = [a if torch.is_tensor(a) else torch.from_numpy(a).to(device) for a in inputs]
        out = torch.empty((rows, width), dtype=torch.uint8, device=device)
        pileup_device.build_packed_rows(t[0], t[1], tuple(t[2:]), ref_len, out)
        built.append((t, out))
    torch.cuda.synchronize()
    err = build_compare(built[1][1], built[0][1], f"a shipped {rows} x {length} group")
    t, out = built[1]
    ms = time_ms(lambda: pileup_device._launch(t[0], t[1], tuple(t[2:]), ref_len, out),
                 reps=5)
    read = sum(x.numel() * x.element_size() for x in t)
    bound_ms, bound_by = bound(read + rows * width)
    print(f"  shipped group {rows} x {length}: {resident.words.numel() * 4} bytes of codes "
          f"on the card == the host pack; the shipped build == the unshipped one, byte "
          f"for byte; kernel on the resident words {ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}); the feeder's host prep {shipped_ms:.3f} ms with the resident "
          f"codes against {full_ms:.3f} ms packing them", flush=True)
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "prep_ms": shipped_ms, "prep_full_ms": full_ms}


def auto_run(label: str, files: list[str], reference: bytes) -> dict:
    """One 'auto' run of the port's CLI on the card with no routing
    variable, against ``reference`` byte for byte. The route is the
    dispatch model's: on the host no kernel launches; streamed, every fed
    group is taken from the early shipper (none repacked), one build
    launch a group and one count call; serial on the card, one count call.
    Prints the store it read, the models' decisions and the route."""
    from phylonium_tpu_torch.ops.pair_count import LAUNCHES_PER_CALL

    store_path = os.environ["PHYLONIUM_TPU_CALIBRATION_FILE"]
    store = {}
    if os.path.exists(store_path):
        with open(store_path) as f:
            store = json.load(f)
    r = port_run(["--progress=never", "--device", "cuda", *files], **_AUTO_ENV)
    if r["out"].encode() != reference:
        raise AssertionError(f"auto run '{label}' differs from the JAX package's host count")
    info, c = r["info"], r["counts"]
    ship = info.get("early_ship")
    groups = info["stream_groups"]
    if info["compare_carrier"] == "host":
        route = "host"
        ok = not any(c.values()) and not groups and not ship
    elif groups:
        route = "streamed"
        ok = (ship is not None and ship["taken"] == groups == c["build_launches"]
              and ship["repacked"] == 0 and ship["groups"] >= groups
              and c["count_launches"] == LAUNCHES_PER_CALL
              and not c["count_plain"] and not c["build_plain"])
    else:
        route = "card, serial"
        ok = (c["count_launches"] == LAUNCHES_PER_CALL and not c["build_launches"]
              and not c["count_plain"] and not ship)
    if not ok or "jax" in sys.modules:
        raise AssertionError(f"auto run '{label}' on the {route} route: {c}, {info}")
    print(f"  auto {label}, {len(files)} genomes: byte-identical to the JAX package's host "
          f"count; store read {json.dumps({k: v for k, v in store.items() if k != 'updated'})}"
          f"; dispatch model {json.dumps(info.get('dispatch_model'))}, stream model "
          f"{json.dumps(info.get('stream_model'))} -> route {route}; early ship "
          f"{json.dumps(ship)}; launches {json.dumps(c)}; wall {r['wall']:.3f} s, phases "
          f"{json.dumps(r['timings'])}", flush=True)
    return {"route": route, "counts": c, "early_ship": ship, "wall": r["wall"],
            "timings": r["timings"], "dispatch_model": info.get("dispatch_model"),
            "stream_model": info.get("stream_model")}


def auto_dispatch(device, eco_files: list[str], eco_reference: bytes,
                  wide_files: list[str], tmp: str) -> dict:
    """Phase 19: the dispatch model's constants, a shipped group, then the
    'auto' CLI on one calibration store that starts empty. While the store
    holds no copy rate the static rule decides: a small panel, 29 x 5 Mbp,
    116 x 5 Mbp and 600 x 1 Mbp, whose work is far above the crossing, so
    it streams and its shipper records the first copy rate; then the
    measured models decide 29 x 5 Mbp, 116 x 5 Mbp and the small panel."""
    constants = dispatch_constants(device, wide_files)
    group = shipped_group(device)
    panels = {}
    for name, n, length, seed in (("small", 3, 100_000, 3), ("600 x 1 Mbp", 600, 1_000_000, 600)):
        directory = os.path.join(tmp, name.replace(" ", "_"))
        os.makedirs(directory, exist_ok=True)
        files = write_fasta(eco29_panel(n, length, seed=seed), directory)
        panels[name] = (files, run_reference_cli(["--progress=never", *files], directory))
    panels["29 x 5 Mbp"] = (eco_files, eco_reference)
    panels["116 x 5 Mbp"] = (wide_files, run_reference_cli(["--progress=never", *wide_files],
                                                           tmp))
    runs = {}
    for name, store in (("small", "no copy rate"), ("29 x 5 Mbp", "no copy rate"),
                        ("116 x 5 Mbp", "no copy rate"), ("600 x 1 Mbp", "no copy rate"),
                        ("29 x 5 Mbp", "filled"), ("116 x 5 Mbp", "filled"),
                        ("small", "filled")):
        label = f"{name}, store {store}"
        runs[label] = auto_run(label, *panels[name])
    streamed = [r for r in runs.values() if r["route"] == "streamed"]
    if not streamed:
        raise AssertionError("no 'auto' run streamed: the shipped route was not driven")
    return {"constants": constants, "group": group, "runs": runs,
            "wide_reference": panels["116 x 5 Mbp"][1],
            "panel_600": panels["600 x 1 Mbp"],
            "build_launches": sum(r["counts"]["build_launches"] for r in runs.values()),
            "count_launches": sum(r["counts"]["count_launches"] for r in runs.values())}


# One CLI run in a child process, through the port's entry point: the
# module of `python -m phylonium_tpu_torch`, run by runpy after wrapping
# cli.main and cli.process. Each pass's LAST_RUN_INFO, whether the
# process imported torch and initialized CUDA, and the clock at its first
# line, after its imports and around cli.main go to the file named by the
# first argument; the entry point then ends the process as it does (the
# port's: the PHYLONIUM_TPU_EXPECT_NO_TORCH guard, then os._exit).
_CLI_CHILD = """
import time
started, t0 = time.time(), time.perf_counter()
import json, runpy, sys
report, *args = sys.argv[1:]
sys.argv = ["phylonium_tpu_torch", *args]
import phylonium_tpu_torch.cli as cli
from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO
passes = []
process, main = cli.process, cli.main
def recorded(*args, **kwargs):
    counts = process(*args, **kwargs)
    passes.append(json.loads(json.dumps(LAST_RUN_INFO)))
    return counts
t1 = time.perf_counter()
def timed(argv=None):
    t2 = time.perf_counter()
    rc = main(argv)
    t3 = time.perf_counter()
    torch = sys.modules.get("torch")
    with open(report, "w") as f:
        json.dump({"rc": rc, "passes": passes, "jax": "jax" in sys.modules,
                   "torch": torch is not None,
                   "cuda_initialized": torch is not None and torch.cuda.is_initialized(),
                   "started": started, "import_s": t1 - t0, "main_s": t3 - t2,
                   "ended": time.time()}, f)
    return rc
cli.process, cli.main = recorded, timed
runpy.run_module("phylonium_tpu_torch", run_name="__main__", alter_sys=True)
"""

_CLI_ENV = dict.fromkeys((
    "PHYLONIUM_TPU_DEVD", "PHYLONIUM_TPU_DEVD_INJECT", "PHYLONIUM_TPU_LOWMEM",
    "PHYLONIUM_TPU_STREAM", "PHYLONIUM_TPU_STREAM_GROUP", "PHYLONIUM_TPU_DEVICE_PILEUP",
    "PHYLONIUM_TPU_RUN_REPORT", "PHYLONIUM_TPU_SHARDED_EXTEND",
    "PHYLONIUM_TPU_EXPECT_NO_TORCH", "PHYLONIUM_TPU_AUTO_DEVICE_GBP"))


def cli_child(args: list[str], cwd: str, env_extra: dict, timeout: float = 300,
              repo: str = REPO) -> dict:
    """The port's CLI of the tree at ``repo`` in a child process, through
    its entry point (``_CLI_CHILD``; its own process group, killed whole at
    the timeout): rc, stdout, stderr, wall, each pass's LAST_RUN_INFO,
    whether the child imported torch and initialized CUDA, and the wall in
    pieces: ``start_s`` (the interpreter's start, to the child's first
    line), ``import_s``, ``main_s`` (``cli.main``) and ``exit_s`` (from
    the end of ``cli.main`` to the child's exit: the entry point's exit
    and, where it made one, the CUDA context's teardown)."""
    import signal

    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    for key, value in {**_CLI_ENV, **env_extra}.items():
        if value is None:
            env.pop(key, None)
        else:
            env[key] = value
    report = os.path.join(cwd, "cli_child.json")
    if os.path.exists(report):
        os.unlink(report)
    t0, spawned = time.perf_counter(), time.time()
    proc = subprocess.Popen([sys.executable, "-c", _CLI_CHILD, report, *args], cwd=cwd,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"the CLI hung: no exit within {timeout} s ({env_extra})")
    wall, exited = time.perf_counter() - t0, time.time()
    result = {"rc": proc.returncode, "out": out, "err": err.decode(errors="replace"),
              "wall": wall, "passes": [], "torch": None, "cuda_initialized": None}
    if os.path.exists(report):
        with open(report) as f:
            child = json.load(f)
        if child["jax"]:
            raise AssertionError("a CLI child imported jax")
        result.update(passes=child["passes"], torch=child["torch"],
                      cuda_initialized=child["cuda_initialized"],
                      start_s=child["started"] - spawned, import_s=child["import_s"],
                      main_s=child["main_s"], exit_s=exited - child["ended"])
    return result


def pid_alive(pid: int) -> bool:
    """A process that exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def daemon_pids(sock: str) -> set[int]:
    """Every daemon that served ``sock``, from the log the CLI's spawns
    append to ("devd: serving ... (pid N, ...)")."""
    import re

    try:
        with open(sock + ".log") as f:
            return {int(m) for m in re.findall(r"devd: serving .* \(pid (\d+),", f.read())}
    except OSError:
        return set()


def stop_daemon(sock: str) -> int | None:
    """SIGTERM the daemon of ``sock`` by its pidfile and wait for it; fail
    unless it is gone and its socket and pidfile are removed. A pidfile
    whose daemon died by SIGKILL is removed here, with its socket."""
    import signal

    try:
        with open(sock + ".pid") as f:
            pid = int(f.read().strip())
    except OSError:
        if os.path.exists(sock):
            raise AssertionError(f"{sock} without a pidfile")
        return None
    if not pid_alive(pid):
        for path in (sock, sock + ".pid"):
            if os.path.exists(path):
                os.unlink(path)
        return pid
    os.kill(pid, signal.SIGTERM)
    deadline = time.time() + 30
    while time.time() < deadline and pid_alive(pid):
        time.sleep(0.05)
    if pid_alive(pid):
        os.kill(pid, signal.SIGKILL)
        raise AssertionError(f"the daemon {pid} outlived SIGTERM by 30 s")
    if os.path.exists(sock) or os.path.exists(sock + ".pid"):
        raise AssertionError(f"the daemon {pid} left {sock} behind")
    return pid


def devd_check(label: str, r: dict, reference: bytes, groups: int, passes: int = 1,
               device_name: str = "cuda", torch_free: bool = True) -> dict:
    """One device-server run: byte for byte against ``reference``, the
    server's launches (one build a group, one count call; plain calls on a
    CPU server), every group taken from the shipper, no CUDA in the CLI
    process and, with ``torch_free`` (every tree since the client stopped
    importing torch), no torch either. Returns the last pass."""
    from phylonium_tpu_torch.ops.pair_count import LAUNCHES_PER_CALL

    card = device_name == "cuda"
    launches = {"build": groups * card, "build_plain": groups * (not card),
                "count": LAUNCHES_PER_CALL * card, "count_plain": int(not card)}
    if r["rc"] != 0:
        raise AssertionError(f"device-server run '{label}' exited {r['rc']}: {r['err'][-2000:]}")
    if r["out"] != reference:
        raise AssertionError(f"device-server run '{label}' differs from the JAX package's")
    if (r["cuda_initialized"] is not False or len(r["passes"]) != passes
            or (torch_free and r["torch"] is not False)):
        raise AssertionError(f"run '{label}': CUDA initialized {r['cuda_initialized']}, "
                             f"torch imported {r['torch']}, {len(r['passes'])} passes")
    for info in r["passes"]:
        server, ship = info.get("devd"), info.get("early_ship")
        if (server is None or server["launches"] != launches or info["cuda_initialized"] or info["kernel_launches"]
                or info["build_kernel_launches"] or ship is None
                or ship["taken"] != groups or ship["repacked"]):
            raise AssertionError(f"run '{label}': {json.dumps(info)}")
    return r["passes"][-1]


def device_server(wide_files: list[str], wide_reference: bytes, eco_files: list[str],
                  eco_reference: bytes, tmp: str, device_name: str = "cuda") -> dict:
    """Phase 20: the device server (serve/) under ``PHYLONIUM_TPU_DEVD=1``.

    Every daemon serves a socket in this phase's directory and is stopped
    in the ``finally``; none may outlive the phase. The 116 x 5 Mbp panel
    streamed under ``PHYLONIUM_TPU_STREAM=force``: a cold run that spawns
    the daemon, then two warm runs through it (phase 22 and
    ``--devd-turns`` hold the server against the in-process route); the
    29 x 5 Mbp panel with ``-2`` and under
    ``PHYLONIUM_TPU_LOWMEM=force``; then the faults, at 6 x 200 kbp: an
    injected poison (the run after it spawns a fresh daemon), and a
    daemon killed after its first ``group`` reply. Every run is a child
    process through the port's entry point, byte for byte against the JAX
    package's host count; no devd run's CLI imports torch (under
    ``PHYLONIUM_TPU_EXPECT_NO_TORCH``) or initializes CUDA.
    (``device_name="cpu"`` rehearses the phase without a card.)"""
    from phylonium_tpu_torch.core.lowmem import group_rows_for
    from phylonium_tpu_torch.core.stream import effective_group_rows
    from phylonium_tpu_torch.ops.states import packed_width
    from phylonium_tpu_torch.serve.daemon import PROTOCOL

    directory = os.path.join(tmp, "devd")
    os.makedirs(directory, exist_ok=True)
    sock = os.path.join(directory, "d.sock")
    # the client imports no torch: under the guard a breach exits 70
    devd_env = {"PHYLONIUM_TPU_DEVD_SOCK": sock, "PHYLONIUM_TPU_DEVD_IDLE_S": "900",
                "PHYLONIUM_TPU_STREAM": "force", "PHYLONIUM_TPU_DEVD": "1",
                "PHYLONIUM_TPU_EXPECT_NO_TORCH": "1"}
    card = device_name == "cuda"
    wide = ["--progress=never", "--device", device_name, *wide_files]
    eco = ["--progress=never", "--device", device_name, *eco_files]
    n = len(wide_files)
    groups = -(-n // effective_group_rows(n))
    eco_groups = -(-len(eco_files) // effective_group_rows(len(eco_files)))
    runs = {}
    try:
        for label in ("cold", "warm 1", "warm 2"):
            r = cli_child(wide, directory, devd_env)
            info = devd_check(label, r, wide_reference, groups, device_name=device_name)
            ship, server = info["early_ship"], info["devd"]
            hits = 0 if label == "cold" else groups
            if ship["cache_hits"] != hits or (ship["mb"] == 0.0) != bool(hits):
                raise AssertionError(f"run '{label}': early ship {ship}")
            if server["socket"] != sock or server["protocol"] != PROTOCOL:
                raise AssertionError(f"run '{label}': server {server}")
            runs[label] = {"wall": r["wall"], "timings": info["timings"],
                           "devd_count_s": info["devd_count_s"],
                           "finish_wait_s": server["finish_wait_s"],
                           "cache_hits": ship["cache_hits"], "mb": ship["mb"],
                           "launches": server["launches"],
                           "memory_reserved": server["memory_reserved"]}
            print(f"  {label:13s} {n} genomes: byte-identical to the JAX package's host count; "
                  f"wall {r['wall']:.3f} s, devd_count_s {runs[label]['devd_count_s']}, finish "
                  f"wait {runs[label]['finish_wait_s']}, {ship['cache_hits']} cache hits, "
                  f"{ship['mb']} MB shipped, server launches {json.dumps(runs[label]['launches'])}"
                  f", server memory_reserved {runs[label]['memory_reserved']}, CUDA initialized "
                  f"in the CLI {r['cuda_initialized']}; phases {json.dumps(info['timings'])}",
                  flush=True)
        warm = [runs[k] for k in ("warm 1", "warm 2")]
        # a panel left reserved by each run (a stream a run) grows the
        # daemon by one panel a run
        panel_bytes = n * packed_width(max(os.path.getsize(f) for f in wide_files))
        grew = warm[1]["memory_reserved"] - warm[0]["memory_reserved"]
        if card and grew >= panel_bytes:
            raise AssertionError(f"the daemon's reserved memory grew by {grew} bytes between "
                                 f"two warm runs of one panel ({panel_bytes} bytes a panel)")
        tail = statistics.median(w["finish_wait_s"] for w in warm)
        print(f"  devd tail (the client's wait for a warm server's finish, median of 2): "
              f"{tail:.6f} s; warm walls {[round(w['wall'], 3) for w in warm]} s; the "
              f"daemon's reserved memory grew by {grew} bytes between the warm runs",
              flush=True)

        reference_2 = run_reference_cli(["--progress=never", "-2", *eco_files], directory)
        r = cli_child(["-2", *eco], directory, devd_env)
        devd_check("-2", r, reference_2, eco_groups, passes=2, device_name=device_name)
        print(f"  -2, {len(eco_files)} genomes: byte-identical; both passes built from the pieces "
              f"shipped once ({json.dumps(r['passes'][1]['early_ship'])}); wall "
              f"{r['wall']:.3f} s", flush=True)

        # the group the CLI predicts from the file sizes (cli._start_shipper)
        est_bp = int(sum(os.path.getsize(f) for f in eco_files) * 0.98)
        lowmem_groups = -(-len(eco_files) // group_rows_for(
            len(eco_files), max(1, est_bp // len(eco_files))))
        r = cli_child(eco, directory, {**devd_env, "PHYLONIUM_TPU_LOWMEM": "force"})
        info = devd_check("low-memory", r, eco_reference, lowmem_groups,
                          device_name=device_name)
        if "lowmem" not in info:
            raise AssertionError("the low-memory run took another path")
        print(f"  low-memory, {len(eco_files)} genomes: byte-identical, {lowmem_groups} groups built in the "
              f"server, devd_count_s {info['devd_count_s']}; wall {r['wall']:.3f} s", flush=True)

        # the faults, each on a daemon the faulty run spawns, at a small
        # panel in 3 groups: what they check does not depend on its size
        small_dir = os.path.join(directory, "small")
        os.makedirs(small_dir, exist_ok=True)
        small_files = write_fasta(eco29_panel(6, 200_000, seed=6), small_dir)
        small_reference = run_reference_cli(["--progress=never", *small_files], small_dir)
        small = ["--progress=never", "--device", device_name, *small_files]
        small_env = {**devd_env, "PHYLONIUM_TPU_STREAM_GROUP": "2"}
        stop_daemon(sock)
        r = cli_child(small, directory, {**small_env, "PHYLONIUM_TPU_DEVD_INJECT": "poison"})
        deadline = time.time() + 30
        while time.time() < deadline and os.path.exists(sock + ".pid"):
            time.sleep(0.05)
        if (r["rc"] != 1 or r["out"] or f"device server at {sock}" not in r["err"]
                or "poisoned" not in r["err"] or os.path.exists(sock + ".pid")):
            raise AssertionError(f"poisoned run: rc {r['rc']}, {r['err'][-2000:]}")
        message = r["err"].strip().splitlines()[-1]
        # the next run spawns a fresh daemon
        r = cli_child(small, directory, small_env)
        info = devd_check("after the poison", r, small_reference, 3, device_name=device_name)
        print(f"  poison, {len(small_files)} x 200 kbp: exit 1, no matrix, '{message[:240]}'; "
              f"the daemon exited, and the next run spawned pid {info['devd']['pid']} and "
              f"printed the right matrix; wall {r['wall']:.3f} s", flush=True)

        stop_daemon(sock)
        r = cli_child(small, directory,
                       {**small_env, "PHYLONIUM_TPU_DEVD_INJECT": "kill_after_group"},
                       timeout=180)
        killed = stop_daemon(sock)
        if r["rc"] == 0 or r["out"] or killed is None or pid_alive(killed):
            raise AssertionError(f"killed daemon: rc {r['rc']}, {r['err'][-2000:]}")
        print(f"  killed daemon (SIGKILL after its first group reply): exit {r['rc']} in "
              f"{r['wall']:.3f} s, no matrix, '{r['err'].strip().splitlines()[-1][:240]}'",
              flush=True)
    finally:
        stop_daemon(sock)
        alive = [pid for pid in daemon_pids(sock) if pid_alive(pid)]
        if alive:
            raise AssertionError(f"daemons outlived the phase: {alive}")
    print(f"  {len(daemon_pids(sock))} daemons served the phase; none outlived it", flush=True)
    return {"runs": runs, "tail_s": tail,
            "build_launches": runs["warm 1"]["launches"]["build"],
            "count_launches": runs["warm 1"]["launches"]["count"]}


_PIECES = ("start_s", "import_s", "main_s", "exit_s")


def device_server_turns(pairs: int, files: list[str], reference: bytes, tmp: str,
                        device_name: str = "cuda") -> dict:
    """The default route against the in-process route at the panel of
    ``files`` (``--devd-turns``; 116 x 5 Mbp on the card), ``pairs`` pairs,
    with no routing variable but ``PHYLONIUM_TPU_DEVD=0`` on the
    in-process side: both stream by the gate, on one calibration store
    that an untimed in-process run fills first (``fill_store``). Each pair
    is a warm run through a daemon that one cold default run just spawned
    and filled, and an in-process run with no daemon alive (it is stopped
    first, so no in-process run shares the card with one); the pairs
    alternate which route runs first. Every run is a CLI child, byte
    for byte against ``reference``, with its wall in pieces (``cli_child``)
    and its phases; the default runs under
    ``PHYLONIUM_TPU_EXPECT_NO_TORCH=1``. Prints each run, then the medians
    by route and the in-process minus warm differences by pair."""
    from phylonium_tpu_torch.core.stream import effective_group_rows

    directory = os.path.join(tmp, "turns")
    os.makedirs(directory, exist_ok=True)
    sock = os.path.join(directory, "d.sock")
    base = {"PHYLONIUM_TPU_DEVD_SOCK": sock, "PHYLONIUM_TPU_DEVD_IDLE_S": "900",
            "PHYLONIUM_TPU_CALIBRATION_FILE": os.path.join(directory, "calibration.json")}
    card = device_name == "cuda"
    devd_env = {**base, "PHYLONIUM_TPU_EXPECT_NO_TORCH": "1"}
    if card:
        fill_store(files, directory, base)
    else:
        # a rehearsal on the CPU, where the stream gate and the server's
        # default are off: both forced
        base["PHYLONIUM_TPU_STREAM"] = devd_env["PHYLONIUM_TPU_STREAM"] = "force"
        devd_env["PHYLONIUM_TPU_DEVD"] = "1"
    args = ["--progress=never", "--device", device_name, *files]
    groups = -(-len(files) // effective_group_rows(len(files)))

    def run(label: str, served: bool) -> dict:
        r = cli_child(args, directory, devd_env if served else {**base, **IN_PROCESS})
        if served:
            info = devd_check(label, r, reference, groups, device_name=device_name)
            hits = 0 if label.startswith("cold") else groups
            if info["early_ship"]["cache_hits"] != hits:
                raise AssertionError(f"run '{label}': early ship {info['early_ship']}")
        else:
            if r["rc"] != 0 or r["out"] != reference:
                raise AssertionError(f"in-process run '{label}': {r['err'][-2000:]}")
            info = r["passes"][-1]
            if (info.get("devd") or info["cuda_initialized"] != card
                    or info["stream_groups"] != groups):
                raise AssertionError(f"in-process run '{label}': {json.dumps(info)}")
        row = {"label": label, "wall": r["wall"], "phases": sum(info["timings"].values()),
               **{k: r[k] for k in _PIECES}}
        row["main_outside_phases"] = row["main_s"] - row["phases"]
        print(f"  {label:16s} wall {r['wall']:.3f} s = start {r['start_s']:.3f} + import "
              f"{r['import_s']:.3f} + main {r['main_s']:.3f} (phases {row['phases']:.3f}) "
              f"+ exit {r['exit_s']:.3f}; phases {json.dumps(info['timings'])}", flush=True)
        return row

    rows = []
    try:
        for i in range(pairs):
            order = ("served", "in-process") if i % 2 == 0 else ("in-process", "served")
            pair = {}
            for route in order:
                stop_daemon(sock)
                if route == "served":
                    rows.append(run(f"cold {i + 1}", True))
                    pair["warm"] = run(f"warm {i + 1}", True)
                    rows.append(pair["warm"])
                else:
                    pair["local"] = run(f"in-process {i + 1}", False)
                    rows.append(pair["local"])
            pair["first"] = order[0]
    finally:
        stop_daemon(sock)
        alive = [pid for pid in daemon_pids(sock) if pid_alive(pid)]
        if alive:
            raise AssertionError(f"daemons outlived the turns: {alive}")

    def by(prefix: str) -> list[dict]:
        return [r for r in rows if r["label"].startswith(prefix)]

    keys = ("wall", *_PIECES, "phases", "main_outside_phases")
    medians = {route: {k: statistics.median(r[k] for r in by(prefix)) for k in keys}
               for route, prefix in (("cold", "cold"), ("warm", "warm"),
                                     ("in_process", "in-process"))}
    warm, local = by("warm"), by("in-process")
    diffs = {k: [round(b[k] - a[k], 6) for a, b in zip(warm, local)] for k in keys}
    summary = {
        "pairs": pairs, "panel": f"{len(files)} x {os.path.getsize(files[0])} bytes",
        "medians_s": medians,
        "in_process_minus_warm_s": diffs,
        "median_in_process_minus_warm_s": {k: statistics.median(v) for k, v in diffs.items()},
        "warm_faster_in": sum(d > 0 for d in diffs["wall"]),
        "warm_first_pairs_median_wall_diff_s": statistics.median(diffs["wall"][0::2]),
        "in_process_first_pairs_median_wall_diff_s": (
            statistics.median(diffs["wall"][1::2]) if pairs > 1 else None),
    }
    print(f"  devd turns: {json.dumps(summary)}", flush=True)
    return summary


# The lazy-startup runs of phase 21 and ``--startup-turns``, by kind: the
# CLI's flags, its environment, and whether the CLI process may import
# torch. (a) 'auto' with no routing variable on an empty calibration
# store, which the static rule sends to the host; (b) the host count by
# flag; (c) through a warm device server; (d) in process, streamed. Each
# pins its route, so that a tree whose default differs takes the same one.
_STARTUP = {
    "a": ([], {}, False),
    "b": (["--count-backend", "host"], {}, False),
    "c": ([], {"PHYLONIUM_TPU_DEVD": "1", "PHYLONIUM_TPU_STREAM": "force"}, False),
    "d": ([], {**IN_PROCESS, "PHYLONIUM_TPU_STREAM": "force"}, True),
}


def route_of(info: dict) -> str:
    """The route a run took, from its last pass's LAST_RUN_INFO."""
    if info.get("devd"):
        return "device server"
    if info["compare_carrier"] == "host":
        return "host"
    return "in process, streamed" if info["stream_groups"] else "in process, serial"


def startup_run(kind: str, label: str, files: list[str], reference: bytes, directory: str,
                repo: str = REPO, torch_free: bool = True) -> dict:
    """One lazy-startup run of kind ``kind`` (``_STARTUP``) of the tree at
    ``repo``, a CLI child through its entry point, on a calibration store
    of its own that starts empty and with the device server's socket in
    ``directory``. Byte for byte against ``reference``. With
    ``torch_free`` (this tree) the runs that stay off the card in the CLI
    process, (a) to (c), run under ``PHYLONIUM_TPU_EXPECT_NO_TORCH=1`` and
    must load no torch and initialize no CUDA. (a) and (b) count on the
    host with no launch; (c) is ``devd_check``'s (a cold run,
    label ``... cold``, ships every group, a warm one hits every group);
    (d) loads torch, launches X1 once a group and the pair count once,
    with no plain call. Returns the run's wall in pieces."""
    from phylonium_tpu_torch.core.stream import effective_group_rows
    from phylonium_tpu_torch.ops.pair_count import LAUNCHES_PER_CALL

    flags, env, card = _STARTUP[kind]
    env = {**env, "PHYLONIUM_TPU_DEVD_SOCK": os.path.join(directory, "d.sock"),
           "PHYLONIUM_TPU_DEVD_IDLE_S": "900",
           "PHYLONIUM_TPU_CALIBRATION_FILE": os.path.join(
               directory, f"store-{label.replace(' ', '-')}-{time.time_ns()}.json")}
    if torch_free and not card:
        env["PHYLONIUM_TPU_EXPECT_NO_TORCH"] = "1"
    r = cli_child(["--progress=never", "--device", "cuda", *flags, *files], directory, env,
                  repo=repo)
    groups = -(-len(files) // effective_group_rows(len(files)))
    if kind == "c":
        info = devd_check(label, r, reference, groups, torch_free=torch_free)
        hits = 0 if label.endswith("cold") else groups
        if info["early_ship"]["cache_hits"] != hits:
            raise AssertionError(f"run '{label}': early ship {info['early_ship']}")
    else:
        if r["rc"] != 0 or r["out"] != reference:
            raise AssertionError(f"lazy-startup run '{label}' exited {r['rc']} or differs "
                                 f"from the JAX package's host count: {r['err'][-2000:]}")
        info = r["passes"][-1]
        if card:
            ok = (r["torch"] and r["cuda_initialized"] and "devd" not in info
                  and info["build_kernel_launches"] == info["stream_groups"] == groups
                  and info["kernel_launches"] == LAUNCHES_PER_CALL
                  and not info["plain_calls"] and not info["build_plain_calls"])
        else:
            ok = (info["compare_carrier"] == "host" and not info["kernel_launches"]
                  and not info["plain_calls"] and not info["stream_groups"]
                  and (kind == "b" or info["dispatch_model"]["link_mb_s"] is None)
                  and (not torch_free or (r["torch"] is False and r["cuda_initialized"] is False
                                          and not info["cuda_initialized"])))
        if not ok:
            raise AssertionError(f"lazy-startup run '{label}': torch {r['torch']}, CUDA "
                                 f"{r['cuda_initialized']}, {json.dumps(info)}")
    row = {"label": label, "kind": kind, "route": route_of(info), "wall": r["wall"],
           "phases": sum(info["timings"].values()), "torch": r["torch"],
           "cuda_initialized": r["cuda_initialized"], **{k: r[k] for k in _PIECES}}
    print(f"  {label:18s} wall {r['wall']:.3f} s = start {r['start_s']:.3f} + import "
          f"{r['import_s']:.3f} + main {r['main_s']:.3f} (phases {row['phases']:.3f}) + exit "
          f"{r['exit_s']:.3f}; route {row['route']}; torch {r['torch']}, CUDA initialized "
          f"{r['cuda_initialized']}; "
          f"{info['compare_carrier']} carried, {info['kernel_launches']} count launches, "
          f"{info['build_kernel_launches']} build launches; phases "
          f"{json.dumps(info['timings'])}", flush=True)
    return row


def import_profile(repo: str = REPO) -> dict:
    """``python -X importtime`` of the CLI of the tree at ``repo``, then of
    torch and of the device modules a run on the card loads: each
    top-level import's cumulative milliseconds, and those of torch's own
    direct imports, largest first (eight of each)."""
    code = ("import phylonium_tpu_torch.cli\nimport torch\n"
            "import phylonium_tpu_torch.ops.pair_count, phylonium_tpu_torch.ops.pileup_device\n"
            "import phylonium_tpu_torch.core.hybrid_map\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-X", "importtime", "-c", code], capture_output=True,
                          text=True, cwd=repo, env=env, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"importtime exited {proc.returncode}: {proc.stderr[-2000:]}")
    rows = []  # (level, name, cumulative ms), in the order printed
    for line in proc.stderr.splitlines():
        if not line.startswith("import time:") or "cumulative" in line:
            continue
        _, cumulative, name = line[len("import time:"):].split("|")
        level = (len(name) - len(name.lstrip(" ")) - 1) // 2
        rows.append((level, name.strip(), int(cumulative) / 1e3))
    top = sorted(((n, ms) for level, n, ms in rows if level == 0), key=lambda x: -x[1])
    where = next(k for k, (_, n, _) in enumerate(rows) if n == "torch")
    children = []
    for level, n, ms in reversed(rows[:where]):
        if level <= rows[where][0]:
            break
        if level == rows[where][0] + 1:
            children.append((n, ms))
    children.sort(key=lambda x: -x[1])
    return {"top_ms": dict(top[:8]), "torch_ms": rows[where][2],
            "torch_level": rows[where][0], "torch_children_ms": dict(children[:8])}


def _medians(rows: list[dict]) -> dict:
    keys = ("wall", *_PIECES, "phases")
    return {k: statistics.median(r[k] for r in rows) for k in keys}


def lazy_startup(eco_files: list[str], eco_reference: bytes, wide_files: list[str],
                 wide_reference: bytes, tmp: str, turns: int = 1) -> dict:
    """Phase 21: runs that never reach the card import no torch. ``turns``
    runs each of (a) and (b) at 29 x 5 Mbp, then at 116 x 5 Mbp a cold
    device-server run and ``turns`` runs of (c) through the daemon it
    filled, then, with no daemon alive, ``turns`` runs of (d)
    (``startup_run``); every daemon is stopped by its pidfile. Then the
    imports' split (``import_profile``). Prints each run's wall in pieces
    and the medians by kind."""
    directory = os.path.join(tmp, "startup")
    os.makedirs(directory, exist_ok=True)
    sock = os.path.join(directory, "d.sock")
    rows = []
    try:
        for t in range(1, turns + 1):
            rows.append(startup_run("a", f"a {t}", eco_files, eco_reference, directory))
            rows.append(startup_run("b", f"b {t}", eco_files, eco_reference, directory))
        stop_daemon(sock)
        cold = startup_run("c", "c cold", wide_files, wide_reference, directory)
        for t in range(1, turns + 1):
            rows.append(startup_run("c", f"c {t}", wide_files, wide_reference, directory))
        stop_daemon(sock)
        for t in range(1, turns + 1):
            rows.append(startup_run("d", f"d {t}", wide_files, wide_reference, directory))
    finally:
        stop_daemon(sock)
        alive = [pid for pid in daemon_pids(sock) if pid_alive(pid)]
        if alive:
            raise AssertionError(f"daemons outlived the lazy-startup phase: {alive}")
    imports = import_profile()
    summary = {"medians_s": {k: _medians([r for r in rows if r["kind"] == k]) for k in "abcd"},
               "cold_s": cold, "imports": imports}
    print(f"  lazy startup: {json.dumps(summary)}", flush=True)
    return summary


def fill_store(files: list[str], directory: str, env: dict) -> dict:
    """One in-process streamed run of ``files`` on the card, which records a
    copy rate in the calibration store that ``env`` names (an empty store
    sends 116 x 5 Mbp to the host by the static rule); spawns no daemon.
    Returns the store."""
    r = cli_child(["--progress=never", "--device", "cuda", *files], directory,
                  {**env, **IN_PROCESS, "PHYLONIUM_TPU_STREAM": "force"})
    with open(env["PHYLONIUM_TPU_CALIBRATION_FILE"]) as f:
        filled = json.load(f)
    sock = env.get("PHYLONIUM_TPU_DEVD_SOCK")
    if (r["rc"] != 0 or not filled.get("link_mb_s")
            or (sock and os.path.exists(sock + ".pid"))):
        raise AssertionError(f"the store's filling run: rc {r['rc']}, store {filled}, "
                             f"{r['err'][-2000:]}")
    print(f"  filled the store with an in-process run of {len(files)} genomes: "
          f"{json.dumps({k: v for k, v in filled.items() if k != 'updated'})}; wall "
          f"{r['wall']:.3f} s", flush=True)
    return filled


def default_route(wide_files: list[str], wide_reference: bytes, eco_files: list[str],
                  tmp: str) -> dict:
    """Phase 22: the default route of a single-process run on the card.

    One in-process run (``PHYLONIUM_TPU_DEVD=0``, streamed) of the
    29 x 5 Mbp panel fills a calibration store in this phase's directory
    with a copy rate. Then the 116 x 5 Mbp panel with no routing variable,
    on that store and with the server's socket in the same directory: a
    cold run, which spawns the daemon, and a warm one, which reuses it;
    each under ``PHYLONIUM_TPU_EXPECT_NO_TORCH=1``, decided by the measured
    stream model's server branch, its launches in the daemon (one X1 a
    group, one pair-count call) and none in the CLI, which makes no CUDA
    context (``devd_check``). Last, with the daemon stopped, the same panel
    with ``PHYLONIUM_TPU_DEVD=0``, in process, spawning none. Every run byte
    for byte against the JAX package's host count."""
    from phylonium_tpu_torch.core.stream import effective_group_rows

    directory = os.path.join(tmp, "default_route")
    os.makedirs(directory, exist_ok=True)
    sock = os.path.join(directory, "d.sock")
    env = {"PHYLONIUM_TPU_DEVD_SOCK": sock, "PHYLONIUM_TPU_DEVD_IDLE_S": "900",
           "PHYLONIUM_TPU_CALIBRATION_FILE": os.path.join(directory, "calibration.json")}
    groups = -(-len(wide_files) // effective_group_rows(len(wide_files)))
    wide = ["--progress=never", "--device", "cuda", *wide_files]
    runs = {}
    try:
        fill_store(eco_files, directory, env)
        pid = None
        for label in ("cold", "warm"):
            r = cli_child(wide, directory, {**env, "PHYLONIUM_TPU_EXPECT_NO_TORCH": "1"})
            info = devd_check(f"default {label}", r, wide_reference, groups)
            ship, server, model = info["early_ship"], info["devd"], info.get("stream_model")
            hits = 0 if label == "cold" else groups
            if (ship["cache_hits"] != hits or server["socket"] != sock
                    or not (model and model.get("devd"))
                    or info["calibration"]["link_mb_s"] is None
                    or (pid is not None and server["pid"] != pid)):
                raise AssertionError(f"default {label} run: {json.dumps(info)}")
            pid = server["pid"]
            runs[label] = {"wall": r["wall"], "launches": server["launches"],
                           "devd_count_s": info["devd_count_s"], "timings": info["timings"],
                           **{k: r[k] for k in _PIECES}}
            print(f"  default route, {label}: byte-identical to the JAX package's host count; "
                  f"stream model {json.dumps(model)}; server pid {pid} launches "
                  f"{json.dumps(server['launches'])}, none in the CLI, which imported no torch "
                  f"and made no CUDA context; {ship['cache_hits']} cache hits, {ship['mb']} MB "
                  f"shipped; wall {r['wall']:.3f} s = start {r['start_s']:.3f} + import "
                  f"{r['import_s']:.3f} + main {r['main_s']:.3f} + exit {r['exit_s']:.3f}; "
                  f"phases {json.dumps(info['timings'])}", flush=True)
        if stop_daemon(sock) != pid:
            raise AssertionError(f"the daemon on {sock} was not the one the cold run spawned")
        r = cli_child(wide, directory, {**env, **IN_PROCESS})
        info = r["passes"][-1] if r["passes"] else {}
        if (r["rc"] != 0 or r["out"] != wide_reference or info.get("devd")
                or info["build_kernel_launches"] != groups or info["stream_groups"] != groups
                or not info["cuda_initialized"] or os.path.exists(sock + ".pid")):
            raise AssertionError(f"the in-process run: rc {r['rc']}, {json.dumps(info)}, "
                                 f"{r['err'][-2000:]}")
        runs["in process"] = {"wall": r["wall"], "timings": info["timings"],
                              **{k: r[k] for k in _PIECES}}
        print(f"  PHYLONIUM_TPU_DEVD=0: byte-identical, in process, {groups} build launches, "
              f"no daemon spawned; wall {r['wall']:.3f} s; phases {json.dumps(info['timings'])}",
              flush=True)
    finally:
        stop_daemon(sock)
        alive = [p for p in daemon_pids(sock) if pid_alive(p)]
        if alive:
            raise AssertionError(f"daemons outlived the default-route phase: {alive}")
    return {"runs": runs, "build_launches": runs["warm"]["launches"]["build"],
            "count_launches": runs["warm"]["launches"]["count"]}


def default_socket_pid() -> int | None:
    """The live daemon on the default socket of the card, if any."""
    from phylonium_tpu_torch.serve.wire import sock_path

    with env_set(PHYLONIUM_TPU_DEVD_SOCK=None):
        path = sock_path("cuda:0")
    try:
        with open(path + ".pid") as f:
            pid = int(f.read().strip())
    except (OSError, ValueError):
        return None
    return pid if pid_alive(pid) else None


def no_daemon_left(directories: list[str], default_before: int | None) -> int:
    """Fail if a daemon this script spawned is alive: a live pidfile, or a
    live daemon in a socket's log, under ``directories``, or a daemon on
    the default socket that was not there when the script started (each
    found is stopped first). Returns the daemons the logs name."""
    import signal

    alive, seen = [], set()
    for directory in directories:
        for pidfile in glob.glob(os.path.join(directory, "**", "*.sock.pid"), recursive=True):
            sock = pidfile[:-len(".pid")]
            try:
                with open(pidfile) as f:
                    pid = int(f.read().strip())
            except (OSError, ValueError):
                continue
            if pid_alive(pid):
                alive.append((sock, pid))
        for log in glob.glob(os.path.join(directory, "**", "*.sock.log"), recursive=True):
            pids = daemon_pids(log[:-len(".log")])
            seen |= pids
            alive += [(log, pid) for pid in pids if pid_alive(pid)]
    now = default_socket_pid()
    if now is not None and now != default_before:
        alive.append(("the default socket", now))
    for _, pid in alive:
        os.kill(pid, signal.SIGTERM)
    if alive:
        raise AssertionError(f"daemons outlived the script's phases: {sorted(set(alive))}")
    return len(seen)


def prebuild(repo: str) -> None:
    """Build the native host library and the CUDA kernels of the tree at
    ``repo`` in a process of their own, so that no timed run builds them."""
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c",
         "from phylonium_tpu_torch.native import build\nbuild.ensure_built()\n"
         "from phylonium_tpu_torch.ops import _build\n_build.load()\n"],
        capture_output=True, text=True, cwd=repo, env=env, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"the build of {repo} exited {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")


def startup_turns(pairs: int, parent: str, eco_files: list[str], eco_reference: bytes,
                  wide_files: list[str], wide_reference: bytes, tmp: str) -> dict:
    """``--startup-turns``: this tree against the parent commit's tree in
    ``parent`` (an unpacked copy), ``pairs`` pairs in alternating order.
    In each pair, each tree runs (a) at 29 x 5 Mbp, a cold device-server
    run and a warm one (c) at 116 x 5 Mbp, then (d) with its daemon
    stopped (``startup_run``; the parent's runs may import torch). Each
    kind pins its route (``_STARTUP``), whatever the tree's default. Prints
    each run with its route, the routes by tree and kind, the medians by
    tree and kind, the parent minus this tree by pair, and each tree's
    import split."""
    trees = {"change": REPO, "parent": os.path.abspath(parent)}
    prebuild(trees["parent"])
    rows = []
    try:
        for i in range(pairs):
            order = ("change", "parent") if i % 2 == 0 else ("parent", "change")
            for name in order:
                repo, torch_free = trees[name], name == "change"
                directory = os.path.join(tmp, f"startup-{name}")
                os.makedirs(directory, exist_ok=True)
                sock = os.path.join(directory, "d.sock")

                def run(kind, label, files, reference):
                    row = startup_run(kind, f"{name} {label}", files, reference, directory,
                                      repo=repo, torch_free=torch_free)
                    rows.append({**row, "tree": name, "pair": i,
                                 "kind": "cold" if label.endswith("cold") else kind})

                run("a", f"a {i + 1}", eco_files, eco_reference)
                stop_daemon(sock)
                run("c", f"c {i + 1} cold", wide_files, wide_reference)
                run("c", f"c {i + 1}", wide_files, wide_reference)
                stop_daemon(sock)
                run("d", f"d {i + 1}", wide_files, wide_reference)
    finally:
        for name in trees:
            sock = os.path.join(tmp, f"startup-{name}", "d.sock")
            stop_daemon(sock)
            alive = [pid for pid in daemon_pids(sock) if pid_alive(pid)]
            if alive:
                raise AssertionError(f"daemons outlived the turns: {alive}")

    def pick(tree, kind):
        return sorted((r for r in rows if r["tree"] == tree and r["kind"] == kind),
                      key=lambda r: r["pair"])

    kinds = ("a", "cold", "c", "d")
    summary = {
        "pairs": pairs,
        # each kind pins its route, so that both trees take the same one
        "routes": {tree: {k: sorted({r["route"] for r in pick(tree, k)}) for k in kinds}
                   for tree in trees},
        "medians_s": {tree: {k: _medians(pick(tree, k)) for k in kinds} for tree in trees},
        "parent_minus_change_s": {
            k: {piece: [round(p[piece] - c[piece], 6)
                        for p, c in zip(pick("parent", k), pick("change", k))]
                for piece in ("wall", *_PIECES)}
            for k in kinds},
        "imports": {tree: import_profile(repo) for tree, repo in trees.items()},
    }
    print(f"  startup turns: {json.dumps(summary)}", flush=True)
    return summary


@contextlib.contextmanager
def patched(module, **values):
    """Set ``module``'s attributes for the body only."""
    saved = {k: getattr(module, k) for k in values}
    try:
        for k, v in values.items():
            setattr(module, k, v)
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def local_cells(device, cells: int) -> dict:
    """``utils.platform.local_devices`` patched to ``cells`` cells on the
    card: the local mesh's devices of a machine with that many cards."""
    from phylonium_tpu_torch.utils import platform

    one = platform.DeviceName("cuda", device.index)
    return {"local_devices": lambda name: [one] * cells}


def local_mesh_counts(device) -> dict:
    """Phase 24 (a): ``pair_counts_sharded`` on local meshes with every
    cell on the card, (2, 2) at 29 x 5 Mbp and (1, 4) and (2, 2) at
    600 x 1 Mbp, each bit for bit against ``pair_counts_rows``, K2 twice a
    cell and no plain call, the bytes as predicted; the walls of the
    mesh's steps (host clock, each step's device work waited for) in
    turns mesh, one device, one device, mesh, the one-device count's wall
    (pack, copy, K1, fetch) beside them."""
    import numpy as np
    import torch

    from phylonium_tpu_torch.ops import pair_count
    from phylonium_tpu_torch.ops.states import pack_rows, to_device

    out = {}
    for (n, length), shapes in (((29, 5_000_000), [(2, 2)]),
                                ((600, 1_000_000), [(1, 4), (2, 2)])):
        states = random_states(np.random.default_rng(24 + n), n, length)

        def one_device():
            return pair_count.pair_counts_rows(to_device(pack_rows(states), device))

        want = one_device()
        for shape in shapes:
            out.update(local_mesh_turns(device, states, shape, want, one_device))
        del states, want
        torch.cuda.empty_cache()
    return out


def local_mesh_turns(device, states, shape, want, one_device) -> dict:
    """Part of phase 24 (a): the ``shape`` local mesh on the card against
    the one-device count, in turns mesh, one device, one device, mesh."""
    import numpy as np

    from phylonium_tpu_torch.ops import pair_count
    from phylonium_tpu_torch.parallel.distributed import (
        LAST_COMM,
        comm_account,
        pair_counts_sharded,
    )
    from phylonium_tpu_torch.parallel.mesh import make_mesh
    from phylonium_tpu_torch.utils import platform

    n, length = states.shape
    cells = shape[0] * shape[1]
    label = f"{shape[0]}x{shape[1]} of {n} x {length}"
    runs = []
    with patched(platform, **local_cells(device, cells)):
        mesh = make_mesh(shape, "cuda")
        if mesh.backend != "local" or len(mesh.devices) != cells:
            raise AssertionError(f"{label}: {mesh}")
        for kind in ("mesh", "one device", "one device", "mesh"):
            zero_counts()
            t0 = time.perf_counter()
            got = pair_counts_sharded(states, mesh) if kind == "mesh" else one_device()
            wall = time.perf_counter() - t0
            launches, plain = pair_count.KERNEL_LAUNCHES, pair_count.PLAIN_CALLS
            if not all(np.array_equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{label}: the {kind} count disagrees")
            calls = cells if kind == "mesh" else 1
            if launches != pair_count.LAUNCHES_PER_CALL * calls or plain:
                raise AssertionError(f"{label}, {kind}: {launches} launches, "
                                     f"{plain} plain calls")
            run = {"kind": kind, "wall": wall, "launches": launches}
            if kind == "mesh":
                comm = comm_account(n, length, mesh)
                if any(comm[f"measured_{k}"] != comm[f"predicted_{k}"] for k in _COMM_KEYS):
                    raise AssertionError(f"{label}: bytes {comm}")
                run["steps"] = dict(LAST_COMM["seconds"])
            runs.append(run)
    for run in runs:
        steps = ", ".join(f"{k} {v:.4f}" for k, v in run.get("steps", {}).items())
        print(f"  local mesh {label}, {cells} cells on {device}: == pair_counts_rows "
              f"bit for bit; {run['kind']}: {run['launches']} pair-count launches, "
              f"wall {run['wall']:.4f} s" + (f" (steps (s): {steps})" if steps else ""),
              flush=True)
    return {label: runs}


def local_mesh_cli(device, files: list[str], reference: bytes) -> dict:
    """Phase 24 (b): the port's CLI in this process with ``--mesh 2,2`` and
    the local devices patched to four cells on the card: byte for byte
    against the JAX package's host count, the run report's mesh "local",
    K2 twice a cell, no plain call."""
    from phylonium_tpu_torch.ops.pair_count import LAUNCHES_PER_CALL
    from phylonium_tpu_torch.utils import platform

    with patched(platform, **local_cells(device, 4)):
        r = port_run(["--progress=never", "-v", "-v", "--device", "cuda", "--mesh", "2,2",
                      *files], **_AUTO_ENV)
    info, c = r["info"], r["counts"]
    mesh = info.get("mesh", {})
    if r["out"].encode() != reference:
        raise AssertionError("the --mesh 2,2 local run differs from the JAX package's")
    if (info["compare_carrier"] != "mesh" or mesh.get("backend") != "local"
            or mesh["shape"] != [2, 2] or mesh["devices"] != [str(device)] * 4
            or c["count_launches"] != 4 * LAUNCHES_PER_CALL or c["count_plain"]
            or mesh["launches"] != c["count_launches"] or mesh["plain_calls"]
            or any(mesh["comm"][f"measured_{k}"] != mesh["comm"][f"predicted_{k}"]
                   for k in _COMM_KEYS) or "jax" in sys.modules):
        raise AssertionError(f"the --mesh 2,2 local run: {c}, {info}")
    steps = ", ".join(f"{k} {v:.4f}" for k, v in mesh["seconds"].items())
    print(f"  --mesh 2,2 e2e, {len(files)} genomes on 4 local cells on the card, in "
          f"process: byte-identical to the JAX package's host count; backend local, "
          f"{c['count_launches']} pair-count launches, 0 plain calls; compare's steps "
          f"(s): {steps}; prewarm {json.dumps(info.get('prewarm'))}; wall "
          f"{r['wall']:.3f} s, phases {json.dumps(r['timings'])}", flush=True)
    return {"launches": c["count_launches"], "wall": r["wall"], "steps": mesh["seconds"]}


def local_mesh_auto(device, files: list[str], reference: bytes, tmp: str) -> dict:
    """Phase 24 (c): 'auto' with the CUDA driver's count and the local
    devices patched to two cells on the card, on phase 19's 600 x 1 Mbp
    panel, in this process with the default route (no
    ``PHYLONIUM_TPU_DEVD``, a socket of the phase's own) on an empty
    store: the run counts on the (1, 2) local mesh by the serial route,
    with no stream group, no shipper and no device server."""
    from phylonium_tpu_torch.cli import main as port_main
    from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO
    from phylonium_tpu_torch.ops import pair_count, pileup_device
    from phylonium_tpu_torch.utils import platform

    sock = os.path.join(tmp, "local_mesh.sock")
    buf = io.StringIO()
    with patched(platform, cuda_device_count=lambda: 2, **local_cells(device, 2)), \
            env_set(PHYLONIUM_TPU_DEVD=None, PHYLONIUM_TPU_DEVD_SOCK=sock, **_AUTO_ENV), \
            contextlib.redirect_stdout(buf):
        zero_counts()
        t0 = time.perf_counter()
        rc = port_main(["--progress=never", "--device", "cuda", *files])
        wall = time.perf_counter() - t0
        launches, plain = pair_count.KERNEL_LAUNCHES, pair_count.PLAIN_CALLS
        builds = pileup_device.KERNEL_LAUNCHES + pileup_device.PLAIN_CALLS
    info = json.loads(json.dumps(LAST_RUN_INFO))
    mesh = info.get("mesh", {})
    if rc != 0 or buf.getvalue().encode() != reference:
        raise AssertionError(f"auto on two cells exited {rc} or differs from the JAX "
                             "package's host count")
    if (mesh.get("backend") != "local" or mesh["shape"] != [1, 2]
            or launches != 2 * pair_count.LAUNCHES_PER_CALL or plain or builds
            or info["stream_groups"] or "devd" in info or "early_ship" in info
            or os.path.exists(sock + ".pid") or os.path.exists(sock)):
        raise AssertionError(f"auto on two cells: {launches} launches, {plain} plain "
                             f"calls, {builds} builds, {info}")
    steps = ", ".join(f"{k} {v:.4f}" for k, v in mesh["seconds"].items())
    print(f"  auto, {len(files)} genomes, two cards faked: the serial route onto the (1, 2) "
          f"local mesh, byte-identical to the JAX package's host count; dispatch model "
          f"{json.dumps(info.get('dispatch_model'))}; no stream group, no shipper, no "
          f"device server; {launches} pair-count launches; compare's steps (s): {steps}; "
          f"wall {wall:.3f} s, phases {json.dumps(info['timings'])}", flush=True)
    return {"launches": launches, "wall": wall}


def local_mesh_refused(files: list[str], tmp: str) -> float:
    """Phase 24 (d): unpatched, in a child, ``--mesh 2,2`` on this machine's
    one card exits 1 with the JAX package's sentence and prints nothing
    on stdout. Returns the child's wall."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(IN_PROCESS)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "phylonium_tpu_torch", "--progress=never", "--mesh", "2,2",
         *files], capture_output=True, cwd=tmp, env=env, timeout=300,
    )
    wall = time.perf_counter() - t0
    err = proc.stderr.decode(errors="replace")
    if (proc.returncode != 1 or proc.stdout
            or "--mesh 2,2 needs 4 devices; the runtime has 1" not in err):
        raise AssertionError(f"--mesh 2,2 on one card exited {proc.returncode}, "
                             f"stdout {proc.stdout[:200]!r}, stderr {err[-2000:]}")
    print(f"  --mesh 2,2 unpatched on the one card: exit 1, empty stdout, "
          f"\"{err.strip().splitlines()[-1][:160]}...\"; wall {wall:.3f} s", flush=True)
    return wall


def local_mesh(device, eco_files: list[str], eco_reference: bytes,
               wide_files: list[str], wide_reference: bytes, tmp: str) -> dict:
    """Phase 24: the local counting mesh, its parts (a)-(d) timed."""
    parts, result = {}, {}
    for name, run in (
        ("a", lambda: local_mesh_counts(device)),
        ("b", lambda: local_mesh_cli(device, eco_files, eco_reference)),
        ("c", lambda: local_mesh_auto(device, wide_files, wide_reference, tmp)),
        ("d", lambda: local_mesh_refused(eco_files, tmp)),
    ):
        t0 = time.perf_counter()
        result[name] = run()
        parts[name] = time.perf_counter() - t0
    print(f"  phase 24 parts (s): {json.dumps(parts)}", flush=True)
    return result


def main(argv: list[str] | None = None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="Smoke run of the torch port on one card.")
    parser.add_argument("--devd-turns", type=int, metavar="PAIRS",
                        help="run only phases 1-2 and the warm device server against "
                             "the in-process route at 116 x 5 Mbp, PAIRS pairs in "
                             "alternating order (device_server_turns)")
    parser.add_argument("--startup-turns", type=int, metavar="PAIRS",
                        help="run only phases 1-2 and phase 21's runs (a), (c) and (d) "
                             "of this tree against the tree in --parent, PAIRS pairs in "
                             "alternating order (startup_turns)")
    parser.add_argument("--parent", metavar="DIR",
                        help="an unpacked copy of the parent commit, for --startup-turns")
    args = parser.parse_args(argv)
    if args.startup_turns and not args.parent:
        parser.error("--startup-turns needs --parent DIR")
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2

    from phylonium_tpu_torch.ops import _build
    from phylonium_tpu_torch.utils.platform import describe_device, resolve_device

    # a daemon already on the card's default socket is not this script's
    default_before = default_socket_pid()
    with phase("device"):
        device = resolve_device("cuda")
        info = describe_device(device)
        print(f"  {json.dumps(info)}", flush=True)
        if not info["nvidia_smi"]:
            raise RuntimeError("nvidia-smi gave no name and power limit")

    with phase("host compiler"):
        print(f"  CXX={os.environ.get('CXX', '(unset)')} in this machine's "
              "environment", flush=True)
        native = port_host_library()
        print(f"  port host library {native['path']}: "
              f"{'built' if native['built'] else 'loaded as built before'} "
              f"with {native['compiler']}", flush=True)
        print(f"  reference host library {build_reference_host_library()}", flush=True)

    with phase("build"):
        _build.load()
        print(f"  built {_build.BUILD_INFO['path']} in "
              f"{_build.BUILD_INFO['seconds']:.3f} s", flush=True)
        for line in _build.BUILD_INFO["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {line.strip()}", flush=True)

    if args.devd_turns:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_turns_") as tmp, \
                phase("device server turns"):
            files = write_fasta(eco29_panel(116, 5_000_000), tmp)
            reference = run_reference_cli(["--progress=never", *files], tmp)
            device_server_turns(args.devd_turns, files, reference, tmp)
            no_daemon_left([tmp], default_before)
        print(info["nvidia_smi"].splitlines()[0], flush=True)
        return 0

    if args.startup_turns:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_startup_") as tmp, \
                phase("startup turns"):
            for name in ("eco", "wide"):
                os.makedirs(os.path.join(tmp, name))
            eco_files = write_fasta(eco29_panel(29, 5_000_000), os.path.join(tmp, "eco"))
            wide_files = write_fasta(eco29_panel(116, 5_000_000), os.path.join(tmp, "wide"))
            startup_turns(args.startup_turns, args.parent,
                          eco_files, run_reference_cli(["--progress=never", *eco_files], tmp),
                          wide_files, run_reference_cli(["--progress=never", *wide_files], tmp),
                          tmp)
            no_daemon_left([tmp], default_before)
        print(info["nvidia_smi"].splitlines()[0], flush=True)
        return 0

    with phase("edge shapes"):
        worst = check_edges(device)

    with phase("production shapes"):
        eco = check_production(device, 29, 5_000_000, seed=1, chunked=True)
        wide = check_production(device, 600, 1_000_000, seed=2)
        torch.cuda.empty_cache()
    worst = max(worst, eco["max_abs_err"], wide["max_abs_err"])

    with phase("extend edge shapes"):
        extend_worst = check_extend_edges(device)

    with phase("extend production shapes"):
        ext = check_extend_production(device)
        torch.cuda.empty_cache()
    extend_worst = max([extend_worst] + [v["max_abs_err"] for v in ext.values()])

    # the eco29-shaped panels: 29 x 5 Mbp for phases 7, 12 and 13, and
    # 116 x 5 Mbp for phases 11 and 12
    with contextlib.ExitStack() as panels:
        eco_dir = panels.enter_context(tempfile.TemporaryDirectory(prefix="chip_smoke_"))
        eco_files = write_fasta(eco29_panel(29, 5_000_000), eco_dir)

        with phase("end to end"):
            e2e = end_to_end("cuda", eco_files, eco_dir)
        if e2e["launches"] < 1 or e2e["carrier"] != "cuda-kernel":
            raise AssertionError("the main path did not launch the pair-count kernel")

        with phase("hybrid end to end"):
            hybrid = end_to_end_hybrid("cuda")
            torch.cuda.empty_cache()

        with phase("build edge shapes"):
            build_worst = check_build_edges(device)

        with phase("build production shapes"):
            # one streamed group of 116 x 5 Mbp (effective_group_rows(116)) and
            # one low-memory group of 1000 x 1 Mbp (group_rows_for(1000, 1 M))
            streamed_group = check_build_production(device, 29, 5_000_000, seed=116)
            lowmem_group = check_build_production(device, 128, 1_000_000, seed=1000)
            torch.cuda.empty_cache()
        build_worst = max(build_worst, streamed_group["max_abs_err"],
                          lowmem_group["max_abs_err"])

        wide_dir = panels.enter_context(
            tempfile.TemporaryDirectory(prefix="chip_smoke_stream_"))
        wide_files = write_fasta(eco29_panel(116, 5_000_000), wide_dir)

        with phase("streamed end to end"):
            streamed = end_to_end_streamed("cuda", wide_files)
            torch.cuda.empty_cache()

        with phase("device pileup end to end"):
            # no 116 x 5 Mbp turns here, nor --complete-deletion turns, to
            # make room for phases 20-22 (PERF.md
            # keeps their earlier numbers)
            x2 = end_to_end_device_pileup(
                "cuda", eco_files, eco_dir,
                [([], eco_files)])
            torch.cuda.empty_cache()

        with phase("profile"):
            profile_run("cuda", eco_files, eco_dir, x2["out"])

        with phase("low-memory end to end"):
            end_to_end_lowmem("cuda")

        with phase("shard kernel"):
            shard_worst = check_shard_edges(device)
            shard = check_shard_production(device)
            torch.cuda.empty_cache()
        shard_worst = max([shard_worst] + [v["max_abs_err"] for v in shard.values()])

        with phase("hybrid with X5"):
            hybrid_x5 = end_to_end_hybrid_sharded("cuda", hybrid["reference"])
            torch.cuda.empty_cache()

        with phase("mesh"):
            mesh_cell = check_mesh_shard(device)
            torch.cuda.empty_cache()
            nccl = mesh_nccl()
            mesh = mesh_world(eco_files, e2e["reference"])

        with phase("pod streamed"):
            # one rank's X1 group (8 of the 29 rows) and its K2 cell,
            # [8, 2.5 MB] x [32, 2.5 MB], under the (4, 1) mesh
            pod_group = check_build_production(device, 8, 5_000_000, seed=8)
            pod_cell = check_mesh_shard(device, shape=(4, 1))
            torch.cuda.empty_cache()
            pod = pod_streamed(eco_files, e2e["reference"], eco_dir)
            prewarm = fresh_prewarm(eco_files, eco_dir)

        with phase("auto dispatch"):
            auto = auto_dispatch(device, eco_files, e2e["reference"], wide_files, wide_dir)
            torch.cuda.empty_cache()

        with phase("device server"):
            devd = device_server(wide_files, auto["wide_reference"], eco_files,
                                 e2e["reference"], wide_dir)

        with phase("lazy startup"):
            startup = lazy_startup(eco_files, e2e["reference"], wide_files,
                                   auto["wide_reference"], wide_dir)

        with phase("default route"):
            default = default_route(wide_files, auto["wide_reference"], eco_files, wide_dir)

        with phase("no daemon left"):
            served = no_daemon_left([eco_dir, wide_dir], default_before)
            print(f"  {served} daemons served the script's phases; none is alive, and none "
                  "on the card's default socket is the script's", flush=True)

        with phase("local counting mesh"):
            local = local_mesh(device, eco_files, e2e["reference"], *auto["panel_600"],
                               wide_dir)

    print(json.dumps({"kernels": [{
        "name": "pair_count",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "also_replaces": ALSO_REPLACES,
        "launches": e2e["launches"],
        "max_abs_err": worst,
        "ms": eco["ms"],
        "plain_ms": eco["plain_ms"],
        "bound_ms": eco["bound_ms"],
        "bound_by": eco["bound_by"],
        "library_ms": eco["library_ms"],
        "library": "torch._int_mm on onehot_operands",
        "shape": "29 x 5000000",
        "ms_600x1000000": wide["ms"],
        "plain_ms_600x1000000": wide["plain_ms"],
        "bound_ms_600x1000000": wide["bound_ms"],
        "bound_by_600x1000000": wide["bound_by"],
        "library_ms_600x1000000": wide["library_ms"],
        "launches_pod_streamed": pod["count_launches"],
        "launches_auto": auto["count_launches"],
        "launches_devd": devd["count_launches"],
        "launches_default_route": default["count_launches"],
        "build_s": _build.BUILD_INFO["seconds"],
    }, {
        "name": "diagonal_neq",
        "route": "cuda",
        "source": EXTEND_SOURCE,
        "replaces": EXTEND_REPLACES,
        "also_replaces": EXTEND_ALSO_REPLACES,
        "launches": hybrid["launches"],
        "max_abs_err": extend_worst,
        "ms": ext["micro"]["ms"],
        "plain_ms": ext["micro"]["plain_ms"],
        "bound_ms": ext["micro"]["bound_ms"],
        "bound_by": ext["micro"]["bound_by"],
        "library_ms": None,
        "shape": f"128 x {CHUNK}",
        "gbp_s": ext["micro"]["gbp_s"],
        f"ms_8x{CHUNK}": ext["hybrid"]["ms"],
        f"plain_ms_8x{CHUNK}": ext["hybrid"]["plain_ms"],
        f"bound_ms_8x{CHUNK}": ext["hybrid"]["bound_ms"],
        f"bound_by_8x{CHUNK}": ext["hybrid"]["bound_by"],
        f"gbp_s_8x{CHUNK}": ext["hybrid"]["gbp_s"],
        "build_s": _build.BUILD_INFO["seconds"],
    }, {
        "name": "pileup_build",
        "route": "cuda",
        "source": BUILD_SOURCE,
        "replaces": BUILD_REPLACES,
        "also_replaces": BUILD_ALSO_REPLACES,
        "launches": x2["launches"],
        "launches_streamed": streamed["launches"],
        "max_abs_err": max(build_worst, auto["group"]["max_abs_err"]),
        "ms": streamed_group["ms"],
        "plain_ms": streamed_group["plain_ms"],
        "bound_ms": streamed_group["bound_ms"],
        "bound_by": streamed_group["bound_by"],
        "library_ms": None,
        "shape": "29 x 5000000",
        "gb_s": streamed_group["gb_s"],
        "ms_128x1000000": lowmem_group["ms"],
        "plain_ms_128x1000000": lowmem_group["plain_ms"],
        "bound_ms_128x1000000": lowmem_group["bound_ms"],
        "bound_by_128x1000000": lowmem_group["bound_by"],
        "launches_pod_streamed": pod["build_launches"],
        "ms_8x5000000": pod_group["ms"],
        "plain_ms_8x5000000": pod_group["plain_ms"],
        "bound_ms_8x5000000": pod_group["bound_ms"],
        "bound_by_8x5000000": pod_group["bound_by"],
        "launches_auto": auto["build_launches"],
        "launches_devd": devd["build_launches"],
        "launches_default_route": default["build_launches"],
        "ms_shipped_29x5000000": auto["group"]["ms"],
        "bound_ms_shipped_29x5000000": auto["group"]["bound_ms"],
        "build_s": _build.BUILD_INFO["seconds"],
    }, {
        "name": "diagonal_neq_shard",
        "route": "cuda",
        "source": EXTEND_SOURCE,
        "replaces": SHARD_REPLACES,
        "launches": hybrid_x5["launches"],
        "max_abs_err": shard_worst,
        "ms": shard["micro"]["ms"],
        "plain_ms": shard["micro"]["plain_ms"],
        "bound_ms": shard["micro"]["bound_ms"],
        "bound_by": shard["micro"]["bound_by"],
        "library_ms": None,
        "shape": f"128 x {CHUNK} in {SHARDS} shards",
        "k3_ms": shard["micro"]["k3_ms"],
        f"ms_8x{CHUNK}": shard["hybrid"]["ms"],
        f"plain_ms_8x{CHUNK}": shard["hybrid"]["plain_ms"],
        f"bound_ms_8x{CHUNK}": shard["hybrid"]["bound_ms"],
        f"bound_by_8x{CHUNK}": shard["hybrid"]["bound_by"],
        f"k3_ms_8x{CHUNK}": shard["hybrid"]["k3_ms"],
        "build_s": _build.BUILD_INFO["seconds"],
    }, {
        "name": "pair_count_mesh",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": MESH_REPLACES,
        "launches": mesh["launches"],
        "launches_nccl": nccl["launches"],
        "max_abs_err": max(mesh_cell["max_abs_err"], pod_cell["max_abs_err"]),
        "ms": mesh_cell["ms"],
        "plain_ms": mesh_cell["plain_ms"],
        "bound_ms": mesh_cell["bound_ms"],
        "bound_by": mesh_cell["bound_by"],
        "library_ms": mesh_cell["library_ms"],
        "library": "torch._int_mm on onehot_operands of the shard",
        "shape": f"[{mesh_cell['cell'][0]}, {mesh_cell['cell'][1]}] x "
                 f"[30, {mesh_cell['cell'][1]}] bytes (2x2 mesh, 29 x 5000000)",
        "launches_pod_streamed": pod["count_launches"],
        "ms_4x1": pod_cell["ms"],
        "plain_ms_4x1": pod_cell["plain_ms"],
        "bound_ms_4x1": pod_cell["bound_ms"],
        "bound_by_4x1": pod_cell["bound_by"],
        "library_ms_4x1": pod_cell["library_ms"],
        "max_abs_err_4x1": pod_cell["max_abs_err"],
        "prewarm_s": prewarm["seconds"],
        "prewarm_waited_s": prewarm["waited"],
        "launches_local_mesh": local["b"]["launches"],
        "launches_local_mesh_auto": local["c"]["launches"],
        "build_s": _build.BUILD_INFO["seconds"],
    }]}), flush=True)
    print(info["nvidia_smi"].splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
