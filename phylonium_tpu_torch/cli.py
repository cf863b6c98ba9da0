"""Command-line entry point of the torch port.

The flags are the JAX package's (phylonium_tpu/cli.py) plus ``--device``, which names the torch device of the
pair count, of hybrid mapping's diagonal bitmaps and of the streamed and
low-memory paths' pileup build. The run is the JAX CLI's: read the FASTA
files (2-bit compacted when the low-memory path is predicted), pick the
reference, run the pipeline (twice with ``-2``), print PHYLIP. The
streamed and low-memory paths are reached through the JAX package's
environment switches (``PHYLONIUM_TPU_STREAM``,
``PHYLONIUM_TPU_STREAM_GROUP``, ``PHYLONIUM_TPU_LOWMEM``,
``PHYLONIUM_TPU_LOWMEM_BYTES``), and so is the serial path's device
pileup (``PHYLONIUM_TPU_DEVICE_PILEUP=1``); the port adds no flag for
them. With 'auto' counting the run is routed as the JAX package routes
it, from the port's calibration store (utils/calibration.py): on a CUDA
device the dispatch model may send the count to the host, the stream
gate may stream, and the early query shipper (core/query_ship.py) copies
each feeding group's 2-bit codes to the card while the files are read.
On a CUDA ``--device`` a single-process run sends the streamed and
low-memory routes' builds and count to the device server (serve/),
spawned on first use and reused after that, as the JAX CLI does
(``PHYLONIUM_TPU_DEVD=0`` keeps them in this process, ``=1`` takes the
server on the CPU too); this process then imports no torch and makes no
CUDA context, and a server error (no daemon comes up, another protocol,
another device, poisoned, a failed build, a timeout) ends the run with
exit 1 and no matrix.
``--profile=DIR`` writes a ``torch.profiler`` trace of the pipeline
(both passes of ``-2``) into DIR, and ``PHYLONIUM_TPU_RUN_REPORT=FILE``
writes the run's ``LAST_RUN_INFO`` as JSON after the matrix.

This module, and every module it imports at the top, loads without torch.
A run imports torch only where it reaches a device step (a device count,
a device build, hybrid mapping, ``--profile``, a world of several ranks),
as the JAX CLI imports jax: a run that counts on the host, or whose device
work goes to the device server, never does. ``main`` returns only once
everything it writes is written (the matrix, the run report, the
``--profile`` trace, the calibration store, checkpoints) and the shipper's
and the feeder's threads are joined, so that the entry point
(``__main__.py``) can leave through ``os._exit``.

In a torch.distributed world of several ranks (started by the launcher,
e.g. with ``parallel.multihost.initialize_distributed``, before ``main``
runs), every rank runs the pipeline and only rank 0 prints the matrix and
writes the run report; the others return the same code. ``--mesh R,C``
needs a world of ``R * C`` ranks, or, in a process of one rank, ``R * C``
local devices of ``--device``'s type (parallel/mesh.py).

``parse_args``, ``cleanup_names``, ``usage`` and ``version`` and their
helpers are a copy of the JAX package's (phylonium_tpu/cli.py:73-353),
which the port carries instead of importing; their messages and the usage
text name the port, and ``--version`` prints the port's version.
"""

from __future__ import annotations

import json
import os
import sys
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from phylonium_tpu_torch import __version__
from phylonium_tpu_torch.config import PROG, ConfigError, TorchRunConfig
from phylonium_tpu_torch.core.lowmem import group_rows_for, should_lowmem
from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO, check_mesh, process
from phylonium_tpu_torch.core.query_ship import QueryShipper, early_ship_eligible
from phylonium_tpu_torch.core.reference_pick import pick_first_pass, pick_second_pass
from phylonium_tpu_torch.data.sequence import join
from phylonium_tpu_torch.io.fasta import read_genome
from phylonium_tpu_torch.io.phylip import print_matrix
from phylonium_tpu_torch.native import build as native_build
from phylonium_tpu_torch.parallel.multihost import world
from phylonium_tpu_torch.serve.client import DevdError, devd_enabled
from phylonium_tpu_torch.utils import calibration
from phylonium_tpu_torch.utils.platform import check_device
from phylonium_tpu_torch.utils.profile import profiled

USAGE = f"""Usage: {PROG} [OPTIONS] FILES...
\tEach FASTA file is one genome (multi-contig files are fine).

Options:
      --device=DEV     Count all pairs, build streamed pileup rows and
                       extend hybrid-mapping anchors on DEV: 'cuda'
                       (default) or 'cpu'
  -2, --2pass          Rerun with the most central genome as reference
  -b, --bootstrap=N    Also print N-1 bootstrapped distance matrices
  --complete-deletion  Keep only reference columns covered in every genome
  -p FILE              Write per-column variant positions to FILE
                       (turns on complete deletion)
    --progress=WHEN    Progress bars on stderr: always/never/auto (default)
  -r FILE              Use FILE's genome as the mapping reference
  -t, --threads=N      Host worker threads (default: all cores)
  -v, --verbose        More diagnostics on stderr (repeat for timings)
      --distance=OPT   Output scale: 'jc' (default), 'raw', or 'ani'
      --esa-backend=B  Suffix index: 'native', 'numpy', or 'auto' (default)
      --count-backend=B  Pair counting: 'auto', 'device' or 'pallas' (all
                       on --device), 'host' or 'numpy' (host counters)
      --map-backend=B  Mapping: 'native', 'python', 'hybrid' (host chain,
                       anchor extension on --device), or 'auto' (default)
      --mesh=R,C       Count on an R x C mesh: R*C ranks, or R*C local
                       cards in a process of one rank (a world of R*C
                       ranks, one device each, is started by the
                       launcher; every rank maps its share of the
                       queries, rank 0 prints)
      --checkpoint=DIR Reuse/persist anchor-mapping results in DIR
      --profile=DIR    Write a torch.profiler trace of the run to DIR
  -h, --help           This text
      --version        Version information
"""


def _strtoul10(val: str) -> int | None:
    """glibc strtoul(s, &end, 10) with the reference's *end=='\\0' check:
    optional leading whitespace and sign, base-10 digits, nothing after.
    A negative value WRAPS mod 2^64; digits beyond ULONG_MAX are ERANGE
    (None).  Numeric flags (-b, -t) must share these exact semantics
    (src/phylonium.cxx:166-199) — e.g. '-b -1' means 2^64-1 matrices."""
    import re

    m = re.match(r"[ \t\n\r\f\v]*([+-])?([0-9]+)\Z", val)
    if not m:
        return None
    digits = int(m.group(2))
    if digits > 0xFFFFFFFFFFFFFFFF:
        return None
    return (-digits if m.group(1) == "-" else digits) % (1 << 64)


def usage(status: int) -> "NoReturn":  # noqa: F821
    out = sys.stdout if status == 0 else sys.stderr
    out.write(USAGE)
    sys.exit(status)


def version() -> "NoReturn":  # noqa: F821
    print(f"{PROG} {__version__}")
    sys.exit(0)


def cleanup_names(reference_name: str, file_names: list[str]) -> list[str]:
    """Add the reference, sort, dedup (src/phylonium.cxx:384-391)."""
    file_names = file_names + [reference_name]
    return sorted(set(file_names))


def _expand_bundles(argv: list[str]) -> list[str]:
    """getopt-style short-option bundling: -2v == -2 -v, -b5 == -b 5.

    Options taking a value (b, p, r, t) consume the rest of the token.
    """
    value_opts = "bprt"
    out: list[str] = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--":
            out.extend(argv[i:])
            break
        if len(arg) > 2 and arg[0] == "-" and arg[1] != "-":
            k = 1
            while k < len(arg):
                c = arg[k]
                out.append(f"-{c}")
                if c in value_opts:
                    rest = arg[k + 1 :]
                    if rest:
                        out.append(rest)
                    break
                k += 1
        else:
            out.append(arg)
        i += 1
    return out


# every long option, for getopt_long-style unambiguous-prefix matching
_LONG_OPTS = (
    "2pass", "bootstrap", "complete-deletion", "distance", "help",
    "progress", "threads", "verbose", "version", "esa-backend",
    "count-backend", "map-backend", "mesh", "checkpoint", "profile",
)


def _canonical_long(arg: str) -> str:
    """Resolve '--boot' to '--bootstrap' like getopt_long does; exact
    names win, ambiguous or unknown prefixes pass through (and fail
    downstream like any unknown option)."""
    name, eq, value = arg[2:].partition("=")
    if name in _LONG_OPTS:
        return arg
    hits = [o for o in _LONG_OPTS if o.startswith(name)] if name else []
    if len(hits) == 1:
        return f"--{hits[0]}{eq}{value}"
    return arg


def parse_args(argv: list[str]) -> tuple[TorchRunConfig, list[str]]:
    cfg = TorchRunConfig()
    files: list[str] = []
    argv = _expand_bundles(argv)
    canon: list[str] = []
    seen_dashes = False
    for a in argv:
        seen_dashes = seen_dashes or a == "--"
        if not seen_dashes and a.startswith("--"):
            a = _canonical_long(a)
        canon.append(a)
    argv = canon
    i = 0

    def take_value(flag: str) -> str:
        nonlocal i
        i += 1
        if i >= len(argv):
            usage(1)
        return argv[i]

    want_version = False
    while i < len(argv):
        arg = argv[i]
        if arg == "--":
            files.extend(argv[i + 1 :])
            break
        elif arg in ("-2", "--2pass"):
            cfg.two_pass = True
        elif arg == "-b" or arg == "--bootstrap" or arg.startswith("--bootstrap="):
            val = arg.split("=", 1)[1] if "=" in arg else take_value(arg)
            bootstrap = _strtoul10(val)
            if bootstrap:  # junk/ERANGE (None) and 0 both soft-error
                cfg.bootstrap = bootstrap - 1
            else:
                cfg.soft_error(
                    f"Expected a positive number for -b argument, but "
                    f"'{val}' was given. Ignoring -b argument."
                )
        elif arg == "--complete-deletion":
            cfg.complete_deletion = True
        elif arg == "--distance" or arg.startswith("--distance="):
            val = arg.split("=", 1)[1] if "=" in arg else take_value(arg)
            low = val.lower()
            if low in ("raw", "jc", "ani"):
                # sticky bits, reference semantics: repeats OR together,
                # 'jc' sets nothing; estimator precedence raw > ani > jc
                if low == "raw":
                    cfg.dist_raw = True
                elif low == "ani":
                    cfg.dist_ani = True
                cfg.distance = (
                    "raw" if cfg.dist_raw
                    else "ani" if cfg.dist_ani
                    else "jc"
                )
            else:
                cfg.soft_error(
                    f"ignoring argument for --distance '{val}' expected "
                    "one of 'raw', 'jc', or 'ani'"
                )
        elif arg in ("-h", "--help"):
            usage(0)
        elif arg == "-p":
            cfg.print_positions = True
            cfg.complete_deletion = True
            cfg.refpos_file_name = take_value(arg)
        elif arg == "--progress" or arg.startswith("--progress="):
            val = arg.split("=", 1)[1] if "=" in arg else "always"
            low = val.lower()
            if low in ("always", "auto", "never"):
                cfg.progress = low
            else:
                cfg.warn(
                    f"invalid argument to --progress '{val}'. Expected one "
                    "of 'auto', 'always', or 'never'."
                )
        elif arg == "-r":
            cfg.reference_name = take_value(arg)
        elif arg in ("-t", "--threads") or arg.startswith("--threads="):
            val = arg.split("=", 1)[1] if "=" in arg else take_value(arg)
            threads = _strtoul10(val)
            if threads is None:
                cfg.warn(
                    f"Expected a number for -t argument, but '{val}' was "
                    "given. Ignoring -t argument."
                )
            else:
                from phylonium_tpu_torch.native import num_procs

                if threads > num_procs():
                    # reference wording verbatim, typo included
                    # (src/phylonium.cxx:179-183): a wrapped negative
                    # lands here with its mod-2^64 value
                    cfg.warn(
                        "The number of threads to be used, is greater "
                        "then the number of available processors; "
                        f"Ignoring -t {threads} argument."
                    )
                else:
                    cfg.threads = threads
        elif arg in ("-v", "--verbose"):
            cfg.verbose += 1
        elif arg == "--version":
            want_version = True
        elif arg == "--esa-backend" or arg.startswith("--esa-backend="):
            val = arg.split("=", 1)[1] if "=" in arg else take_value(arg)
            if val in ("auto", "native", "numpy"):
                cfg.esa_backend = val
            else:
                cfg.soft_error(
                    f"ignoring argument for --esa-backend '{val}' expected "
                    "one of 'auto', 'native', or 'numpy'"
                )
        elif arg == "--count-backend" or arg.startswith("--count-backend="):
            val = arg.split("=", 1)[1] if "=" in arg else take_value(arg)
            if val in ("auto", "pallas", "device", "host", "numpy"):
                cfg.count_backend = val
            else:
                cfg.soft_error(
                    f"ignoring argument for --count-backend '{val}' "
                    "expected one of 'auto', 'pallas', 'device', 'host', "
                    "or 'numpy'"
                )
        elif arg == "--mesh" or arg.startswith("--mesh="):
            val = arg.split("=", 1)[1] if "=" in arg else take_value(arg)
            parts = val.split(",")
            if all(p.isdigit() and int(p) > 0 for p in parts) and len(
                parts
            ) in (1, 2):
                cfg.mesh = val
            else:
                cfg.soft_error(
                    f"ignoring argument for --mesh '{val}' expected "
                    "'R,C' with positive integers"
                )
        elif arg == "--map-backend" or arg.startswith("--map-backend="):
            val = arg.split("=", 1)[1] if "=" in arg else take_value(arg)
            if val in ("auto", "native", "python", "hybrid"):
                cfg.map_backend = val
            else:
                cfg.soft_error(
                    f"ignoring argument for --map-backend '{val}' expected "
                    "one of 'auto', 'native', 'python', or 'hybrid'"
                )
        elif arg == "--checkpoint" or arg.startswith("--checkpoint="):
            cfg.checkpoint_dir = (
                arg.split("=", 1)[1] if "=" in arg else take_value(arg)
            )
        elif arg == "--profile" or arg.startswith("--profile="):
            cfg.profile_dir = (
                arg.split("=", 1)[1] if "=" in arg else take_value(arg)
            )
        elif arg.startswith("--"):
            # getopt_long's diagnostic line precedes the usage text;
            # a prefix matching several long options gets the
            # "ambiguous" form (our extra options can make a prefix
            # ambiguous that is unique in the reference's table —
            # inherent to extending the surface)
            name = arg[2:].partition("=")[0]
            hits = (
                [o for o in _LONG_OPTS if o.startswith(name)]
                if name else []
            )
            if len(hits) > 1:
                poss = " ".join(f"'--{o}'" for o in hits)
                print(
                    f"{PROG}: option '{arg}' is ambiguous; "
                    f"possibilities: {poss}",
                    file=sys.stderr,
                )
            else:
                print(
                    f"{PROG}: unrecognized option '{arg}'",
                    file=sys.stderr,
                )
            usage(1)
        elif arg.startswith("-") and arg != "-":
            # bundles were pre-split, so an unknown short is one char
            print(
                f"{PROG}: invalid option -- '{arg[1:]}'", file=sys.stderr
            )
            usage(1)
        else:
            files.append(arg)
        i += 1

    if want_version:
        version()

    return cfg, files



def _split_device(argv: list[str]) -> tuple[str, list[str]] | None:
    """Take ``--device DEV`` / ``--device=DEV`` out of argv.

    Returns None when ``--device`` has no value.
    """
    device = "cuda"
    rest: list[str] = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--":
            rest.extend(argv[i:])
            break
        if arg == "--device":
            if i + 1 >= len(argv):
                return None
            device = argv[i + 1]
            i += 2
            continue
        if arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
        i += 1
    return device, rest


def _read_all(file_names: list[str], workers: int, compact: bool, shipper=None):
    """Read and join every genome, in order, a bounded few files ahead;
    with ``compact``, 2-bit compact each one as it arrives; hand each to
    ``shipper`` in query order (compacted first: the shipper then works
    from the per-genome packs)."""

    def joined(genome):
        seq = join(genome)
        if compact:
            seq.compact()
        if shipper is not None:
            if seq.compacted:
                shipper.add_seq(seq)
            else:
                shipper.add(seq.as_array())
        return seq

    with ThreadPoolExecutor(max_workers=workers) as pool:
        pending: deque = deque()
        queries = []
        for name in file_names:
            pending.append(pool.submit(read_genome, name))
            if len(pending) >= 2 * workers:
                queries.append(joined(pending.popleft().result()))
        while pending:
            queries.append(joined(pending.popleft().result()))
    return queries


def _predicts_lowmem(file_names: list[str], cfg: TorchRunConfig) -> bool:
    """Will the pipeline take the low-memory path? Predicted from the
    file sizes, as the JAX CLI does, so that sequences are compacted at
    read time and the raw panel never exists; the pipeline decides again
    on the exact sizes, and compaction is transparent either way."""
    try:
        est_bp = int(sum(os.path.getsize(f) for f in file_names) * 0.98)
    except OSError:
        return False
    return should_lowmem(len(file_names), est_bp, cfg)


def _start_shipper(file_names: list[str], cfg: TorchRunConfig, lowmem: bool):
    """The early query shipper of this run, or None (JAX cli.py:398-434):
    where ``early_ship_eligible`` says the streamed device compare is
    worth it, groups of the streamed feeder's size, or of the low-memory
    group predicted from the file sizes; the largest file bounds the
    reference's length for the groups' int32 cuts. Under
    ``devd_enabled`` it ships to the device server; otherwise its
    worker imports torch and resolves the device on its own thread."""
    if not early_ship_eligible(cfg, file_names):
        return None
    sizes = [os.path.getsize(f) for f in file_names]
    group = None
    if lowmem:
        est_bp = int(sum(sizes) * 0.98)
        group = group_rows_for(len(file_names), max(1, est_bp // len(file_names)))
    return QueryShipper(
        len(file_names), cfg.device, group_rows=group, ref_len_bound=max(sizes),
        store=calibration.for_device(cfg.device),
        transport="devd" if devd_enabled(cfg.device) else "local",
    )


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    split = _split_device(argv)
    if split is None:
        sys.stderr.write(USAGE)
        return 1
    device, argv = split
    cfg, file_names = parse_args(argv)
    cfg.device = device

    try:
        check_mesh(cfg)
        devd_enabled(cfg.device)  # refused in a world of several ranks
        if (cfg.count_backend not in ("numpy", "host")
                or cfg.map_backend == "hybrid"):
            check_device(cfg.device)  # fail before any work
    except ConfigError as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        return 1

    if cfg.print_positions and os.path.exists(cfg.refpos_file_name):
        print(
            f"{PROG}: output file '{cfg.refpos_file_name}' already exists",
            file=sys.stderr,
        )
        return 1

    if cfg.reference_name:
        file_names = cleanup_names(cfg.reference_name, file_names)

    if len(file_names) < 2:
        sys.stderr.write(USAGE)
        return 1

    if cfg.threads:
        from phylonium_tpu_torch.native import num_procs, set_threads

        if cfg.threads > num_procs():
            cfg.warn(
                "The number of threads to be used, is greater then the "
                f"number of available processors; Ignoring -t "
                f"{cfg.threads} argument."
            )
            cfg.threads = 0
        else:
            set_threads(cfg.threads)

    lowmem = _predicts_lowmem(file_names, cfg)
    try:
        cfg._query_shipper = _start_shipper(file_names, cfg, lowmem)
    except OSError as e:
        print(f"{PROG}: {e.filename}: {e.strerror}", file=sys.stderr)
        return e.errno or 1
    try:
        return _run(cfg, file_names, lowmem)
    finally:
        if cfg._query_shipper is not None:
            cfg._query_shipper.stop()
            cfg._query_shipper = None


def _run(cfg: TorchRunConfig, file_names: list[str], lowmem: bool) -> int:
    """Read, pick the reference, run the pipeline (twice with ``-2``),
    print the matrix and the run report."""
    try:
        queries = _read_all(
            file_names, max(cfg.threads or min(8, len(file_names)), 1),
            lowmem, cfg._query_shipper,
        )
    except OSError as e:
        print(f"{PROG}: {e.filename}: {e.strerror}", file=sys.stderr)
        return e.errno or 1
    except ValueError as e:  # FastaError and friends
        print(f"{PROG}: {e}", file=sys.stderr)
        return 1

    if cfg.reference_name:
        reference_index = file_names.index(cfg.reference_name)
    else:
        reference_index = pick_first_pass(queries, verbose=bool(cfg.verbose))

    try:
        with profiled(cfg):
            counts = process(queries[reference_index], queries, cfg)
            if cfg.two_pass:
                second_index = pick_second_pass(counts)
                if second_index == reference_index:
                    # the pass-1 reference is already the central genome: a
                    # second pass would repeat the same deterministic run
                    if cfg.verbose:
                        print(
                            f"ref: {queries[reference_index].name}",
                            file=sys.stderr,
                        )
                else:
                    reference_index = second_index
                    counts = process(queries[reference_index], queries, cfg)
    except (ConfigError, DevdError) as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        return 1
    if cfg.verbose and native_build.BUILD_INFO:
        info = native_build.BUILD_INFO
        print(
            f"native library {info['path']} "
            f"({'built' if info['built'] else 'loaded'}; {info['compiler']})",
            file=sys.stderr,
        )

    # several ranks: every rank computed the same matrix (the count's last
    # gather hands it to all); only rank 0 prints it and writes the report
    if world()[1] != 0:
        return cfg.return_code

    names = [q.name for q in queries]
    lengths = np.array([len(q) for q in queries], dtype=np.int64)
    print_matrix(cfg, names, lengths, counts, reference_index)

    report_path = os.environ.get("PHYLONIUM_TPU_RUN_REPORT")
    if report_path:
        # written after the matrix, so it never perturbs the output
        try:
            with open(report_path, "w") as f:
                json.dump(LAST_RUN_INFO, f)
        except Exception as e:  # noqa: BLE001 — never fail the run over a report
            cfg.warn(f"could not write run report: {e}")
    return cfg.return_code


if __name__ == "__main__":
    sys.exit(main())
