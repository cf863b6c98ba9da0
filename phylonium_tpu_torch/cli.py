"""Command-line entry point of the torch port.

The flags are the JAX package's (phylonium_tpu/cli.py, parsed by its
``parse_args``) plus ``--device``, which names the torch device of the
pair count, of hybrid mapping's diagonal bitmaps and of the streamed and
low-memory paths' pileup build. The run is the JAX CLI's: read the FASTA
files (2-bit compacted when the low-memory path is predicted), pick the
reference, run the pipeline (twice with ``-2``), print PHYLIP. The
streamed and low-memory paths are reached through the JAX package's
environment switches (``PHYLONIUM_TPU_STREAM``,
``PHYLONIUM_TPU_STREAM_GROUP``, ``PHYLONIUM_TPU_LOWMEM``,
``PHYLONIUM_TPU_LOWMEM_BYTES``); the port adds no flag for them.
"""

from __future__ import annotations

import os
import sys
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from phylonium_tpu.cli import cleanup_names, parse_args
from phylonium_tpu.core.lowmem import should_lowmem
from phylonium_tpu.core.reference_pick import pick_first_pass, pick_second_pass
from phylonium_tpu.data.sequence import join
from phylonium_tpu.io.fasta import read_genome
from phylonium_tpu.io.phylip import print_matrix
from phylonium_tpu_torch import __version__
from phylonium_tpu_torch.config import PROG, ConfigError, TorchRunConfig
from phylonium_tpu_torch.core.pipeline import process, refuse_unported
from phylonium_tpu_torch.utils.platform import resolve_device

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
      --checkpoint=DIR Reuse/persist anchor-mapping results in DIR
  -h, --help           This text
      --version        Version information
"""


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


def _read_all(file_names: list[str], workers: int, compact: bool):
    """Read and join every genome, in order, a bounded few files ahead;
    with ``compact``, 2-bit compact each one as it arrives."""

    def joined(genome):
        seq = join(genome)
        if compact:
            seq.compact()
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


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    split = _split_device(argv)
    if split is None:
        sys.stderr.write(USAGE)
        return 1
    device, argv = split
    head = argv[: argv.index("--")] if "--" in argv else argv
    if "-h" in head or "--help" in head:
        sys.stdout.write(USAGE)
        return 0
    if "--version" in head:
        print(f"{PROG} {__version__}")
        return 0

    base_cfg, file_names = parse_args(argv)
    cfg = TorchRunConfig.from_run_config(base_cfg, device=device)

    try:
        refuse_unported(cfg)
        if (cfg.count_backend not in ("numpy", "host")
                or cfg.map_backend == "hybrid"):
            resolve_device(cfg.device)  # fail before any work
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
        from phylonium_tpu.native import num_procs, set_threads

        if cfg.threads > num_procs():
            cfg.warn(
                "The number of threads to be used, is greater then the "
                f"number of available processors; Ignoring -t "
                f"{cfg.threads} argument."
            )
            cfg.threads = 0
        else:
            set_threads(cfg.threads)

    try:
        queries = _read_all(
            file_names, max(cfg.threads or min(8, len(file_names)), 1),
            _predicts_lowmem(file_names, cfg),
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
    except ConfigError as e:
        print(f"{PROG}: {e}", file=sys.stderr)
        return 1

    names = [q.name for q in queries]
    lengths = np.array([len(q) for q in queries], dtype=np.int64)
    print_matrix(cfg, names, lengths, counts, reference_index)
    return cfg.return_code


if __name__ == "__main__":
    sys.exit(main())
