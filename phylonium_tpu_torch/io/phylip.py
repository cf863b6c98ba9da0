"""PHYLIP distance-matrix output and warnings.

Formatting parity with the reference (`src/io.cxx:141-233`):

- header line: N;
- each row: name, then two spaces before every value;
- JC / raw distances print like C++ ``std::scientific`` at precision 4
  (``%.4e``); ANI prints like C++ defaultfloat at precision 4 (``%.4g``)
  — the reference's ``std::dec`` is a no-op for doubles;
- the diagonal prints as 0.0 regardless of cell content;
- ``-b`` appends bootstrap replicate matrices;
- warnings (nan distances; pairwise coverage < 20%) go to stderr *before*
  the matrix and force a failing exit code (src/io.cxx:106-139);
- verbose mode appends avg coverage and alignment totals on stderr
  (src/io.cxx:202-232).

A copy of the JAX package's ``phylonium_tpu/io/phylip.py``: the port carries
its own host layer and imports nothing of that package.
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np

from phylonium_tpu_torch.config import RunConfig
from phylonium_tpu_torch.model.evo import EvoCounts


def format_matrix(names: list[str], dist: np.ndarray, ani: bool) -> str:
    n = len(names)
    # one C-level printf per row ("%.4e"/"%.4g" == the f-string specs
    # used per-cell before; byte parity enforced by the oracle suites),
    # several times faster than per-cell Python formatting at N=1000
    cells = np.array(dist, dtype=np.float64, copy=True)
    np.fill_diagonal(cells, 0.0)
    fmt1 = "%.4g" if ani else "%.4e"
    row_fmt = "  ".join([fmt1] * n)
    # glibc printf renders negative-signed NaNs as "-nan" (the JC map
    # produces them for raw > 3/4, src/evo_model.cxx:124-131 semantics);
    # Python's %-formatting silently drops the sign, so rows carrying
    # one take a per-cell slow path
    negnan = np.isnan(cells) & np.signbit(cells)
    lines = [str(n)]
    for i in range(n):
        if negnan[i].any():
            vals = "  ".join(
                "-nan" if negnan[i, j] else fmt1 % cells[i, j]
                for j in range(n)
            )
            lines.append(names[i] + "  " + vals)
        else:
            lines.append(names[i] + "  " + row_fmt % tuple(cells[i]))
    return "\n".join(lines) + "\n"


def estimate(counts: EvoCounts, distance: str) -> np.ndarray:
    if distance == "raw":
        return counts.estimate_raw()
    if distance == "ani":
        return counts.estimate_ani()
    return counts.estimate_jc()


def print_warnings(
    cfg: RunConfig,
    names: list[str],
    lengths: np.ndarray,
    dist: np.ndarray,
    counts: EvoCounts,
) -> None:
    n = len(names)
    cov = counts.coverage(lengths)
    for i in range(n):
        for j in range(i):
            d = dist[i, j]
            if np.isnan(d):
                cfg.soft_error(
                    f"For the two sequences '{names[i]}' and '{names[j]}' "
                    "the distance computation failed and is reported as nan."
                )
            else:
                cov1 = cov[i, j]
                cov2 = counts.homologs[i, j] / lengths[j]
                if cov1 < 0.2 or cov2 < 0.2:
                    cfg.soft_error(
                        f"For the two sequences '{names[i]}' and "
                        f"'{names[j]}' less than 20% homology were found "
                        f"({cov1:f} and {cov2:f}, respectively)."
                    )


def write_abscov(
    subject_name: str, names: list[str], counts: EvoCounts
) -> str:
    """Write '<subject>.abscov' with absolute pairwise coverages.

    Functional equivalent of the reference's second print_matrix overload
    (src/io.cxx:235-258) — declared there but never reachable from main;
    here it is activated by extra verbosity (-v -v).
    """
    path = f"{subject_name}.abscov"
    with open(path, "w") as f:
        f.write("Absolute Coverages:\n")
        n = len(names)
        for i in range(n):
            f.write(names[i])
            for j in range(n):
                f.write(f"  {int(counts.homologs[i, j]):8d}")
            f.write("\n")
    return path


def print_matrix(
    cfg: RunConfig,
    names: list[str],
    lengths: np.ndarray,
    counts: EvoCounts,
    reference_index: int,
    out=None,
) -> None:
    out = out or sys.stdout
    # the ani FORMAT keys on the ani bit alone (src/io.cxx:149), even
    # when the raw bit wins the estimator choice
    ani = cfg.dist_ani or cfg.distance == "ani"
    dist = estimate(counts, cfg.distance)

    print_warnings(cfg, names, lengths, dist, counts)

    out.write(format_matrix(names, dist, ani))
    if cfg.bootstrap:
        seed = os.environ.get("PHYLONIUM_TPU_RD_SEED")
        if seed is not None:
            # Draw-for-draw glibcxx replication: with the oracle built
            # under PHYLONIUM_ORACLE_RD_SEED=<same u32>, `-b` replicate
            # matrices are byte-identical (model/glibcxx_prng.py).  The
            # reference consumes 1248 random_device words at startup:
            # its seed-buffer template sizes by mt19937::result_type,
            # which is uint_fast32_t = 8 BYTES on LP64, doubling the
            # word count (src/phylonium.cxx:76-91); it then bootstraps
            # every cell of the full N x N matrix row-major
            # (src/io.cxx:187-193).
            from phylonium_tpu_torch.model import glibcxx_prng as gp

            # parse like the oracle shim's strtoul: leading digits win,
            # junk means 0, value wraps to u32 (splitmix masks anyway)
            m = re.match(r"\s*\+?(\d+)", seed)
            seed_val = int(m.group(1)) if m else 0
            grng = gp.Mt19937(gp.splitmix32_words(seed_val, 1248))
            for _ in range(cfg.bootstrap):
                subs = gp.bootstrap_cells(
                    counts.homologs, counts.substitutions, grng
                )
                boot = EvoCounts(subs, counts.homologs.copy())
                dist = estimate(boot, cfg.distance)
                out.write(format_matrix(names, dist, ani))
        else:
            rng = np.random.default_rng()
            for _ in range(cfg.bootstrap):
                boot = counts.bootstrap(rng)
                dist = estimate(boot, cfg.distance)
                out.write(format_matrix(names, dist, ani))
    # NOTE: with -b, `dist` is now the LAST replicate — deliberately:
    # the reference overwrites dist_matrix per replicate and its verbose
    # avg-coverage loop masks NaN cells by whatever it holds afterwards
    # (src/io.cxx:188-214)

    if cfg.verbose:
        n = len(names)
        total = 0.0
        counter = 0
        for i in range(n):
            for j in range(i):
                if np.isnan(dist[i, j]):
                    continue
                total += counts.homologs[i, j] / lengths[i]
                total += counts.homologs[i, j] / lengths[j]
                counter += 2
        avg = total / counter if counter else float("nan")
        aln_aligned = 0
        aln_total = 0
        for i in range(n):
            if i == reference_index:
                continue
            aln_aligned += int(counts.homologs[reference_index, i])
            aln_total += int(lengths[i])
        # C++ cerr default formatting: defaultfloat, precision 6 (%.6g)
        print(f"avg coverage:\t{avg:.6g}", file=sys.stderr)
        frac = aln_aligned / aln_total if aln_total else float("nan")
        print(
            f"alignment:\t{aln_aligned}\t{aln_total}\t{frac:.6g}",
            file=sys.stderr,
        )
        if cfg.verbose >= 2:
            path = write_abscov(names[reference_index], names, counts)
            print(f"absolute coverages written to {path}", file=sys.stderr)
