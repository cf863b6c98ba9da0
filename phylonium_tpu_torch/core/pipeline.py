"""The one-shot pipeline: index -> map -> pileup -> all-pairs counts.

It follows the JAX package's ``process`` (phylonium_tpu/core/pipeline.py)
on its one-shot path and imports every host step from there: the suffix
index, anchor mapping, complete deletion, the pileup build and the
``-p`` position file are jax-free host code (C++ in ``native/`` and
numpy). Only the all-pairs count differs: it runs once, on the torch
device the configuration names, through ops/pair_count.py.

Not carried here: the streamed feeder, low-memory mode, pod and mesh
runs, kernel prewarm, link calibration, and the host race. Options that
would reach the JAX package's device code are refused.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from phylonium_tpu.core.anchor_stats import min_anchor_length
from phylonium_tpu.core.complete_deletion import complete_delete
from phylonium_tpu.core.pileup import build_pileup
from phylonium_tpu.core.pipeline import map_queries
from phylonium_tpu.core.segsites import write_refpos
from phylonium_tpu.data.sequence import Sequence, gc_content
from phylonium_tpu.index.esa import ESAIndex
from phylonium_tpu.model.evo import EvoCounts
from phylonium_tpu.utils.progress import ProgressBar
from phylonium_tpu_torch.config import ConfigError, TorchRunConfig
from phylonium_tpu_torch.ops import pair_count
from phylonium_tpu_torch.utils.platform import resolve_device

# What the most recent process() run did: which carrier produced the pair
# counts ("cuda-kernel", "torch-cpu", "host" or "numpy"), the phase
# timings in seconds, and the kernel launches and plain-version calls it
# made.
LAST_RUN_INFO: dict = {}


def refuse_unported(cfg: TorchRunConfig) -> None:
    """Raise ConfigError for options that reach JAX device code."""
    if cfg.mesh:
        raise ConfigError("--mesh is not supported by the torch port yet")
    if cfg.map_backend == "hybrid":
        raise ConfigError(
            "--map-backend hybrid is not supported by the torch port yet"
        )
    if cfg.profile_dir:
        raise ConfigError("--profile is not supported by the torch port yet")


def pair_counts(
    states: np.ndarray, cfg: TorchRunConfig
) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs (substitutions, homologs), int64 [N, N].

    numpy and host keep the JAX package's jax-free host counters; auto,
    device and pallas all count on ``cfg.device`` through the port.
    """
    backend = cfg.count_backend
    if backend == "numpy":
        from phylonium_tpu.ops.match_table import pair_counts_numpy

        LAST_RUN_INFO["compare_carrier"] = "numpy"
        return pair_counts_numpy(states)
    if backend == "host":
        from phylonium_tpu.ops.bitplane_host import pair_counts_host

        LAST_RUN_INFO["compare_carrier"] = "host"
        return pair_counts_host(states)
    device = resolve_device(cfg.device)
    LAST_RUN_INFO["compare_carrier"] = (
        "cuda-kernel" if device.type == "cuda" else "torch-cpu"
    )
    return pair_count.pair_counts(states, device)


def process(
    subject: Sequence, queries: list[Sequence], cfg: TorchRunConfig
) -> EvoCounts:
    refuse_unported(cfg)
    LAST_RUN_INFO.clear()
    launches0 = pair_count.KERNEL_LAUNCHES
    plain0 = pair_count.PLAIN_CALLS
    timings: dict[str, float] = {}
    n = len(queries)

    t0 = time.perf_counter()
    ref = ESAIndex(subject, backend=cfg.esa_backend)
    timings["index"] = time.perf_counter() - t0
    gc = gc_content(subject.nucl)
    threshold = min_anchor_length(cfg.anchor_p_value, gc, ref.size)

    if cfg.verbose:
        print(f"ref: {subject.name}", file=sys.stderr)

    t0 = time.perf_counter()
    homologies = map_queries(ref, threshold, queries, cfg)
    timings["map"] = time.perf_counter() - t0

    if cfg.complete_deletion:
        homologies = complete_delete(homologies)

    t0 = time.perf_counter()
    states = build_pileup(
        [q.as_array() for q in queries], homologies, len(subject)
    )
    timings["pileup"] = time.perf_counter() - t0

    if cfg.print_positions:
        write_refpos(cfg.refpos_file_name, subject.nucl, states, homologies[0])

    num_comparisons = (n * n - n) // 2
    bar = ProgressBar(
        "Comparing the sequences", num_comparisons,
        enabled=cfg.progress_enabled,
    )
    t0 = time.perf_counter()
    subs, homs = pair_counts(states, cfg)
    timings["compare"] = time.perf_counter() - t0
    bar.finish()

    LAST_RUN_INFO["timings"] = timings
    LAST_RUN_INFO["kernel_launches"] = pair_count.KERNEL_LAUNCHES - launches0
    LAST_RUN_INFO["plain_calls"] = pair_count.PLAIN_CALLS - plain0
    if cfg.verbose >= 2:
        phases = "  ".join(f"{k}={v:.3f}s" for k, v in timings.items())
        print(
            f"phase timings ({ref.backend_name} index, "
            f"{cfg.count_backend} counts, "
            f"{LAST_RUN_INFO['compare_carrier']} carried, "
            f"{LAST_RUN_INFO['kernel_launches']} kernel launches, "
            f"{LAST_RUN_INFO['plain_calls']} plain calls): {phases}",
            file=sys.stderr,
        )
    return EvoCounts(subs, homs)
