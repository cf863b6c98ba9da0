"""Multi-rank start-up, the world the CLI reads, and the pod mesh.

The port of the JAX package's phylonium_tpu/parallel/multihost.py. JAX
runs one process per host under ``jax.distributed`` and spans its mesh
over the devices of all of them; PyTorch's idiom is one process per
device, so in a ``torch.distributed`` world of several ranks a mesh cell
is a rank. A process of one rank with several local devices spans them
instead (parallel/mesh.py's local mesh), as the JAX package spans its
local devices: :func:`make_pod_mesh` is then ``(1, n)`` over them.

The launcher starts the world with :func:`initialize_distributed` (or
``dist.init_process_group`` itself) before it calls the CLI or the API;
the pipeline only reads it (:func:`world`), as the JAX CLI reads
``jax.distributed``'s state. The backend is the caller's choice and is
never swapped:

- ``nccl`` for ranks with a CUDA device each. More ranks on a host than
  it has cards is a :class:`ConfigError` that names gloo (NCCL refuses two
  ranks on one card, "Duplicate GPU").
- ``gloo`` for CPU ranks, and for ranks that share one card. Collectives
  then run on host tensors: the collective wrappers copy to the host
  before and back to the device after, by rule of the backend
  (parallel/distributed.py). The kernels still run on the card.

Every world has an explicit timeout, so a lost rank fails its peers' next
collective instead of hanging them.

This module loads without torch: :func:`world` reads the world only where
``torch.distributed`` is already imported (the JAX package's
``_is_multiprocess`` idiom). A world of several ranks has joined before
the CLI runs, so it has loaded torch; a process that never imported it is
a world of one.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket
import sys

import numpy as np

from phylonium_tpu_torch.config import ConfigError
from phylonium_tpu_torch.utils.platform import loaded

DEFAULT_TIMEOUT_S = 600.0
# the timeout of the world this process joined; subgroups take the same
TIMEOUT = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)

# this rank's host: its name, the ranks and cards on it (node_info)
_NODE: dict = {}


@contextlib.contextmanager
def native_stdout_to_stderr():
    """Point fd 1 at fd 2 for the body, so that what the backends print
    from C++ (gloo's connection lines, NCCL's warnings) never reaches the
    matrix on stdout. Python's own ``print`` is not redirected when
    ``sys.stdout`` is not fd 1."""
    sys.stdout.flush()
    saved = os.dup(1)
    try:
        os.dup2(2, 1)
        yield
    finally:
        os.dup2(saved, 1)
        os.close(saved)


def world() -> tuple[int, int]:
    """(size, rank) of the torch.distributed world; (1, 0) outside one,
    and in a process that has not imported ``torch.distributed``."""
    dist = loaded("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def node_info() -> dict:
    """Collective on first call: every rank's host name and card count.

    Returns ``hosts`` (a name a rank), ``nodes`` (distinct hosts),
    ``local_rank`` and ``local_size`` (this rank's place among the ranks
    of its host) and ``gpus`` (each rank's card count).
    """
    import torch
    import torch.distributed as dist

    if _NODE:
        return _NODE
    size, rank = world()
    mine = (socket.gethostname(),
            torch.cuda.device_count() if torch.cuda.is_available() else 0)
    if size == 1:
        everyone = [mine]
    else:
        everyone = [None] * size
        with native_stdout_to_stderr():
            group = dist.new_group(backend="gloo", timeout=TIMEOUT)
            dist.all_gather_object(everyone, mine, group=group)
    hosts = [h for h, _ in everyone]
    _NODE.update(
        hosts=hosts,
        gpus=[g for _, g in everyone],
        nodes=len(set(hosts)),
        local_rank=hosts[:rank].count(hosts[rank]),
        local_size=hosts.count(hosts[rank]),
    )
    return _NODE


def _check_nccl(info: dict) -> None:
    for host in sorted(set(info["hosts"])):
        ranks = info["hosts"].count(host)
        cards = min(g for h, g in zip(info["hosts"], info["gpus"]) if h == host)
        if ranks > cards:
            raise ConfigError(
                f"the nccl backend takes one CUDA device a rank, but host "
                f"{host} runs {ranks} ranks on {cards} device(s) (NCCL refuses "
                "a duplicate GPU); launch at most one rank a device, or start "
                "the world with the gloo backend "
                "(initialize_distributed('gloo', ...)), which stages the "
                "collectives through the host"
            )


def initialize_distributed(
    backend: str,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    timeout: float = DEFAULT_TIMEOUT_S,
    store=None,
) -> None:
    """Join a torch.distributed world (a no-op if one is already up).

    ``backend``: 'nccl' (one CUDA device a rank) or 'gloo' (CPU ranks, or
    ranks that share a card). ``init_method``/``store``, ``world_size`` and
    ``rank`` go to ``dist.init_process_group``; left out, they come from
    torchrun's environment (``env://``). ``timeout`` (seconds) bounds every
    collective. A rank with a card is pinned to
    ``cuda:{local_rank % device_count}``.
    """
    global TIMEOUT
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if backend not in ("nccl", "gloo"):
        raise ConfigError(f"backend '{backend}' is not supported; use 'nccl' or 'gloo'")
    if backend == "nccl" and not torch.cuda.is_available():
        raise ConfigError(
            "the nccl backend needs a CUDA device; CPU ranks take gloo"
        )
    TIMEOUT = datetime.timedelta(seconds=timeout)
    _NODE.clear()  # what a lone process found before it joined the world
    kwargs = {"backend": backend, "timeout": TIMEOUT}
    if store is not None:
        kwargs["store"] = store
    else:
        kwargs["init_method"] = init_method or "env://"
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    with native_stdout_to_stderr():
        dist.init_process_group(**kwargs)
    info = node_info()
    if backend == "nccl":
        try:
            _check_nccl(info)
        except ConfigError:
            dist.destroy_process_group()
            _NODE.clear()
            raise
    if torch.cuda.is_available():
        torch.cuda.set_device(info["local_rank"] % torch.cuda.device_count())


def _launch_advice(ranks: int) -> str:
    return (
        f"Launch {ranks} ranks, e.g. `torchrun --nproc-per-node {ranks} -m "
        "phylonium_tpu_torch ...` with a launcher that calls "
        "phylonium_tpu_torch.parallel.multihost.initialize_distributed"
    )


def needed_ranks_message(shape: tuple[int, int], size: int) -> str:
    """Why a world of ``size`` ranks (more than one) cannot hold the
    ``shape`` mesh of ranks."""
    rows, cols = shape
    return (
        f"--mesh {rows},{cols} needs {rows * cols} ranks; the torch.distributed "
        f"world has {size}. {_launch_advice(rows * cols)}"
    )


def needed_devices_message(shape: tuple[int, int], local: int, kind: str) -> str:
    """Why a process of one rank, with ``local`` devices of type ``kind``,
    cannot hold the ``shape`` mesh of local devices: the JAX package's
    sentence (phylonium_tpu/core/pipeline.py:632-635), then the port's
    other way to the mesh, a world of ranks."""
    rows, cols = shape
    return (
        f"--mesh {rows},{cols} needs {rows * cols} devices; the runtime has "
        f"{local} (this process's local {kind} devices, in a world of one "
        f"rank). {_launch_advice(rows * cols)}"
    )


def make_pod_mesh(rows: int | None = None, device="cuda"):
    """A ('rows', 'cols') mesh over every rank of the world; ``rows``
    defaults to the host count, so that the all_gather rides the links
    inside a host and only the count's reduction crosses hosts. In a world
    of one rank, ``(1, n)`` over the process's ``n`` local devices of
    ``device``'s type (``utils.platform.local_devices``), as the JAX
    package's pod mesh is ``(process_count() = 1, n)`` over its devices."""
    from phylonium_tpu_torch.parallel.mesh import make_mesh
    from phylonium_tpu_torch.utils import platform

    size, _ = world()
    if size == 1:
        return make_mesh((1, len(platform.local_devices(device))), device)
    if rows is None:
        rows = max(1, node_info()["nodes"])
    while size % rows:
        rows -= 1
    return make_mesh((rows, size // rows), device)


def pair_counts_pod(
    states: np.ndarray, rows: int | None = None, device="cuda"
) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs counts over every rank of the world (collective)."""
    from phylonium_tpu_torch.parallel.distributed import pair_counts_sharded

    return pair_counts_sharded(states, make_pod_mesh(rows, device))
