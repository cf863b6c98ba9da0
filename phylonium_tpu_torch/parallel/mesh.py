"""The counting mesh: a ('rows', 'cols') grid of torch.distributed ranks.

The port of the JAX package's phylonium_tpu/parallel/mesh.py. Its axes are
the JAX package's:

- ``cols``: reference-column shards. Each cell counts its column shard;
  the exact integer partials are summed over the cells of a row.
- ``rows``: genome blocks (row blocks of the output matrix), the axis that
  scales with N. Each cell gathers the other blocks of its column shard.

JAX spans a mesh over devices; here a cell is a rank (one process, one
device), so an ``R x C`` mesh is a world of exactly ``R * C`` ranks. Rank
``r`` holds the cell ``(r // C, r % C)`` and the device
``cuda:{local_rank % device_count}`` or the CPU. Each rank builds two
process groups: ``rows_group``, the R ranks of its column (the all_gather
runs over it), and ``cols_group``, the C ranks of its row (the all_reduce
runs over it). Every rank creates every group, in the same order, as
``dist.new_group`` requires.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from phylonium_tpu_torch.config import ConfigError
from phylonium_tpu_torch.parallel.multihost import (
    native_stdout_to_stderr,
    node_info,
    world,
)

# meshes built in this process, by (shape, device): new groups are made
# once, and every rank asks for the same meshes in the same order
_MESHES: dict = {}


@dataclass(frozen=True)
class Mesh:
    shape: tuple[int, int]  # (rows, cols)
    rank: int
    device: torch.device
    backend: str | None  # None: a 1 x 1 mesh outside any world
    rows_group: object = None  # the ranks of this rank's column
    cols_group: object = None  # the ranks of this rank's row

    @property
    def cell(self) -> tuple[int, int]:
        return divmod(self.rank, self.shape[1])


def needed_ranks_message(shape: tuple[int, int], size: int) -> str:
    rows, cols = shape
    return (
        f"--mesh {rows},{cols} needs {rows * cols} ranks; the torch.distributed "
        f"world has {size}. Launch {rows * cols} ranks, e.g. `torchrun "
        f"--nproc-per-node {rows * cols} -m phylonium_tpu_torch ...` with a "
        "launcher that calls "
        "phylonium_tpu_torch.parallel.multihost.initialize_distributed"
    )


def _rank_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ConfigError(f"device '{device}' is not supported; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise ConfigError(f"device '{device}' was asked for, but torch finds no CUDA device")
    if device.index is not None:
        return device
    return torch.device("cuda", node_info()["local_rank"] % torch.cuda.device_count())


def make_mesh(shape: tuple[int, int] | None = None, device="cuda") -> Mesh:
    """The mesh of this rank (collective: every rank calls it alike).

    ``shape`` defaults to ``(1, world size)``, as JAX's defaults to
    ``(1, n)``: the column axis is the one that divides the work at any N.
    """
    size, rank = world()
    if shape is None:
        shape = (1, size)
    rows, cols = (int(x) for x in shape)
    if rows < 1 or cols < 1 or rows * cols != size:
        raise ConfigError(needed_ranks_message((rows, cols), size))
    device = _rank_device(device)
    key = ((rows, cols), str(device))
    if key in _MESHES:
        return _MESHES[key]
    if not dist.is_initialized():
        mesh = Mesh((1, 1), 0, device, None)
    else:
        backend = dist.get_backend()
        if backend == "nccl" and device.type != "cuda":
            raise ConfigError(
                "an nccl world counts on CUDA devices; run CPU ranks under gloo"
            )
        from phylonium_tpu_torch.parallel.multihost import TIMEOUT

        my_row, my_col = divmod(rank, cols)
        groups = {}
        with native_stdout_to_stderr():
            for c in range(cols):
                g = dist.new_group([i * cols + c for i in range(rows)], timeout=TIMEOUT)
                if c == my_col:
                    groups["rows"] = g
            for i in range(rows):
                g = dist.new_group([i * cols + c for c in range(cols)], timeout=TIMEOUT)
                if i == my_row:
                    groups["cols"] = g
        mesh = Mesh((rows, cols), rank, device, backend, groups["rows"], groups["cols"])
    _MESHES[key] = mesh
    return mesh
