"""The counting mesh: a ('rows', 'cols') grid of ranks or of local devices.

The port of the JAX package's phylonium_tpu/parallel/mesh.py. Its axes are
the JAX package's:

- ``cols``: reference-column shards. Each cell counts its column shard;
  the exact integer partials are summed over the cells of a row.
- ``rows``: genome blocks (row blocks of the output matrix), the axis that
  scales with N. Each cell gathers the other blocks of its column shard.

JAX spans a mesh over devices. The port has two kinds:

- In a torch.distributed world of several ranks a cell is a rank (one
  process, one device), so an ``R x C`` mesh is a world of exactly
  ``R * C`` ranks. Rank ``r`` holds the cell ``(r // C, r % C)`` and the
  device ``cuda:{local_rank % device_count}`` or the CPU. Each rank builds
  two process groups: ``rows_group``, the R ranks of its column (the
  all_gather runs over it), and ``cols_group``, the C ranks of its row
  (the all_reduce runs over it). Every rank creates every group, in the
  same order, as ``dist.new_group`` requires.
- In a world of one rank, an ``R x C`` mesh with ``R * C > 1`` spans the
  first ``R * C`` local devices of the device's type
  (``utils.platform.local_devices``), cell ``k = i * C + c`` on device
  ``k``, as JAX's ``make_mesh(shape, devices=jax.devices()[:R*C])``
  does. Its backend is ``"local"``: the process holds every cell and
  moves blocks between its devices with copies, not collectives
  (parallel/distributed.py). Fewer local devices than cells is a
  ConfigError; cells share a device only where a caller patches the
  helper.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from phylonium_tpu_torch.config import ConfigError
from phylonium_tpu_torch.parallel.multihost import (
    native_stdout_to_stderr,
    needed_devices_message,
    needed_ranks_message,
    node_info,
    world,
)
from phylonium_tpu_torch.utils import platform

# meshes built in this process, by (shape, device): new groups are made
# once, and every rank asks for the same meshes in the same order
_MESHES: dict = {}


@dataclass(frozen=True)
class Mesh:
    """A counting mesh. ``rank`` is this process's rank in its world and
    ``cell`` the cell it counts, ``(rank // C, rank % C)``; ``device`` is
    that cell's device. On a mesh of ranks ``devices`` is ``(device,)``.
    On a local mesh (``backend == "local"``) the process, rank 0 of a
    world of one, holds every cell: ``devices[k]`` is the device of cell
    ``divmod(k, C)``, and ``cell`` and ``device`` are cell (0, 0)'s."""

    shape: tuple[int, int]  # (rows, cols)
    rank: int
    device: torch.device
    backend: str | None  # None: a 1 x 1 mesh outside any world
    rows_group: object = None  # the ranks of this rank's column
    cols_group: object = None  # the ranks of this rank's row
    devices: tuple = ()  # the devices of the cells this process holds

    @property
    def cell(self) -> tuple[int, int]:
        return divmod(self.rank, self.shape[1])


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


def _local_mesh(shape: tuple[int, int], device) -> Mesh:
    """The ``shape`` mesh over this process's first ``R * C`` local
    devices of ``device``'s type."""
    rows, cols = shape
    local = platform.local_devices(device)
    if rows * cols > len(local):
        raise ConfigError(needed_devices_message(
            shape, len(local), platform.parse_device(device).type))
    devices = tuple(_rank_device(str(name)) for name in local[: rows * cols])
    return Mesh(shape, 0, devices[0], "local", devices=devices)


def make_mesh(shape: tuple[int, int] | None = None, device="cuda") -> Mesh:
    """The mesh of this process (collective in a world of several ranks:
    every rank calls it alike).

    ``shape`` defaults to ``(1, n)``, as JAX's does: ``n`` is the world's
    size, or in a world of one rank the local devices of ``device``'s
    type; the column axis is the one that divides the work at any N. In a
    world of one rank a mesh of more than one cell is a local mesh.
    """
    size, rank = world()
    if shape is None:
        shape = (1, size if size > 1 else len(platform.local_devices(device)))
    rows, cols = (int(x) for x in shape)
    if size == 1 and rows >= 1 and cols >= 1 and rows * cols > 1:
        return _local_mesh((rows, cols), device)
    if rows < 1 or cols < 1 or rows * cols != size:
        raise ConfigError(needed_ranks_message((rows, cols), size))
    device = _rank_device(device)
    key = ((rows, cols), str(device))
    if key in _MESHES:
        return _MESHES[key]
    if not dist.is_initialized():
        mesh = Mesh((1, 1), 0, device, None, devices=(device,))
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
        mesh = Mesh((rows, cols), rank, device, backend, groups["rows"], groups["cols"],
                    devices=(device,))
    _MESHES[key] = mesh
    return mesh
