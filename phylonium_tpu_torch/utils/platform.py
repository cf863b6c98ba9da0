"""Which torch device a run counts on, and what that device is.

The port names its device explicitly. Asking for ``cuda`` where there is
no CUDA device is an error; the port never moves a run to the CPU on its
own.

The check comes in two steps, as the JAX package's ``utils/platform.py``
decides from its pin without importing jax:

- ``check_device``, before any work, parses the name itself and asks the
  CUDA driver for its card count (``cuda_device_count``, through
  ``ctypes``: ``cuInit`` and ``cuDeviceGetCount`` make no context). It
  imports no torch, so a run that then counts on the host, or sends its
  device work to the device server, never loads torch;
- ``resolve_device``, at the first device step, imports torch and keeps
  torch's own check: a CPU-only torch beside a card still fails there.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from typing import NamedTuple

from phylonium_tpu_torch.config import ConfigError

_NAME = re.compile(r"([a-z_]+)(?::(\d+))?")


class DeviceName(NamedTuple):
    """A checked device name: ``type`` and ``index`` as on a torch.device,
    and the same ``str``, without torch."""

    type: str
    index: int | None = None

    def __str__(self) -> str:
        return self.type if self.index is None else f"{self.type}:{self.index}"


def parse_device(name) -> DeviceName:
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` (or a torch.device) -> its
    DeviceName; ConfigError for any other name."""
    text = str(name)
    match = _NAME.fullmatch(text)
    if match is None:
        raise ConfigError(
            f"unknown device '{text}': expected 'cuda', 'cuda:N' or 'cpu'"
        )
    kind, index = match.group(1), match.group(2)
    if kind not in ("cuda", "cpu"):
        raise ConfigError(
            f"device '{text}' is not supported; use 'cuda' or 'cpu'"
        )
    return DeviceName(kind, None if index is None else int(index))


def device_type(name) -> str | None:
    """The type of a device name ('cuda' or 'cpu'), None where it does not
    parse (``check_device`` names that fault where a run needs it)."""
    try:
        return parse_device(name).type
    except ConfigError:
        return None


def loaded(name: str = "torch"):
    """The module ``name`` where this process has imported it, else None.
    A module that another thread is still importing (the prewarm's torch)
    counts as not loaded: importlib marks its ``__spec__``
    ``_initializing`` until the import ends."""
    module = sys.modules.get(name)
    if module is None or getattr(module.__spec__, "_initializing", False):
        return None
    return module


def cuda_device_count() -> int:
    """The cards the CUDA driver finds (it honours ``CUDA_VISIBLE_DEVICES``),
    asked through ``libcuda.so.1`` with ``cuInit(0)`` and
    ``cuDeviceGetCount``, which make no context; 0 without a driver."""
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return 0
    count = ctypes.c_int(0)
    if lib.cuInit(0) != 0 or lib.cuDeviceGetCount(ctypes.byref(count)) != 0:
        return 0
    return count.value


def local_devices(name) -> list[DeviceName]:
    """The devices a process of one rank can span, of ``name``'s type:
    every card the CUDA driver finds (``cuda_device_count``), or the one
    CPU, as the JAX package's ``jax.devices()`` holds one CPU device
    without its XLA flag. The one source of the local counting mesh's
    cells (parallel/mesh.py) and of X5's shards
    (``ops.anchor_extend_sharded.shard_devices``); tests patch it to put
    several cells on one device. Imports no torch and makes no context."""
    if parse_device(name).type == "cuda":
        return [DeviceName("cuda", i) for i in range(cuda_device_count())]
    return [DeviceName("cpu")]


def check_device(name) -> DeviceName:
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` -> that device, checked
    against the CUDA driver's card count without torch and without a
    CUDA context; the index stays as given."""
    device = parse_device(name)
    if device.type == "cpu":
        return device
    count = cuda_device_count()
    if count == 0:
        raise ConfigError(
            f"device '{name}' was asked for, but the CUDA driver finds no "
            "CUDA device (libcuda.so.1 missing, or no card visible); pass "
            "--device cpu to count on the CPU"
        )
    if device.index is not None and device.index >= count:
        raise ConfigError(
            f"device '{name}' does not exist: the CUDA driver sees {count} "
            "CUDA device(s)"
        )
    return device


def resolve_device(name):
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` -> a usable torch.device,
    checked by torch; a bare ``cuda`` becomes this thread's current device
    (which initializes CUDA). Imports torch: a run's device steps call it,
    never a host-counted run."""
    import torch

    device = parse_device(name)
    if device.type == "cpu":
        return torch.device(str(device))
    if not torch.cuda.is_available():
        raise ConfigError(
            f"device '{name}' was asked for, but torch finds no CUDA "
            f"device (torch {torch.__version__}, CUDA "
            f"{torch.version.cuda or 'none'}); pass --device cpu to count "
            "on the CPU"
        )
    if device.index is not None and device.index >= torch.cuda.device_count():
        raise ConfigError(
            f"device '{name}' does not exist: torch sees "
            f"{torch.cuda.device_count()} CUDA device(s)"
        )
    if device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(str(device))


def carrier(device) -> str:
    """How a run reports work done on ``device`` (a torch.device or a
    DeviceName): 'cuda-kernel' (the port's kernels) or 'torch-cpu' (their
    plain versions)."""
    return "cuda-kernel" if device.type == "cuda" else "torch-cpu"


def nvidia_smi_line() -> str | None:
    """``name, power.limit`` of the cards as nvidia-smi prints them."""
    tool = shutil.which("nvidia-smi")
    if tool is None:
        return None
    proc = subprocess.run(
        [tool, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        return None
    return proc.stdout.strip()


def describe_device(device=None) -> dict:
    """Name, compute capability, torch/CUDA versions and power limit."""
    import torch

    info = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
    }
    if torch.cuda.is_available():
        index = device.index if device is not None and device.index else 0
        major, minor = torch.cuda.get_device_capability(index)
        info.update(
            name=torch.cuda.get_device_name(index),
            capability=f"{major}.{minor}",
            count=torch.cuda.device_count(),
        )
    info["nvidia_smi"] = nvidia_smi_line()
    return info
