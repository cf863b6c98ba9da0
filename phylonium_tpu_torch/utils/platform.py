"""Which torch device a run counts on, and what that device is.

The port names its device explicitly. Asking for ``cuda`` where torch
finds no CUDA device is an error; the port never moves a run to the CPU
on its own.
"""

from __future__ import annotations

import shutil
import subprocess

import torch

from phylonium_tpu_torch.config import ConfigError


def check_device(name: str) -> torch.device:
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` -> that torch device, checked
    without creating a CUDA context (a run whose device work goes to the
    device server checks its device this way); the index stays as given."""
    try:
        device = torch.device(name)
    except (RuntimeError, ValueError) as e:
        raise ConfigError(f"unknown device '{name}': {e}") from e
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ConfigError(
            f"device '{name}' is not supported; use 'cuda' or 'cpu'"
        )
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
    return device


def resolve_device(name: str) -> torch.device:
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` -> a usable torch device; a
    bare ``cuda`` becomes this thread's current device (which initializes
    CUDA)."""
    device = check_device(name)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def carrier(device: torch.device) -> str:
    """How a run reports work done on ``device``: 'cuda-kernel' (the
    port's kernels) or 'torch-cpu' (their plain versions)."""
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


def describe_device(device: torch.device | None = None) -> dict:
    """Name, compute capability, torch/CUDA versions and power limit."""
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
