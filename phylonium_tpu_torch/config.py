"""Run configuration of the port: the JAX package's, plus a device.

The flags, their defaults and their soft-error semantics are the JAX
package's ``RunConfig`` (phylonium_tpu/config.py); the port adds the torch
device it counts on and computes hybrid mapping's bitmaps on.
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass

from phylonium_tpu.config import ConfigError, RunConfig

__all__ = ["PROG", "ConfigError", "TorchRunConfig"]

PROG = "phylonium-tpu-torch"


@dataclass
class TorchRunConfig(RunConfig):
    # torch device of the pair count and the hybrid bitmaps: 'cuda' | 'cpu'
    device: str = "cuda"

    @classmethod
    def from_run_config(cls, cfg: RunConfig, **changes) -> "TorchRunConfig":
        fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
        return cls(**fields, **changes)

    def soft_error(self, msg: str) -> None:
        self.return_code |= 1
        print(f"{PROG}: {msg}", file=sys.stderr)

    def warn(self, msg: str) -> None:
        print(f"{PROG}: {msg}", file=sys.stderr)
