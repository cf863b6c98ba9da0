"""Run configuration of the port: the JAX package's, plus a device.

``RunConfig`` and ``ConfigError`` are a copy of the JAX package's
``phylonium_tpu/config.py`` (flags, defaults, soft-error semantics); the
port carries its own host layer and imports nothing of that package. Its
messages name the port's program. ``TorchRunConfig`` adds the torch device
the port counts on, builds pileup rows on and computes hybrid mapping's
bitmaps on. The copy leaves out the early query shipper's handle and
``auto_device_min_gbp`` (``PHYLONIUM_TPU_AUTO_DEVICE_GBP``), the JAX
package's threshold for sending 'auto' counting to its device: the port
has no shipper, and its 'auto' always counts on ``--device``.

The reference uses a global FLAGS bitfield plus assorted globals
(`src/global.h:7-23`); here the same knobs live in one dataclass that is
threaded through the pipeline.  ``soft_error`` mirrors the ``soft_errx``
macro (`src/global.h:29-43`): warn on stderr and force a failing exit
code at the end.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

__all__ = ["PROG", "ConfigError", "RunConfig", "TorchRunConfig"]

PROG = "phylonium-tpu-torch"


class ConfigError(ValueError):
    """A user-facing configuration/limit error from the pipeline.

    The CLI catches exactly this (a clean one-line exit, like the
    reference's errx paths) — any other exception is a defect and
    keeps its traceback.
    """


@dataclass
class RunConfig:
    distance: str = "jc"  # 'jc' | 'raw' | 'ani' (estimator choice)
    # The reference accumulates --distance choices as STICKY flag bits
    # (src/phylonium.cxx:147-158, src/global.h:14-15): the estimator
    # takes raw > ani > jc precedence, while the FORMATTER keys on the
    # ani bit alone (src/io.cxx:149) — so '--distance=ani
    # --distance=raw' prints raw values in defaultfloat.  The CLI sets
    # these bits and derives `distance`; library callers may keep
    # setting `distance` directly.
    dist_raw: bool = False
    dist_ani: bool = False
    bootstrap: int = 0  # number of *extra* matrices printed
    complete_deletion: bool = False
    print_positions: bool = False
    refpos_file_name: str = ""
    verbose: int = 0  # 0 / 1 / 2 (-v -v)
    progress: str = "auto"  # 'auto' | 'always' | 'never'
    threads: int = 0  # 0 = all
    two_pass: bool = False
    reference_name: str = ""
    anchor_p_value: float = 0.025
    esa_backend: str | None = None  # None/'auto' | 'native' | 'numpy'
    # 'auto' | 'pallas' | 'device' | 'host' | 'numpy'
    count_backend: str = "auto"
    map_backend: str = "auto"  # 'auto' | 'native' | 'python' | 'hybrid'
    mesh: str = ""  # 'R,C' device mesh for counting ('' = all devices)
    checkpoint_dir: str = ""  # reuse/persist mapping results here
    profile_dir: str = ""  # write a torch.profiler trace here
    return_code: int = 0
    _progress_enabled: bool | None = field(default=None, repr=False)

    def soft_error(self, msg: str) -> None:
        self.return_code |= 1
        print(f"{PROG}: {msg}", file=sys.stderr)

    def warn(self, msg: str) -> None:
        print(f"{PROG}: {msg}", file=sys.stderr)

    @property
    def progress_enabled(self) -> bool:
        if self._progress_enabled is None:
            if self.progress == "always":
                self._progress_enabled = True
            elif self.progress == "never":
                self._progress_enabled = False
            else:
                self._progress_enabled = sys.stderr.isatty()
        return self._progress_enabled


@dataclass
class TorchRunConfig(RunConfig):
    # torch device of the pair count, the pileup build and the hybrid
    # bitmaps: 'cuda' | 'cpu'
    device: str = "cuda"
