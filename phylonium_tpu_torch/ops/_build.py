"""Build the CUDA kernels at first use and bind them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` to an object, one process per
source, all started together, and links the objects into one shared
library with a plain C interface, in ``phylonium_tpu_torch/_build/`` (not
committed). The file name carries a hash of the sources and flags, so an
edited kernel is rebuilt and an unchanged one is loaded as it is. A build
or load that fails raises :class:`KernelBuildError` with the compiler's
output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# the last build: library path, seconds spent (0 when loaded as built
# before) and the compiler's report of registers and shared memory
BUILD_INFO: dict = {}

_lib = None
_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing, refused the sources, or the library did not load."""


def _nvcc() -> str:
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError(
        "nvcc not found (set NVCC, put it on PATH, or install the CUDA "
        "toolkit under /usr/local/cuda); the CUDA kernels cannot be built"
    )


def _digest(sources: list[Path]) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()[:16]


def _library_path(sources: list[Path]) -> Path:
    return BUILD_DIR / f"libpt_kernels_{_digest(sources)}.so"


def library_digest() -> str:
    """The hash that names the kernel library of this tree's sources and
    flags; computed from the files, without nvcc or a device."""
    return _digest(sorted(CSRC_DIR.glob("*.cu")))


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stderr[-8000:]}"
        )
    return proc.stderr


def _compile(sources: list[Path], target: Path) -> str:
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    # build beside the target and rename: a concurrent process either
    # sees no library or a whole one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [os.path.join(tmp, f"{src.stem}.o") for src in sources]
        with ThreadPoolExecutor(max_workers=len(sources)) as pool:
            logs = list(pool.map(
                _run,
                [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
                 for src, obj in zip(sources, objects)],
            ))
        library = os.path.join(tmp, target.name)
        _run([nvcc, "-shared", "-o", library, *objects])
        os.replace(library, target)
    return "".join(logs)


def _bind(lib: ctypes.CDLL) -> None:
    # every pointer and the stream as c_void_p: ctypes would otherwise
    # pass a Python int as a 32-bit C int and cut the address
    lib.pt_cross_counts.restype = ctypes.c_int
    lib.pt_cross_counts.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.pt_set_partner_mask.restype = ctypes.c_int
    lib.pt_set_partner_mask.argtypes = [ctypes.c_void_p]
    lib.pt_diagonal_neq.restype = ctypes.c_int
    lib.pt_diagonal_neq.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.pt_diagonal_neq_shard.restype = ctypes.c_int
    lib.pt_diagonal_neq_shard.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.pt_pileup_build.restype = ctypes.c_int
    lib.pt_pileup_build.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p,
    ]


def load() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/`` on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(CSRC_DIR.glob("*.cu"))
        if not sources:
            raise KernelBuildError(f"no CUDA sources under {CSRC_DIR}")
        target = _library_path(sources)
        t0 = time.perf_counter()
        log = ""
        if not target.exists():
            log = _compile(sources, target)
        try:
            lib = ctypes.CDLL(str(target))
        except OSError as e:
            raise KernelBuildError(f"cannot load {target}: {e}") from e
        _bind(lib)
        BUILD_INFO.update(
            path=str(target),
            seconds=time.perf_counter() - t0,
            ptxas=log,
        )
        _lib = lib
        return lib
