"""On-demand build of the native host library.

Compiles phylonium_native.cpp into a shared library in ``_build/`` beside
the sources (cached by mtime).  No external build system needed; plain
``$CXX`` (default g++) with OpenMP.  Equivalent role to the reference's
autotools + per-ISA kernel libs (configure.ac, libs/Makefile.am) — here a
single -O3 -march=native translation unit.

A copy of the JAX package's ``phylonium_tpu/native/build.py``: the port carries
its own host layer and imports nothing of that package.  One change: the
library is compiled into a temporary file in ``_build/`` and renamed into
place, so that processes building at once (test workers) never load a
half-written library.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).parent / "src"
BUILD_DIR = Path(__file__).parent / "_build"
LIB_NAME = "libphylonium_native.so"


class NativeBuildError(RuntimeError):
    pass


def lib_path() -> Path:
    return BUILD_DIR / LIB_NAME


def needs_rebuild() -> bool:
    lib = lib_path()
    if not lib.exists():
        return True
    lib_mtime = lib.stat().st_mtime
    return any(
        src.stat().st_mtime > lib_mtime for src in SRC_DIR.glob("*.cpp")
    )


def build(verbose: bool = False) -> Path:
    BUILD_DIR.mkdir(exist_ok=True)
    sources = sorted(SRC_DIR.glob("*.cpp"))
    if not sources:
        raise NativeBuildError("no native sources found")

    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".lib", suffix=".so")
    os.close(fd)
    cxx = os.environ.get("CXX", "g++")
    cmd = [
        cxx,
        "-O3",
        "-march=native",
        "-std=c++17",
        "-fPIC",
        "-shared",
        "-fopenmp",
        "-Wall",
        "-o",
        tmp,
        *map(str, sources),
    ]
    try:
        try:
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=300
            )
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(f"compiler invocation failed: {e}") from e
        if proc.returncode != 0:
            raise NativeBuildError(
                f"native build failed:\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, lib_path())
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    if verbose:
        print(f"built {lib_path()}")
    return lib_path()


def ensure_built() -> Path:
    if os.environ.get("PHYLONIUM_TPU_NATIVE", "1") == "0":
        raise NativeBuildError("native backend disabled by env")
    if needs_rebuild():
        build()
    return lib_path()
