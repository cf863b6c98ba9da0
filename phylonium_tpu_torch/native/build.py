"""On-demand build of the native host library.

Compiles phylonium_native.cpp into a shared library in ``_build/`` beside
the sources.  No external build system needed; a C++ compiler with OpenMP
and a single -O3 -march=native translation unit.  Equivalent role to the
reference's autotools + per-ISA kernel libs (configure.ac,
libs/Makefile.am).

Adapted from the JAX package's ``phylonium_tpu/native/build.py``: the port
carries its own host layer and imports nothing of that package.  What
differs:

- the compiler is ``$CXX`` if it builds OpenMP code, else ``g++``: a
  machine may export a CXX whose toolchain lacks OpenMP (no libgomp.spec),
  and the library needs it.  A small OpenMP program, compiled and run,
  decides; with neither compiler able, the build raises naming both;
- the library's file name carries a hash of the sources, the flags, the
  compiler's path and ``--version`` and the host CPU's flags (it is built
  with ``-march=native``), so a ``_build/`` carried to another machine or
  compiler builds anew instead of loading a library made for another CPU;
- the library is compiled into a temporary file in ``_build/`` and renamed
  into place, so that processes building at once (test workers) never
  load a half-written library.
"""

from __future__ import annotations

import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).parent / "src"
BUILD_DIR = Path(__file__).parent / "_build"
LIB_STEM = "libphylonium_native"

FLAGS = (
    "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared", "-fopenmp",
    "-Wall",
)

_OMP_PROBE = "#include <omp.h>\nint main() { return omp_get_max_threads() < 1; }\n"

# the library in use: its path, the compiler that built it, and whether
# this process built it (False: loaded as built before)
BUILD_INFO: dict = {}


class NativeBuildError(RuntimeError):
    pass


def candidates() -> list[str]:
    """The compilers to try, in order: ``$CXX``, then ``g++``."""
    return list(dict.fromkeys(filter(None, (os.environ.get("CXX"), "g++"))))


def compiler_version(cxx: str) -> str | None:
    """``cxx --version``, or None when the compiler does not run."""
    try:
        proc = subprocess.run(
            [cxx, "--version"], capture_output=True, text=True, timeout=60
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout if proc.returncode == 0 else None


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.machine()


def lib_path(cxx: str, version: str) -> Path:
    """Where the library built by ``cxx`` (reporting ``version``) lives."""
    digest = hashlib.sha256()
    for part in (" ".join(FLAGS), shutil.which(cxx) or cxx, version, _cpu_flags()):
        digest.update(part.encode() + b"\0")
    for src in sorted(SRC_DIR.iterdir()):
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"{LIB_STEM}_{digest.hexdigest()[:16]}.so"


def _builds_openmp(cxx: str) -> str | None:
    """None if ``cxx`` compiles and runs an OpenMP program, else why not."""
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "omp.cpp")
        with open(src, "w") as f:
            f.write(_OMP_PROBE)
        exe = os.path.join(tmp, "omp")
        try:
            proc = subprocess.run(
                [cxx, "-fopenmp", src, "-o", exe],
                capture_output=True, text=True, timeout=120,
            )
            if proc.returncode == 0:
                proc = subprocess.run(
                    [exe], capture_output=True, text=True, timeout=60
                )
        except (OSError, subprocess.TimeoutExpired) as e:
            return str(e)
    if proc.returncode == 0:
        return None
    return proc.stderr.strip()[-300:] or f"exit code {proc.returncode}"


def build(cxx: str, target: Path) -> Path:
    """Compile the sources with ``cxx`` into ``target``."""
    BUILD_DIR.mkdir(exist_ok=True)
    sources = sorted(SRC_DIR.glob("*.cpp"))
    if not sources:
        raise NativeBuildError("no native sources found")

    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".lib", suffix=".so")
    os.close(fd)
    cmd = [cxx, *FLAGS, "-o", tmp, *map(str, sources)]
    try:
        try:
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=300
            )
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(f"compiler invocation failed: {e}") from e
        if proc.returncode != 0:
            raise NativeBuildError(
                f"native build with {cxx} failed:\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def ensure_built() -> Path:
    """The library's path, built first if no candidate compiler has built
    it for these sources, flags and this CPU.

    A library that either candidate built is used as it is; otherwise the
    first candidate that builds OpenMP code builds it.
    """
    if os.environ.get("PHYLONIUM_TPU_NATIVE", "1") == "0":
        raise NativeBuildError("native backend disabled by env")
    found = []
    tried = []
    for cxx in candidates():
        version = compiler_version(cxx)
        if version is None:
            tried.append(f"{cxx}: does not run")
            continue
        path = lib_path(cxx, version)
        if path.exists():
            BUILD_INFO.update(path=str(path), compiler=cxx, built=False)
            return path
        found.append((cxx, path))
    for cxx, path in found:
        why = _builds_openmp(cxx)
        if why is not None:
            tried.append(f"{cxx}: cannot build OpenMP code: {why}")
            continue
        build(cxx, path)
        BUILD_INFO.update(path=str(path), compiler=cxx, built=True)
        return path
    raise NativeBuildError(
        "no C++ compiler builds the native library (tried $CXX, then "
        "g++):\n" + "\n".join(tried)
    )
