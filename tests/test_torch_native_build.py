"""The port's native host-library build: the compiler pick and the cache key.

A machine may export a CXX that cannot build OpenMP code; the build then
takes g++, and with neither it names both. The library's file name is a
hash of the sources, flags, compiler and CPU, so a build directory
carried to another machine builds anew. The cases build a one-function
stand-in source in a temporary directory, not the real library.
"""

import ctypes
import os
import stat

import pytest

from phylonium_tpu_torch.native import build


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """A one-function source and an empty build directory."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "tiny.cpp").write_text(
        '#include <omp.h>\nextern "C" int tiny_threads() '
        "{ return omp_get_max_threads(); }\n"
    )
    monkeypatch.setattr(build, "SRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "BUILD_INFO", {})
    monkeypatch.delenv("PHYLONIUM_TPU_NATIVE", raising=False)
    return tmp_path


def _stub(path):
    """A compiler stand-in that reports a version and fails every
    compile, as a toolchain without libgomp fails one with -fopenmp."""
    path.write_text(
        "#!/bin/sh\n"
        'if [ "$1" = "--version" ]; then echo "stub-cxx 0.1"; exit 0; fi\n'
        "echo 'libgomp.spec: No such file' >&2\n"
        "exit 1\n"
    )
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def _loads(path):
    return ctypes.CDLL(str(path)).tiny_threads() >= 1


def test_cxx_without_openmp_builds_with_gxx(tiny, monkeypatch):
    monkeypatch.setenv("CXX", _stub(tiny / "cxx-no-omp"))
    path = build.ensure_built()
    assert build.BUILD_INFO == {"path": str(path), "compiler": "g++", "built": True}
    assert path.parent == tiny / "_build" and _loads(path)
    # a second call loads what the first built
    assert build.ensure_built() == path
    assert build.BUILD_INFO["built"] is False


def test_missing_cxx_builds_with_gxx(tiny, monkeypatch):
    monkeypatch.setenv("CXX", str(tiny / "no-such-compiler"))
    path = build.ensure_built()
    assert build.BUILD_INFO["compiler"] == "g++" and _loads(path)


def test_no_openmp_compiler_names_both(tiny, monkeypatch):
    bin_dir = tiny / "bin"
    bin_dir.mkdir()
    _stub(bin_dir / "g++")
    cxx = _stub(tiny / "cxx-no-omp")
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setenv("PATH", str(bin_dir))
    with pytest.raises(build.NativeBuildError) as err:
        build.ensure_built()
    message = str(err.value)
    assert f"{cxx}: cannot build OpenMP code" in message
    assert "g++: cannot build OpenMP code" in message
    assert "libgomp.spec" in message
    assert not list((tiny / "_build").glob("*.so"))


def test_library_path_keys_on_flags_compiler_and_sources(tiny, monkeypatch):
    version = build.compiler_version("g++")
    assert version
    path = build.lib_path("g++", version)
    assert path == build.lib_path("g++", version)
    assert path.name.startswith(build.LIB_STEM + "_")
    assert build.lib_path("g++", version + " (patched)") != path
    for name, value in (("FLAGS", build.FLAGS + ("-DSOMETHING",)),
                        ("_cpu_flags", lambda: "another cpu")):
        saved = getattr(build, name)
        monkeypatch.setattr(build, name, value)
        assert build.lib_path("g++", version) != path
        monkeypatch.setattr(build, name, saved)
    assert build.lib_path("g++", version) == path
    (tiny / "src" / "tiny.cpp").write_text("// edited\n")
    assert build.lib_path("g++", version) != path


def test_a_build_dir_from_another_machine_builds_anew(tiny, monkeypatch):
    """A library carried over under another CPU's key is not loaded: this
    machine's key names another file, which is built."""
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(build, "_cpu_flags", lambda: "the other machine")
    carried = build.ensure_built()
    monkeypatch.setattr(build, "_cpu_flags", lambda: "this machine")
    path = build.ensure_built()
    assert path != carried and build.BUILD_INFO["built"] is True
    assert sorted((tiny / "_build").glob("*.so")) == sorted([carried, path])


def test_disabled_by_env(tiny, monkeypatch):
    monkeypatch.setenv("PHYLONIUM_TPU_NATIVE", "0")
    with pytest.raises(build.NativeBuildError, match="disabled"):
        build.ensure_built()


def test_port_library_lives_in_the_port():
    from phylonium_tpu_torch import native

    path = native.get_lib()._name
    assert os.path.dirname(path) == str(build.BUILD_DIR)
    assert os.path.basename(path).startswith(build.LIB_STEM + "_")
