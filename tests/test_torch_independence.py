"""The port is a package of its own: it imports neither jax nor phylonium_tpu.

- every ``.py`` under ``phylonium_tpu_torch/``, ``chip_smoke.py``, the
  card tools it shares code with (``tools/compare_pair_count.py``,
  ``tools/compare_kernels.py``) and the test inputs it imports
  (``tests/pileup_cases.py``, ``tests/extend_cases.py``), parsed with
  ``ast``: no import of ``jax*`` or of ``phylonium_tpu`` /
  ``phylonium_tpu.*``, at top level or inside a function (a string such as
  the reference CLI's ``-m phylonium_tpu`` argument is not an import);
- a ``--device cpu`` run of the port's CLI, in a fresh process that first
  imports the port's entry modules, leaves neither in ``sys.modules``.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "phylonium_tpu_torch")

SOURCES = sorted(
    os.path.relpath(os.path.join(root, name), REPO)
    for root, _, names in os.walk(PORT)
    for name in names
    if name.endswith(".py")
) + [
    "chip_smoke.py",
    "tools/compare_pair_count.py",
    "tools/compare_kernels.py",
    "tests/pileup_cases.py",
    "tests/extend_cases.py",
]


def _foreign(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "phylonium_tpu")


def _imports(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_neither_jax_nor_the_jax_package(path):
    with open(os.path.join(REPO, path), encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [f"{path}:{line} imports {name}" for line, name in _imports(tree)
           if _foreign(name)]
    assert not bad, "\n".join(bad)


def test_the_scan_sees_the_whole_port():
    assert "phylonium_tpu_torch/native/__init__.py" in SOURCES
    assert "phylonium_tpu_torch/cli.py" in SOURCES
    assert len(SOURCES) > 40


_PROBE = """
import json, os, sys
import phylonium_tpu_torch
import phylonium_tpu_torch.cli
import phylonium_tpu_torch.api
import phylonium_tpu_torch.core.pipeline
import phylonium_tpu_torch.core.stream
import phylonium_tpu_torch.core.lowmem
import phylonium_tpu_torch.core.hybrid_map
rc = phylonium_tpu_torch.cli.main(sys.argv[1:])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "phylonium_tpu"))
print(json.dumps({"rc": rc, "loaded": loaded}), file=sys.stderr)
"""


def test_a_cpu_run_loads_neither(tmp_path):
    import numpy as np

    rng = np.random.default_rng(17)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    base = acgt[rng.integers(0, 4, 4000)]
    files = []
    for k in range(4):
        arr = base.copy()
        hit = rng.random(arr.size) < 0.02 * k
        arr[hit] = acgt[(np.searchsorted(acgt, arr[hit]) + 1) % 4]
        path = tmp_path / f"g{k}.fasta"
        path.write_bytes(b">g%d\n" % k + arr.tobytes() + b"\n")
        files.append(str(path))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-c", _PROBE, "--device", "cpu", "--progress=never", *files],
        capture_output=True, cwd=tmp_path, env=env, timeout=300,
    )
    report = json.loads(r.stderr.decode().strip().splitlines()[-1])
    assert report["rc"] == 0, r.stderr.decode()[-2000:]
    assert r.stdout.decode().splitlines()[0].strip() == "4"
    assert report["loaded"] == []
