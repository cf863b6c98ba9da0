"""The torch port's CLI and API against the committed fixtures and JAX.

- `python -m phylonium_tpu_torch --device cpu` reproduces every golden
  fixture byte for byte (set up as tests/test_golden_fixtures.py does);
- the port's distance_matrix equals the JAX package's with its Pallas
  count (interpret mode on the CPU), exactly;
- a CPU run of the port never loads jax and counts through the plain
  PyTorch version.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from golden_panel import GOLDEN_CASES, RD_SEED, write_panel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "data", "golden")
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def panel_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden_panel_torch")
    return write_panel(str(d)), str(d)


def _fixture(name: str, kind: str) -> bytes:
    with open(os.path.join(GOLDEN_DIR, f"{name}.{kind}"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_port_cli_matches_committed_fixture(name, panel_files):
    files, tmp = panel_files
    argv = GOLDEN_CASES[name]
    refpos = os.path.join(tmp, f"refpos_torch_{name}.txt")
    args = [refpos if a == "REFPOS_FILE" else a for a in argv]
    env = _env()
    if "-b" in args:
        env["PHYLONIUM_TPU_RD_SEED"] = str(RD_SEED)
    r = subprocess.run(
        [sys.executable, "-m", "phylonium_tpu_torch", "--progress=never",
         "--device", "cpu", *args, *files],
        capture_output=True, cwd=tmp, env=env, timeout=600,
    )
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert r.stdout == _fixture(name, "stdout"), (
        f"stdout diverged from committed fixture {name}"
    )
    if "REFPOS_FILE" in argv:
        with open(refpos, "rb") as f:
            assert f.read() == _fixture(name, "refpos")


def _genomes(seed=5, n=4, length=6000):
    rng = np.random.default_rng(seed)
    base = ACGT[rng.integers(0, 4, length)]
    out = []
    for k in range(n):
        arr = base.copy()
        hit = rng.random(length) < 0.01 * (k + 1)
        arr[hit] = ACGT[(rng.integers(1, 4, hit.sum()) + arr[hit]) % 4]
        out.append((f"G{k}", arr.tobytes()))
    # a draft genome: two contigs, the second reverse-complemented
    rc = out[1][1][3000:][::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))
    out.append(("draft", out[1][1][:3000] + b"!" + rc))
    return out


@pytest.mark.parametrize("two_pass", [False, True])
def test_port_api_equals_jax_pallas(two_pass):
    import phylonium_tpu.api as jax_api
    import phylonium_tpu_torch.api as torch_api

    genomes = _genomes()
    ours = torch_api.distance_matrix(genomes, device="cpu", two_pass=two_pass)
    ref = jax_api.distance_matrix(
        genomes, count_backend="pallas", two_pass=two_pass
    )
    assert ours.names == ref.names
    assert ours.reference_index == ref.reference_index
    assert np.array_equal(ours.counts.substitutions, ref.counts.substitutions)
    assert np.array_equal(ours.counts.homologs, ref.counts.homologs)
    assert np.array_equal(ours.distances, ref.distances, equal_nan=True)


_PROBE = """
import json, sys
from phylonium_tpu_torch.cli import main
rc = main(sys.argv[1:])
from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO
print(json.dumps({"rc": rc, "jax": "jax" in sys.modules,
                  "info": LAST_RUN_INFO}), file=sys.stderr)
"""


def test_port_cpu_run_is_jax_free(tmp_path):
    paths = []
    for name, seq in _genomes(n=3):
        path = tmp_path / f"{name}.fasta"
        contigs = seq.split(b"!")
        path.write_bytes(b"".join(
            b">%s_%d\n%s\n" % (name.encode(), i, c)
            for i, c in enumerate(contigs)
        ))
        paths.append(str(path))
    r = subprocess.run(
        [sys.executable, "-c", _PROBE, "--progress=never", "--device=cpu",
         "-v", "-v", *paths],
        capture_output=True, cwd=tmp_path, env=_env(), timeout=600,
    )
    err = r.stderr.decode()
    assert r.returncode == 0, err[-2000:]
    report = json.loads(err.strip().splitlines()[-1])
    assert report["rc"] == 0
    assert report["jax"] is False
    assert report["info"]["compare_carrier"] == "torch-cpu"
    assert report["info"]["plain_calls"] > 0
    assert report["info"]["kernel_launches"] == 0
    assert "torch-cpu carried" in err
    assert r.stdout.decode().splitlines()[0].strip() == str(len(paths))


def test_port_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    from phylonium_tpu_torch.cli import main
    from phylonium_tpu_torch.utils import platform

    # the CUDA driver finds no card
    monkeypatch.setattr(platform, "cuda_device_count", lambda: 0)
    files = []
    for name, seq in _genomes(n=2):
        path = tmp_path / f"{name}.fasta"
        path.write_bytes(b">%s\n%s\n" % (name.encode(), seq.split(b"!")[0]))
        files.append(str(path))
    assert main(["--progress=never", *files]) == 1
    assert main(["--progress=never", "--mesh", "2,1", "--device", "cpu",
                 *files]) == 1
