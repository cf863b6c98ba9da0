"""The port's ``simf`` (phylonium_tpu_torch/utils/simulate.py).

- ``simulate`` gives the JAX package's sequences byte for byte for the
  same seed, distances, lengths and ``raw`` flag;
- the port's CLI on ``--device cpu`` recovers the simulated distances, as
  tests/test_simulate.py checks the JAX pipeline;
- the command line writes the same FASTA files and stdout as the JAX
  package's.
"""

import contextlib
import io
import subprocess
import sys

import pytest

from phylonium_tpu.utils.simulate import simulate as jax_simulate
from phylonium_tpu_torch.utils.simulate import simulate


@pytest.mark.parametrize("distances,length,seed,raw", [
    ([0.1], 1000, 5, False),
    ([0.05, 0.15, 0.3], 20_000, 3, False),
    ([0.0, 0.5], 777, 11, True),
    ([0.01] * 4, 1, 0, False),
])
def test_simulate_equals_the_jax_simulate(distances, length, seed, raw):
    ours = simulate(distances, length, seed, raw)
    theirs = jax_simulate(distances, length, seed, raw)
    assert len(ours) == len(distances) + 1
    assert ours == theirs


def test_port_cli_recovers_simulated_distances(tmp_path):
    from phylonium_tpu_torch.cli import main
    from phylonium_tpu_torch.utils.simulate import write_fasta_file

    distances = [0.05, 0.15]
    files = []
    for k, seq in enumerate(simulate(distances, length=60_000, seed=3)):
        path = str(tmp_path / f"S{k}.fasta")
        write_fasta_file(path, f"S{k}", seq)
        files.append(path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--progress=never", "--device", "cpu", "-r", files[0], *files])
    assert rc == 0
    rows = [line.split() for line in out.getvalue().splitlines()[1:]]
    jc = {row[0]: [float(x) for x in row[1:]] for row in rows}
    for k, d in enumerate(distances):
        got = jc["S0"][k + 1]
        assert abs(got - d) / d < 0.08, (d, got)


def test_simulate_command_line_equals_the_jax_one(tmp_path):
    args = ["-s", "5", "-l", "500", "-d", "0.1", "-d", "0.2", "-L", "60"]
    runs = {}
    for package in ("phylonium_tpu", "phylonium_tpu_torch"):
        prefix = str(tmp_path / f"{package}_x")
        files = subprocess.run(
            [sys.executable, "-m", f"{package}.utils.simulate", *args, "-p", prefix],
            capture_output=True, text=True, check=True,
        )
        stdout = subprocess.run(
            [sys.executable, "-m", f"{package}.utils.simulate", "-r", *args],
            capture_output=True, text=True, check=True,
        ).stdout
        texts = [open(f"{prefix}{k}.fasta").read() for k in range(3)]
        runs[package] = (files.stdout, texts, stdout)
    assert runs["phylonium_tpu"] == runs["phylonium_tpu_torch"]
    assert runs["phylonium_tpu_torch"][1][0].startswith(">S0\n")
