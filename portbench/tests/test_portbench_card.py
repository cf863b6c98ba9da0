"""The harness on the card: one short run of each cell of
``BENCHMARK.json``, correct, with the card named. Skips without a card.

    python -m pytest portbench/tests/test_portbench_card.py
"""

import json
import os

import pytest

import run as harness


def _cells() -> list[str]:
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _cells())
def test_each_cell_runs_correct_on_the_card(cell, capsys):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    rc = harness.main(["--workload", cell, "--seed", "3000000999", "--seconds", "5",
                       "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is True, err[-3000:]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
