"""The port's CLI in torch.distributed worlds of CPU ranks (gloo).

- ``--mesh 2,2`` in 4 ranks, and no ``--mesh`` in 2 ranks ('auto' counting
  on the pod mesh): rank 0's stdout is byte for byte the JAX CLI's with
  ``--count-backend numpy``, with no line filtered; the other ranks print
  nothing; each rank's stderr says which share of the queries it mapped;
  the count ran on the mesh.
- ``--mesh 2,2`` in one process exits 1 and names the ranks it needs;
  ``distance_matrix(mesh="2,2")`` raises the same ConfigError, and
  ``mesh="1,1"`` takes the one-device path.
"""

import contextlib
import io
import json

import numpy as np
import pytest

from torch_world import spawn_world

ACGT = np.frombuffer(b"ACGT", np.uint8)
N_GENOMES = 4

_CLI = """
import json
from phylonium_tpu_torch.cli import main
from phylonium_tpu_torch.core.pipeline import LAST_RUN_INFO
rc = main(ARGS)
print(json.dumps({"rc": rc, "info": LAST_RUN_INFO}), file=sys.stderr)
"""


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_multiprocess")
    rng = np.random.default_rng(7)
    base = ACGT[rng.integers(0, 4, 12_000)]
    paths = []
    for k, p in enumerate([0.0, 0.01, 0.04, 0.07][:N_GENOMES]):
        arr = base.copy()
        idx = np.flatnonzero(rng.random(arr.size) < p)
        arr[idx] = ACGT[(np.searchsorted(ACGT, arr[idx]) + rng.integers(1, 4, idx.size)) % 4]
        path = tmp / f"g{k}.fasta"
        path.write_bytes(b">g%d\n" % k + arr.tobytes() + b"\n")
        paths.append(str(path))
    return paths, tmp


@pytest.fixture(scope="module")
def expected(files):
    from phylonium_tpu.cli import main

    paths, _ = files
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["--progress=never", "--count-backend", "numpy", *paths]) == 0
    return buf.getvalue()


def _world(files, size, flags):
    paths, tmp = files
    args = ["--progress=never", "--device", "cpu", "-v", "-v", *flags, *paths]
    outs = spawn_world(_CLI, size, tmp, args=args)
    runs = []
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} exited {rc}:\n{err[-3000:]}"
        report = json.loads(err.strip().splitlines()[-1])
        runs.append({"rc": report["rc"], "info": report["info"], "out": out, "err": err})
    return runs


@pytest.fixture(scope="module")
def mesh_2x2(files):
    return _world(files, 4, ["--mesh", "2,2"])


@pytest.fixture(scope="module")
def pod_2(files):
    return _world(files, 2, [])


@pytest.fixture(params=["mesh_2x2", "pod_2"])
def runs(request):
    return request.param, request.getfixturevalue(request.param)


def test_rank0_prints_the_jax_matrix(runs, expected):
    name, ranks = runs
    assert ranks[0]["rc"] == 0
    assert ranks[0]["out"] == expected, f"{name}: rank 0's stdout differs"


def test_other_ranks_print_nothing(runs):
    name, ranks = runs
    for rank, r in enumerate(ranks[1:], 1):
        assert r["rc"] == 0 and r["out"] == "", f"{name}: rank {rank} printed"


def test_each_rank_maps_its_share(runs):
    name, ranks = runs
    size = len(ranks)
    for rank, r in enumerate(ranks):
        share = len(range(rank, N_GENOMES, size))
        line = (f"mapping sharded: process {rank}/{size} mapped {share} of "
                f"{N_GENOMES} queries locally")
        assert line in r["err"], f"{name}: rank {rank}:\n{r['err'][-2000:]}"


def test_the_count_ran_on_the_mesh(runs):
    name, ranks = runs
    shape = [2, 2] if name == "mesh_2x2" else [1, 2]
    for rank, r in enumerate(ranks):
        info = r["info"]
        assert info["compare_carrier"] == "mesh"
        mesh = info["mesh"]
        assert mesh["shape"] == shape and mesh["rank"] == rank
        assert mesh["backend"] == "gloo" and mesh["shard_carrier"] == "torch-cpu"
        comm = mesh["comm"]
        for key in ("gather_recv_bytes", "psum_bytes", "result_gather_recv_bytes"):
            assert comm[f"measured_{key}"] == comm[f"predicted_{key}"]
        # the shard step went through the wrapper's plain route
        assert info["plain_calls"] >= 1 and info["kernel_launches"] == 0


def test_mesh_in_one_process_is_a_config_error(files, capsys):
    from phylonium_tpu_torch.cli import main

    paths, _ = files
    assert main(["--progress=never", "--device", "cpu", "--mesh", "2,2", *paths]) == 1
    err = capsys.readouterr().err
    assert "--mesh 2,2 needs 4 ranks" in err
    assert "torchrun --nproc-per-node 4" in err


def test_api_mesh_in_one_process_is_a_config_error(files):
    from phylonium_tpu_torch.api import distance_matrix
    from phylonium_tpu_torch.config import ConfigError

    paths, _ = files
    with pytest.raises(ConfigError, match="needs 4 ranks"):
        distance_matrix(paths, device="cpu", mesh="2,2")
    # a 1 x 1 mesh is the one-device path
    result = distance_matrix(paths, device="cpu", mesh="1,1")
    assert result.distances.shape == (N_GENOMES, N_GENOMES)
