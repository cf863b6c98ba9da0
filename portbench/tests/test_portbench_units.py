"""The harness's pieces on small hand-made inputs, on the CPU: what it
imports, the panel's repeatability, the reference's counting rule, the
arithmetic of the end-to-end and per-layer metrics."""

import ast
import glob
import json
import os

import numpy as np
import pytest

import child
import panel
import reference
import traces
from run import HERE, ROOT, child_env, end_to_end, load_metric

FORBIDDEN = {"jax", "jaxlib", "flax", "phylonium_tpu"}


def imported(source: str) -> set[str]:
    """The top-level names of every module ``source`` imports."""
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_and_the_reference_no_program():
    files = glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True)
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            found = imported(f.read())
        assert not found & FORBIDDEN, (path, found & FORBIDDEN)
    for code in (child.CLI_CHILD, child.SPAWNER, child.DEVD_TRACE, child.CUDA_CHECK):
        assert not imported(code) & FORBIDDEN
    with open(os.path.join(HERE, "reference.py")) as f:
        found = imported(f.read())
    assert "phylonium_tpu_torch" not in found and not found & FORBIDDEN
    # whole names: the port's name begins with the JAX package's
    assert imported("import phylonium_tpu_torch.cli") == {"phylonium_tpu_torch"}


def test_benchmark_names_its_files():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    for m in bench["per_layer"]:
        assert callable(load_metric(m["name"]).read)


SHAPE = {"genomes": 7, "length": 20000, "divergence_low": 0.01, "divergence_span": 0.03,
         "draft_contigs": 4, "draft_inversion": 3000}


def test_panel_repeats_from_its_seed(tmp_path):
    a = panel.write_panel(SHAPE, 2**31 + 11, str(tmp_path / "a"))
    b = panel.write_panel(SHAPE, 2**31 + 11, str(tmp_path / "b"))
    c = panel.write_panel(SHAPE, 2**31 + 12, str(tmp_path / "c"))
    read = lambda files: [open(f, "rb").read() for f in files]  # noqa: E731
    assert read(a) == read(b)
    assert read(a) != read(c)
    genomes = [reference.read_genome(f) for f in a]
    assert len({len(g) for g in genomes}) == len(genomes)
    assert genomes[-1].count(b"!") == SHAPE["draft_contigs"] - 1
    # every seed the same sizes
    assert [len(g) for g in genomes] == [len(reference.read_genome(f)) for f in c]


def test_panel_turns_over_a_share_and_keeps_its_reference(tmp_path):
    shape = {**SHAPE, "genomes": 23}
    turning = panel.Panel(shape, 2**33 + 5, str(tmp_path / "p"), period=10)
    seen, ref = set(), panel.median_slot(shape)
    for r in range(12):
        files = turning.files(r)
        new = set(files) - seen
        assert len(new) == (23 if r == 0 else len([k for k in range(1, 23)
                                                    if k % 10 == r % 10 and k != ref]))
        seen |= new
        lengths = [len(reference.read_genome(f)) for f in files]
        assert lengths == panel.joined_lengths(shape)
        assert reference.pick_reference(lengths) == ref
    assert turning.written == len(seen)
    # the same seed writes the same genomes; a panel that never turns over is run 0's
    again = panel.Panel(shape, 2**33 + 5, str(tmp_path / "q"), period=10).files(3)
    assert [open(f, "rb").read() for f in again] == [open(f, "rb").read()
                                                      for f in turning.files(3)]
    still = panel.Panel(shape, 2**33 + 5, str(tmp_path / "r"))
    assert still.files(7) == still.files(0)


def test_matrices_of_panels_that_share_genomes(tmp_path):
    """Judged together, each panel gets the answer it gets alone."""
    turning = panel.Panel(SHAPE, 2**31 + 7, str(tmp_path / "p"), period=3)
    panels = [turning.files(r) for r in (1, 2)]
    together = reference.Matrices(panels, workers=2)
    for files, answer in zip(panels, together.answers):
        alone = reference.matrix(files, workers=2)
        assert answer.names == alone.names and answer.cells == alone.cells
        assert answer.control_cells == alone.control_cells
        assert answer.exit_nonzero == alone.exit_nonzero
    assert together.genomes == len(set(panels[0]) | set(panels[1]))


def test_pair_counts_follow_the_match_rule():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 10, (6, 3000)).astype(np.uint8)
    rows[rng.random(rows.shape) < 0.3] = reference.UNCOVERED
    subs, homs = reference.pair_counts(rows)
    for i in range(6):
        for j in range(6):
            if i == j:
                continue
            both = (rows[i] != reference.UNCOVERED) & (rows[j] != reference.UNCOVERED)
            match = sum(reference.match(int(a), int(b))
                        for a, b in zip(rows[i][both], rows[j][both]))
            assert homs[i, j] == both.sum()
            assert subs[i, j] == both.sum() - match
    # the same products in plain PyTorch (the card's path, here on the CPU)
    rows[0, :10] = 4  # forward separators
    rows[1, 5:15] = 9  # reverse separators
    plain = reference.pair_counts(rows)
    torch_counts = reference.pair_counts(rows, "cpu")
    assert all(np.array_equal(a, b) for a, b in zip(plain, torch_counts))


def test_estimator_and_cells():
    subs = np.array([[0, 10, 0], [10, 0, 900], [0, 900, 0]])
    homs = np.array([[0, 1000, 0], [1000, 0, 1000], [0, 1000, 0]])
    d = reference.jukes_cantor(subs, homs)
    table = reference.cells(d)
    assert table[0][1] == "%.4e" % (-0.75 * np.log(1 - 4 / 3 * 0.01))
    assert table[0][2] == "nan"  # no site
    assert table[1][2] == "-nan"  # 0.9 > 3/4
    assert table[1][1] == "0.0000e+00"
    assert reference.parse_phylip(reference.phylip(["a", "b", "c"], table)) == (["a", "b", "c"], table)


def test_interval_union_and_bounds():
    assert traces.interval_union([(0, 2), (1, 3), (5, 6)]) == 4
    assert traces.interval_union([]) == 0
    # A C G T ! on two strands; forward C shares its partners with
    # reverse G, forward G with reverse C
    assert traces.planes() == 8
    # 29 x 5 Mbp: bound by the bytes, the packed panel and two int32 outputs
    assert traces.count_bound_s(29, 5_000_000) == pytest.approx(
        (29 * 2.5e6 + 8 * 29 * 29) / 3.35e12)
    # 563 x 1.04 Mbp: bound by the operations, 9 a cell and column
    assert traces.count_bound_s(563, 1_040_000) == pytest.approx(
        2 * 9 * (563 * 564 // 2) * 1.04e6 / 1979e12)
    # bytes: a quarter byte a base read, half a byte a column written
    assert traces.build_bound_s(2, 100, 400) == pytest.approx((100 + 100) / 3.35e12)


def _run(k, spawned, wall, timings, count=2, build=4):
    main_began = spawned + 0.5
    return {"spawned": spawned, "exited": spawned + wall, "wall": wall, "start_s": 0.1,
            "import_s": 0.4, "main_s": wall - 0.6, "exit_s": 0.1, "timings": timings,
            "main_began": main_began, "process_began": main_began + 0.2,
            "process_ended": main_began + 0.2 + sum(timings.values()),
            "count_launches": count, "build_launches": build, "rss_mb": 100.0 + k}


def test_end_to_end_and_layer_arithmetic():
    runs = [_run(0, 100.0, 2.0, {"index": 0.5, "map+pileup+feed": 0.6, "compare": 0.1}),
            _run(1, 102.5, 3.0, {"index": 0.7, "map+pileup+feed": 0.8, "compare": 0.3})]
    e2e = end_to_end(runs, 12.5)
    assert e2e == {"matrix_s": 2.5, "peak_rss_mb": 101.0, "setup_s": 12.5}
    window = (100.0, 105.5)
    kernels = [("pair_mma_kernel", 101.0, 101.5), ("pileup_build_kernel", 101.2, 101.6),
               ("pair_mma_kernel", 104.0, 104.5), ("other", 99.0, 99.5)]
    record = {"runs": runs, "kernels": kernels, "window": window,
              "problem": {"genomes": 29, "width": 5_000_000, "query_bases": 145_000_000}}
    read = lambda name: load_metric(name).read(record)  # noqa: E731
    assert read("startup_s") == pytest.approx(0.6)
    assert read("read_s") == pytest.approx(0.2)
    assert read("index_s") == pytest.approx(0.6)
    assert read("map_s") == pytest.approx(0.7)
    assert read("compare_s") == pytest.approx(0.2)
    # busy 0.6 + 0.5 of 5.5 s
    assert read("card_idle") == pytest.approx(100 * (1 - 1.1 / 5.5))
    assert read("count_roofline") == pytest.approx(100 * 2 * traces.count_bound_s(29, 5e6) / 1.0)
    assert read("build_roofline") == pytest.approx(
        100 * 2 * traces.build_bound_s(29, 5e6, 145e6) / 0.4)
    assert load_metric("card_idle").read({**record, "kernels": []}) is None
    gaps = traces.idle_gaps(kernels, runs, *window)
    assert gaps[0][0] == "run0.map+pileup+feed" and gaps[0][1] == pytest.approx(2.4)
    assert traces.device_ops(kernels, *window)[0] == ["pair_mma_kernel", 1.0]


def test_child_env_keeps_the_run_in_its_directory(monkeypatch, tmp_path):
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "0")
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    env = child_env(ROOT, str(tmp_path), {})
    assert not {"PHYLONIUM_TPU_DEVD", "PHYLONIUM_TPU_STREAM"} & env.keys()
    assert env["PHYLONIUM_TPU_DEVD_SOCK"].startswith(str(tmp_path))
    assert env["PHYLONIUM_TPU_CALIBRATION_FILE"].startswith(str(tmp_path))
    for key in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "CUDA_CACHE_PATH"):
        assert env[key].startswith(ROOT)
