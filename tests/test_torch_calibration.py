"""The port's calibration store (phylonium_tpu_torch/utils/calibration.py).

The cases of the JAX package's tests/test_calibration.py (EWMA, corrupt
file, garbage samples, the link noise floor, the hermetic CPU rule, the
defaults) on the port's module, each also held against the JAX module on
the same file where the two share a meaning; and the port's default
store, which is not the JAX package's file.
"""

import json
import os

import pytest
import torch

from phylonium_tpu.utils import calibration as jax_calibration
from phylonium_tpu_torch.utils import calibration


@pytest.fixture
def calfile(tmp_path, monkeypatch):
    path = tmp_path / "calibration.json"
    monkeypatch.setenv("PHYLONIUM_TPU_CALIBRATION_FILE", str(path))
    return path


@pytest.fixture
def store(calfile):
    return calibration.for_device("cuda")


def test_record_ewma_roundtrip(store, calfile):
    store.record("link_mb_s", 10.0)
    assert store.link_mb_s() == 10.0
    store.record("link_mb_s", 30.0)
    assert store.link_mb_s() == 20.0  # 0.5*10 + 0.5*30
    data = json.loads(calfile.read_text())
    assert data["samples"]["link_mb_s"] == 2
    assert data["updated"] > 0
    # the JAX module reads the same file the same way
    assert jax_calibration.link_mb_s() == 20.0
    jax_calibration.record("link_mb_s", 40.0)
    assert store.link_mb_s() == 30.0


def test_corrupt_file_tolerated(store, calfile):
    calfile.write_text("{not json")
    assert store.load() == {}
    assert store.link_mb_s() is None
    store.record("link_mb_s", 5.0)  # overwrites the corrupt file
    assert store.link_mb_s() == 5.0


def test_rejects_garbage_samples(store):
    store.record("link_mb_s", 0.0)
    store.record("link_mb_s", -3.0)
    store.record("link_mb_s", float("nan"))
    assert store.link_mb_s() is None


def test_link_noise_floor(store):
    store.record_link(1 << 20, 0.5)  # 1 MB: latency-dominated, dropped
    assert store.link_mb_s() is None
    store.record_link(8 << 20, 1.0)
    assert store.link_mb_s() == pytest.approx(8.389, abs=0.01)


def test_rate_noise_floors(store):
    store.record_map(1.0, 0.1)  # shorter than 0.2 s: noise
    store.record_host_compare(1.0, 0.1)
    assert store.load() == {}
    store.record_map(1.0, 0.5)
    store.record_host_compare(30.0, 0.5)
    assert store.map_gbps() == 2.0
    assert store.host_compare_gbps() == 60.0


def test_cpu_run_is_hermetic(monkeypatch):
    """Without the override a run on the CPU, or a process that finds no
    CUDA device, neither reads nor writes the real store."""
    monkeypatch.delenv("PHYLONIUM_TPU_CALIBRATION_FILE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for device in ("cpu", torch.device("cpu"), "not a device"):
        cpu = calibration.for_device(device)
        assert cpu.path is None
        assert cpu.load() == {}
        cpu.record("link_mb_s", 99.0)  # no-op
        assert cpu.link_mb_s() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert calibration.for_device("cuda").path is None


def test_default_store_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("PHYLONIUM_TPU_CALIBRATION_FILE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    path = calibration.for_device("cuda:0").path
    assert path == os.path.join(
        str(tmp_path), ".cache", "phylonium_tpu_torch", "calibration.json"
    )
    jax_path = os.path.expanduser("~/.cache/phylonium_tpu/calibration.json")
    assert path != jax_path
    store = calibration.for_device("cuda")
    store.record("map_gbps", 0.5)  # makes the directory
    assert json.loads(open(path).read())["map_gbps"] == 0.5
    assert not os.path.exists(jax_path)
    assert [p.name for p in (tmp_path / ".cache" / "phylonium_tpu_torch").iterdir()] == [
        "calibration.json"
    ]  # written through a temp file and renamed


def test_defaults_without_measurements(store):
    assert store.host_compare_gbps() == calibration._DEFAULT_HOST_COMPARE_GBPS
    assert store.map_gbps() == calibration._DEFAULT_MAP_GBPS
    snap = store.snapshot()
    assert snap["link_mb_s"] is None
    assert snap["host_compare_gbps"] == round(calibration._DEFAULT_HOST_COMPARE_GBPS, 2)


def test_snapshot_matches_the_jax_modules_on_one_file(store, monkeypatch):
    monkeypatch.setattr(jax_calibration, "_DEFAULT_HOST_COMPARE_GBPS",
                        calibration._DEFAULT_HOST_COMPARE_GBPS)
    monkeypatch.setattr(jax_calibration, "_DEFAULT_MAP_GBPS", calibration._DEFAULT_MAP_GBPS)
    assert store.snapshot() == jax_calibration.snapshot()
    for key, value in (("link_mb_s", 12345.678), ("host_compare_gbps", 71.234567),
                       ("map_gbps", 0.31234)):
        store.record(key, value)
        assert store.snapshot() == jax_calibration.snapshot()
