"""The port's 'auto' dispatch against the JAX package's.

- With the port's constants set to the JAX package's (the device tail,
  the default host-compare and map rates, the static work threshold, and
  an infinite host pack rate: the JAX model has no pack term),
  ``_auto_prefers_host``, ``_stream_predicts_win`` and
  ``early_ship_eligible`` decide as the JAX functions do on a hypothesis
  grid of panel sizes, reference lengths, calibrated rates (a copy rate
  or none) and the ``PHYLONIUM_TPU_AUTO_DEVICE_GBP`` override, both read
  from one calibration file. The JAX device server is off
  (``PHYLONIUM_TPU_DEVD=0``): its branch waits for the port of ``serve/``.
- ``should_stream``'s conditions against JAX ``_should_stream`` over every
  combination of flags, the stream switch and the device (the JAX
  ``cpu_pinned()`` against ``--device cpu``).
- Hand-worked cases with the card's own constants.
"""

import itertools
import json
import os

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import phylonium_tpu.core.pipeline as jax_pipeline
import phylonium_tpu.core.query_ship as jax_query_ship
import phylonium_tpu.utils.calibration as jax_calibration
import phylonium_tpu.utils.platform as jax_platform
from phylonium_tpu.config import RunConfig
from phylonium_tpu_torch.config import TorchRunConfig
from phylonium_tpu_torch.core import pipeline, query_ship
from phylonium_tpu_torch.utils import calibration

_ENV = ("PHYLONIUM_TPU_STREAM", "PHYLONIUM_TPU_STREAM_GROUP", "PHYLONIUM_TPU_AUTO_DEVICE_GBP",
        "PHYLONIUM_TPU_CALIBRATION_FILE", "PHYLONIUM_TPU_DEVD")


@pytest.fixture
def jax_constants(monkeypatch, tmp_path):
    """The port's model constants set to the JAX package's; one shared
    calibration file; the JAX device server off; a CUDA-like JAX run."""
    for key in _ENV:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(pipeline, "_DEVICE_TAIL_S", jax_pipeline._DEVICE_TAIL_S)
    monkeypatch.setattr(pipeline, "_PACK_BPS", float("inf"))  # the JAX model packs nothing
    monkeypatch.setattr(calibration, "_DEFAULT_HOST_COMPARE_GBPS",
                        jax_calibration._DEFAULT_HOST_COMPARE_GBPS)
    monkeypatch.setattr(calibration, "_DEFAULT_MAP_GBPS", jax_calibration._DEFAULT_MAP_GBPS)
    monkeypatch.setenv("PHYLONIUM_TPU_DEVD", "0")
    monkeypatch.setattr(jax_platform, "cpu_pinned", lambda: False)
    path = tmp_path / "calibration.json"
    monkeypatch.setenv("PHYLONIUM_TPU_CALIBRATION_FILE", str(path))
    return path


def _configs(**fields):
    jax_cfg = RunConfig(**fields)
    port_cfg = TorchRunConfig(device="cuda", **fields)
    port_cfg.auto_device_min_gbp = jax_cfg.auto_device_min_gbp
    return jax_cfg, port_cfg


_RATES = st.one_of(st.none(), st.floats(0.05, 1e5, allow_nan=False))


def _write_store(path, link, host, mapr):
    data = {k: v for k, v in (("link_mb_s", link), ("host_compare_gbps", host),
                              ("map_gbps", mapr)) if v is not None}
    path.write_text(json.dumps(data))


_GRID = dict(
    n=st.integers(2, 2000),
    ref_len=st.integers(1, 50_000_000),
    link=_RATES, host=_RATES, mapr=_RATES,
    override=st.sampled_from([None, "0", "1", "128", "5000"]),
)
_SETTINGS = settings(max_examples=300, deadline=None, derandomize=True,
                     suppress_health_check=[HealthCheck.function_scoped_fixture])


@_SETTINGS
@given(**_GRID)
def test_dispatch_models_decide_as_the_jax_package(jax_constants, n, ref_len, link, host,
                                                   mapr, override):
    _write_store(jax_constants, link, host, mapr)
    if override is None:
        os.environ.pop("PHYLONIUM_TPU_AUTO_DEVICE_GBP", None)
    else:
        os.environ["PHYLONIUM_TPU_AUTO_DEVICE_GBP"] = override
    jax_cfg, port_cfg = _configs()
    assert port_cfg.auto_device_min_gbp == jax_cfg.auto_device_min_gbp
    assert (pipeline._auto_prefers_host(n, ref_len, port_cfg)
            == jax_pipeline._auto_prefers_host(n, ref_len, jax_cfg))
    assert (pipeline._stream_predicts_win(n, ref_len, port_cfg)
            == jax_pipeline._stream_predicts_win(n, ref_len, jax_cfg))
    for key in ("dispatch_model", "stream_model"):
        if key in jax_pipeline.LAST_RUN_INFO and key in pipeline.LAST_RUN_INFO:
            if pipeline.LAST_RUN_INFO[key].get("link_mb_s") is not None:
                assert pipeline.LAST_RUN_INFO[key] == jax_pipeline.LAST_RUN_INFO[key]
        jax_pipeline.LAST_RUN_INFO.pop(key, None)
        pipeline.LAST_RUN_INFO.pop(key, None)
    os.environ.pop("PHYLONIUM_TPU_AUTO_DEVICE_GBP", None)


@_SETTINGS
@given(**_GRID, bytes_per_base=st.floats(1.0, 1.1), stream=st.sampled_from(["", "0", "force"]))
def test_early_ship_eligible_decides_as_the_jax_package(jax_constants, monkeypatch, n, ref_len,
                                                        link, host, mapr, override,
                                                        bytes_per_base, stream):
    _write_store(jax_constants, link, host, mapr)
    env = {"PHYLONIUM_TPU_AUTO_DEVICE_GBP": override, "PHYLONIUM_TPU_STREAM": stream or None}
    for key, value in env.items():
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = value
    names = [f"genome{k}.fasta" for k in range(n)]
    size = int(ref_len * bytes_per_base)
    with monkeypatch.context() as m:
        m.setattr(os.path, "getsize", lambda name: size)
        jax_cfg, port_cfg = _configs()
        assert (query_ship.early_ship_eligible(port_cfg, names)
                == jax_query_ship.early_ship_eligible(jax_cfg, names))
    for key in env:
        os.environ.pop(key, None)


def test_early_ship_structural_conditions(jax_constants, monkeypatch):
    names = [f"g{k}.fa" for k in range(40)]
    monkeypatch.setattr(os.path, "getsize", lambda name: 5_000_000)
    fields = [{}, {"count_backend": "numpy"}, {"count_backend": "device"}, {"mesh": "2,4"},
              {"complete_deletion": True}, {"print_positions": True},
              {"checkpoint_dir": "/tmp/c"}, {"map_backend": "hybrid"},
              {"map_backend": "python"}, {"esa_backend": "numpy"}, {"esa_backend": "native"}]
    for stream, f in itertools.product(["", "0", "force"], fields):
        monkeypatch.setenv("PHYLONIUM_TPU_STREAM", stream)
        jax_cfg, port_cfg = _configs(**f)
        want = jax_query_ship.early_ship_eligible(jax_cfg, names)
        assert query_ship.early_ship_eligible(port_cfg, names) == want, (stream, f)
        # a CPU run: the JAX package's cpu_pinned()
        monkeypatch.setattr(jax_platform, "cpu_pinned", lambda: True)
        port_cfg.device = "cpu"
        want = jax_query_ship.early_ship_eligible(jax_cfg, names)
        assert query_ship.early_ship_eligible(port_cfg, names) == want, (stream, f, "cpu")
        monkeypatch.setattr(jax_platform, "cpu_pinned", lambda: False)
    # several ranks never ship
    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", "force")
    monkeypatch.setattr("phylonium_tpu_torch.parallel.multihost.world", lambda: (4, 0))
    assert not query_ship.early_ship_eligible(_configs()[1], names)


class _Ref:
    def __init__(self, backend_name):
        self.backend_name = backend_name


class _Shipper:
    def __init__(self, cancelled):
        self.cancelled = self._cancelled = cancelled


_SHOULD_FIELDS = [{}, {"count_backend": "host"}, {"count_backend": "device"}, {"mesh": "2,2"},
                  {"complete_deletion": True}, {"print_positions": True},
                  {"checkpoint_dir": "/tmp/c"}, {"map_backend": "hybrid"},
                  {"map_backend": "native"}]


@pytest.mark.parametrize("stream", ["", "0", "force"])
def test_should_stream_conditions_match_the_jax_gate(jax_constants, monkeypatch, stream):
    import phylonium_tpu.utils.platform as plat

    monkeypatch.setenv("PHYLONIUM_TPU_STREAM", stream)
    monkeypatch.setattr(plat, "backends_initialized", lambda: False)
    cases = itertools.product(
        _SHOULD_FIELDS, ["native", "numpy"], [False, True],  # CPU run
        [None, False, True],  # no shipper, a live one, a cancelled one
        [(9, 5_000_000), (29, 5_000_000), (8, 5_000_000), (29, 1_000), (116, 5_000_000)],
        [None, 20_000.0],  # a calibrated copy rate, or none
    )
    for fields, backend, cpu, shipper, (n, ref_len), link in cases:
        _write_store(jax_constants, link, None, None)
        jax_cfg, port_cfg = _configs(**fields)
        if shipper is not None:
            jax_cfg._query_shipper = _Shipper(shipper)
            port_cfg._query_shipper = _Shipper(shipper)
        if cpu:
            port_cfg.device = "cpu"
        monkeypatch.setattr(plat, "cpu_pinned", lambda: cpu)
        want = jax_pipeline._should_stream(n, ref_len, jax_cfg, _Ref(backend))
        got = pipeline.should_stream(n, ref_len, port_cfg, _Ref(backend))
        assert got == want, (stream, fields, backend, cpu, shipper, n, ref_len, link)


def test_hand_worked_cases_with_the_cards_constants(tmp_path, monkeypatch):
    """The card's constants as they stand: an empty store keeps the static
    rule, a calibrated copy rate the measured model, by the formulas."""
    for key in _ENV:
        monkeypatch.delenv(key, raising=False)
    path = tmp_path / "calibration.json"
    monkeypatch.setenv("PHYLONIUM_TPU_CALIBRATION_FILE", str(path))
    cfg = TorchRunConfig(device="cuda")
    min_gbp = cfg.auto_device_min_gbp
    tail = pipeline._DEVICE_TAIL_S
    host_rate = calibration._DEFAULT_HOST_COMPARE_GBPS
    map_rate = calibration._DEFAULT_MAP_GBPS
    eco29 = 29 * 28 / 2 * 5_000_000 / 1e9  # 2.03 Gbp of pair work
    # empty store: the static threshold
    assert pipeline._auto_prefers_host(29, 5_000_000, cfg) == (eco29 < min_gbp)
    assert pipeline.LAST_RUN_INFO["dispatch_model"] == {
        "link_mb_s": None, "work_gbp": 2.03, "auto_device_min_gbp": min_gbp}
    assert pipeline._stream_predicts_win(29, 5_000_000, cfg) is None
    # three genomes of 30 kbp: 90 kbp of pair work never beats the tail
    assert pipeline._auto_prefers_host(3, 30_000, cfg) == (9e-5 < min_gbp)
    # a calibrated 20 GB/s copy: serial copies 72.5 MB of nibbles
    path.write_text(json.dumps({"link_mb_s": 20_000.0}))
    t_dev = 29 * 5_000_000 / 2 / 1e6 / 20_000.0 + 29 * 5_000_000 / pipeline._PACK_BPS + tail
    assert pipeline._auto_prefers_host(29, 5_000_000, cfg) == (eco29 / host_rate < t_dev)
    assert pipeline.LAST_RUN_INFO["dispatch_model"]["t_device_s"] == round(t_dev, 3)
    # streamed: 36.25 MB of codes hide under the mapping window
    unhidden = max(0.0, 29 * 5_000_000 / 4 / 20_000e6 - 29 * 5_000_000 / (map_rate * 1e9))
    assert unhidden == 0.0
    assert pipeline._stream_predicts_win(29, 5_000_000, cfg) == (tail < eco29 / host_rate)
    # a tiny panel: the host compare takes microseconds
    assert pipeline._auto_prefers_host(3, 30_000, cfg)
    assert not pipeline._stream_predicts_win(3, 30_000, cfg)
    # 116 x 5 Mbp: 33.35 Gbp, whose host compare exceeds the tail
    assert pipeline._stream_predicts_win(116, 5_000_000, cfg) == (
        tail < 116 * 115 / 2 * 5_000_000 / 1e9 / host_rate)
    # the override pins the static rule
    monkeypatch.setenv("PHYLONIUM_TPU_AUTO_DEVICE_GBP", "1")
    assert pipeline._stream_predicts_win(29, 5_000_000, cfg) is None
    assert not pipeline._auto_prefers_host(29, 5_000_000, TorchRunConfig(device="cuda"))


def test_the_gate_applies_to_cuda_devices_only(tmp_path, monkeypatch):
    """On the CPU 'auto' counts with the plain version whatever the model
    says; on a CUDA device the model may pick the host."""
    for key in _ENV:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("PHYLONIUM_TPU_AUTO_DEVICE_GBP", "1e9")  # host always
    assert not pipeline._gate_picks_host(29, 5_000_000, TorchRunConfig(device="cpu"))
    assert pipeline._gate_picks_host(29, 5_000_000, TorchRunConfig(device="cuda"))
    for backend in ("device", "pallas", "host", "numpy"):
        assert not pipeline._gate_picks_host(
            29, 5_000_000, TorchRunConfig(device="cuda", count_backend=backend))
    monkeypatch.setattr(pipeline, "world", lambda: (2, 0))
    assert not pipeline._gate_picks_host(29, 5_000_000, TorchRunConfig(device="cuda"))
