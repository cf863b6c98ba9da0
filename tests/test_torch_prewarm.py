"""The device prewarm of the port's ``process()`` (core/pipeline.py).

- ``_prewarm_plan``: which configurations start a prewarm, and whether it
  warms the build kernel too: none on the CPU, none for host or numpy
  counting, none for a device name that does not parse;
- a prewarm worker that raises makes ``process()`` raise that same error
  at the join, after the index and before any device step; with
  ``--device cuda`` and no card the prewarm's start raises the
  ConfigError that names it, before the index, and nothing runs on the
  CPU instead;
- the prewarm's work (here the plain versions, the CPU route of its
  launches) stays out of the run's launch and plain-call counters.
"""

import threading

import numpy as np
import pytest
import torch

from phylonium_tpu_torch.config import ConfigError, TorchRunConfig
from phylonium_tpu_torch.core import pipeline
from phylonium_tpu_torch.data.sequence import Sequence
from phylonium_tpu_torch.ops import match_matrix, pileup_device
from phylonium_tpu_torch.utils import platform

ACGT = np.frombuffer(b"ACGT", np.uint8)

_ENV = ("PHYLONIUM_TPU_STREAM", "PHYLONIUM_TPU_DEVICE_PILEUP", "PHYLONIUM_TPU_LOWMEM",
        "PHYLONIUM_TPU_STREAM_GROUP")

# name: (config fields, environment, world size, plan)
PLAN_CASES = {
    "cpu": ({"device": "cpu"}, {}, 1, None),
    "cpu-hybrid": ({"device": "cpu", "map_backend": "hybrid"}, {}, 1, None),
    "cpu-streamed": ({"device": "cpu"}, {"PHYLONIUM_TPU_STREAM": "force"}, 1, None),
    "host-count": ({"count_backend": "host"}, {}, 1, None),
    "numpy-count": ({"count_backend": "numpy"}, {}, 1, None),
    "host-lowmem": ({"count_backend": "host"}, {"PHYLONIUM_TPU_LOWMEM": "force"}, 1, None),
    "unparsed-device": ({"device": "tpu!"}, {}, 1, None),
    "host-count-hybrid": ({"count_backend": "host", "map_backend": "hybrid"}, {}, 1,
                          (False, False)),
    "serial": ({}, {"PHYLONIUM_TPU_STREAM": "0"}, 1, (True, False)),
    "serial-device": ({"count_backend": "device"}, {}, 1, (True, False)),
    "serial-pallas": ({"count_backend": "pallas"}, {}, 1, (True, False)),
    "hybrid": ({"map_backend": "hybrid"}, {}, 1, (True, False)),
    "x2": ({}, {"PHYLONIUM_TPU_DEVICE_PILEUP": "1"}, 1, (True, True)),
    "streamed": ({}, {"PHYLONIUM_TPU_STREAM": "force"}, 1, (True, True)),
    "streamed-complete-deletion": ({"complete_deletion": True},
                                   {"PHYLONIUM_TPU_STREAM": "force"}, 1, (True, False)),
    "lowmem": ({}, {"PHYLONIUM_TPU_LOWMEM": "force"}, 1, (True, True)),
    "pod-streamed": ({}, {}, 4, (True, True)),
    "pod-stream-off": ({}, {"PHYLONIUM_TPU_STREAM": "0"}, 4, (True, False)),
    "mesh": ({"mesh": "2,2"}, {}, 4, (True, False)),
}


@pytest.fixture
def clean_env(monkeypatch):
    for key in _ENV:
        monkeypatch.delenv(key, raising=False)
    return monkeypatch


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_which_runs_prewarm(name, clean_env):
    fields, env, size, plan = PLAN_CASES[name]
    for key, value in env.items():
        clean_env.setenv(key, value)
    clean_env.setattr(pipeline, "world", lambda: (size, 0))
    # a threshold of 0 Gbp keeps the dispatch model's count on the card
    clean_env.setenv("PHYLONIUM_TPU_AUTO_DEVICE_GBP", "0")
    cfg = TorchRunConfig(**{"device": "cuda", **fields})
    assert pipeline._prewarm_plan(29, 5_000, 29 * 5_000, cfg) == plan
    if plan is None:
        assert pipeline.prewarm_device(29, 5_000, 29 * 5_000, cfg) is None


def _panel(n: int = 4, length: int = 3_000):
    rng = np.random.default_rng(11)
    base = ACGT[rng.integers(0, 4, length)]
    seqs = []
    for k in range(n):
        arr = base.copy()
        idx = np.flatnonzero(rng.random(length) < 0.01 * k)
        arr[idx] = ACGT[(np.searchsorted(ACGT, arr[idx]) + rng.integers(1, 4, idx.size)) % 4]
        seqs.append(Sequence(f"g{k}", arr.tobytes()))
    return seqs


class Injected(RuntimeError):
    pass


@pytest.mark.parametrize("env", [{}, {"PHYLONIUM_TPU_STREAM": "force"},
                                 {"PHYLONIUM_TPU_LOWMEM": "force"}],
                         ids=["serial", "streamed", "lowmem"])
def test_a_prewarm_error_is_raised_at_the_join(env, clean_env):
    for key, value in env.items():
        clean_env.setenv(key, value)
    err = Injected("context creation failed (injected)")

    def fail(device, count, build):
        raise err

    clean_env.setattr(pipeline, "_prewarm_plan", lambda *args: (True, True))
    clean_env.setattr(pipeline, "_warm", fail)
    seqs = _panel()
    calls = pileup_device.PLAIN_CALLS
    with pytest.raises(Injected) as raised:
        pipeline.process(seqs[0], seqs, TorchRunConfig(device="cpu", progress="never"))
    assert raised.value is err
    assert set(pipeline.LAST_RUN_INFO["prewarm"]) == {"seconds", "waited", "launches"}
    assert pileup_device.PLAIN_CALLS == calls  # no device step ran around it


def test_no_card_is_a_config_error_before_the_index(clean_env, monkeypatch):
    from phylonium_tpu_torch.index import esa

    # the CUDA driver finds no card: the check before any work says so
    monkeypatch.setattr(platform, "cuda_device_count", lambda: 0)

    def no_index(*args, **kwargs):
        raise AssertionError("the index was built")

    monkeypatch.setattr(pipeline, "ESAIndex", no_index)
    seqs = _panel()
    with pytest.raises(ConfigError, match="finds no CUDA device"):
        pipeline.process(seqs[0], seqs, TorchRunConfig(device="cuda", progress="never"))
    assert "prewarm" not in pipeline.LAST_RUN_INFO
    assert esa.ESAIndex is not no_index


@pytest.mark.parametrize("env", [{}, {"PHYLONIUM_TPU_STREAM": "force"}],
                         ids=["serial", "streamed"])
def test_prewarm_work_stays_out_of_the_counters(env, clean_env):
    for key, value in env.items():
        clean_env.setenv(key, value)
    seqs = _panel()
    cfg = TorchRunConfig(device="cpu", progress="never")
    keys = ("kernel_launches", "plain_calls", "build_kernel_launches", "build_plain_calls")
    want = pipeline.process(seqs[0], seqs, cfg)
    plain = {k: pipeline.LAST_RUN_INFO[k] for k in keys}
    assert "prewarm" not in pipeline.LAST_RUN_INFO

    # the real worker, let run on the CPU: its calls of the plain versions
    # are what its launches are on a card
    warm_calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            if threading.current_thread().name == "device-prewarm":
                warm_calls.append(name)
            return fn(*args, **kwargs)
        return wrapped

    clean_env.setattr(match_matrix, "cross_counts_reference",
                      spy("pair_count", match_matrix.cross_counts_reference))
    clean_env.setattr(pileup_device, "_plain", spy("pileup_build", pileup_device._plain))
    clean_env.setattr(pipeline, "_prewarm_plan", lambda *args: (True, True))
    got = pipeline.process(seqs[0], seqs, cfg)
    assert sorted(warm_calls) == ["pair_count", "pileup_build"]
    assert pipeline.LAST_RUN_INFO["prewarm"]["launches"] == {"pair_count": 0,
                                                            "pileup_build": 0}
    assert {k: pipeline.LAST_RUN_INFO[k] for k in keys} == plain
    assert np.array_equal(got.substitutions, want.substitutions)
    assert np.array_equal(got.homologs, want.homologs)
