"""The port's host utilities against the JAX package's: ``utils/profiling``
(``PhaseTimer``'s record format, ``trace`` as torch.profiler), ``utils/
metrics`` (to 1e-12), and ``cli.finetune --profile_steps`` at t2v-tiny on
the CPU."""

import contextlib
import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

from moviigen_tpu.utils import metrics as jmetrics
from moviigen_tpu.utils import profiling as jprof
from moviigen_tpu_torch.utils import metrics, profiling


def _clock(values):
    it = iter(values)
    return lambda: next(it)


def test_phase_timer_matches_jax(monkeypatch):
    """Same clock readings, same phases: the same totals, counts,
    averages and report (``name=…ms`` sorted by name)."""
    readings = [0.0, 0.25, 1.0, 1.5, 2.0, 2.0125, 3.0, 3.75, 4.0, 4.0]
    timers = []
    for mod in (jprof, profiling):
        monkeypatch.setattr(mod.time, "perf_counter", _clock(readings))
        t = mod.PhaseTimer(enabled=True)
        for name in ("step", "load", "step", "save", "step"):
            with t.phase(name):
                pass
        timers.append(t)
    want, got = timers
    assert dict(got.totals) == dict(want.totals)
    assert dict(got.counts) == dict(want.counts)
    assert got.averages() == want.averages()
    assert got.report() == want.report() \
        == "load=500.0ms save=750.0ms step=87.5ms"
    off = profiling.PhaseTimer(enabled=False)
    with off.phase("step"):
        pass
    assert off.report() == "" and not off.totals


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    ctx = profiling.trace(str(tmp_path / "profile"), device="cpu")
    assert isinstance(ctx, contextlib.AbstractContextManager)
    with ctx as tr:
        assert tr.path is None
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.dirname(tr.path) == str(tmp_path / "profile")
    assert tr.path.endswith(".pt.trace.json")
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert tr.kernels == {}  # no device kernels on the CPU


def test_sync_reads_back_the_first_tensor():
    calls = []

    class Probe(torch.Tensor):
        def item(self):
            calls.append(self.shape)
            return super().item()

    first = torch.zeros(2, 3).as_subclass(Probe)
    profiling.sync({"b": torch.ones(1), "a": [first, torch.ones(4)]})
    profiling.sync(None)  # no card: nothing to wait for
    assert len(calls) == 1


def _arrays(seed, shape=(2, 3, 20, 24)):
    rng = np.random.default_rng(seed)
    a = np.clip(rng.standard_normal(shape) * 0.5, -1, 1)
    return a, np.clip(a + 0.05 * rng.standard_normal(shape), -1, 1)


@pytest.mark.parametrize("fn", ["psnr", "ssim", "latent_parity_report"])
def test_metrics_match_jax(fn):
    for seed in (0, 1):
        a, b = _arrays(seed)
        got, want = getattr(metrics, fn)(a, b), getattr(jmetrics, fn)(a, b)
        if fn == "latent_parity_report":
            assert got.keys() == want.keys()
            for k in want:
                assert abs(got[k] - want[k]) <= 1e-12 * abs(want[k]), k
        else:
            assert abs(got - want) <= 1e-12 * abs(want)
    assert metrics.psnr(a, a) == jmetrics.psnr(a, a) == float("inf")
    assert metrics.ssim(a[0, 0], a[0, 0]) == pytest.approx(1.0, abs=1e-12)


@pytest.fixture
def small_dataset(tmp_path):
    d = tmp_path / "ds"
    (d / "latent").mkdir(parents=True)
    (d / "prompt_embed").mkdir()
    rng = np.random.default_rng(0)
    annos = []
    for i in range(3):
        np.save(d / "latent" / f"v{i}.npy",
                rng.standard_normal((4, 3, 8, 8)).astype(np.float32))
        np.save(d / "prompt_embed" / f"v{i}.npy",
                rng.standard_normal((5 + 4 * i, 32)).astype(np.float32))
        annos.append({"latent_path": f"v{i}.npy",
                      "prompt_embed_path": f"v{i}.npy",
                      "length": 3, "aspect_ratio_bin": 0})
    path = d / "videos2caption.json"
    path.write_text(json.dumps(annos))
    return str(path)


def test_finetune_profile_steps(small_dataset, tmp_path, caplog,
                                monkeypatch):
    """``--profile_steps 2``: the trace of the first two steps lands in
    ``<output_dir>/profile``, the phase line is logged, and the losses are
    those of a run without the flag (the JAX CLI's wiring,
    cli/finetune.py:392-424). TensorBoard is left out (where TensorFlow is
    installed its import takes seconds, and it logs nothing this test
    reads)."""
    from moviigen_tpu_torch.cli.finetune import main

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)

    def run(out, *flags):
        return main(["--task", "t2v-tiny", "--device", "cpu",
                     "--data_json_path", small_dataset, "--num_latent_t",
                     "2", "--output_dir", str(out), "--max_train_steps",
                     "3", "--learning_rate", "1e-4", *flags])

    plain = run(tmp_path / "plain")
    with caplog.at_level(logging.INFO):
        profiled = run(tmp_path / "prof", "--profile_steps", "2")
    assert plain["profile"] is None
    assert profiled["loss"] == plain["loss"] and len(plain["loss"]) == 3
    tr = profiled["profile"]
    assert os.path.dirname(tr.path) == str(tmp_path / "prof" / "profile")
    assert os.listdir(tmp_path / "prof" / "profile") == [
        os.path.basename(tr.path)]
    with open(tr.path) as f:
        assert json.load(f)["traceEvents"]
    lines = [r.getMessage() for r in caplog.records
             if "profiler trace written" in r.getMessage()]
    assert len(lines) == 1 and "phases: step=" in lines[0]
    # every batch through the native reader pool (built with g++)
    assert profiled["python_batches"] == 0
    assert profiled["native_batches"] >= 3
