"""The port's windowed measurement (``tpujob_torch.workloads.benchlib``)
against the JAX package's (``tpujob/workloads/benchlib.py``).

Every case of ``tests/test_benchlib.py`` runs on both implementations;
then both run the same scripted ``run_step`` under one patched clock and
must return equal ``WindowStats`` (window and step counts, wall time,
per-window seconds a step, mean and stddev), whatever the bounds.
"""
import time

import pytest
import torch

from tpujob.workloads import benchlib as jbench
from tpujob_torch.workloads import benchlib as tbench

IMPLS = {"jax": jbench.measure_windows, "torch": tbench.measure_windows}


@pytest.fixture(params=sorted(IMPLS))
def measure_windows(request):
    return IMPLS[request.param]


def test_fixed_steps_exact_counts(measure_windows):
    calls = []

    def run_one():
        calls.append(1)
        return None

    stats = measure_windows(run_one, fixed_steps=7, min_windows=3,
                            min_total_s=3600.0)
    assert stats.steps == len(calls) == 21
    assert len(stats.per_window_s) == 3
    assert stats.wall_s > 0 and stats.mean_s > 0
    with pytest.raises(ValueError):
        measure_windows(run_one, fixed_steps=0)


def test_min_bounds_and_stats(measure_windows):
    stats = measure_windows(lambda: None, window_s=0.01, min_windows=5,
                            min_total_s=0.05, min_steps_per_window=2)
    assert len(stats.per_window_s) >= 5
    assert stats.steps >= 10
    mean = sum(stats.per_window_s) / len(stats.per_window_s)
    assert abs(stats.mean_s - mean) < 1e-12
    assert stats.std_s >= 0.0


def test_steps_per_call_scales_counts(measure_windows):
    calls = []
    stats = measure_windows(
        lambda: calls.append(1), window_s=0.01, min_windows=2,
        min_total_s=0.02, min_steps_per_window=3, fixed_steps=3,
        steps_per_call=10,
    )
    assert stats.steps == len(calls) * 10
    assert abs(stats.mean_s * stats.steps - stats.wall_s) / stats.wall_s < 0.5


def test_steps_per_call_must_be_positive(measure_windows):
    with pytest.raises(ValueError, match="steps_per_call"):
        measure_windows(lambda: None, steps_per_call=0)


class Clock:
    """A ``time.perf_counter`` that moves only when a step runs."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("kw,step_s", [
    ({}, 0.3),  # the defaults: 1 s windows, >= 5 of them, >= 5 s
    ({"window_s": 0.5, "min_windows": 2, "min_total_s": 1.0,
      "min_steps_per_window": 2, "steps_per_call": 2}, 0.07),
    ({"fixed_steps": 4, "min_windows": 3, "min_total_s": 3600.0}, 0.2),
    ({"fixed_steps": 3, "min_windows": 2, "steps_per_call": 10}, 0.05),
    ({"window_s": 0.1, "min_windows": 3, "min_total_s": 0.2,
      "min_steps_per_window": 7}, 0.5),  # the step floor sets the window
])
def test_both_measure_the_same_script_the_same(kw, step_s, monkeypatch):
    """One scripted step (each call moves the clock by ``step_s``, a
    little more every call, so windows differ) under each implementation:
    the same windows, steps and statistics."""
    out = {}
    for name, impl in IMPLS.items():
        clock = Clock()
        monkeypatch.setattr(time, "perf_counter", clock)
        calls = []

        def run_step():
            calls.append(1)
            clock.t += step_s * (1 + 0.01 * len(calls))
            return torch.zeros(1)  # a CPU tensor: nothing to drain

        out[name] = (impl(run_step, **kw), len(calls))
    (jstats, jcalls), (tstats, tcalls) = out["jax"], out["torch"]
    assert tcalls == jcalls
    assert tstats.steps == jstats.steps
    assert tstats.per_window_s == pytest.approx(jstats.per_window_s,
                                                rel=1e-12)
    assert tstats.wall_s == pytest.approx(jstats.wall_s, rel=1e-12)
    assert tstats.mean_s == pytest.approx(jstats.mean_s, rel=1e-12)
    assert tstats.std_s == pytest.approx(jstats.std_s, rel=1e-12, abs=1e-15)
    assert tstats.throughput_steps_per_s == pytest.approx(
        jstats.throughput_steps_per_s, rel=1e-12)
    if "fixed_steps" in kw:
        assert len(tstats.per_window_s) == kw["min_windows"]
        assert tstats.steps == (kw["fixed_steps"] * kw["min_windows"]
                                * kw.get("steps_per_call", 1))


def test_drain_waits_on_nothing_off_the_card():
    """On the CPU a drained tensor (alone or in a tuple) is already
    there; the card's drain is ``torch.cuda.synchronize`` on its device."""
    tbench.drain(torch.ones(2))
    tbench.drain((torch.ones(2), [torch.zeros(1)], None))
    tbench.drain(None)
