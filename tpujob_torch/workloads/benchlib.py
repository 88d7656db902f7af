"""Steady-state measurement for the port's benchmarks: the port of
``tpujob/workloads/benchlib.py``.

One implementation of the windowed dispatch/drain timing that both
``tpujob_torch.bench`` (the MNIST headline) and
``tpujob_torch.bench_models`` (the flagship models) use, so the two never
measure differently.

Method, as in the JAX package: N windows, each queueing steps without
waiting for the card and then draining (``torch.cuda.synchronize`` on the
drained tensor's device; nothing to wait for on the CPU) INSIDE its own
wall time, so a window is an honest end-to-end throughput sample.  The
stddev across windows is what tells a real regression from run-to-run
noise.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch


@dataclass
class WindowStats:
    steps: int          # total steps across all windows
    wall_s: float       # total measured wall time (drains included)
    mean_s: float       # sample mean of per-window seconds-per-step
    std_s: float        # sample stddev of per-window seconds-per-step
    per_window_s: List[float]  # seconds-per-step of each window

    @property
    def throughput_steps_per_s(self) -> float:
        return self.steps / self.wall_s


def platform_name(device: torch.device) -> str:
    """What a bench line names its platform: the card's name, or "cpu"."""
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def drain(out) -> None:
    """Wait until the card has computed ``out`` (a tensor, or a tuple or
    list holding one); a CPU tensor or anything else is already there."""
    if isinstance(out, (tuple, list)):
        for x in out:
            drain(x)
    elif isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


def measure_windows(
    run_step: Callable[[], object],
    *,
    window_s: float = 1.0,
    min_windows: int = 5,
    min_total_s: float = 5.0,
    min_steps_per_window: int = 5,
    fixed_steps: Optional[int] = None,
    steps_per_call: int = 1,
) -> WindowStats:
    """Time ``run_step`` (queue one step, return something to drain on)
    in windows of ~``window_s`` seconds.

    ``fixed_steps``: run exactly that many steps per window, and exactly
    ``min_windows`` windows (``min_total_s`` is ignored), as several
    processes need: a wall-clock-bounded loop would queue unequal
    collective counts per process.

    ``steps_per_call``: optimizer steps one ``run_step`` call performs
    (``train_lib.make_multi_step``); reported steps and per-step times
    account for it.  ``fixed_steps`` still counts calls.
    """
    if fixed_steps is not None and fixed_steps <= 0:
        raise ValueError(f"fixed_steps must be positive, got {fixed_steps}")
    if steps_per_call <= 0:
        raise ValueError(f"steps_per_call must be positive, got {steps_per_call}")

    windows: List[tuple] = []  # (steps, seconds)
    t0 = time.perf_counter()
    while (
        len(windows) < min_windows
        if fixed_steps is not None  # deterministic window count
        else (time.perf_counter() - t0 < min_total_s
              or len(windows) < min_windows)
    ):
        w0 = time.perf_counter()
        w_steps = 0
        out = None
        while (w_steps < fixed_steps if fixed_steps is not None
               else (time.perf_counter() - w0 < window_s
                     or w_steps < min_steps_per_window)):
            out = run_step()
            w_steps += 1
        drain(out)  # inside the window
        windows.append((w_steps, time.perf_counter() - w0))
    wall = time.perf_counter() - t0

    per_step = [s / (w * steps_per_call) for w, s in windows]
    mean = sum(per_step) / len(per_step)
    std = (
        (sum((s - mean) ** 2 for s in per_step) / (len(per_step) - 1)) ** 0.5
        if len(per_step) > 1 else 0.0
    )
    return WindowStats(
        steps=sum(w for w, _ in windows) * steps_per_call,
        wall_s=wall,
        mean_s=mean,
        std_s=std,
        per_window_s=per_step,
    )
