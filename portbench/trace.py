"""The traced window, reduced from a ``torch.profiler`` Chrome trace.

Device operations are the trace's kernels, copies and fills; host spans
are the benchmark's own ``record_function`` ranges (``portbench.*`` around
its calls, ``bert.train`` for the loop's work between them).  Every time is
on the trace's one clock, in microseconds.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

from portbench import kernels

Event = Tuple[str, float, float]  # name, start us, duration us
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "portbench.window"
# the loop's own work between the benchmark's spans: put_batch, the step
# call, logging
LOOP_LABEL = "bert.train"


@dataclasses.dataclass
class Summary:
    kernels: List[Event]          # kernels inside the window
    ops: List[Event]              # kernels, copies and fills inside it
    spans: List[Event]            # the benchmark's host spans
    window_us: Tuple[float, float]
    calls: int                    # train-step calls traced (whole groups)
    counts: Dict[str, float]      # a call's counts by the architecture
    peak_flops: Optional[float]   # the card's dense bf16 peak, or None

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, in order."""
        out: List[List[float]] = []
        for _, t, d in sorted(self.ops, key=lambda e: e[1]):
            if out and t <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t + d)
            else:
                out.append([t, t + d])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def ms_per_call(self, layer: str) -> float:
        us = sum(d for n, _, d in self.kernels if kernels.layer_class(n) == layer)
        return us / 1e3 / self.calls


def load(path: str, calls: int, counts: Dict[str, float],
         peak_flops: Optional[float]) -> Summary:
    """The window of the trace at ``path``; ``counts`` are one call's
    numbers from ``portbench/models/<architecture>.py`` (``counts``)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
             if e.get("cat") == "user_annotation"]
    windows = [s for s in spans if s[0] == WINDOW_SPAN]
    if len(windows) != 1:
        raise ValueError(f"the trace holds {len(windows)} window spans")
    lo, hi = windows[0][1], windows[0][1] + windows[0][2]
    ops = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
           if e.get("cat") in DEVICE_CATS and lo <= float(e["ts"]) < hi]
    kern = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("cat") == "kernel" and lo <= float(e["ts"]) < hi]
    return Summary(kern, ops, [s for s in spans if s[0] != WINDOW_SPAN],
                   (lo, hi), calls, counts, peak_flops)


def _span_at(spans: List[Event], t: float) -> str:
    """The innermost (latest-starting) span open at ``t``."""
    best = None
    for name, s, d in spans:
        if s <= t < s + d and (best is None or s >= best[1]):
            best = (name, s)
    return best[0] if best else LOOP_LABEL


def breakdown(t: Summary) -> Dict[str, list]:
    """The ten device operations with most time (the three classes, then
    kernels by name) and the idle time by what the host was doing, in
    seconds over the traced window."""
    by_class: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    for n, _, d in t.kernels:
        cls = kernels.layer_class(n)
        by_class[cls] = by_class.get(cls, 0.0) + d / 1e6
        by_name[n[:120]] = by_name.get(n[:120], 0.0) + d / 1e6
    ops = [[f"class:{c}", s] for c, s in sorted(by_class.items(),
                                                key=lambda kv: -kv[1])]
    ops += [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])]
    idle: Dict[str, float] = {}
    edge = t.window_us[0]
    for a, b in t.busy_intervals() + [(t.window_us[1], t.window_us[1])]:
        if a > edge:
            label = _span_at(t.spans, edge)
            idle[label] = idle.get(label, 0.0) + (a - edge) / 1e6
        edge = max(edge, b)
    gaps = [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])]
    return {"device_ops": ops[:10], "idle_gaps": gaps[:10]}
