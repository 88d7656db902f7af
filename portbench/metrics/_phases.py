"""What the phase and idle readers share: the program's phase marks and
loop spans by name, and the two splits that read them.

The port launches a one-thread kernel at each phase boundary of its train
step (``tpujob_mark_<boundary>``; a captured step's graph holds them, so a
replay carries them), and puts the loop's host work in ``record_function``
spans named ``tpujob.*``.  The names are written out here: nothing of the
port is imported.  Not a metric of its own: ``run.py`` reads only the
readers that ``BENCHMARK.json`` names.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

BEGIN, FORWARD, BACKWARD, FOLD, UPDATE = (
    "tpujob_mark_begin", "tpujob_mark_forward", "tpujob_mark_backward",
    "tpujob_mark_fold", "tpujob_mark_update")
MARKS = (BEGIN, FORWARD, BACKWARD, FOLD, UPDATE)
# (the mark before a kernel, the mark after it) -> the kernel's phase;
# any other pair (after the update or the fold, before the next begin) is
# outside the step's phases
PHASES = {(BEGIN, FORWARD): "forward", (FORWARD, BACKWARD): "backward",
          (BACKWARD, FOLD): "fold", (BACKWARD, UPDATE): "optimizer",
          (FOLD, UPDATE): "optimizer"}
OUTSIDE = "outside"

SPANS = "tpujob."
FEED = "tpujob.feed"
STEP = "tpujob.step"  # and its children, tpujob.step.<part>


def kernel_ms_by_phase(t) -> Optional[Dict[str, float]]:
    """Device ms a call of the window's kernels by phase (``PHASES``'s
    values and ``OUTSIDE``; the marks themselves are outside): a kernel
    belongs to the phase of the marks that start last before it and first
    after it.  None where the window holds no mark."""
    marks = sorted((s, n) for n, s, _ in t.kernels if n in MARKS)
    if not marks:
        return None
    starts = [s for s, _ in marks]
    out: Dict[str, float] = {}
    for name, s, d in t.kernels:
        phase = OUTSIDE
        if name not in MARKS:
            j = bisect.bisect_right(starts, s)
            if 0 < j < len(marks):
                phase = PHASES.get((marks[j - 1][1], marks[j][1]), OUTSIDE)
        out[phase] = out.get(phase, 0.0) + d / 1e3 / t.calls
    return out


def phase_ms(t, phase: str) -> Optional[float]:
    """``phase``'s device ms a call; None where the window holds no mark
    that closes it (no mark at all, or a step without that phase)."""
    closing = {b for (_, b), p in PHASES.items() if p == phase}
    if not any(n in closing for n, _, _ in t.kernels):
        return None
    return kernel_ms_by_phase(t).get(phase, 0.0)


def _innermost(spans: List[Tuple[float, float, str]]
               ) -> List[Tuple[float, float, Optional[str]]]:
    """The window cut at every span's edges: (from, to, the innermost span
    open there, or None)."""
    edges = sorted({x for a, b, _ in spans for x in (a, b)})
    out = []
    for lo, hi in zip(edges, edges[1:]):
        mid = (lo + hi) / 2
        open_ = [(a, -b, n) for a, b, n in spans if a <= mid < b]
        out.append((lo, hi, max(open_)[2] if open_ else None))
    return out


def idle_ms_by_span(t) -> Optional[Dict[Optional[str], float]]:
    """Device-idle ms a call (the window's time outside the device
    operations' busy intervals) by the innermost ``tpujob.*`` span open at
    each instant (None: no such span).  None where the trace holds no
    device operation or no ``tpujob.*`` span."""
    spans = [(s, s + d, n) for n, s, d in t.spans if n.startswith(SPANS)]
    if not spans or not t.ops:
        return None
    lo, hi = t.window_us
    gaps, edge = [], lo
    for a, b in t.busy_intervals() + [(hi, hi)]:
        if a > edge:
            gaps.append((edge, min(a, hi)))
        edge = max(edge, b)
    segments = _innermost(spans)
    out: Dict[Optional[str], float] = {}
    k = 0
    for a, b in gaps:
        while k < len(segments) and segments[k][1] <= a:
            k += 1
        covered = a
        j = k
        while j < len(segments) and segments[j][0] < b:
            s0, s1, name = segments[j]
            x0, x1 = max(a, s0), min(b, s1)
            if x1 > x0:
                if x0 > covered:  # before the segment: no span open
                    out[None] = out.get(None, 0.0) + x0 - covered
                out[name] = out.get(name, 0.0) + x1 - x0
                covered = x1
            j += 1
        if b > covered:
            out[None] = out.get(None, 0.0) + b - covered
    return {n: us / 1e3 / t.calls for n, us in out.items()}


def is_step(name: Optional[str]) -> bool:
    return name is not None and (name == STEP or name.startswith(STEP + "."))
