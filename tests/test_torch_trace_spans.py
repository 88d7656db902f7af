"""The port's trace instrumentation: the trainer loop's host spans
(``train_lib.span`` in ``bert.train`` and the step), the step's phase marks
(``train_lib.PhaseMarks``, ``csrc/mark.cu``) and the benchmark's readers
that name both; and the loop's log, closed with every row written when
``on_step`` raises.  This file imports no JAX, so its card tests run beside
the card: ``python -m pytest -m gpu tests/test_torch_trace_spans.py -q``.
"""
import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpujob_torch.kernels import build
from tpujob_torch.workloads import bert as tbert
from tpujob_torch.workloads import distributed
from tpujob_torch.workloads import gpt as tgpt
from tpujob_torch.workloads import train_lib

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--hidden", "32", "--layers", "1", "--heads", "2", "--intermediate",
        "64", "--vocab", "97", "--seq-len", "16", "--batch-size", "2",
        "--log-interval", "1", "--checkpoint-interval", "0", "--device",
        "cpu"]
LOOP = ("tpujob.feed", "tpujob.step", "tpujob.log")


def _train(tmp_path, steps, accum=1, on_step=None):
    """A tiny GPT through ``bert.train`` on the CPU, a fresh batch a call
    from a provider."""
    args = tgpt.build_parser().parse_args(
        TINY + ["--steps", str(steps), "--grad-accum", str(accum), "--dir",
                str(tmp_path)])
    dev = torch.device("cpu")
    pe = distributed.initialize(device=dev)
    model = tgpt.build_model(args, dev)

    def provider(step):
        return (np.random.default_rng(step).integers(0, 97, (2, 16)),)

    return tbert.train(args, pe, model, lambda net: tgpt.lm_loss(net),
                       train_lib.put_batch(provider(0), dev), tag="t",
                       batch_provider=provider, on_step=on_step)


@pytest.mark.parametrize("accum", [1, 2])
def test_loop_spans_once_a_call_nested(accum, tmp_path):
    """Under a CPU-only profiler each call records ``tpujob.feed``,
    ``tpujob.step`` holding ``tpujob.step.eager``, and ``tpujob.log``, in
    that order."""
    steps = 4
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train(tmp_path, steps, accum)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.name.startswith("tpujob."))
    outer = [n for _, _, n in spans if n != "tpujob.step.eager"]
    assert outer == list(LOOP) * steps
    steps_ = [(a, b) for a, b, n in spans if n == "tpujob.step"]
    eager = [(a, b) for a, b, n in spans if n == "tpujob.step.eager"]
    assert len(eager) == steps
    for (a, b), (c, d) in zip(steps_, eager):
        assert a <= c and d <= b
    loop = [(a, b) for a, b, n in spans if n in LOOP]
    assert all(b <= c for (_, b), (c, _) in zip(loop, loop[1:]))


@pytest.mark.parametrize("profiling", [False, True])
def test_span_enters_record_function_only_under_a_profiler(profiling,
                                                           monkeypatch):
    entered = []
    real = torch.autograd.profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    if profiling:
        with profile(activities=[ProfilerActivity.CPU]):
            with train_lib.span("tpujob.step", 3):
                pass
    else:
        with train_lib.span("tpujob.step", 3):
            pass
    assert entered == (["tpujob.step"] if profiling else [])


@pytest.mark.parametrize("phase", train_lib.PhaseMarks.PHASES)
def test_a_mark_is_a_no_op_on_the_cpu(phase, monkeypatch):
    def refuse(stem):
        raise AssertionError(f"built {stem} for a mark on the CPU")

    monkeypatch.setattr(build, "load", refuse)
    marks = train_lib.PhaseMarks("cpu")
    marks(phase)
    assert marks._word is None


@pytest.mark.parametrize("accum,calls", [
    (1, [["begin", "forward", "backward", "update"]] * 2),
    (2, [["begin", "forward", "backward", "fold"],
         ["begin", "forward", "backward", "fold", "update"]]),
])
def test_the_step_marks_its_phases_in_order(accum, calls, monkeypatch):
    seen = []

    class Recording:
        def __init__(self, device):
            assert torch.device(device).type == "cpu"

        def __call__(self, phase):
            seen.append(phase)

    monkeypatch.setattr(train_lib, "PhaseMarks", Recording)
    w = torch.nn.Parameter(torch.ones(2, 3))  # in adamw's first group
    opt = train_lib.adamw([w], 0.1)
    step = train_lib.make_train_step(lambda b: (w * b[0]).sum(), opt,
                                     lambda c: 0.1,
                                     train_lib.with_grad_accum([w], accum))
    state, got = {"step": 0}, []
    for _ in calls:
        seen.clear()
        state, _ = step(state, (torch.arange(3.0),))
        got.append(list(seen))
    assert got == calls


def _names(path):
    """The string constants of a Python file that start with ``tpujob``."""
    return {n.value for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and n.value.startswith("tpujob")}


READERS = sorted((ROOT / "portbench" / "metrics").glob("*.py"))
SOURCES = [ROOT / "tpujob_torch" / "workloads" / f for f in
           ("train_lib.py", "bert.py")]


def test_the_readers_name_the_spans_and_marks_the_program_emits():
    """``portbench/metrics`` names the port's spans and marks as text (it
    imports nothing of the port): each name must be one the port emits."""
    named = set().union(*(_names(p) for p in READERS))
    emitted = set()
    for path in SOURCES:
        emitted |= set(re.findall(r'span\(\s*"(tpujob\.[\w.]+)"',
                                  path.read_text()))
    assert set(LOOP) | {"tpujob.step.eager", "tpujob.step.inputs",
                        "tpujob.step.launch"} <= emitted
    spans = {n for n in named if n.startswith("tpujob.")}
    assert {"tpujob.feed", "tpujob.step"} <= spans
    assert spans - {"tpujob."} <= emitted
    marks = {n for n in named if n.startswith("tpujob_mark")}
    assert marks == {f"tpujob_mark_{p}" for p in train_lib.PhaseMarks.PHASES}
    source = (ROOT / "tpujob_torch" / "csrc" / "mark.cu").read_text()
    for i, phase in enumerate(train_lib.PhaseMarks.PHASES):
        assert f"TPUJOB_MARK({phase}, {i})" in source
        assert f"case {i}: tpujob_mark_{phase}<<<" in source
    assert named == spans | marks


@pytest.mark.parametrize("k", [0, 2])
def test_on_step_raising_leaves_every_row_written_and_the_log_closed(
        k, tmp_path, monkeypatch):
    closed = []

    class Writer(train_lib.SummaryWriter):
        def close(self):
            closed.append(self._f is not None)
            super().close()

    class Stop(Exception):
        pass

    def on_step(i):
        if i == k:
            raise Stop

    monkeypatch.setattr(train_lib, "SummaryWriter", Writer)
    with pytest.raises(Stop):
        _train(tmp_path, 6, on_step=on_step)
    assert closed == [True]
    rows = [json.loads(line) for line in
            (tmp_path / "scalars.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if r["tag"] == "loss"] == \
        list(range(k + 1))


@pytest.mark.gpu
@pytest.mark.parametrize("accum", [1, 2])
def test_a_replayed_step_carries_its_marks_in_order(accum, tmp_path):
    """On the card the captured step's replay runs the marks in phase
    order, one ``begin`` a ``tpujob.step.launch`` span.  (That each
    ``begin`` starts after its launch span is read from the benchmark's
    traced runs, where the launch leads by a tenth of a millisecond or
    more: a replay this small starts within the error of the trace's
    alignment of the host's clock to the card's.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs)")
    dev = torch.device("cuda")
    torch.manual_seed(0)
    lin = torch.nn.Linear(64, 64).to(dev)
    opt = train_lib.adamw(lin.parameters(), 1e-3)
    step = train_lib.make_train_step(
        lambda b: lin(b[0]).square().mean(), opt, lambda c: 1e-3,
        train_lib.with_grad_accum(lin.parameters(), accum))
    x = (torch.randn(8, 64, device=dev),)
    state = {"step": 0}
    for _ in range(2 * accum):  # the eager group, then the captures
        state, _ = step(state, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2 * accum):
            state, _ = step(state, x)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    marks = sorted((e["ts"], e["name"]) for e in events
                   if e.get("cat") == "kernel"
                   and e["name"].startswith("tpujob_mark_"))
    one = ["begin", "forward", "backward", "update"] if accum == 1 else \
        ["begin", "forward", "backward", "fold"] * (accum - 1) + \
        ["begin", "forward", "backward", "fold", "update"]
    assert [n for _, n in marks] == [f"tpujob_mark_{p}" for p in one] * 2
    launches = [e for e in events if e.get("cat") == "user_annotation"
                and e["name"] == "tpujob.step.launch"]
    assert len(launches) == 2 * accum
