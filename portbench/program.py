"""The system under test: the port, trained through its own trainer loop.

One call of ``tpujob_torch.workloads.bert.train`` (what ``gpt.run`` and
``bert.run`` call) does the whole run.  The model comes from the
objective's port module (``build_parser`` / ``build_model``) with the
configuration's sizes as flags, ``--attention flash``, bf16 compute; the
benchmark's weights are copied into it; a ``batch_provider`` serves the
cell's traffic, one fresh batch a call, which the loop copies to the
card (``train_lib.put_batch``) and feeds its captured step.  ``--log-interval
1`` makes the loop log every call's loss to its ``scalars.jsonl``, which
is where the check reads the losses.

The loop runs a fixed ``--steps``; the window is ended from its
``on_step`` hook: the first ``setup_calls`` calls are set-up (the eager
call, the captures, and the check's calls), then the window runs for
``seconds`` (or, traced, for ``trace_calls`` calls), and the hook
synchronises the card and raises ``StopWindow``.  A CUDA event is
recorded at every call's end from the last set-up call on, so each step
interval is the device's time from one call's end to the next.

The check's readings of the program are taken as the run goes: the first
update's gradient from AdamW's first moment right after that update (a
global optimizer step hook), the change of every leaf after the check's
updates from ``on_step`` (the first weights drawn again, a group at a
time).
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import time
from typing import Dict, List, Optional

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from portbench import check, models, roofline, trace, weights
from portbench.traffic import Traffic


class StopWindow(Exception):
    """Raised from the loop's ``on_step`` hook to end the window."""


@dataclasses.dataclass
class Run:
    readings: check.Readings
    calls: int                   # train-step calls in the window
    window_s: float
    step_ms: List[float]         # every step interval of the window
    setup_s: float
    peak_bytes: int
    window_losses: List[float]   # the window's logged losses
    phases: Dict[str, float]     # set-up: seconds from process start to each
    summary: Optional[trace.Summary] = None


def port_flags(cfg: dict, spec: dict, seed: int, log_dir: str,
               device: str) -> List[str]:
    """The architecture's flags of its sizes, then the run's."""
    opt, accum = spec["optimizer"], spec["grad_accum"]
    flags = [
        "--batch-size", spec["batch_size"], "--grad-accum", accum,
        "--steps", opt["total_updates"] * accum, "--lr", opt["lr"],
        "--lr-schedule", opt["schedule"],
        "--warmup-steps", opt["warmup_updates"] * accum,
        "--seed", seed % 2 ** 63, "--attention", "flash",
        "--log-interval", 1, "--checkpoint-interval", 0,
        "--dir", log_dir, "--device", device,
        "--bf16" if cfg["precision"]["compute"] == "bfloat16" else "--no-bf16",
    ]
    if not cfg["remat"]:
        flags.append("--no-remat")
    return models.of(cfg).port_flags(cfg["model"]) + [str(f) for f in flags]


class _Spans:
    """The benchmark's host spans, recorded only while the profiler runs."""

    def __init__(self):
        self.on = False
        self._open: List = []

    def enter(self, name: str) -> None:
        if self.on:
            rf = torch.autograd.profiler.record_function(name)
            rf.__enter__()
            self._open.append(rf)

    def exit(self) -> None:
        if self._open:
            self._open.pop().__exit__(None, None, None)


def logged_losses(log_dir: str) -> Dict[int, float]:
    path = os.path.join(log_dir, "scalars.jsonl")
    out = {}
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            if row["tag"] == "loss":
                out[int(row["step"])] = float(row["value"])
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg: dict, spec: dict, seed: int, seconds: float, traced: bool,
        device: str, log_dir: str, proc_start: float) -> Run:
    objective = importlib.import_module(f"portbench.objectives.{cfg['objective']}")
    if objective.CAUSAL != cfg["model"]["causal"]:
        raise ValueError(f"objective {cfg['objective']} and the model's "
                         "causal switch disagree")
    from tpujob_torch.workloads import bert, distributed

    module = objective.module
    arch = models.of(cfg)
    model_cfg = cfg["model"]
    layout = arch.groups(model_cfg)
    setup_calls, ccalls = spec["setup_calls"], check.check_calls(spec)
    accum = spec["grad_accum"]
    if ccalls > setup_calls or setup_calls % accum or spec["trace_calls"] % accum:
        raise ValueError("setup_calls must hold the check's calls, and set-up "
                         "and trace whole accumulation groups")
    os.makedirs(log_dir, exist_ok=True)
    scalars = os.path.join(log_dir, "scalars.jsonl")
    if os.path.exists(scalars):
        os.remove(scalars)

    args = module.build_parser().parse_args(
        port_flags(cfg, spec, seed, log_dir, device))
    dev = distributed.local_device(args.device)
    pe = distributed.initialize(device=dev)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    phases = {"imports": time.time() - proc_start}
    model = module.build_model(args, dev)
    _sync(dev)
    phases["port model built"] = time.time() - proc_start
    params = dict(model.named_parameters())
    weights.load_into(params, layout, model_cfg["init_std"], seed)
    _sync(dev)
    phases["weights drawn"] = time.time() - proc_start
    name_of = {id(p): n for n, p in params.items()}
    traffic = Traffic(spec, model_cfg["vocab"], seed)
    spans = _Spans()
    st = {"grad": None, "change": None, "events": [], "t0": None, "t1": None,
          "setup_s": None, "last": None, "prof": None, "host_marks": []}

    def grad_hook(opt, _args, _kwargs):
        # the first update only, never inside a capture (which runs no
        # kernel and would record a synchronisation)
        if st["grad"] is not None or (
                on_card and torch.cuda.is_current_stream_capturing()):
            return
        norm = {}
        for group in opt.param_groups:
            b1 = group["betas"][0]
            for p in group["params"]:
                moment = opt.state.get(p, {}).get("exp_avg")
                norm[name_of[id(p)]] = (0.0 if moment is None else  # no update
                                        float(torch.linalg.vector_norm(moment))
                                        / (1 - b1))
        st["grad"] = norm

    def provider(step: int):
        spans.enter("portbench.traffic")
        try:
            return traffic.batch(step)
        finally:
            spans.exit()

    def change_readings():
        # a leaf at a time: no second copy of the weights on the card
        norm = {}
        with torch.no_grad():
            for n, p0 in weights.all_values(layout, model_cfg["init_std"],
                                            seed, dev):
                norm[n] = float(torch.linalg.vector_norm(params[n].detach() - p0))
        st["change"] = norm

    def mark():
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            st["events"].append(ev)
        else:
            st["host_marks"].append(time.perf_counter())

    def on_step(i: int) -> None:
        spans.enter("portbench.on_step")
        if i == 0:
            phases["first call"] = time.time() - proc_start
        if i == ccalls - 1:
            change_readings()
        if i >= setup_calls - 1:
            mark()
        if i == setup_calls - 1:
            _sync(dev)
            st["t0"] = time.perf_counter()
            st["setup_s"] = phases["set-up calls"] = time.time() - proc_start
            if traced:
                spans.exit()
                acts = [torch.profiler.ProfilerActivity.CPU]
                if on_card:
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                st["prof"] = torch.profiler.profile(activities=acts)
                st["prof"].start()
                spans.on = True
                spans.enter(trace.WINDOW_SPAN)
                spans.enter("portbench.on_step")
        elif i >= setup_calls:
            n = i - setup_calls + 1
            done = (n >= spec["trace_calls"] if traced
                    else time.perf_counter() - st["t0"] >= seconds)
            if done:
                spans.exit()
                _sync(dev)
                st["t1"] = time.perf_counter()
                st["last"] = i
                spans.exit()  # the window
                spans.on = False
                if traced:
                    st["prof"].stop()
                raise StopWindow
        spans.exit()

    handle = register_optimizer_step_post_hook(grad_hook)
    try:
        bert.train(args, pe, model, objective.loss_of(cfg),
                   check.to_device(traffic.batch(0), dev), tag="portbench",
                   batch_provider=provider, on_step=on_step)
        raise RuntimeError(f"bert.train ended its {args.steps} steps "
                           "before the window did")
    except StopWindow:
        pass
    finally:
        handle.remove()
        while spans._open:
            spans.exit()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if on_card:
        ev = st["events"]
        step_ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
    else:
        hm = st["host_marks"]
        step_ms = [1e3 * (b - a) for a, b in zip(hm, hm[1:])]
    calls = st["last"] - setup_calls + 1
    summary = None
    if traced:
        path = os.path.join(log_dir, "trace.json")
        st["prof"].export_chrome_trace(path)
        st["prof"] = None
        elem = 2 if cfg["precision"]["compute"] == "bfloat16" else 4
        summary = trace.load(
            path, calls, arch.counts(model_cfg, spec["batch_size"],
                                     spec["seq_len"], cfg["remat"], elem),
            roofline.H100_BF16_FLOPS if on_card else None)
        os.remove(path)
    losses = logged_losses(log_dir)
    missing = [c for c in range(ccalls) if c not in losses]
    if missing or st["grad"] is None or st["change"] is None:
        raise RuntimeError(f"the run left no reading: losses of calls "
                           f"{missing} missing, first gradient "
                           f"{st['grad'] is not None}, change "
                           f"{st['change'] is not None}")
    readings = check.Readings([losses[c] for c in range(ccalls)],
                              st["grad"], st["change"])
    window_losses = [v for c, v in losses.items() if c >= setup_calls]
    return Run(readings, calls, st["t1"] - st["t0"], step_ms, st["setup_s"],
               peak, window_losses, phases, summary)
