"""Training core: the port of ``tpujob/workloads/train_lib.py``.

- ``SummaryWriter``: the same ``scalars.jsonl`` as the JAX package.
- ``TrainTelemetry``: the step loop's smoothed samples/s and the progress
  heartbeat the operator's watchdog reads.
- ``lecun_normal_``: flax's default kernel init, for every model.
- ``sgd``: ``torch.optim.SGD`` with momentum and no dampening, which is
  optax.sgd's trace.
- ``adamw``: ``torch.optim.AdamW`` with optax's defaults (b1 .9, b2 .999,
  eps 1e-8, weight decay .01) and its mask: decay on tensors with ndim >= 2
  only; on the card its update is one kernel a group (``optim.AdamW``).
- ``make_lr_schedule``: optax's warmup / cosine / constant values, evaluated
  at the optimizer's update count BEFORE the update (optax's convention).
- ``put_batch``: a step's host arrays on the device.
- ``make_train_step``: forward, backward, one optimizer update (the
  counterpart of ``_step_body``), or with the ``GradAccum`` that
  ``with_grad_accum`` gives one update every ``every`` mini-steps
  (optax.MultiSteps); the loss it returns is the global batch's mean.
  Its ``value_and_grad_fn`` takes a schedule's fused forward and backward
  (the pipeline's) in place of the loss's backward.
  On one card it is the compiled step: the first call runs eagerly (it
  creates the optimizer's moments and picks the libraries' algorithms),
  the next ones replay a CUDA graph of the whole step (the counterpart of
  the JAX trainers' AOT ``compile()``); ``step_mode`` is the rule.
- ``make_multi_step``: k updates in one call (the ``lax.scan``), k steps
  in one CUDA graph on one card; ``init_state``: the state dict.
- ``data_parallel``: the model in ``DistributedDataParallel`` over the
  ranks that hold the same parameters (the gradient all-reduce that jit
  inserts in the JAX package; an FSDP model reduces its own),
  ``global_mean`` / ``global_sum`` over the ranks that hold distinct
  tokens, and ``make_eval_step`` (metric sums over the global batch).
- ``Checkpointer``: step-numbered ``torch.save`` checkpoints with the same
  ``latest_step``/``restore``/``restore_latest``/``max_to_keep`` contract;
  process 0 writes, every process agrees on the latest step; a sharded
  state (tensor parallel, FSDP) is written whole and sliced again on
  restore, so it resumes at any layout; a pipeline's stages are gathered
  to one file the same way.
- ``Profiler``, ``add_profile_flags``, ``profiler_from_args``: the
  ``--profile-*`` surface on ``torch.profiler`` (a Chrome trace where the
  JAX package writes an xplane one).
- ``span``: a host range in that trace (``tpujob.*``), entered only while
  a profiler runs; ``PhaseMarks``: the step's phase boundaries on the card,
  one tiny kernel each, which a captured step's replay carries.
"""
from __future__ import annotations

import collections
import contextlib
import json
import logging
import math
import os
import shutil
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist
from torch.distributed.tensor import DTensor
from torch.nn.parallel import DistributedDataParallel

from tpujob_torch.kernels import build
from tpujob_torch.workloads import distributed as dist
from tpujob_torch.workloads import optim


class SummaryWriter:
    """tensorboardX-shaped scalar writer; one JSONL file per run, only
    process 0 writes.

    A value on the card is not read at once (a read would wait for every
    step queued before it): it is copied to pinned host memory behind the
    step that made it, and its row is written, in order, once the copy
    has landed (at a later ``add_scalar`` or at ``close``)."""

    def __init__(self, logdir: str, enabled: Optional[bool] = None):
        self.logdir = logdir
        if enabled is None:
            enabled = dist.process_env().process_id == 0
        self.enabled = enabled
        self._f = None
        self._pending: collections.deque = collections.deque()
        if enabled:
            os.makedirs(logdir, exist_ok=True)
            self._f = open(os.path.join(logdir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int) -> None:
        if not self._f:
            return
        row = {"tag": tag, "value": value, "step": int(step),
               "wall_time": time.time()}
        landed = None
        if isinstance(value, torch.Tensor) and value.is_cuda:
            host = torch.empty_like(value, device="cpu", pin_memory=True)
            row["value"] = host.copy_(value.detach(), non_blocking=True)
            landed = torch.cuda.Event()
            landed.record()
        self._pending.append((row, landed))
        self._write(wait=False)

    def _write(self, wait: bool) -> None:
        while self._pending:
            row, landed = self._pending[0]
            if landed is not None and not (wait or landed.query()):
                break
            if landed is not None:
                landed.synchronize()
            self._f.write(json.dumps(dict(row, value=float(row["value"])))
                          + "\n")
            self._pending.popleft()
        self._f.flush()

    def close(self) -> None:
        if self._f:
            self._write(wait=True)
            self._f.close()
            self._f = None


class Profiler:
    """``--profile-dir`` hook: traces ``num_steps`` steady-state steps with
    ``torch.profiler`` and writes one Chrome trace
    (``<profile_dir>/trace_steps<a>-<b>.pt.trace.json``, for Perfetto or
    ``chrome://tracing``).  CPU activity (the host's operators and the
    loop's ``span``s), and CUDA activity too when the model is on the card
    (its kernels, the step's ``PhaseMarks`` among them).

    Skips the first ``start_step`` steps (allocator and kernel-build
    warm-up); only process 0 traces.  Call ``step(i)`` at the top of each
    loop iteration and ``close()`` from ``finally``: one window a run.
    ``overhead_s`` is the time spent stopping the trace and writing it, for
    callers to leave out of their clock."""

    def __init__(self, profile_dir: Optional[str], start_step: int = 2,
                 num_steps: int = 3, enabled: Optional[bool] = None,
                 device=None):
        if enabled is None:
            enabled = dist.process_env().process_id == 0
        self.profile_dir = profile_dir
        self.start_step = start_step
        self.stop_step = start_step + max(1, num_steps)
        self.enabled = bool(profile_dir) and enabled
        on_card = device is not None and torch.device(device).type == "cuda"
        self._activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            self._activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = None
        self.path: Optional[str] = None
        self.overhead_s = 0.0

    def step(self, step: int, block_on=None) -> None:
        """Call at each loop iteration's top; ``block_on`` is the previous
        step's output: the card runs behind the host, so the window waits
        for the traced steps to finish before it stops."""
        if not self.enabled:
            return
        if self._prof is None and self.start_step <= step < self.stop_step:
            self._prof = torch.profiler.profile(activities=self._activities)
            self._prof.start()
        elif self._prof is not None and step >= self.stop_step:
            self._finish(block_on)

    def close(self, block_on=None) -> None:
        """Stop a window still open (a short run, or an exception inside
        the window): the profiler is process-wide."""
        if self._prof is not None:
            self._finish(block_on)

    def _finish(self, block_on=None) -> None:
        prof, self._prof = self._prof, None
        self.enabled = False  # one trace window per run
        try:
            # waiting for the traced steps is training time, not overhead
            if isinstance(block_on, torch.Tensor) and block_on.is_cuda:
                torch.cuda.synchronize(block_on.device)
        finally:
            t0 = time.perf_counter()
            try:
                self._write(prof)
            except (RuntimeError, OSError) as e:
                # never let trace teardown kill training
                logging.getLogger("tpujob_torch.workloads").warning(
                    "profiler trace not written: %s", e)
            self.overhead_s += time.perf_counter() - t0

    def _write(self, prof) -> None:
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        self.path = os.path.join(
            self.profile_dir, f"trace_steps{self.start_step}-"
                              f"{self.stop_step - 1}.pt.trace.json")
        prof.export_chrome_trace(self.path)


class TrainTelemetry:
    """Step-loop telemetry: smoothed samples/s and the progress heartbeat
    (``tpujob.dev/progress``) that the operator's telemetry plane and its
    Stalled-job watchdog read.

    Call ``step`` once a loop iteration and ``checkpointed`` after each
    durable save.  Only process 0 publishes: the controller reads one
    heartbeat a job.  With no reporter (local runs, tests) this is
    throughput bookkeeping only."""

    def __init__(self, reporter: Optional["dist.ProgressReporter"] = None,
                 enabled: Optional[bool] = None, ema: float = 0.3,
                 clock: Callable[[], float] = time.monotonic):
        if enabled is None:
            enabled = dist.process_env().process_id == 0
        self.reporter = reporter if enabled else None
        self._ema = ema
        self._clock = clock
        self.samples_per_sec: Optional[float] = None
        self.step_count = 0
        self.checkpoint_step: Optional[int] = None
        self.resize_generation = 0
        self._last_t: Optional[float] = None

    @classmethod
    def from_env(cls, interval_s: float = 10.0) -> "TrainTelemetry":
        """The in-cluster construction: process 0 publishes through the
        pod-identity env (no publisher anywhere else)."""
        pe = dist.process_env()
        publish = (dist.progress_publisher_from_env()
                   if pe.process_id == 0 else None)
        return cls(reporter=dist.ProgressReporter(publish,
                                                  interval_s=interval_s),
                   enabled=pe.process_id == 0)

    def step(self, step: int, samples: int = 0,
             resize_generation: Optional[int] = None) -> None:
        """One loop iteration: fold ``samples`` into the throughput EMA and
        heartbeat (rate-limited inside the reporter)."""
        now = self._clock()
        if self._last_t is not None and samples > 0:
            dt = now - self._last_t
            if dt > 0:
                inst = samples / dt
                self.samples_per_sec = (
                    inst if self.samples_per_sec is None
                    else self._ema * inst + (1 - self._ema) * self.samples_per_sec)
        self._last_t = now
        self.step_count = step
        if resize_generation is not None:
            self.resize_generation = resize_generation
        if self.reporter is not None:
            self.reporter.report(step, self.samples_per_sec,
                                 self.checkpoint_step, self.resize_generation)

    def checkpointed(self, step: int) -> None:
        """A durable checkpoint landed: publish now (the watchdog's
        checkpoint-age metric reads it)."""
        self.checkpoint_step = step
        if self.reporter is not None:
            self.reporter.report(self.step_count, self.samples_per_sec,
                                 step, self.resize_generation, force=True)

    def close(self) -> None:
        """A last forced heartbeat, so the controller sees the last step."""
        if self.reporter is not None and self.step_count:
            self.reporter.report(self.step_count, self.samples_per_sec,
                                 self.checkpoint_step,
                                 self.resize_generation, force=True)


_profiling = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def span(name: str, step: Optional[int] = None):
    """A ``record_function`` range ``name`` (with ``step`` as its args)
    while a profiler runs, else a context that does nothing: entering a
    ``record_function`` with no profiler costs about 13 us on a CPU core,
    the check a fraction of one.  The loop's spans (``bert.train``):
    ``tpujob.feed``, ``tpujob.step`` (``.inputs`` and ``.launch`` on the
    captured step, ``.eager`` otherwise), ``tpujob.log``,
    ``tpujob.checkpoint``."""
    if not _profiling():
        return _NO_SPAN
    return torch.autograd.profiler.record_function(
        name, None if step is None else str(step))


class PhaseMarks:
    """The train step's phase boundaries on the card, for a trace to split
    each call's device time by.  ``marks(phase)`` launches the one-thread
    kernel ``tpujob_mark_<phase>`` (``csrc/mark.cu``) on the current
    stream; each writes one device word, made at the first mark, so a
    capture records it as a kernel node and allocates nothing in the
    graph's pool.  A step marks ``begin``, then ``forward`` after the loss,
    ``backward`` after its backward, ``fold`` after a ``GradAccum`` folded
    the grads in, and ``update`` after the optimizer's step: the kernels
    that start between two marks belong to the phase the second names.
    Inside a phase a dropless expert layer (``bert.DroplessMoE``) marks
    ``moe_in`` where its work starts and ``moe_out`` where it ends, in each
    pass.  On the CPU a no-op."""

    PHASES = ("begin", "forward", "backward", "fold", "update", "moe_in",
              "moe_out")

    def __init__(self, device):
        self.device = torch.device(device)
        self._word: Optional[torch.Tensor] = None

    def __call__(self, phase: str) -> None:
        if self.device.type != "cuda":
            return
        if self._word is None:
            self._word = torch.zeros(1, dtype=torch.int32, device=self.device)
        build.launch(f"mark_{phase}", "tpujob_mark", self.PHASES.index(phase),
                     self._word.data_ptr(),
                     torch.cuda.current_stream(self.device).cuda_stream)


def add_profile_flags(parser) -> None:
    """The shared --profile-* surface for every workload CLI."""
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler Chrome trace of "
                             "steady-state steps here")
    parser.add_argument("--profile-start-step", type=int, default=2,
                        help="first step of the trace window (skips warm-up)")
    parser.add_argument("--profile-steps", type=int, default=3,
                        help="number of steps to trace")


def profiler_from_args(args, pe, device=None) -> Profiler:
    return Profiler(
        getattr(args, "profile_dir", None),
        start_step=getattr(args, "profile_start_step", 2),
        num_steps=getattr(args, "profile_steps", 3),
        enabled=pe.process_id == 0, device=device,
    )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


_TRUNC = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's lecun_normal: a normal truncated to 2 std with variance
    1/fan_in, drawn as JAX draws it, one uniform pass through the inverse
    normal CDF (no redraws, so a billion-parameter stack takes one pass)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC
    edge = math.erf(2.0 / math.sqrt(2.0))
    w.uniform_(-edge, edge, generator=gen).erfinv_()
    w.mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


# ---------------------------------------------------------------------------
# optimizer + schedule
# ---------------------------------------------------------------------------


def _decay_mask(params):
    """(decayed, not decayed): matrices/embeddings decay; biases, LayerNorm
    scales and scalars do not."""
    decay, no_decay = [], []
    for p in params:
        (decay if p.ndim >= 2 else no_decay).append(p)
    return decay, no_decay


def sgd(params, lr: float, momentum: float) -> torch.optim.SGD:
    """optax.sgd(lr, momentum): the trace ``m = g + momentum * m`` and
    ``p -= lr * m``, which is torch's SGD with ``dampening=0`` (the first
    step's buffer is g in both)."""
    return torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0.0)


def adamw(params, lr: float, weight_decay: float = 0.01) -> torch.optim.AdamW:
    """optax.adamw(lr, weight_decay, mask=_decay_mask) as torch's AdamW:
    two param groups, decay only on >=2-D tensors.  ``lr`` is the initial
    value; a schedule sets each group's lr before every step.

    On the card the update is the port's one-pass kernel (``optim.AdamW``)
    and the optimizer is capturable: its step counts live on the card and
    each group's lr is a 0-d fp32 tensor there, which ``set_lr`` fills, so
    one captured update reads each step's lr (a float would be baked into
    the graph).  FSDP's sharded parameters (DTensors, whose step is eager
    across ranks) keep a float lr, which the kernel reads from a tensor of
    its own.  On the CPU it is torch's AdamW with a float lr, as before,
    its updates counted (``optim.count_torch``)."""
    params = list(params)
    decay, no_decay = _decay_mask(params)
    groups = [{"params": decay, "weight_decay": weight_decay},
              {"params": no_decay, "weight_decay": 0.0}]
    kw = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if not (params and params[0].is_cuda):
        opt = torch.optim.AdamW(groups, **kw)
        opt.register_step_post_hook(optim.count_torch)
        return opt
    if not isinstance(params[0], DTensor):
        for g in groups:
            g["lr"] = torch.tensor(float(lr), device=params[0].device)
    return optim.AdamW(groups, capturable=True, **kw)


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule."""
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float = 0.0
            ) -> Callable[[int], float]:
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def schedule(count):
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init * ((1 - alpha) * cosine + alpha)

    return schedule


def _join(schedules, boundaries) -> Callable[[int], float]:
    """optax.join_schedules."""

    def schedule(step):
        out = schedules[0](step)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = fn(step - boundary)
        return out

    return schedule


def make_lr_schedule(lr: float, kind: str, warmup_steps: int, total_steps: int
                     ) -> Callable[[int], float]:
    """count -> learning rate: linear warmup to ``lr`` over ``warmup_steps``,
    then constant or cosine decay to 0 at ``total_steps`` (the JAX
    package's flag surface, optax's formulas)."""
    if kind == "cosine":
        if warmup_steps <= 0:
            # no warmup: decay from peak (a forced 1-step warmup would run
            # the FIRST update at LR 0)
            return _cosine(lr, max(total_steps, 1))
        decay_steps = max(total_steps, warmup_steps + 1)
        return _join([_linear(0.0, lr, warmup_steps),
                      _cosine(lr, decay_steps - warmup_steps)],
                     [warmup_steps])
    if kind != "constant":
        raise ValueError(f"unknown lr schedule {kind!r}")
    if warmup_steps > 0:
        return _join([_linear(0.0, lr, warmup_steps), lambda count: lr],
                     [warmup_steps])
    return lambda count: lr


def set_lr(optimizer: torch.optim.Optimizer, value: float) -> None:
    """Every group's lr: a tensor lr is filled in place (on the card, a
    launch and no wait), a float one rebound."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(value)
        else:
            group["lr"] = value


def lr_on_params_device(optimizer: torch.optim.Optimizer) -> None:
    """Put tensor lrs back beside the params: ``load_state_dict`` takes
    the saved groups' lr as saved (a checkpoint restored on the CPU)."""
    for group in optimizer.param_groups:
        lr = group["lr"]
        if isinstance(lr, torch.Tensor) and group["params"]:
            group["lr"] = lr.to(group["params"][0].device)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


class GradAccum:
    """Gradient accumulation as ``optax.MultiSteps`` does it (the JAX
    package's ``with_grad_accum``): each mini-step folds its grads into a
    running mean, ``acc + (g - acc) / (n + 1)``; on the ``every``-th the
    optimizer takes one update from the mean and the mean restarts.
    Params do not change on the other mini-steps.  ``gradient_step`` counts
    updates (the schedule's and AdamW's count), ``mini_step`` the position
    inside the current group.  Its ``state_dict`` holds both and the
    running mean, so a checkpoint taken mid-accumulation resumes exactly.
    The means live in fp32 beside the params (one more copy of them)."""

    def __init__(self, params, every: int):
        self.params = list(params)
        self.every = every
        self.mini_step = 0
        self.gradient_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params]

    def fold(self, n: int) -> bool:
        """Fold the params' ``.grad`` into the mean as mini-step ``n`` of
        a group (the device's work of a mini-step, and all that a captured
        mini-step holds).  At the group's last mini-step the mean is handed
        over as ``.grad`` (no copy: it is overwritten when the next group
        starts) and True returned: the optimizer updates from it."""
        with torch.no_grad():
            for a, p in zip(self.acc, self.params):
                if p.grad is None:
                    a.sub_(a / (n + 1))  # 0 when a group starts
                elif n == 0:  # a group starts: 0 + (g - 0) / 1 is g exactly
                    a.copy_(p.grad)
                else:
                    a.add_((p.grad - a) / (n + 1))
        if n + 1 < self.every:
            return False
        for a, p in zip(self.acc, self.params):
            p.grad = a
        return True

    def advance(self) -> Optional[int]:
        """Count one mini-step on the host: the index of the update it fed
        when it ended a group (for the schedule), else None."""
        self.mini_step = (self.mini_step + 1) % self.every
        if self.mini_step:
            return None
        self.gradient_step += 1
        return self.gradient_step - 1

    def add(self) -> Optional[int]:
        """``fold`` at the current position, then ``advance``."""
        self.fold(self.mini_step)
        return self.advance()

    def state_dict(self) -> Dict[str, Any]:
        return {"mini_step": self.mini_step,
                "gradient_step": self.gradient_step,
                "acc": [a.clone() for a in self.acc]}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.mini_step = int(sd["mini_step"])
        self.gradient_step = int(sd["gradient_step"])
        with torch.no_grad():
            for a, saved in zip(self.acc, sd["acc"]):
                a.copy_(saved)


def with_grad_accum(params, every: int) -> Optional[GradAccum]:
    """Average grads over ``every`` mini-steps per update: a ``GradAccum``
    for ``make_train_step``, or None for ``every`` 1 (plain updates)."""
    if every <= 0:
        raise ValueError(f"grad accumulation must be >= 1, got {every}")
    return GradAccum(params, every) if every > 1 else None


# ---------------------------------------------------------------------------
# data parallelism across processes
# ---------------------------------------------------------------------------


def data_parallel(model: torch.nn.Module, mesh=None) -> torch.nn.Module:
    """``model`` in ``DistributedDataParallel`` over the ranks that hold
    the same parameters, else ``model`` itself.  Every rank builds the
    same weights from the seed (DDP checks and broadcasts them once); the
    grads of each backward are averaged across those ranks, which over
    equal local batches is the global batch's gradient.

    Without ``mesh`` they are the whole world.  With one they are the
    token axes' group (``distributed.TOKEN_AXES``): a tensor group's ranks
    hold different shards, whose grads must not be averaged together.  A
    model FSDP has sharded (``parallel.fully_shard_model``) is returned
    as it is: FSDP reduce-scatters its grads over fsdp and averages them
    over the replica axes itself, and a DDP around it would reduce them
    twice."""
    group = dist.token_group(mesh)
    if group is None or getattr(model, "fsdp_mesh", None) is not None:
        return model
    dev = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[dev.index] if dev.type == "cuda" else None,
        process_group=group)


def global_sum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``x`` summed over the ranks that hold distinct tokens (a new
    tensor; ``x`` itself when there is one such rank): the whole world
    without ``mesh``, the token axes' group with one (a tensor group's
    ranks hold the same rows, and are not counted twice).  Queued on the
    card under NCCL: the host does not wait."""
    group = dist.token_group(mesh)
    if group is None:
        return x
    y = x.clone()
    tdist.all_reduce(y, group=group)
    return y


def global_mean(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``x`` averaged over the ranks of ``global_sum``, in fp32 and then in
    ``x``'s dtype (one rounding of a bf16 loss, as the global mean has):
    of a per-rank mean over equal local batches, the global batch's
    mean."""
    shards = dist.token_shards(mesh)
    if shards == 1:
        return x
    return (global_sum(x.float(), mesh) / shards).to(x.dtype)


def make_eval_step(metric_fn: Callable[[Any], Tuple[torch.Tensor, ...]]):
    """``eval_step(batch) -> sums``: ``metric_fn(batch)`` (per-batch
    sums, e.g. summed loss and correct count) without grad, each summed
    over the ranks, so every process holds the global batch's sums (the
    JAX package's ``make_eval_step``)."""

    def eval_step(batch):
        with torch.no_grad():
            return tuple(global_sum(m) for m in metric_fn(batch))

    return eval_step


def step_mode(optimizer: torch.optim.Optimizer, capture: bool = True,
              scheduled: bool = False) -> str:
    """How a train step runs: ``"graph"`` (captured once, replayed) when
    the optimizer's parameters are on a CUDA card and no process group of
    more than one rank exists, else ``"eager"``.  The one owner of that
    rule.  The CPU has no graphs; across ranks DDP's all-reduce runs on
    gloo's host copies (uncapturable) or NCCL, whose capture is not
    measured yet.  ``capture=False`` forces the eager step on the card
    (to hold the graph against it).  ``scheduled``: a step whose gradient
    is a schedule across ranks (a pipeline's ``value_and_grad_fn``, host
    control flow around point-to-point exchanges) is eager; a pipeline
    runs at world > 1 anyway, so no CUDA graph is captured on it."""
    dev = optimizer.param_groups[0]["params"][0].device
    if capture and not scheduled and dev.type == "cuda" \
            and dist.group_size() == 1:
        return "graph"
    return "eager"


def _no_mark(phase: str) -> None:
    pass


def _eager_step(loss_fn, optimizer, lr_fn, accum, count: int, batch,
                vag=None, marks=_no_mark):
    """One step as the JAX package's ``_step_body`` runs it: the loss
    (detached) of ``batch`` after its backward (or ``vag(batch)``, which
    leaves the gradients in ``.grad`` itself) and, unless ``accum`` holds
    the update back, one optimizer update at ``lr_fn(update)``; and
    whether it updated.  ``marks`` (``PhaseMarks``) marks its phases."""
    optimizer.zero_grad(set_to_none=True)
    marks("begin")
    if vag is None:
        loss = loss_fn(batch)
        marks("forward")
        loss.backward()
    else:
        loss = vag(batch)  # forward and backward in one schedule
        if loss_extras(vag) is not None:
            raise ValueError(
                "value_and_grad_fn does not support loss extras (it "
                "returns the loss with no slot for extra outputs)")
    marks("backward")
    update = count
    if accum is not None:
        update = accum.add()
        marks("fold")
    if update is not None:
        set_lr(optimizer, lr_fn(update))
        optimizer.step()
        marks("update")
    return loss.detach(), update is not None


def check_baked_lr(optimizer: torch.optim.Optimizer, values) -> None:
    """Raise unless every lr in ``values`` is the float lr the optimizer
    holds: a captured step bakes a float lr in (SGD's; AdamW's lr on the
    card is a tensor that each step fills)."""
    floats = [g["lr"] for g in optimizer.param_groups
              if not isinstance(g["lr"], torch.Tensor)]
    if floats and any(v != floats[0] for v in values):
        raise ValueError(
            f"the optimizer's lr is a float, which a captured step bakes "
            f"in ({floats[0]}), but the schedule moves it: "
            f"{sorted(set(values))}")


# what the card ran, counted on the host: kernel launches by kernel and
# parameter tensors updated by each AdamW route
_COUNTS = (build.LAUNCHES, optim.UPDATES)


class _Graphs:
    """CUDA graphs of one step function, and what replaying them needs.

    Calls run eagerly on a side stream until one has updated: the first
    call, or with gradient accumulation the first group.  The optimizer
    then holds its state (AdamW's moments, SGD's momentum buffers; torch
    makes them at the first update, which a capture would record as a
    zero fill that every replay repeats), the libraries have picked their
    algorithms and the flash kernels are built.  These are counted steps,
    never extra ones (the JAX trainers' rule: no update outside the
    counted loop).  A graph is captured on that stream the first time its
    variant is needed, then replayed; every graph of one step function
    shares one memory pool (they run one after another, in the order of
    their captures).

    Inputs are static buffers: each call copies its batch into them.  A
    replay overwrites its outputs, so each call returns a copy.  An lr
    that is a float is baked into a graph: a schedule that moves it
    raises.  ``build.LAUNCHES`` and ``optim.UPDATES`` keep counting what
    the card ran: what a capture records is taken back out (the card ran
    none of it) and added again at each replay."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.device = optimizer.param_groups[0]["params"][0].device
        self.stream = None  # made by the first (eager) call
        self.graphs: Dict[Any, tuple] = {}
        self.pool = None
        self.inputs: Optional[tuple] = None
        self.updated = False

    def warm(self) -> bool:
        """Whether a graph may be captured: the static inputs exist and
        an eager update has made the optimizer's state."""
        return self.inputs is not None and self.updated

    def eager(self, fn):
        """``fn() -> (out, updated)`` on the side stream, ordered after the
        current stream's work and before what follows on it; ``out``."""
        here = torch.cuda.current_stream(self.device)
        self.stream = self.stream or torch.cuda.Stream(self.device)
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream):
            out, updated = fn()
        here.wait_stream(self.stream)
        out.record_stream(here)  # the caller reads (and frees) it there
        self.updated = self.updated or updated
        return out

    def feed(self, batch) -> tuple:
        """Copy ``batch`` into the static inputs (made at the first call)."""
        batch = tuple(batch)
        if self.inputs is None:
            self.inputs = tuple(torch.empty_like(t) for t in batch)
        if [(t.shape, t.dtype) for t in batch] != \
                [(t.shape, t.dtype) for t in self.inputs]:
            raise ValueError(
                "a captured step takes one batch shape: got "
                f"{[(tuple(t.shape), t.dtype) for t in batch]}, captured "
                f"{[(tuple(t.shape), t.dtype) for t in self.inputs]}")
        for dst, src in zip(self.inputs, batch):
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        return self.inputs

    def replay(self, key, capture: Callable[[], Any]):
        """Replay the graph ``key``, capturing ``capture()`` (whose result
        is the graph's output) first if it is new; a copy of the output."""
        if key not in self.graphs:
            if not self.warm():
                raise RuntimeError("a capture before the first update would "
                                   "replay the optimizer's state creation")
            self.optimizer.zero_grad(set_to_none=True)
            before = [dict(c) for c in _COUNTS]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                out = capture()
            self.pool = self.pool or graph.pool()
            recorded = []
            for counts, was in zip(_COUNTS, before):
                recorded.append({k: n - was.get(k, 0)
                                 for k, n in counts.items()})
                counts.clear()
                counts.update(was)
            self.graphs[key] = (graph, out, recorded)
        graph, out, recorded = self.graphs[key]
        graph.replay()
        for counts, rec in zip(_COUNTS, recorded):
            for k, n in rec.items():
                counts[k] += n
        return out.clone()


def set_loss_extras(loss_fn, values: torch.Tensor) -> None:
    """Write ``values`` (a fixed-shape tensor) into ``loss_fn.extras``, the
    loss's extra outputs (see ``make_train_step``): made at the first call,
    filled in place at every later one, so a captured step holds it as a
    static output."""
    values = values.detach()
    if getattr(loss_fn, "extras", None) is None:
        loss_fn.extras = values.clone()
    else:
        loss_fn.extras.copy_(values)


def loss_extras(loss_fn) -> Optional[torch.Tensor]:
    """A copy of the extra outputs of ``loss_fn``'s latest call, or None."""
    extras = getattr(loss_fn, "extras", None)
    return None if extras is None else extras.clone()


def make_train_step(loss_fn: Optional[Callable[[Any], torch.Tensor]],
                    optimizer: torch.optim.Optimizer,
                    lr_fn: Callable[[int], float],
                    accum: Optional[GradAccum] = None,
                    capture: bool = True, mesh=None,
                    value_and_grad_fn: Optional[Callable] = None):
    """``step(state, batch) -> (state, loss)``: value and grad of
    ``loss_fn(batch)`` (which runs the model), one AdamW update at
    ``lr_fn(update count)``, and ``state['step'] + 1``.  The update is in
    place (the parameters and moments are the state).  With ``accum`` the
    update comes on every ``accum.every``-th mini-step only, from the mean
    of the group's grads; ``state['step']`` counts mini-steps and the loss
    is each mini-step's own.

    ``step.mode`` is ``step_mode(optimizer, capture)``.  In ``"graph"``
    mode the first call (with ``accum``, the first group) is eager and
    each later one replays a captured step (with ``accum``, one graph per
    position in the group: all but the last fold the grads in, the last
    folds and updates); the losses and parameters are those of the eager
    step, bit for bit, since the same kernels run in the same order.

    Across processes ``loss_fn`` runs the DDP wrapper (``data_parallel``)
    or an FSDP model, so the grads are the ranks' mean before ``accum``
    folds them in; the returned loss is the ranks' mean too
    (``global_mean`` over ``mesh``'s token axes, or the world), the global
    batch's loss as the JAX package reports it.

    Extra outputs of the loss: besides its value, ``loss_fn`` may write
    values it computed on the way (a MoE model's aux terms) with
    ``set_loss_extras``.  They live in one buffer, made at the first call
    (eager, in either mode) and refilled by every later call, so a
    captured step writes them as static outputs and each replay leaves its
    own.  Read them with ``loss_extras(loss_fn)`` right after the step:
    any other call of ``loss_fn`` (an eval) overwrites them.

    The step marks its phases on the card (``PhaseMarks``; a captured
    graph holds the marks, so a trace of its replay splits a call into
    forward, backward, fold and update) and puts its host work in
    ``span``s: ``tpujob.step.inputs`` (the batch's copy into the static
    inputs, the lr's fill) and ``tpujob.step.launch`` (the replay) on the
    captured step, ``tpujob.step.eager`` around an eager call.

    ``value_and_grad_fn(batch) -> loss`` replaces ``loss_fn`` and its
    backward when the gradient computation is itself a schedule (a
    pipeline's fused forward and backward, which interleaves microbatches'
    backwards between other microbatches' forwards: no backward of one
    forward expresses it).  It leaves the gradients in ``.grad``, already
    averaged over the data group; the update, the ``accum`` folding and
    the ``global_mean`` of the loss are the step's own, and the step is
    eager (``step_mode``).  Like the JAX package's, it has no slot for
    extra outputs: a ``value_and_grad_fn`` that sets loss extras
    raises."""
    mode = step_mode(optimizer, capture,
                     scheduled=value_and_grad_fn is not None)
    marks = PhaseMarks(optimizer.param_groups[0]["params"][0].device)

    if mode == "eager":
        def step(state, batch):
            with span("tpujob.step.eager", state["step"]):
                loss, _ = _eager_step(loss_fn, optimizer, lr_fn, accum,
                                      state["step"], batch, value_and_grad_fn,
                                      marks)
                loss = global_mean(loss, mesh)
            return dict(state, step=state["step"] + 1), loss

        step.mode = mode
        return step

    graphs = _Graphs(optimizer)

    def captured(n: int):
        marks("begin")
        loss = loss_fn(graphs.inputs)
        marks("forward")
        loss.backward()
        marks("backward")
        update = True
        if accum is not None:
            update = accum.fold(n)
            marks("fold")
        if update:
            optimizer.step()
            marks("update")
        return loss.detach()

    def step(state, batch):
        i = state["step"]
        if not graphs.warm():
            with span("tpujob.step.eager", i):
                loss = graphs.eager(lambda: _eager_step(
                    loss_fn, optimizer, lr_fn, accum, i, batch, marks=marks))
                graphs.feed(batch)
            return dict(state, step=i + 1), loss
        n = 0 if accum is None else accum.mini_step
        update = i if accum is None else (
            accum.gradient_step if n + 1 == accum.every else None)
        with span("tpujob.step.inputs", i):
            graphs.feed(batch)
            if update is not None:
                check_baked_lr(optimizer, [lr_fn(update)])
                set_lr(optimizer, lr_fn(update))
        with span("tpujob.step.launch", i):
            loss = graphs.replay(n, lambda: captured(n))
        if accum is not None:
            accum.advance()
        return dict(state, step=i + 1), loss

    step.mode = mode
    return step


def make_multi_step(loss_fn: Callable[[Any], torch.Tensor],
                    optimizer: torch.optim.Optimizer, k: int, *,
                    lr_fn: Optional[Callable[[int], float]] = None,
                    stacked: bool = False, capture: bool = True):
    """``step(state, batch) -> (state, losses [k])``: ``k`` optimizer
    updates in one call, the counterpart of the JAX package's
    ``make_multi_step`` (``lax.scan`` over ``_step_body``).  With
    ``stacked=True`` every batch tensor carries a leading ``[k]`` dim of
    per-step microbatches; otherwise one batch serves every step.  The lr
    of update ``c`` is ``lr_fn(c)`` (the optimizer's own lr when None).

    ``step.mode`` as in ``make_train_step``: in ``"graph"`` mode the first
    call runs its k steps eagerly and each later one replays the k steps
    captured in one graph, reading each step's lr from a ``[k]`` tensor
    filled before the replay; elsewhere a loop of k eager steps."""
    if k < 1:
        raise ValueError(f"multi-step k must be >= 1, got {k}")
    if lr_fn is None:
        lr0 = float(optimizer.param_groups[0]["lr"])
        lr_fn = lambda count: lr0  # noqa: E731
    mode = step_mode(optimizer, capture)

    def microbatch(batch, j):
        return tuple(t[j] for t in batch) if stacked else tuple(batch)

    def check(batch):
        lead = batch[0].shape[0]
        if stacked and lead != k:
            raise ValueError(
                f"stacked batch carries {lead} microbatches but the "
                f"multi-step was built with k={k}")

    def loop(count, batch):
        return torch.stack([
            _eager_step(loss_fn, optimizer, lr_fn, None, count + j,
                        microbatch(batch, j))[0] for j in range(k)]), True

    if mode == "eager":
        def multi(state, batch):
            check(batch)
            losses, _ = loop(state["step"], batch)
            return dict(state, step=state["step"] + k), losses

        multi.mode = mode
        return multi

    graphs = _Graphs(optimizer)
    lrs = torch.zeros(k, dtype=torch.float32, device=graphs.device)
    filled: list = []

    def captured():
        losses = []
        for j in range(k):
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(microbatch(graphs.inputs, j))
            loss.backward()
            for group in optimizer.param_groups:
                if isinstance(group["lr"], torch.Tensor):
                    group["lr"].copy_(lrs[j])
            optimizer.step()
            losses.append(loss.detach())
        return torch.stack(losses)

    def multi(state, batch):
        check(batch)
        count = state["step"]
        if not graphs.warm():
            losses = graphs.eager(lambda: loop(count, batch))
            graphs.feed(batch)
            return dict(state, step=count + k), losses
        graphs.feed(batch)
        values = [lr_fn(count + j) for j in range(k)]
        check_baked_lr(optimizer, values)
        if values != filled:
            for j, v in enumerate(values):
                lrs[j].fill_(v)
            filled[:] = values
        losses = graphs.replay("multi", captured)
        return dict(state, step=count + k), losses

    multi.mode = mode
    return multi


def init_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               extra: Any = None) -> Dict[str, Any]:
    """``{'model', 'opt', 'step'[, 'extra']}``, the JAX package's
    ``init_state`` (``{'params', 'opt', 'step'[, 'extra']}``): the module
    holds the params, the optimizer its state, which torch creates at the
    first update (optax's init holds zeros of the same shapes), and the
    step count starts at 0.  ``extra`` carries what the train step threads
    besides the params (the JAX package's BatchNorm statistics; the
    port's modules hold theirs as buffers)."""
    state = {"model": model, "opt": optimizer, "step": 0}
    if extra is not None:
        state["extra"] = extra
    return state


def sync(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def put_batch(arrays, device) -> tuple:
    """This process's rows of a step's batch (host arrays) on ``device``:
    integer arrays (token ids, labels) as the int64 that embeddings and
    losses take, the rest (images, the MLM mask) in their own dtype."""
    return tuple(
        torch.from_numpy(np.asarray(a, dtype=np.int64)
                         if np.issubdtype(a.dtype, np.integer)
                         else np.ascontiguousarray(a)).to(device)
        for a in arrays)


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------


def _to_saveable(state: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (v.state_dict() if hasattr(v, "state_dict") else v)
            for k, v in state.items()}


def _optimizer_names(optimizer, model) -> list:
    """The parameter name of each index of ``optimizer.state_dict()``'s
    state (its groups' parameters in order)."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def _map_tensors(state: Dict[str, Any], saved: Dict[str, Any], fn
                 ) -> Dict[str, Any]:
    """``saved``, the state dicts of ``state``'s values, with every tensor
    shaped like a parameter replaced by ``fn(name, t, like)``: ``name`` is
    the parameter's and ``like`` its live counterpart in ``state``.  Those
    tensors are the model's, the optimizer's moments (not its 0-d step
    counts) and a ``GradAccum``'s running means."""
    model = state["model"]
    params = dict(model.named_parameters())
    live = model.state_dict()
    out = dict(saved)
    for k, v in state.items():
        sd = saved[k]
        if k == "model":
            out[k] = {n: fn(n, t, live[n]) for n, t in sd.items()}
        elif isinstance(v, torch.optim.Optimizer):
            names = _optimizer_names(v, model)
            out[k] = dict(sd, state={
                i: {key: (fn(names[i], t, params[names[i]])
                          if torch.is_tensor(t) and t.ndim else t)
                    for key, t in entry.items()}
                for i, entry in sd["state"].items()})
        elif isinstance(v, GradAccum):
            out[k] = dict(sd, acc=[fn(n, a, params[n])
                                   for n, a in zip(params, sd["acc"])])
    return out


def _whole_names(model_sd: Dict[str, torch.Tensor]) -> list:
    """The parameter name of each index of a one-process ``adamw``'s state
    dict over the whole model whose state dict is ``model_sd``: its decay
    group (the >= 2-D tensors), then the rest, each in the model's
    order."""
    return ([n for n, t in model_sd.items() if t.ndim >= 2]
            + [n for n, t in model_sd.items() if t.ndim < 2])


def _named(state: Dict[str, Any], saved: Dict[str, Any]) -> Dict[str, Any]:
    """``saved`` (``state``'s state dicts) with the optimizer's entries
    and the accumulator's means keyed by parameter name, every tensor on
    the host: what a pipeline stage contributes to a whole checkpoint."""
    model = state["model"]
    out = {}
    for k, v in state.items():
        sd = saved[k]
        if isinstance(v, torch.optim.Optimizer):
            names = _optimizer_names(v, model)
            sd = dict(sd, state={names[i]: e for i, e in sd["state"].items()})
        elif isinstance(v, GradAccum):
            sd = dict(sd, acc=dict(zip(dict(model.named_parameters()),
                                       sd["acc"])))
        out[k] = _to_host(sd)
    return out


def _to_host(obj):
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_host(v) for v in obj]
    return obj


def _join_stages(parts: list) -> Dict[str, Any]:
    """The one-process checkpoint from the stages' ``_named`` parts (in
    stage order): the model's parameters every stage holds (stage 0's),
    then each stage's layers in turn, which is one process's order; the
    optimizer indexed as one process's ``adamw`` (``_whole_names``)."""
    out = dict(parts[0])
    model = {n: t for n, t in parts[0]["model"].items()
             if not n.startswith("layer_")}
    for part in parts:
        model.update((n, t) for n, t in part["model"].items()
                     if n.startswith("layer_"))
    out["model"] = model
    names = _whole_names(model)
    decay = sum(t.ndim >= 2 for t in model.values())
    for k, sd in parts[0].items():
        if isinstance(sd, dict) and "param_groups" in sd:
            entries = {}
            for part in parts:
                entries.update(part[k]["state"])
            g0, g1 = sd["param_groups"]
            out[k] = dict(sd, state={i: entries[n] for i, n in
                                     enumerate(names) if n in entries},
                          param_groups=[
                              dict(g0, params=list(range(decay))),
                              dict(g1, params=list(range(decay,
                                                         len(names))))])
        elif isinstance(sd, dict) and "acc" in sd:
            acc = {}
            for part in parts:
                acc.update(part[k]["acc"])
            out[k] = dict(sd, acc=[acc[n] for n in model])
    return out


def _stage_of(like: Dict[str, Any], saved: Dict[str, Any]) -> Dict[str, Any]:
    """A one-process checkpoint cut to the stage ``like`` holds: its
    parameters, their optimizer entries reindexed as its optimizer holds
    them, their accumulated means."""
    model = like["model"]
    whole = saved["model"]
    out = dict(saved, model={n: whole[n] for n in model.state_dict()})
    for k, v in like.items():
        if isinstance(v, torch.optim.Optimizer):
            by_name = dict(zip(_whole_names(whole), range(len(whole))))
            entries = saved[k]["state"]
            live = v.state_dict()["param_groups"]
            out[k] = dict(saved[k], state={
                i: entries[by_name[n]]
                for i, n in enumerate(_optimizer_names(v, model))
                if by_name[n] in entries},
                param_groups=[dict(g, params=mine["params"]) for g, mine
                              in zip(saved[k]["param_groups"], live)])
        elif isinstance(v, GradAccum):
            acc = dict(zip(whole, saved[k]["acc"]))
            out[k] = dict(saved[k], acc=[acc[n] for n, _ in
                                         model.named_parameters()])
    return out


class Checkpointer:
    """Step-numbered save/restore for the train state.

    A state is a dict whose values are modules/optimizers (saved through
    ``state_dict``) or plain values.  Checkpoint ``N`` lives in
    ``<directory>/<N>/state.pt``, written to a temporary name and renamed,
    so a crash mid-save leaves no step that ``latest_step`` would pick.
    The newest ``max_to_keep`` steps are kept.

    Across processes (a shared directory, as the JAX package's orbax
    needs on several hosts) process 0 writes and every process waits for
    it at a barrier; ``latest_step`` is process 0's answer, so no process
    resumes at another step.  A state holds the unwrapped module, never
    the DDP wrapper, so a checkpoint restores at any world size.

    A sharded state (tensor parallel, FSDP) comes with ``shards``
    (``parallel.ParamShards``): every process gathers each parameter, its
    AdamW moments and its accumulated gradient whole (``shards.full``),
    process 0 writes the one-process checkpoint, and a restore slices each
    tensor to this rank's shard again (``shards.local``), as orbax restores
    into the live sharded template in the JAX package.  So a checkpoint
    written at one layout resumes at another, one process included.

    Under pipeline parallelism (``stages``: the pipeline's process group)
    each rank holds its stage's layers: the stages' parts, keyed by
    parameter name (``_named``), are gathered to the group's first rank
    and joined into the one-process form (``_join_stages``), and a
    restore keeps this stage's share of it (``_stage_of``).  These assume
    the optimizer is ``adamw``'s, whose state dict is indexed by its two
    groups in the model's order.
    """

    FILE = "state.pt"

    def __init__(self, directory: str, max_to_keep: int = 3, shards=None,
                 stages=None):
        self._dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.shards = shards
        self.stages = stages
        os.makedirs(self._dir, exist_ok=True)

    def _steps(self):
        out = []
        for name in os.listdir(self._dir):
            if name.isdigit() and os.path.exists(
                    os.path.join(self._dir, name, self.FILE)):
                out.append(int(name))
        return sorted(out)

    def save(self, step: int, state: Dict[str, Any]) -> None:
        saveable = _to_saveable(state)
        if self.shards is not None:  # every rank takes part in the gathers
            saveable = _map_tensors(state, saveable,
                                    lambda n, t, like: self.shards.full(n, t))
        ranks = tdist.get_process_group_ranks(self.stages) \
            if self.stages is not None else []
        if 0 in ranks:  # the stages holding what rank 0 writes
            parts = [None] * len(ranks) if tdist.get_rank() == 0 else None
            tdist.gather_object(_named(state, saveable), parts, dst=0,
                                group=self.stages)
            if parts is not None:
                saveable = _join_stages(parts)
        if not tdist.is_initialized() or tdist.get_rank() == 0:
            d = os.path.join(self._dir, str(step))
            os.makedirs(d, exist_ok=True)
            tmp = os.path.join(d, self.FILE + ".tmp")
            torch.save(saveable, tmp)
            os.replace(tmp, os.path.join(d, self.FILE))
            for old in self._steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self._dir, str(old)),
                              ignore_errors=True)
        if dist.group_size() > 1:
            tdist.barrier()

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        latest = [steps[-1] if steps else None]
        if dist.group_size() > 1:
            tdist.broadcast_object_list(latest, src=0)
        return latest[0]

    def restore(self, step: int, like: Dict[str, Any]) -> Dict[str, Any]:
        """The checkpointed state in ``like``'s structure: modules and
        optimizers in ``like`` are loaded in place, plain values replaced."""
        saved = torch.load(os.path.join(self._dir, str(step), self.FILE),
                           map_location="cpu", weights_only=True)
        if self.stages is not None:
            saved = _stage_of(like, saved)
        if self.shards is not None:
            saved = _map_tensors(like, saved, self.shards.local)
        out = dict(like)
        for k, v in like.items():
            if hasattr(v, "load_state_dict"):
                v.load_state_dict(saved[k])
                if isinstance(v, torch.optim.Optimizer):
                    lr_on_params_device(v)
            else:
                out[k] = saved[k]
        return out

    def restore_latest(self, like) -> Tuple[Optional[int], Any]:
        """``(step, state)`` from the newest checkpoint, or ``(None, like)``
        when none exists yet (cold start)."""
        step = self.latest_step()
        if step is None:
            return None, like
        return step, self.restore(step, like)

    def close(self) -> None:
        pass
