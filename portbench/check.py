"""What ``correct`` compares: readings of the first optimizer updates, taken
from the program's run and from the plain reference on the same weights
and batches, and the numbers made of them.

A reading holds each call's loss, the gradient of the first update as the
optimizer got it (by leaf), and each leaf's change after the check's
updates.  Numbers (each a worst case; a norm's gap is measured against the
reference's norm of that leaf or of the median leaf, whichever is larger):

- ``loss_gap``: the widest |program - reference| of a call's loss;
- ``grad_norm_gap``: the worst leaf's gap between the two gradients' norms;
- ``change_norm_gap``: the same of the change after the check's updates,
  over the leaves whose reference gradient is at least a thousandth of the
  median leaf's (the rest, as a key's bias under softmax, move by
  round-off alone under Adam).

Nothing here imports the program.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
import statistics
from typing import Dict, List, Optional

import torch

from portbench import models, weights
from portbench.traffic import Traffic

KEEP_RULE = 1e-3  # a leaf moves by more than round-off: grad >= this x median


@dataclasses.dataclass
class Readings:
    losses: List[float]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]


def check_calls(spec: dict) -> int:
    return spec["check_updates"] * spec["grad_accum"]


def lr_at(opt: dict, update: int) -> float:
    """Linear warm-up from 0 over ``warmup_updates``, then cosine decay to
    0 at ``total_updates`` (optax's warmup and cosine_decay_schedule,
    joined); or constant after the warm-up."""
    lr, warm, total = opt["lr"], opt["warmup_updates"], opt["total_updates"]
    if update < warm:
        return lr * update / warm
    if opt["schedule"] == "constant":
        return lr
    decay = max(total, warm + 1) - warm
    return lr * 0.5 * (1 + math.cos(math.pi * min(update - warm, decay) / decay))


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    out = {n: torch.linalg.vector_norm(t) for n, t in tensors.items()}
    return {n: float(v) for n, v in out.items()}


def follow_reference(cfg: dict, spec: dict, seed: int, device,
                     precision: str = "fp32",
                     fault: Optional[str] = None) -> Readings:
    """The reference trained through the check's calls from the run's
    weights on the run's batches, with AdamW written out.  ``fault``
    plants one of the faults a training step can have in the reference:
    ``half`` (each batch's second half of rows left out, the mean taken
    over the rest), ``frozen`` (no update), ``loss`` (each reported loss
    5% high)."""
    ref = importlib.import_module(f"portbench.references.{cfg['reference']}")
    ref.fp32_exact()
    loss_fn = ref.LOSSES[spec["objective"]]
    model, opt = cfg["model"], spec["optimizer"]
    layout = models.of(cfg).groups(model)
    b1, b2 = opt["betas"]
    p = {n: t.clone().requires_grad_()
         for n, t in weights.all_values(layout, model["init_std"], seed, device)}
    names = list(p)
    m = {n: torch.zeros_like(t) for n, t in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    traffic = Traffic(spec, model["vocab"], seed)
    accum = spec["grad_accum"]
    losses, acc, grad = [], None, None
    for call in range(check_calls(spec)):
        batch = to_device(traffic.batch(call), device)
        if fault == "half":
            batch = tuple(t[: t.shape[0] // 2] for t in batch)
        loss = loss_fn(p, batch, model, precision)
        gs = torch.autograd.grad(loss, [p[n] for n in names])
        losses.append(float(loss.detach()) * (1.05 if fault == "loss" else 1.0))
        acc = list(gs) if acc is None else [a + g for a, g in zip(acc, gs)]
        del gs, loss
        if (call + 1) % accum:
            continue
        update = call // accum
        g = {n: a / accum for n, a in zip(names, acc)}
        acc = None
        if update == 0:
            grad = g
        if fault == "frozen":
            continue
        lr, t = lr_at(opt, update), update + 1
        with torch.no_grad():
            for n in names:
                w = p[n]
                if w.dim() >= 2:
                    w.mul_(1 - lr * opt["weight_decay"])
                m[n].mul_(b1).add_(g[n], alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g[n], g[n], value=1 - b2)
                step = (m[n] / (1 - b1 ** t)) / (
                    (v[n] / (1 - b2 ** t)).sqrt() + opt["eps"])
                w.sub_(lr * step)
        del g
    if fault == "frozen":
        grad = {n: torch.zeros_like(t) for n, t in p.items()}
    del m, v
    change = {}
    with torch.no_grad():
        for n, p0 in weights.all_values(layout, model["init_std"], seed, device):
            change[n] = float(torch.linalg.vector_norm(p[n].detach() - p0))
    return Readings(losses, norms(grad), change)


def to_device(arrays, device) -> tuple:
    """Host arrays as the program's loader gives them: ids int64, the
    rest in their own dtype."""
    out = []
    for a in arrays:
        t = torch.from_numpy(a)
        out.append((t.long() if not t.is_floating_point() else t).to(device))
    return tuple(out)


def _most(values) -> float:
    """The largest of ``values``; NaN if any is NaN (``max`` would skip it)."""
    values = list(values)
    return float("nan") if any(math.isnan(x) for x in values) else max(values)


def _worst(prog: Dict[str, float], ref: Dict[str, float], leaves) -> float:
    med = statistics.median(ref[n] for n in leaves)
    return _most(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in leaves)


def moving_leaves(ref: Readings) -> List[str]:
    med = statistics.median(ref.grad_norms.values())
    return [n for n, g in ref.grad_norms.items() if g >= KEEP_RULE * med]


def numbers(prog: Readings, ref: Readings) -> Dict[str, float]:
    if len(prog.losses) != len(ref.losses):
        raise ValueError(f"the program logged {len(prog.losses)} losses of "
                         f"the check's {len(ref.losses)} calls")
    leaves = list(ref.grad_norms)
    moving = moving_leaves(ref)
    return {
        "loss_gap": _most(abs(a - b) for a, b in zip(prog.losses, ref.losses)),
        "grad_norm_gap": _worst(prog.grad_norms, ref.grad_norms, leaves),
        "change_norm_gap": _worst(prog.change_norms, ref.change_norms, moving),
    }


def judge(nums: Dict[str, float], limits: Dict[str, dict]):
    """(correct, {name: {"value", "limit"}}): every number of the limits
    file present, finite and at most its limit."""
    shown, ok = {}, True
    for name, entry in limits.items():
        value = nums.get(name, float("nan"))
        shown[name] = {"value": value, "limit": entry["limit"]}
        ok = ok and math.isfinite(value) and value <= entry["limit"]
    return ok, shown
