"""The 1F1B pipeline schedule: the port of
``tpujob/workloads/pipeline_schedule.py``.

GPipe (``parallel.pipeline``) runs every microbatch's forward, then every
backward, so a stage keeps each microbatch's activations from its forward
tick to its backward tick: the stash grows with the microbatch count m.
1F1B interleaves each microbatch's backward between other microbatches'
forwards, so a stage holds at most about n - s of them.  This module
schedules the forward and backward ticks itself:

- ``build_1f1b_tables(n, m)`` simulates the classic policy (each stage:
  n - s warm-up forwards, then a backward whenever one is ready, else the
  next forward, until all m backwards are done) once, and emits the
  static timetable: which microbatch each stage forwards or backwards at
  each tick, the stash slot each activation and cotangent occupies, and
  where arriving traffic lands.  The simulator checks every dependency
  and that every op runs exactly once.  Plain Python, the JAX package's
  own (this copy keeps the port free of it).
- ``pipeline_1f1b(...)``: each rank executes its own column of the
  timetable.  Forward ticks run the stage without grad and keep only its
  input; the last stage's ``FWD_LOSS`` tick runs the head and the
  microbatch's loss and starts its cotangent; a backward tick recomputes
  the stage forward under grad and calls ``torch.autograd.backward``.
  Activations go to the next stage and cotangents to the previous one
  (``parallel.to_next`` / ``to_prev``), only where the table says a
  tensor travels, so every rank enters the same exchanges in the same
  order.  The result is the fused forward and backward, not a
  differentiable forward: the stage's and the head's gradients land in
  their parameters' ``.grad``.

Memory: a stage stashes at most ``Tables.stash_depth`` microbatch
activations (about n + 1), whatever m is.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch

from tpujob_torch.workloads import distributed as dist
from tpujob_torch.workloads import parallel

# the per-tick actions
IDLE, FWD, FWD_LOSS, BWD = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class Tables:
    """Static 1F1B timetable (everything [T, n] int32 unless noted)."""

    n: int
    m: int
    ticks: int
    stash_depth: int        # activation stash slots per stage
    cot_depth: int          # cotangent stash slots per stage
    action: np.ndarray      # IDLE/FWD/FWD_LOSS/BWD
    op_mb: np.ndarray       # microbatch index of the tick's op (-1 idle)
    op_slot: np.ndarray     # stash slot: fwd reads / bwd reads+frees
    cot_slot: np.ndarray    # bwd: cotangent slot to read
    arr_slot: np.ndarray    # where the arriving activation lands (-1 drop)
    cotarr_slot: np.ndarray  # where the arriving cotangent lands (-1 drop)
    loss_cot_slot: np.ndarray  # last stage fwd tick: slot for the loss cot
    feed_mb: np.ndarray     # stage-0 fwd tick: microbatch to load from x


def build_1f1b_tables(n: int, m: int) -> Tables:
    """Simulate the 1F1B policy and emit the static timetable.

    Policy per stage s (classic): complete min(n - s, m) warmup forwards
    first; afterwards prefer the oldest ready backward, else the next
    forward whose input has arrived; stop when all m backwards are done.
    """
    if m < 1 or n < 1:
        raise ValueError(f"need n >= 1, m >= 1, got n={n} m={m}")
    warmup = [min(n - s, m) for s in range(n)]
    fwd_done = [[None] * m for _ in range(n)]   # tick fwd completed
    bwd_done = [[None] * m for _ in range(n)]
    # activation/cotangent arrival ticks at each stage (stage 0 activations
    # "arrive" at their fwd tick from the local feed; last-stage cotangents
    # at its fwd tick from the local loss)
    act_arrival = [dict() for _ in range(n)]
    cot_arrival = [dict() for _ in range(n)]

    rows: List[dict] = []
    t = 0
    while not all(all(x is not None for x in bwd_done[s]) for s in range(n)):
        row = {"action": [IDLE] * n, "op_mb": [-1] * n}
        for s in range(n):
            fwds = sum(x is not None for x in fwd_done[s])
            # oldest microbatch ready to go backward
            bwd_j = next(
                (j for j in range(m)
                 if bwd_done[s][j] is None and fwd_done[s][j] is not None
                 and cot_arrival[s].get(j, 10**9) <= t),
                None)
            fwd_j = fwds if fwds < m else None
            if fwd_j is not None and s > 0 \
                    and act_arrival[s].get(fwd_j, 10**9) > t:
                fwd_j = None
            if fwds < warmup[s] and fwd_j is not None:
                row["action"][s], row["op_mb"][s] = FWD, fwd_j
            elif bwd_j is not None:
                row["action"][s], row["op_mb"][s] = BWD, bwd_j
            elif fwd_j is not None:
                row["action"][s], row["op_mb"][s] = FWD, fwd_j
        # commit this tick's effects (the exchange lands next tick)
        for s in range(n):
            a, j = row["action"][s], row["op_mb"][s]
            if a == FWD:
                fwd_done[s][j] = t
                if s == 0:
                    act_arrival[0][j] = t  # local feed
                if s + 1 < n:
                    act_arrival[s + 1][j] = t + 1
                if s == n - 1:
                    row["action"][s] = FWD_LOSS
                    cot_arrival[s][j] = t  # local loss
            elif a == BWD:
                bwd_done[s][j] = t
                if s > 0:
                    cot_arrival[s - 1][j] = t + 1
        rows.append(row)
        t += 1
        if t > 4 * (m + n) + 16:
            raise AssertionError("1F1B simulator failed to converge")

    T = len(rows)

    # slot assignment: an activation occupies a slot from its arrival tick
    # until its backward completes; cotangents from arrival until consumed
    def assign_slots(arrival, release):
        slots = [dict() for _ in range(n)]  # mb -> slot per stage
        depth = 1
        for s in range(n):
            free: List[int] = []
            next_new = 0
            events = sorted(
                [(arrival[s][j], 0, j) for j in arrival[s]]
                + [(release[s][j], 1, j) for j in arrival[s]])
            for _, kind, j in events:
                if kind == 0:
                    if free:
                        slots[s][j] = free.pop()
                    else:
                        slots[s][j] = next_new
                        next_new += 1
                        depth = max(depth, next_new)
                else:
                    free.append(slots[s][j])
        return slots, depth

    act_release = [{j: bwd_done[s][j] for j in act_arrival[s]}
                   for s in range(n)]
    cot_release = [{j: bwd_done[s][j] for j in cot_arrival[s]}
                   for s in range(n)]
    act_slots, stash_depth = assign_slots(act_arrival, act_release)
    cot_slots, cot_depth = assign_slots(cot_arrival, cot_release)

    def tbl(fill=-1):
        return np.full((T, n), fill, dtype=np.int32)

    action = tbl(IDLE)
    op_mb, op_slot, cot_slot = tbl(), tbl(), tbl()
    arr_slot, cotarr_slot, loss_cot_slot, feed_mb = tbl(), tbl(), tbl(), tbl()
    for t_, row in enumerate(rows):
        for s in range(n):
            a, j = row["action"][s], row["op_mb"][s]
            action[t_, s] = a
            if a == IDLE:
                continue
            op_mb[t_, s] = j
            op_slot[t_, s] = act_slots[s][j]
            if a in (FWD, FWD_LOSS) and s == 0:
                feed_mb[t_, s] = j
            if a == FWD_LOSS:
                loss_cot_slot[t_, s] = cot_slots[s][j]
            if a == BWD:
                cot_slot[t_, s] = cot_slots[s][j]
    # arrivals: activation sent from s-1's fwd at t-1 lands at (t, s);
    # cotangent from s+1's bwd at t-1 lands at (t, s)
    for t_, row in enumerate(rows[:-1]):
        for s in range(n):
            a, j = row["action"][s], row["op_mb"][s]
            if a in (FWD, FWD_LOSS) and s + 1 < n:
                arr_slot[t_ + 1, s + 1] = act_slots[s + 1][j]
            if a == BWD and s > 0:
                cotarr_slot[t_ + 1, s - 1] = cot_slots[s - 1][j]

    # invariants: every op exactly once, dependencies respected
    for s in range(n):
        if sorted(j for t_ in range(T)
                  for a, j in [(action[t_, s], op_mb[t_, s])]
                  if a in (FWD, FWD_LOSS)) != list(range(m)) \
                or sorted(op_mb[t_, s] for t_ in range(T)
                          if action[t_, s] == BWD) != list(range(m)):
            raise AssertionError(f"stage {s} does not run every op once")
        for j in range(m):
            ok = (act_arrival[s][j] <= fwd_done[s][j] < bwd_done[s][j]
                  and cot_arrival[s][j] <= bwd_done[s][j]
                  and (s == 0 or fwd_done[s - 1][j] < fwd_done[s][j])
                  and (s + 1 == n or bwd_done[s + 1][j] < bwd_done[s][j]))
            if not ok:
                raise AssertionError(
                    f"stage {s} microbatch {j} breaks a dependency")
    return Tables(
        n=n, m=m, ticks=T, stash_depth=stash_depth, cot_depth=cot_depth,
        action=action, op_mb=op_mb, op_slot=op_slot, cot_slot=cot_slot,
        arr_slot=arr_slot, cotarr_slot=cotarr_slot,
        loss_cot_slot=loss_cot_slot, feed_mb=feed_mb,
    )


def batch_shard_count(mesh, global_batch: int) -> int:
    """How many ways the batch splits over the mesh's batch axes: THE one
    decision shared by ``pipeline_1f1b`` (which averages the gradients
    over that many shards) and any caller that scales its per-microbatch
    loss by the shard count.  1 when the batch does not divide (the
    layout then refuses it: ``distributed.local_batch_slice``)."""
    axes = dist.batch_axes(mesh)
    if not axes:
        return 1
    div = dist.batch_divisor(mesh, *axes)
    return div if global_batch % div == 0 else 1


class Result(NamedTuple):
    """What a fused schedule returns on each rank: ``loss`` (0 off the
    last stage), ``dx`` its gradient with respect to the pipeline input
    (stage 0; 0 elsewhere), and the most microbatch activations and
    cotangents the stage held at once (``stash_peak``, ``cot_peak``)."""

    loss: torch.Tensor
    dx: torch.Tensor
    stash_peak: int
    cot_peak: int


def pipeline_1f1b(stage_fn: Callable[[torch.Tensor], torch.Tensor],
                  x: torch.Tensor,
                  head_fn: Callable[[torch.Tensor, Any], torch.Tensor],
                  extra: Any, group, *, num_layers: int,
                  num_microbatches: Optional[int] = None) -> Result:
    """Fused forward and backward of this rank's stage over the 1F1B
    timetable.

    ``stage_fn(x_mb) -> y_mb`` applies this rank's layers to one
    microbatch (shape and dtype kept; the parameters are the stage's own,
    and their gradients accumulate in ``.grad``).  ``x`` is this rank's
    rows of the pipeline input ``[b, ...]`` on stage 0; on the other
    stages a tensor of its shape and dtype (its values unread).
    ``head_fn(y_mb, extra_mb) -> scalar`` is a microbatch's loss on the
    last stage (its parameters' gradients accumulate there); the returned
    loss is the mean over the microbatches, and the gradients are those
    of that mean.  ``extra``: a tuple of ``[b, ...]`` tensors cut into
    microbatches alongside ``x`` (labels, masks).  ``group``: the
    pipeline's process group (stage = group rank).  ``num_layers``: the
    whole stack's depth, checked against the stages.

    Summing the loss over the stages, and the gradients of parameters
    several stages hold, is the caller's (``bert.make_pipeline_value_and_
    grad``): here each rank holds only what its own ticks computed."""
    n, s = parallel.group_size(group), parallel.group_rank(group)
    m = num_microbatches or n
    parallel.check_pipeline(num_layers, n, x.shape[0], m)
    t = build_1f1b_tables(n, m)
    x_mb = x.chunk(m)
    extra_mb = list(zip(*(e.chunk(m) for e in extra)))
    like = torch.empty_like(x_mb[0])
    stash: List[Optional[torch.Tensor]] = [None] * t.stash_depth
    cots: List[Optional[torch.Tensor]] = [None] * t.cot_depth
    dxs = [torch.zeros_like(like) for _ in range(m)] if s == 0 else None
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    peak = {id(stash): 0, id(cots): 0}

    def put(buf, slot, value):
        if buf[slot] is not None:
            raise AssertionError(f"stash slot {slot} is still live")
        buf[slot] = value
        peak[id(buf)] = max(peak[id(buf)],
                            sum(v is not None for v in buf))

    def take(buf, slot):
        value, buf[slot] = buf[slot], None
        return value

    for tick in range(t.ticks):
        act, j = int(t.action[tick, s]), int(t.op_mb[tick, s])
        slot = int(t.op_slot[tick, s])
        if int(t.feed_mb[tick, s]) >= 0:
            put(stash, slot, x_mb[int(t.feed_mb[tick, s])].detach())
        down = up = None
        if act in (FWD, FWD_LOSS):
            with torch.no_grad():
                y = stage_fn(stash[slot])
            if act == FWD:
                down = y
            else:
                with torch.enable_grad():
                    y = y.detach().requires_grad_()
                    loss_j = head_fn(y, extra_mb[j]) / m
                    loss_j.backward()
                loss += loss_j.detach().float()
                put(cots, int(t.loss_cot_slot[tick, s]), y.grad)
        elif act == BWD:
            with torch.enable_grad():
                xi = take(stash, slot).requires_grad_()
                y = stage_fn(xi)
                torch.autograd.backward(y, take(cots, int(t.cot_slot[tick,
                                                                     s])))
            if s == 0:
                dxs[j] = xi.grad
            else:
                up = xi.grad
        if tick + 1 == t.ticks:
            break
        # this tick's traffic, where the next tick's row says it lands
        arr, cotarr = int(t.arr_slot[tick + 1, s]), int(t.cotarr_slot[tick + 1,
                                                                        s])
        got = parallel.to_next(like if down is None else down, group,
                               send=down is not None, recv=arr >= 0)
        if arr >= 0:
            put(stash, arr, got)
        got = parallel.to_prev(like if up is None else up, group,
                               send=up is not None, recv=cotarr >= 0)
        if cotarr >= 0:
            put(cots, cotarr, got)
    dx = torch.cat(dxs) if s == 0 else torch.zeros_like(x)
    return Result(loss, dx, peak[id(stash)], peak[id(cots)])


def pipeline_gpipe(stage_fn: Callable[[torch.Tensor], torch.Tensor],
                   x: torch.Tensor,
                   head_fn: Callable[[torch.Tensor, Any], torch.Tensor],
                   extra: Any, group, *, num_layers: int,
                   num_microbatches: Optional[int] = None,
                   skip_idle: bool = True) -> Result:
    """Fused forward and backward of this rank's stage over the GPipe
    schedule, with ``pipeline_1f1b``'s arguments and result: every
    microbatch's forward (``parallel.gpipe_forward``, the stage's graph
    of each kept), then on the last stage ``head_fn(y, extra)`` on the
    whole batch's output, as the JAX package's GPipe path runs its head
    and loss after the pipeline, and its backward, whose output gradient
    starts the backward ticks (``parallel.gpipe_backward``).  The loss is
    the head's, in its dtype; the stage stashes all m microbatches."""
    n, s = parallel.group_size(group), parallel.group_rank(group)
    m = num_microbatches or n
    parallel.check_pipeline(num_layers, n, x.shape[0], m)
    outs, stash = parallel.gpipe_forward(stage_fn, list(x.chunk(m)), group,
                                         skip_idle=skip_idle)
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    grads: List[torch.Tensor] = []
    if s == n - 1:
        with torch.enable_grad():
            y = torch.cat(outs).requires_grad_()
            loss = head_fn(y, extra)
            loss.backward()
        loss = loss.detach()
        grads = list(y.grad.chunk(m))
    dxs = parallel.gpipe_backward(stash, grads, group)
    dx = torch.cat(dxs) if s == 0 else torch.zeros_like(x)
    return Result(loss, dx, m, m if s == n - 1 else 1)
