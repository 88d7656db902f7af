"""Dense attention, the reference every attention path is held against,
and the sparse MoE feed-forward: the port of ``tpujob/workloads/parallel.py``.

Layout is the JAX package's ``[batch, seq, heads, head_dim]``.  Only the
unsharded pieces are ported so far (grouped-query repeat, full attention,
and ``moe_capacity``/``moe_ffn`` on one device); the sequence, tensor,
expert and pipeline strategies are not.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


def _gqa_repeat(q, k, v):
    """Broadcast K/V heads up to the query heads (grouped-query attention);
    head ``i`` of K/V serves query heads ``i*rep .. i*rep+rep-1``."""
    rep = q.shape[2] // k.shape[2]
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"query heads {q.shape[2]} must be a multiple of KV heads "
            f"{k.shape[2]}")
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def full_attention(q, k, v, *, causal: bool = False,
                   scale: Optional[float] = None, window: int = 0):
    """Dense softmax attention in the inputs' dtype.  ``window`` > 0 masks
    keys more than window-1 positions behind the query (causal only)."""
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("window (sliding-window attention) requires "
                         "causal=True")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    k, v = _gqa_repeat(q, k, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        delta = (torch.arange(sq, device=q.device)[:, None]
                 - torch.arange(sk, device=q.device)[None, :])
        mask = delta >= 0
        if window:
            mask = mask & (delta < window)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


# ---------------------------------------------------------------------------
# sparse Mixture-of-Experts FFN (expert parallelism 1)
# ---------------------------------------------------------------------------


def moe_capacity(tokens_per_group: int, num_experts: int, k: int,
                 capacity_factor: float) -> int:
    """Static per-expert buffer length for one routing group (a batch
    row).  Assignments past it are dropped: their combine weight is 0 and
    the residual stream carries the token through."""
    return max(1, math.ceil(tokens_per_group * k * capacity_factor / num_experts))


class Routing(NamedTuple):
    """Top-k routing of one ``moe_ffn`` call: ``logits``/``probs`` [b, s, E]
    in fp32, ``gate`` [b, s, k] renormalised, ``expert_idx`` [b, s, k],
    ``oh`` [b, s, k, E] the choices' one-hot (zero at invalid positions),
    ``oh_prio`` [b, k*s, E] the same in k-major priority order, and for
    each assignment in that order its slot ``pos`` and ``keep`` (1.0 when
    the slot is below the capacity) [b, k*s]."""

    logits: torch.Tensor
    probs: torch.Tensor
    gate: torch.Tensor
    expert_idx: torch.Tensor
    oh: torch.Tensor
    oh_prio: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor


def moe_route(x: torch.Tensor, router_kernel: torch.Tensor, k: int, cap: int,
              valid: Optional[torch.Tensor] = None) -> Routing:
    """The routing half of ``moe_ffn``: an fp32 router, softmax, top-k with
    the gates renormalised by max(sum, 1e-9), and each assignment's slot in
    its expert's buffer, first choices before second choices, per batch
    row.  Positions where ``valid`` is 0 are zeroed before the slot cumsum,
    so they never occupy (or steal) a slot.  Every shape is static and no
    value goes to the host: the step that runs it can be captured."""
    b, s, _ = x.shape
    num_experts = router_kernel.shape[1]
    # fp32 router: exp/softmax on bf16 logits is where MoE training
    # classically diverges
    logits = torch.einsum("bsd,de->bse", x.float(), router_kernel.float())
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    experts = torch.arange(num_experts, device=x.device)
    oh = (expert_idx[..., None] == experts).float()  # [b, s, k, E]
    if valid is not None:
        oh = oh * valid.float()[..., None, None]
    oh_prio = oh.transpose(1, 2).reshape(b, k * s, num_experts)
    pos = torch.cumsum(oh_prio, dim=1) - 1.0
    pos = torch.sum(pos * oh_prio, dim=-1)  # [b, k*s]
    keep = (pos < cap).float()
    return Routing(logits, probs, gate, expert_idx, oh, oh_prio, pos, keep)


def dispatch_combine(r: Routing, cap: int, dtype: torch.dtype
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense dispatch and combine tensors [b, s, E, cap] of a routing,
    in ``dtype``: dispatch is 1 where a kept assignment puts the token in
    an expert's slot, combine the same weighted by its gate.  The slot
    one-hot compares with ``arange(cap)``: a slot past the capacity
    matches none, where a one-hot of it would raise."""
    b, ks, num_experts = r.oh_prio.shape
    k = r.gate.shape[-1]
    slots = torch.arange(cap, device=r.pos.device, dtype=torch.float32)
    slot = (r.pos[..., None] == slots).float() * r.keep[..., None]
    # [b, k*s, E, cap] -> [b, s, k, E, cap]
    dispatch = (r.oh_prio[..., None] * slot[..., None, :]).reshape(
        b, k, ks // k, num_experts, cap).permute(0, 2, 1, 3, 4)
    combine = (dispatch * r.gate[..., None, None]).sum(2).to(dtype)
    return dispatch.sum(2).to(dtype), combine


def load_balance(top1_count: torch.Tensor, prob_sum: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """The Switch aux loss E * sum_e(density_e * mean_prob_e) over the last
    dim (1.0 when balanced): density from the per-expert count of top-1
    choices, mean probability from the sum of the router's probabilities,
    both over ``tokens`` routed positions (shape ``top1_count.shape[:-1]``)."""
    n = tokens[..., None]
    return top1_count.shape[-1] * torch.sum(
        (top1_count / n) * (prob_sum / n), dim=-1)


def moe_ffn(x: torch.Tensor, router_kernel: torch.Tensor, wi: torch.Tensor,
            wo: torch.Tensor, *, k: int = 2, capacity_factor: float = 1.25,
            valid: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sparse MoE feed-forward with top-k routing (the JAX package's
    ``moe_ffn`` without a mesh).

    ``x``: [batch, seq, d_model]; ``router_kernel``: [d_model, E];
    ``wi``: [E, d_model, d_ff]; ``wo``: [E, d_ff, d_model].  Returns ``(y,
    metrics)``, y shaped like x.  ``valid``: optional [batch, seq] 0/1
    mask; positions with 0 are not routed (no slot, output 0) and the
    load balance counts valid positions only, which keeps decode over a
    fixed buffer causal.

    Dispatch is dense, as in the reference: one-hot dispatch and combine
    tensors [b, s, E, cap] (``dispatch_combine``, in x's dtype) and three
    einsums around a tanh GELU, so every expert takes part and the shapes
    never depend on the data.

    ``metrics``: ``load_balance`` (the Switch aux loss, density from the
    top-1 choice only) and ``router_z`` (mean squared logsumexp of the
    logits), the reference's two; and the parts the load balance is made
    of, which the loss sums over ranks (``top1_count`` [E] and
    ``tokens``, without grad, ``prob_sum`` [E]), and ``dropped``, the
    count of valid assignments past their expert's capacity (not in the
    reference; a diagnostic)."""
    b, s, _ = x.shape
    num_experts = wi.shape[0]
    if not 1 <= k <= num_experts:
        raise ValueError(
            f"top-k k={k} must be in [1, num_experts={num_experts}]")
    cap = moe_capacity(s, num_experts, k, capacity_factor)
    r = moe_route(x, router_kernel, k, cap, valid)
    dispatch, combine = dispatch_combine(r, cap, x.dtype)
    expert_in = torch.einsum("bsec,bsd->becd", dispatch, x)
    h = F.gelu(torch.einsum("becd,edf->becf", expert_in, wi),
               approximate="tanh")
    out = torch.einsum("becf,efd->becd", h, wo)
    y = torch.einsum("bsec,becd->bsd", combine, out)

    top1_count = r.oh[:, :, 0, :].sum(dim=(0, 1))
    if valid is not None:
        vmask = valid.float()
        tokens = torch.clamp(vmask.sum(), min=1.0)
        prob_sum = (r.probs * vmask[..., None]).sum(dim=(0, 1))
    else:
        tokens = torch.full((), float(b * s), device=x.device)
        prob_sum = r.probs.sum(dim=(0, 1))
    metrics = {
        "load_balance": load_balance(top1_count, prob_sum, tokens),
        "router_z": torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2),
        "top1_count": top1_count, "prob_sum": prob_sum, "tokens": tokens,
        "dropped": torch.sum(r.oh_prio.sum(-1) * (1.0 - r.keep)),
    }
    return y, metrics
