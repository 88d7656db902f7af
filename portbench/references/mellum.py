"""The plain reference of Mellum2's block family, in fp32 (TF32 off), written
from the configuration alone.

Per block, pre-norm: ``x = x + Attn(RMSNorm(x)); x = x + MoE(RMSNorm(x))``;
then ``RMSNorm`` and the untied head, its logits over the vocabulary's
slice.  RMSNorm is ``x / sqrt(mean(x^2) + eps) * scale``.  Attention is the
textbook ``softmax(Q K^T / sqrt(d) + mask) V`` with K and V repeated from
the KV heads to the query heads, causal, and on a sliding layer each
query seeing itself and the ``window - 1`` keys before it; rotary
positions (half-split) with theta, and on the full layers YaRN as HF's
``_compute_yarn_parameters`` defines it (written out in
``rope_frequencies``).  The MoE: an fp32 softmax over the experts, the top
k, their gates renormalised to sum 1; each expert's tokens found by a plain
loop over the experts, ``W2 (silu(W1 u) * W3 u)`` weighed by the gate and
added to the token's output.  The loss adds ``aux_coef`` times the layers'
mean load balance, ``E x sum_e (share of all top-k assignments to e) x
(mean router probability of e)``.

Each block is checkpointed, and so is attention a block of queries at a
time (keys cut to those a block can see), so that the reference fits
beside nothing else at the timed sizes; that changes no arithmetic.
``precision="fp8"`` is the control: every matrix product but the router's
(the projections, attention's two, the experts', the head) on operands
rounded to fp8 (``references/trunk.py``'s ``matmul``); the router stays
fp32 as the configuration states it.

Imports nothing of ``tpujob_torch`` (nor ``jax`` or ``tpujob``).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.references.trunk import fp32_exact, matmul  # noqa: F401

Params = Dict[str, torch.Tensor]
QUERY_BLOCK = 1024


def rope_frequencies(d: int, theta: float, yarn=None):
    """(the d/2 inverse frequencies, the cos/sin scale): ``1 / theta^(2i/d)``,
    or with ``yarn`` (the configuration's ``rope_parameters`` entry) HF's
    blend: the correction range ``floor``/``ceil`` of ``d ln(L0 / (2 pi
    beta)) / (2 ln theta)`` at ``beta_fast`` and ``beta_slow``, a linear
    ramp over it between the plain frequencies and those divided by the
    factor, and the scale ``attention_factor``."""
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32) / d)
    if yarn is None:
        return inv, 1.0
    original = yarn["original_max_position_embeddings"]

    def correction_dim(rotations):
        return (d * math.log(original / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(correction_dim(yarn["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(yarn["beta_slow"])), d - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(d // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    extrapolation = 1 - ramp
    inv = inv / yarn["factor"] * (1 - extrapolation) + inv * extrapolation
    return inv, yarn["attention_factor"]


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _attend(q, k, v, lo: int, k0: int, window: int, precision: str):
    """Queries ``lo..`` (``q`` [b, H, c, d]) against keys ``k0..`` ([b, H,
    n, d]): the causal and window masks by absolute position."""
    scores = matmul(q, k.transpose(-1, -2), precision) / math.sqrt(q.shape[-1])
    qi = torch.arange(lo, lo + q.shape[2], device=q.device)[:, None]
    kj = torch.arange(k0, k0 + k.shape[2], device=q.device)[None, :]
    visible = kj <= qi
    if window:
        visible = visible & (qi - kj < window)
    scores = scores.masked_fill(~visible, float("-inf"))
    return matmul(torch.softmax(scores, dim=-1), v, precision)


def _attention(x, p: Params, pre: str, window: int, yarn, model: dict,
               precision: str):
    b, s, _ = x.shape
    heads, kv, d = model["heads"], model["kv_heads"], model["head_dim"]

    def proj(name, n):
        w = p[f"{pre}.attn.{name}.weight"]
        return matmul(x, w.T, precision).reshape(b, s, n, d)

    inv, scale = rope_frequencies(d, model["rope_theta"], yarn)
    freqs = torch.arange(s, dtype=torch.float32)[:, None] * inv
    cos = (torch.cos(freqs) * scale).to(x.device)[None, :, None, :]
    sin = (torch.sin(freqs) * scale).to(x.device)[None, :, None, :]
    q = _rotate(proj("query", heads), cos, sin).transpose(1, 2)
    k = _rotate(proj("key", kv), cos, sin).repeat_interleave(heads // kv, 2)
    v = proj("value", kv).repeat_interleave(heads // kv, 2)
    k, v = k.transpose(1, 2), v.transpose(1, 2)  # [b, H, s, d]
    outs = []
    for lo in range(0, s, QUERY_BLOCK):
        hi = min(lo + QUERY_BLOCK, s)
        k0 = max(0, lo - window + 1) if window else 0
        outs.append(checkpoint(_attend, q[:, :, lo:hi], k[:, :, k0:hi],
                               v[:, :, k0:hi], lo, k0, window, precision,
                               use_reentrant=False))
    o = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, heads * d)
    return matmul(o, p[f"{pre}.attn.out.weight"].T, precision)


def _moe(u, p: Params, pre: str, model: dict, precision: str):
    """(the experts' output, the layer's load balance) of ``u`` [b, s, h]."""
    b, s, h = u.shape
    e_count, k, f = model["experts"], model["top_k"], model["expert_width"]
    tokens = u.reshape(b * s, h)
    probs = torch.softmax(tokens @ p[f"{pre}.moe.router"], dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    y = torch.zeros_like(tokens)
    for e in range(e_count):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        hg = matmul(tokens[tok], p[f"{pre}.moe.wi"][e], precision)
        a = F.silu(hg[:, :f]) * hg[:, f:]
        out = matmul(a, p[f"{pre}.moe.wo"][e], precision)
        y = y.index_add(0, tok, out * gate[tok, slot, None])
    share = torch.zeros(e_count, device=u.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=u.device))
    share = share / idx.numel()
    balance = e_count * torch.sum(share * probs.mean(0))
    return y.reshape(b, s, h), balance


def _block(x, p: Params, i: int, window: int, yarn, model: dict,
           precision: str):
    pre, eps = f"layer_{i}", model["rms_norm_eps"]
    x = x + _attention(_rms(x, p[f"{pre}.ln_attn.weight"], eps), p, pre,
                       window, yarn, model, precision)
    y, balance = _moe(_rms(x, p[f"{pre}.ln_mlp.weight"], eps), p, pre, model,
                      precision)
    return x + y, balance


def logits(p: Params, ids: torch.Tensor, model: dict,
           precision: str = "fp32"):
    """([b, s, vocab] fp32 logits of ``ids`` [b, s], the layers' mean load
    balance)."""
    x = F.embedding(ids, p["token_embed.weight"])
    balances = []
    for i, kind in enumerate(model["layer_types"][: model["layers"]]):
        sliding = kind == "sliding_attention"
        x, balance = checkpoint(
            _block, x, p, i, model["window"] if sliding else 0,
            None if sliding else model["yarn"], model, precision,
            use_reentrant=False)
        balances.append(balance)
    x = _rms(x, p["ln_f.weight"], model["rms_norm_eps"])
    z = matmul(x, p["lm_head.weight"].T, precision)[..., : model["vocab"]]
    return z, torch.stack(balances).mean()


def lm_loss(p: Params, batch, model: dict, precision: str = "fp32"):
    """Next-token cross-entropy (the mean over every (position, next token)
    pair of the batch) plus ``aux_coef`` times the mean load balance."""
    (ids,) = batch
    z, balance = logits(p, ids, model, precision)
    logp = torch.log_softmax(z[:, :-1], dim=-1)
    ce = -torch.gather(logp, -1, ids[:, 1:, None]).mean()
    return ce + model["aux_coef"] * balance


LOSSES = {"lm": lm_loss}
