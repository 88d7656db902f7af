"""The plain reference of the transformer trunk: one model with a causal
switch, in fp32 (TF32 off), written from the configuration alone.

Post-LN blocks as the JAX package defines them: token embedding plus
learned positions, a LayerNorm, then per block
``x = LN(x + Attn(x)); x = LN(x + W_o gelu_tanh(W_i x))``; with
``final_layer_norm`` a LayerNorm before the head; the head is the tied
embedding table, its logits sliced to the true vocabulary.  Attention is
the textbook softmax(Q K^T / sqrt(d)) V with -inf above the diagonal when
causal.  Each block is checkpointed so that the reference fits beside
nothing else at the timed sizes; that changes no arithmetic.

``precision="fp8"`` is the control: every matrix product (the
projections, attention's two products, the head) takes its operands
rounded to fp8 with one scale a tensor (e4m3 forward, e5m2 for the
gradients), accumulating in fp32, everything else as in fp32.

Imports nothing of ``tpujob_torch`` (nor ``jax`` or ``tpujob``).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]


def fp32_exact() -> None:
    """fp32 products in fp32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` on fp8-rounded operands; the backward's products on the
    fp8-rounded gradient and saved operands."""

    @staticmethod
    def forward(ctx, a, b):
        aq = _round_fp8(a, torch.float8_e4m3fn)
        bq = _round_fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = _round_fp8(g, torch.float8_e5m2)
        da = gq @ bq.transpose(-1, -2)
        if bq.dim() == 2:  # a weight shared by every row
            db = aq.reshape(-1, aq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        else:
            db = aq.transpose(-1, -2) @ gq
        return da, db


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp32":
        return a @ b
    if precision == "fp8":
        return _Fp8Matmul.apply(a, b)
    raise ValueError(f"unknown precision {precision!r}")


def _linear(x, p: Params, name: str, precision: str):
    y = matmul(x, p[f"{name}.weight"].T, precision)
    return y + p[f"{name}.bias"]


def _norm(x, p: Params, name: str, eps: float):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"],
                        eps)


def _block(x, p: Params, i: int, model: dict, precision: str):
    b, s, h = x.shape
    heads = model["heads"]
    d = h // heads
    pre = f"layer_{i}"

    def split(t):
        return t.reshape(b, s, heads, d).transpose(1, 2)  # [b, heads, s, d]

    q = split(_linear(x, p, f"{pre}.attn.query", precision))
    k = split(_linear(x, p, f"{pre}.attn.key", precision))
    v = split(_linear(x, p, f"{pre}.attn.value", precision))
    scores = matmul(q, k.transpose(-1, -2), precision) / math.sqrt(d)
    if model["causal"]:
        above = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
        scores = scores.masked_fill(above, float("-inf"))
    o = matmul(torch.softmax(scores, dim=-1), v, precision)
    o = o.transpose(1, 2).reshape(b, s, h)
    eps = model["layer_norm_eps"]
    x = _norm(x + _linear(o, p, f"{pre}.attn.out", precision), p,
              f"{pre}.ln_attn", eps)
    m = F.gelu(_linear(x, p, f"{pre}.mlp_wi", precision), approximate="tanh")
    return _norm(x + _linear(m, p, f"{pre}.mlp_wo", precision), p,
                 f"{pre}.ln_mlp", eps)


def logits(p: Params, ids: torch.Tensor, model: dict,
           precision: str = "fp32") -> torch.Tensor:
    """[b, s, vocab] fp32 logits of ``ids`` [b, s] (int64)."""
    table = p["token_embed.weight"]
    eps = model["layer_norm_eps"]
    x = F.embedding(ids, table) + p["pos_embed"][: ids.shape[1]]
    x = _norm(x, p, "ln_embed", eps)
    for i in range(model["layers"]):
        x = checkpoint(_block, x, p, i, model, precision, use_reentrant=False)
    if model["final_layer_norm"]:
        x = _norm(x, p, "ln_f", eps)
    return matmul(x, table.T, precision)[..., : model["vocab"]]


def lm_loss(p: Params, batch, model: dict, precision: str = "fp32"):
    """Next-token cross-entropy: the mean over every (position, next
    token) pair of the batch."""
    (ids,) = batch
    z = logits(p, ids, model, precision)[:, :-1]
    logp = torch.log_softmax(z, dim=-1)
    return -torch.gather(logp, -1, ids[:, 1:, None]).mean()


def mlm_loss(p: Params, batch, model: dict, precision: str = "fp32"):
    """Masked LM: every masked position's id replaced by ``mask_token_id``
    in the input, its original id predicted; the mean over the masked
    positions."""
    ids, mask = batch
    masked = torch.where(mask > 0, model["mask_token_id"], ids)
    logp = torch.log_softmax(logits(p, masked, model, precision), dim=-1)
    tok = torch.gather(logp, -1, ids[..., None])[..., 0]
    return -(tok * mask).sum() / mask.sum().clamp(min=1.0)


LOSSES = {"lm": lm_loss, "mlm": mlm_loss}
