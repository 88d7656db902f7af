"""Transformer trunk and training loop: the port of ``tpujob/workloads/bert.py``.

The BERT encoder and the GPT decoder are one machine here as in the JAX
package: post-LN blocks, learned (or rotary) positions, a tied LM head,
rematerialised blocks.  What is ported: ``rope``, ``Attention`` (training
branch and the KV-cache branch of decode), ``Block`` with the dense FFN or
the sparse MoE one (``MoEConfig``, ``MoEMlp``, ``moe_config_from``; on
one device, or its experts split over an expert group and its FFN over
a tensor group, on a sequence split over a sequence group), ``Bert``
(embed / head / forward, and decode one token at a time against an
explicit ``KVCache``), the
masked-LM objective (``mask_batch``, ``mlm_loss``, with the MoE aux
terms), the flag surface, ``tokenizer_from_args`` and
``token_batches`` (synthetic, or a real corpus with ``--data-file``, raw
bytes or ``--tokenizer bpe:...`` tokens, a new batch every step), the flag
checks, ``make_mesh_for`` and ``build_model`` (dense, flash, and under
``--sequence-parallel`` the ring or Ulysses attention, flash as Ulysses's
local kernel; under ``--tensor-parallel`` Megatron's blocks), the
``train`` loop (a per-step batch provider, gradient accumulation,
``--profile-dir``, data parallelism across processes through DDP over
the ranks that hold the same parameters, ZeRO-3 through FSDP2 under
``--fsdp``, checkpoints written whole at any layout) and ``run``/``main``.
Every parallel strategy of the JAX package is ported: data, sequence,
tensor, expert and pipeline parallelism and FSDP, and their compositions
(TP x SP on the ring, FSDP x TP, FSDP x SP, MoE with EP or without on
any of them, data x pipeline and TP x pipeline).

Under ``--pipeline-parallel`` each rank holds its stage's layers
(``parallel.stage_layers``) and every parameter outside them, and a step
is the schedule's fused forward and backward
(``make_pipeline_value_and_grad``: GPipe or 1F1B, the embedding on the
first stage, the head on the last); ``pipeline_apply`` is the pipelined
forward (every stage's logits), for decode.

Under sequence parallelism each rank holds its rows of the batch and its
columns of the sequence (``seq_positions``: a contiguous block, or for
the causal ring the zigzag pair of chunks) from the embedding on: the
learned positions and rotary phases are each token's global position,
and the losses take their targets and counts from the global rows, so
each rank's loss, scaled by the world, averages to the global batch's.

Parity with flax, made explicit rather than left to autocast:

- params are fp32; under ``--bf16`` every Dense/Embed casts its input and
  its params to bf16 (flax ``promote_dtype``), so activations and the
  tied head's logits are bf16;
- LayerNorm normalises in fp32 with eps 1e-6 (torch's default is 1e-5)
  and casts its output to the compute dtype;
- GELU is the tanh approximation;
- submodules carry the flax names (``token_embed``, ``pos_embed``,
  ``ln_embed``, ``ln_f``, ``layer_{i}/{attn/{query,key,value,out},
  ln_attn, ln_mlp, mlp_wi, mlp_wo}``, or ``moe/{router,wi,wo}`` in flax's
  layout) so ``convert.params_from_flax`` is a mechanical rename.

Entry points (on the card; ``--device cpu`` for the CPU):
    python -m tpujob_torch.workloads.bert --attention flash --batch-size 8 --steps 5
    python -m tpujob_torch.workloads.bert --attention flash --vocab 257 \
        --data-file corpus.txt            (byte-level MLM, [MASK] = 256)
    python -m tpujob_torch.workloads.gpt   (the causal family, and decode)
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as tdist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from tpujob_torch.workloads import data as datalib
from tpujob_torch.workloads import distributed as dist
from tpujob_torch.workloads import parallel, pipeline_schedule, train_lib
from tpujob_torch.workloads import tokenizer as toklib

class Dense(nn.Module):
    """flax ``nn.Dense``: input and params promoted to ``dtype`` before the
    product.  The weight is torch's ``[out, in]`` (flax's kernel is
    ``[in, out]``); ``bias=False`` leaves the bias out.  With ``reduce_group`` it is row-parallel (Megatron):
    the rank holds a block of the input dim (``parallel.tp_shard_``), the
    partial products, in fp32, are summed over the group and rounded once
    to ``dtype`` (``parallel.reduce_from_tensor``), and the bias, whole
    on every rank, is added once after the sum."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype,
                 gen: torch.Generator, reduce_group=None, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None
        self.dtype = dtype
        self.reduce_group = reduce_group
        with torch.no_grad():
            train_lib.lecun_normal_(self.weight, d_in, gen)

    def params(self):
        """The weight and bias (None without one) in the compute dtype."""
        b = None if self.bias is None else self.bias.to(self.dtype)
        return self.weight.to(self.dtype), b

    def forward(self, x):
        w, b = self.params()
        if self.reduce_group is None:
            return F.linear(x.to(self.dtype), w, b)
        y = F.linear(x.to(self.dtype).float(), w.float())
        y = parallel.reduce_from_tensor(y, self.reduce_group)
        return y.to(self.dtype) if b is None else y.to(self.dtype) + b


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: statistics and affine in fp32, eps 1e-6,
    output in ``dtype``.  (flax takes the variance as E[x^2] - E[x]^2, torch
    in two passes: the same value to fp32 rounding, one fused kernel.)"""

    def __init__(self, hidden: int, dtype: torch.dtype, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden))
        self.bias = nn.Parameter(torch.zeros(hidden))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x):
        y = F.layer_norm(x.float(), self.weight.shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.dtype)


class RMSNorm(nn.Module):
    """RMSNorm of the pre-norm block family: ``x / sqrt(mean(x^2) + eps)``
    times the scale, in fp32 (eps 1e-6), output in ``dtype``."""

    def __init__(self, hidden: int, dtype: torch.dtype, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x):
        y = F.rms_norm(x.float(), self.weight.shape, self.weight, self.eps)
        return y.to(self.dtype)


@dataclasses.dataclass(frozen=True)
class YaRN:
    """YaRN's rotary scaling (HF ``_compute_yarn_parameters``, at its
    default ``beta_fast`` 32, ``beta_slow`` 1 and attention factor): the
    frequencies blended between the plain ones and those divided by
    ``factor`` over the dims whose wavelengths fall between ``beta_fast``
    and ``beta_slow`` rotations of ``original`` positions, and cos/sin
    scaled by ``0.1 ln(factor) + 1``."""

    factor: float
    original: int
    beta_fast = 32.0
    beta_slow = 1.0

    def correction_range(self, d: int, theta: float):
        """(low, high) dims of the blend's ramp, floored and ceiled, as HF
        truncates them."""

        def dim(rotations):
            return (d * math.log(self.original / (rotations * 2 * math.pi))
                    / (2 * math.log(theta)))

        low = math.floor(dim(self.beta_fast))
        high = math.ceil(dim(self.beta_slow))
        return max(low, 0), min(high, d - 1)

    def scale(self) -> float:
        return 0.1 * math.log(self.factor) + 1.0


def rope_frequencies(d: int, theta: float, yarn: Optional[YaRN], device):
    """(the d/2 inverse frequencies, the cos/sin scale) of rotary
    embedding at head dim ``d``: ``1 / theta^(2i/d)``, or YaRN's blend."""
    half = d // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=device) / half)
    if yarn is None:
        return inv, 1.0
    low, high = yarn.correction_range(d, theta)
    ramp = torch.clamp((torch.arange(half, dtype=torch.float32, device=device)
                        - low) / max(high - low, 1e-3), 0, 1)
    extrapolate = 1 - ramp  # 1: keep the plain frequency
    inv = inv / yarn.factor * (1 - extrapolate) + inv * extrapolate
    return inv, yarn.scale()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
         yarn: Optional[YaRN] = None):
    """Rotary position embedding (GPT-NeoX half-split convention) on
    ``x`` [batch, seq, heads, head_dim] at absolute ``positions`` [seq];
    with ``yarn`` its frequencies and cos/sin scale."""
    d = x.shape[-1]
    half = d // 2
    inv, scale = rope_frequencies(d, theta, yarn, x.device)
    freqs = positions[:, None].to(torch.float32) * inv  # [s, d/2]
    cos = torch.cos(freqs)[None, :, None, :] * scale
    sin = torch.sin(freqs)[None, :, None, :] * scale
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class Attention(nn.Module):
    """Multi-head (or grouped-query) self-attention.  Training runs the
    ``attention_fn`` (dense or flash) over the whole sequence; decode
    (``cache`` given) attends one new token against the KV cache.  A
    sequence-parallel ``attention_fn`` takes a shard at ``positions``;
    without them (the full route's decode of a MoE model) the
    ``whole_attention_fn`` attends the whole sequence on every rank.

    Under tensor parallelism (``tp_group``) the rank holds ``heads / n``
    query heads and ``kv_heads / n`` KV heads, a contiguous block of each
    (so a GQA group stays whole), and ``out``'s matching input columns:
    the attention function and the cache see the local heads only.

    ``head_dim`` (default ``hidden / heads``) sizes the heads, so the query
    width ``heads x head_dim`` may differ from ``hidden``; ``bias=False``
    leaves the projections' biases out; rotary positions take
    ``rope_theta`` and, with ``yarn``, YaRN's scaling."""

    def __init__(self, hidden: int, heads: int, dtype: torch.dtype,
                 attention_fn: Optional[Callable], gen: torch.Generator,
                 kv_heads: Optional[int] = None, use_rope: bool = False,
                 window: int = 0, tp_group=None,
                 whole_attention_fn: Optional[Callable] = None,
                 head_dim: int = 0, bias: bool = True,
                 rope_theta: float = 10000.0, yarn: Optional[YaRN] = None):
        super().__init__()
        n = parallel.group_size(tp_group)
        hkv = kv_heads or heads
        self.hidden, self.heads, self.hkv = hidden, heads // n, hkv // n
        self.d = head_dim or hidden // heads
        self.tp_group = tp_group
        self.attention_fn = attention_fn or parallel.full_attention
        self.whole_attention_fn = whole_attention_fn
        self.use_rope = use_rope
        self.rope_theta, self.yarn = rope_theta, yarn
        # causal sliding window (0 = full context); the cached decode masks
        # slots behind it so it matches windowed training exactly
        self.window = window
        width = heads * self.d
        self.query = Dense(hidden, width, dtype, gen, bias=bias)
        self.key = Dense(hidden, hkv * self.d, dtype, gen, bias=bias)
        self.value = Dense(hidden, hkv * self.d, dtype, gen, bias=bias)
        self.out = Dense(width, hidden, dtype, gen, reduce_group=tp_group,
                         bias=bias)

    def _rope(self, x, positions):
        return rope(x, positions, self.rope_theta, self.yarn)

    def forward(self, x, cache=None, positions=None):
        """``cache``: ``(k, v, index)`` of this layer in decode, else None.
        ``positions``: the global positions of ``x``'s tokens (a sequence
        shard's), else ``arange(s)``."""
        b, s, _ = x.shape
        q, k, v = parallel.column_parallel(
            x.to(self.query.dtype),
            [d.params() for d in (self.query, self.key, self.value)],
            self.tp_group)
        q = q.reshape(b, s, self.heads, self.d)
        k = k.reshape(b, s, self.hkv, self.d)
        v = v.reshape(b, s, self.hkv, self.d)
        if cache is not None:
            o = self._attend_cache(q, k, v, *cache)
        else:
            if self.use_rope:
                pos = (torch.arange(s, device=x.device) if positions is None
                       else positions)
                q, k = self._rope(q, pos), self._rope(k, pos)
            fn = self.attention_fn
            if positions is None and self.whole_attention_fn is not None:
                fn = self.whole_attention_fn
            o = fn(q, k, v)  # [b, s, h, d]
        return self.out(o.reshape(b, s, self.heads * self.d))

    def _attend_cache(self, q, k, v, ck, cv, i: int):
        """One decode position against the cache (``bert.py`` cache branch):
        write this token's K/V at slot ``i`` (in place), then a grouped
        einsum over the KV heads in the compute dtype, as the JAX package
        computes it (bf16 scores, mask and softmax under --bf16)."""
        b, s = q.shape[:2]
        if s != 1:
            raise ValueError(
                f"cached decode feeds one position at a time, got {s}")
        if self.use_rope:
            # rotate at the decode cursor; the cache holds rotated keys
            pos = torch.tensor([i], device=q.device)
            q, k = self._rope(q, pos), self._rope(k, pos)
        ck[:, i] = k[:, 0]
        cv[:, i] = v[:, 0]
        rep = self.heads // self.hkv
        # the rep query heads sharing a KV head attend the cache directly,
        # with no rep-times K/V repeat
        qg = q.reshape(b, s, self.hkv, rep, self.d)
        sc = torch.einsum("bqhrd,bkhd->bhrqk", qg, ck) * self.d ** -0.5
        # causal: only filled slots (<= i) are visible, and with a window
        # only the trailing ``window`` of them
        slots = torch.arange(ck.shape[1], device=q.device)
        vis = slots <= i
        if self.window:
            vis = vis & (i - slots < self.window)
        sc = sc.masked_fill(~vis, -1e30)
        p = torch.softmax(sc, dim=-1)
        o = torch.einsum("bhrqk,bkhd->bqhrd", p, cv)
        return o.reshape(b, s, self.heads, self.d)


# the Switch layer's aux-loss coefficients: load balance and router z-loss
MOE_AUX_COEF, MOE_Z_COEF = 0.01, 1e-3
# the dropless layer's: Qwen-MoE's router_aux_loss_coef, no z-loss
DROPLESS_AUX_COEF, DROPLESS_Z_COEF = 1e-3, 0.0


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Static MoE hyperparameters (the JAX package's; its mesh is the
    model's ``moe_groups``).  ``expert_width`` (0: the model's
    intermediate) sizes each expert; ``aux_coef`` and ``z_coef`` weigh the
    aux losses.  The block family picks the layer: the post-LN trunk's is
    capacity-bound (``MoEMlp``), the pre-norm family's dropless
    (``DroplessMoE``)."""

    experts: int
    k: int = 2
    capacity_factor: float = 1.25
    expert_width: int = 0
    aux_coef: float = MOE_AUX_COEF
    z_coef: float = MOE_Z_COEF


class MoEMlp(nn.Module):
    """Sparse MoE FFN (``parallel.moe_ffn``), with flax's param layout:
    ``router`` [d, E] (fp32, normal(0.02)), ``wi`` [E, d, f] and ``wo``
    [E, f, d] (flax's lecun_normal, whose fan-in counts the expert axis as
    receptive field: d * E and f * E), cast to the compute dtype at each
    use.  All three are drawn whole from the seed; on ``groups`` the model
    then keeps this rank's experts and block of f (``Bert``'s
    ``parallel.ep_shard_`` / ``tp_shard_``), so the generator's stream and
    every later parameter are one process's."""

    def __init__(self, hidden: int, intermediate: int, cfg: MoEConfig,
                 dtype: torch.dtype, gen: torch.Generator,
                 groups: Optional[parallel.MoEGroups] = None):
        super().__init__()
        e = cfg.experts
        self.cfg, self.dtype, self.groups = cfg, dtype, groups
        self.router = nn.Parameter(torch.empty(hidden, e))
        self.wi = nn.Parameter(torch.empty(e, hidden, intermediate))
        self.wo = nn.Parameter(torch.empty(e, intermediate, hidden))
        with torch.no_grad():
            self.router.normal_(0.0, 0.02, generator=gen)
            train_lib.lecun_normal_(self.wi, hidden * e, gen)
            train_lib.lecun_normal_(self.wo, intermediate * e, gen)

    def forward(self, x, valid=None, positions=None):
        return parallel.moe_ffn(
            x, self.router, self.wi.to(self.dtype), self.wo.to(self.dtype),
            k=self.cfg.k, capacity_factor=self.cfg.capacity_factor,
            valid=valid, groups=self.groups, positions=positions)


class _LayerMark(torch.autograd.Function):
    """The identity, marking ``phase`` on the card in the forward (and in
    remat's recompute) and ``back`` in the backward: a layer's two sides
    in both passes (``train_lib.PhaseMarks``)."""

    @staticmethod
    def forward(ctx, x, marks, phase, back):
        marks(phase)
        ctx.marks, ctx.back = marks, back
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.marks(ctx.back)
        return grad, None, None, None


class DroplessMoE(nn.Module):
    """The dropless SwiGLU expert layer (``parallel.moe_dropless``) on one
    device: ``router`` [d, E] (fp32, normal(0.02)), ``wi`` [E, d, 2f] (each
    expert's gate and up projections side by side) and ``wo`` [E, f, d],
    lecun-normal over d and f, held in fp32 and cast inside the grouped
    product.  Its work lies between the marks ``moe_in`` and ``moe_out``
    in the forward, remat's recompute and the backward."""

    def __init__(self, hidden: int, width: int, cfg: MoEConfig,
                 dtype: torch.dtype, gen: torch.Generator):
        super().__init__()
        e = cfg.experts
        self.cfg, self.dtype = cfg, dtype
        self.router = nn.Parameter(torch.empty(hidden, e))
        self.wi = nn.Parameter(torch.empty(e, hidden, 2 * width))
        self.wo = nn.Parameter(torch.empty(e, width, hidden))
        with torch.no_grad():
            self.router.normal_(0.0, 0.02, generator=gen)
            train_lib.lecun_normal_(self.wi, hidden, gen)
            train_lib.lecun_normal_(self.wo, width, gen)
        self._marks = None

    def forward(self, x, valid=None, positions=None):
        if self._marks is None:
            self._marks = train_lib.PhaseMarks(x.device)
        x = _LayerMark.apply(x, self._marks, "moe_in", "moe_out")
        y, metrics = parallel.moe_dropless(x.to(self.dtype), self.router,
                                           self.wi, self.wo, k=self.cfg.k,
                                           valid=valid)
        return _LayerMark.apply(y, self._marks, "moe_out", "moe_in"), metrics


class PreNormBlock(nn.Module):
    """The pre-norm block family: ``x + Attn(RMSNorm(x))``, then ``x +
    FFN(RMSNorm(x))`` with a SwiGLU FFN, ``mlp_wo(silu(gate) * up)`` (dense:
    ``mlp_wi`` [2f, d] gives gate and up), or the dropless SwiGLU experts
    (``moe``); no biases.  One device (the flag checks refuse every
    sharded layout)."""

    def __init__(self, hidden: int, heads: int, intermediate: int,
                 dtype: torch.dtype, attention_fn: Optional[Callable],
                 gen: torch.Generator, kv_heads: Optional[int] = None,
                 use_rope: bool = False, window: int = 0,
                 moe: Optional[MoEConfig] = None, head_dim: int = 0,
                 rope_theta: float = 10000.0, yarn: Optional[YaRN] = None):
        super().__init__()
        self.ln_attn = RMSNorm(hidden, dtype)
        self.attn = Attention(hidden, heads, dtype, attention_fn, gen,
                              kv_heads, use_rope, window, head_dim=head_dim,
                              bias=False, rope_theta=rope_theta, yarn=yarn)
        self.ln_mlp = RMSNorm(hidden, dtype)
        if moe is not None:
            self.moe = DroplessMoE(hidden, moe.expert_width or intermediate,
                                   moe, dtype, gen)
        else:
            self.moe = None
            self.mlp_wi = Dense(hidden, 2 * intermediate, dtype, gen,
                                bias=False)
            self.mlp_wo = Dense(intermediate, hidden, dtype, gen, bias=False)

    def forward(self, x, cache=None, valid=None, positions=None):
        """As ``Block.forward``."""
        x = x + self.attn(self.ln_attn(x), cache, positions)
        u = self.ln_mlp(x)
        if self.moe is not None:
            h, metrics = self.moe(u, valid, positions)
            return x + h, metrics
        h = self.mlp_wi(u)
        f = h.shape[-1] // 2
        return x + self.mlp_wo(F.silu(h[..., :f]) * h[..., f:])


class Block(nn.Module):
    """Post-LN transformer block with the dense FFN, or with ``moe`` the
    sparse one.  Under tensor parallelism ``mlp_wi`` is column-parallel and
    ``mlp_wo`` row-parallel (a block of the intermediate dim a rank); the
    sparse one exchanges over ``moe_groups``."""

    def __init__(self, hidden: int, heads: int, intermediate: int,
                 dtype: torch.dtype, attention_fn: Optional[Callable],
                 gen: torch.Generator, kv_heads: Optional[int] = None,
                 use_rope: bool = False, window: int = 0,
                 moe: Optional[MoEConfig] = None, tp_group=None,
                 moe_groups: Optional[parallel.MoEGroups] = None,
                 whole_attention_fn: Optional[Callable] = None,
                 head_dim: int = 0, rope_theta: float = 10000.0,
                 yarn: Optional[YaRN] = None):
        super().__init__()
        self.tp_group = tp_group
        self.attn = Attention(hidden, heads, dtype, attention_fn, gen,
                              kv_heads, use_rope, window, tp_group,
                              whole_attention_fn, head_dim,
                              rope_theta=rope_theta, yarn=yarn)
        self.ln_attn = LayerNorm(hidden, dtype)
        if moe is not None:
            self.moe = MoEMlp(hidden, moe.expert_width or intermediate, moe,
                              dtype, gen, moe_groups)
        else:
            self.moe = None
            self.mlp_wi = Dense(hidden, intermediate, dtype, gen)
            self.mlp_wo = Dense(intermediate, hidden, dtype, gen,
                                reduce_group=tp_group)
        self.ln_mlp = LayerNorm(hidden, dtype)

    def forward(self, x, cache=None, valid=None, positions=None):
        """The block's output; a MoE block's is ``(x, metrics)``, its FFN's
        metrics returned rather than kept aside, so that a rematerialised
        block's recomputation writes nothing twice and a captured step
        holds them as outputs.  ``valid`` ([b, s] 0/1) marks the positions
        the MoE routes; a dense block ignores it.  ``positions``: as
        ``Attention.forward`` takes them."""
        x = self.ln_attn(x + self.attn(x, cache, positions))
        if self.moe is not None:
            h, metrics = self.moe(x, valid, positions)
            return self.ln_mlp(x + h), metrics
        [h] = parallel.column_parallel(x.to(self.mlp_wi.dtype),
                                       [self.mlp_wi.params()], self.tp_group)
        h = F.gelu(h, approximate="tanh")
        return self.ln_mlp(x + self.mlp_wo(h))


@dataclasses.dataclass
class KVCache:
    """The decode state of a whole trunk, passed into ``Bert.forward`` and
    returned by it (flax kept it in a mutable ``cache`` collection).

    ``k[l]``/``v[l]``: layer ``l``'s keys (rotated under RoPE) and values,
    ``[batch, length, kv_heads, head_dim]`` in the compute dtype: KV heads
    only, the grouped-query memory saving.  ``index``: the slot the next
    token writes, shared by every layer.  ``position``: the trunk's cursor
    into the learned ``pos_embed``.  A forward writes the new token's K/V
    into the buffers in place and returns a cache one slot further on."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    index: int = 0
    position: int = 0


class Bert(nn.Module):
    """The transformer with a tied LM head (BERT encoder; with a causal
    attention_fn and ``final_ln`` the GPT-2 decoder).

    ``tp_group``: tensor parallelism over that group (Megatron's layout,
    ``parallel.TP_RULES``).  Every rank draws the whole weights from the
    seed, as one process does, and keeps its blocks; the token embedding
    is split over the vocab (the lookup masked to the rank's rows, then
    summed over the group; the tied head's logits gathered).
    ``moe_groups``: the sparse FFN's groups (``parallel.moe_groups``);
    the rank keeps its experts (``parallel.EP_RULES``) the same way.
    ``whole_attention_fn``: the attention of a forward without
    ``positions`` when ``attention_fn`` takes a sequence shard.
    ``exchanges``: the blocks exchange activations with other ranks (a
    sequence, tensor or expert group, or FSDP's parameter gathers); see
    ``trunk``'s remat.  ``stage``: the layers this rank holds, a pipeline
    stage's (``parallel.stage_layers``; default all of them): the rank
    draws the whole model from the seed, as one process does, and drops
    the other stages' blocks, so a block keeps its one-process name
    (``layer_<i>``) and weights; the embeddings and LayerNorms stay on
    every stage.

    ``block``: ``"post_ln"`` (the JAX package's trunk) or ``"pre_rms"``
    (``PreNormBlock``s, no ``ln_embed``, an RMSNorm ``ln_f``).
    ``head_dim``: the heads' size (default ``hidden / heads``).
    ``layer_windows``: each layer's window (default ``window`` for all),
    its attention ``attention_for(window)``; rotary positions take
    ``rope_theta``, and the full-context layers (window 0) ``yarn`` too.
    ``untied_head``: the head is ``lm_head``, a bias-free projection of
    its own, not the embedding table."""

    def __init__(self, vocab: int = 30522, hidden: int = 1024, layers: int = 24,
                 heads: int = 16, intermediate: int = 4096, max_seq: int = 512,
                 dtype: torch.dtype = torch.float32,
                 attention_fn: Optional[Callable] = None, remat: bool = True,
                 final_ln: bool = False, kv_heads: Optional[int] = None,
                 use_rope: bool = False, window: int = 0, seed: int = 0,
                 moe: Optional[MoEConfig] = None,
                 exchanges: bool = False, tp_group=None,
                 moe_groups: Optional[parallel.MoEGroups] = None,
                 whole_attention_fn: Optional[Callable] = None,
                 stage: Optional[range] = None, block: str = "post_ln",
                 head_dim: int = 0,
                 layer_windows: Optional[List[int]] = None,
                 attention_for: Optional[Callable[[int], Callable]] = None,
                 rope_theta: float = 10000.0, yarn: Optional[YaRN] = None,
                 untied_head: bool = False):
        super().__init__()
        self.vocab, self.layers, self.max_seq = vocab, layers, max_seq
        self.stage = range(layers) if stage is None else stage
        self.dtype, self.remat, self.final_ln = dtype, remat, final_ln
        self.use_rope, self.moe = use_rope, moe
        expert_group = moe_groups.expert if moe_groups else None
        self.exchanges = (exchanges or tp_group is not None
                          or expert_group is not None)
        self.tp_group = tp_group
        gen = torch.Generator().manual_seed(seed)
        # vocab padded to a multiple of 128 (the JAX package's Megatron
        # padding); logits are sliced back to the true vocab
        vocab_padded = -(-vocab // 128) * 128
        table = torch.empty(vocab_padded, hidden).normal_(
            0.0, hidden ** -0.5, generator=gen)
        self.token_embed = nn.Embedding.from_pretrained(table, freeze=False)
        if not use_rope:
            self.pos_embed = nn.Parameter(torch.empty(max_seq, hidden))
            with torch.no_grad():
                self.pos_embed.normal_(0.0, 0.02, generator=gen)
        pre = block == "pre_rms"
        self.ln_embed = None if pre else LayerNorm(hidden, dtype)
        if final_ln:
            self.ln_f = (RMSNorm if pre else LayerNorm)(hidden, dtype)
        windows = layer_windows or [window] * layers
        for i in range(layers):
            w = windows[i]
            fn = attention_fn if attention_for is None else attention_for(w)
            attn = dict(head_dim=head_dim, rope_theta=rope_theta,
                        yarn=None if w else yarn)
            if pre:
                blk = PreNormBlock(hidden, heads, intermediate, dtype, fn,
                                   gen, kv_heads, use_rope, w, moe, **attn)
            else:
                blk = Block(hidden, heads, intermediate, dtype, fn, gen,
                            kv_heads, use_rope, w, moe, tp_group, moe_groups,
                            whole_attention_fn, **attn)
            setattr(self, f"layer_{i}", blk)
        self.lm_head = (Dense(hidden, vocab_padded, dtype, gen, bias=False)
                        if untied_head else None)
        for i in range(layers):
            if i not in self.stage:
                delattr(self, f"layer_{i}")
        parallel.tp_shard_(self, tp_group)
        parallel.ep_shard_(self, expert_group)

    def embed(self, ids, position: int = 0, positions=None):
        """Token embedding plus the learned positions from ``position`` on
        (the decode cursor; 0 for a whole sequence), or at ``positions``
        (a sequence shard's global positions)."""
        table = self.token_embed.weight.to(self.dtype)
        if self.tp_group is None:
            x = F.embedding(ids, table)
        else:
            # the rank's block of the vocab: its ids looked up, the rest 0,
            # and one rank's row summed into each token
            lo = parallel.group_rank(self.tp_group) * table.shape[0]
            local = ids - lo
            mine = (local >= 0) & (local < table.shape[0])
            x = F.embedding(torch.where(mine, local, 0), table)
            x = parallel.reduce_from_tensor(
                x.masked_fill(~mine[..., None], 0.0), self.tp_group)
        if not self.use_rope:
            pos = (self.pos_embed[position : position + ids.shape[1]]
                   if positions is None else self.pos_embed[positions])
            x = x + pos[None].to(self.dtype)
        return x if self.ln_embed is None else self.ln_embed(x)

    def head(self, x):
        if self.final_ln:
            x = self.ln_f(x)
        if self.lm_head is not None:
            return self.lm_head(x)[..., : self.vocab]
        # tied LM head: the JAX model casts x to fp32, but flax's
        # Embed.attend then promotes it and the table to the module dtype,
        # so under bf16 the logits are bf16
        [logits] = parallel.column_parallel(
            x.to(self.dtype), [(self.token_embed.weight.to(self.dtype), None)],
            self.tp_group)
        logits = parallel.gather_from_tensor(logits, self.tp_group)
        return logits[..., : self.vocab]

    def forward(self, ids, cache: Optional[KVCache] = None, valid=None,
                with_metrics: bool = False, positions=None):
        """Logits of ``ids`` [b, s]; with ``cache``, decode: ``ids`` is one
        position [b, 1], and the result is ``(logits, next cache)``.
        ``valid`` ([b, s] 0/1) marks the real tokens: MoE routing skips the
        rest, so a fixed decode buffer stays causal; dense models ignore
        it.  ``with_metrics``: return ``(logits, metrics)``, one dict of
        ``parallel.moe_ffn`` metrics a MoE layer (what the JAX package
        sows into ``moe_metrics``).  ``positions`` [s]: the global
        positions of a sequence shard's tokens (``seq_positions``)."""
        if cache is not None:
            return self._decode(ids, cache)
        x, metrics = self.trunk(self.embed(ids, positions=positions), valid,
                                positions)
        logits = self.head(x)
        return (logits, metrics) if with_metrics else logits

    def trunk(self, x, valid=None, positions=None,
              remat: Optional[bool] = None):
        """The blocks this model holds (all of them, or its pipeline
        stage's) applied to ``x``, and a MoE model's metrics, one dict a
        layer.  ``remat`` (default ``self.remat``) checkpoints each block
        when grad is enabled; the 1F1B stage passes False, its backward
        tick recomputing the stage already."""
        remat = self.remat if remat is None else remat
        metrics = []
        for i in self.stage:
            blk = getattr(self, f"layer_{i}")
            if remat and torch.is_grad_enabled():
                # rematerialise each block on backward (jax.checkpoint);
                # the trunk draws no random numbers (no dropout, as in the
                # JAX package), so no RNG state is saved: reading it is
                # not allowed inside a CUDA graph capture.  When the block
                # exchanges with other ranks (sequence or tensor
                # parallelism, FSDP) the recomputation runs the whole
                # block: one that stopped at its last saved tensor would
                # skip an exchange on one rank that another rank waits for
                with set_checkpoint_early_stop(not self.exchanges):
                    x = checkpoint(blk, x, None, valid, positions,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
            else:
                x = blk(x, valid=valid, positions=positions)
            if self.moe is not None:
                x, m = x
                metrics.append(m)
        return x, metrics

    def _decode(self, ids, cache: KVCache):
        """One position through the trunk with every layer's attention on
        the cache (dense, whatever the training attention_fn), no remat."""
        x = self.embed(ids, cache.position)
        for i in range(self.layers):
            x = getattr(self, f"layer_{i}")(
                x, (cache.k[i], cache.v[i], cache.index))
            if self.moe is not None:
                x = x[0]
        return self.head(x), dataclasses.replace(
            cache, index=cache.index + 1, position=cache.position + 1)

    def new_cache(self, batch: int, length: int) -> KVCache:
        """An empty cache of ``length`` slots on the model's device."""
        attn = self.layer_0.attn
        shape = (batch, length, attn.hkv, attn.d)
        dev = self.token_embed.weight.device
        return KVCache(
            k=[torch.zeros(shape, dtype=self.dtype, device=dev)
               for _ in range(self.layers)],
            v=[torch.zeros(shape, dtype=self.dtype, device=dev)
               for _ in range(self.layers)])


# ---------------------------------------------------------------------------
# pipeline parallelism
# ---------------------------------------------------------------------------


def pipeline_apply(model: Bert, ids, mesh, num_microbatches: int):
    """Logits of ``ids`` with the trunk run as a GPipe pipeline over
    ``mesh``'s pipeline group (``parallel.pipeline``; each block
    checkpointed under ``model.remat``): the JAX package's
    ``pipeline_apply``.  Every stage embeds and runs the head on the
    pipeline's output, as the JAX package does on its replicated arrays,
    so every stage holds the logits.  A forward: training runs
    ``make_pipeline_value_and_grad``, which embeds on the first stage and
    runs the head once, on the last."""
    y = parallel.pipeline(lambda xb: model.trunk(xb)[0], model.embed(ids),
                          mesh.group("pipeline"), num_layers=model.layers,
                          num_microbatches=num_microbatches)
    return model.head(y)


def _sum_grads(params, group, loss: torch.Tensor) -> torch.Tensor:
    """Each parameter's ``.grad`` (0 where it has none) and ``loss``,
    summed over ``group`` in one fp32 all-reduce and written back: the
    summed loss (fp32)."""
    flat = torch.cat([(p.grad if p.grad is not None else
                       torch.zeros_like(p)).reshape(-1).float()
                      for p in params] + [loss.reshape(1).float()])
    flat = parallel._all_reduce(flat, group)
    at = 0
    for p in params:
        p.grad = flat[at : at + p.numel()].view_as(p).to(p.dtype)
        at += p.numel()
    return flat[-1]


def make_pipeline_value_and_grad(model: Bert, mesh, num_microbatches: int,
                                 head_loss, preprocess, *,
                                 schedule: str = "gpipe",
                                 batch_shards: int = 1):
    """``vag(batch) -> loss``: one step's fused forward and backward of
    the pipelined ``model`` (this rank's stage), its gradients left in
    ``.grad``: the JAX package's ``make_1f1b_value_and_grad``, and its
    GPipe path, on ``pipeline_schedule.pipeline_1f1b`` /
    ``pipeline_gpipe`` over ``mesh``'s pipeline group.

    ``preprocess(batch) -> (ids, extra)``: the trunk's input ids and the
    ``[b, ...]`` tensors the loss needs; ``head_loss(logits, extra) ->
    scalar``: under 1F1B a microbatch's loss, scaled so that the mean
    over the microbatches is the rank's loss; under GPipe the whole
    batch's (the workloads' ``make_f1b``).  Stage 0 embeds (under grad,
    and runs the embedding's backward from the schedule's input
    gradient); the last stage runs the head and the loss.  The 1F1B stage
    does not checkpoint its blocks, its backward tick recomputing them
    already; the GPipe stage does under ``model.remat``.

    The gradients of the parameters every stage holds (the embeddings,
    the LayerNorms outside the blocks) are each stage's own part, the
    embedding's on the first and the head's on the last (the tied table
    gets both), summed over the stages in one all-reduce, with the loss
    beside them: every stage ends with one process's gradient and the
    loss.  Then every gradient is averaged over the rank's data group
    (the ranks of its stage that hold other rows: DDP's all-reduce,
    divided by ``batch_shards``, the one shard decision the loss scaling
    was made against).  A layer's gradient is never summed across
    stages.  The returned loss is the rank's; the train step averages it
    over the data group (``train_lib.global_mean``)."""
    group, data = mesh.group("pipeline"), dist.token_group(mesh)
    s = mesh.index("pipeline")
    shared = [p for name, p in model.named_parameters()
              if not name.startswith("layer_")]
    hidden = model.token_embed.weight.shape[1]
    if schedule == "1f1b":
        run = pipeline_schedule.pipeline_1f1b
        stage_fn = lambda xb: model.trunk(xb, remat=False)[0]  # noqa: E731
    else:
        run = pipeline_schedule.pipeline_gpipe
        stage_fn = lambda xb: model.trunk(xb)[0]  # noqa: E731

    def head_fn(y, extra):
        return head_loss(model.head(y), extra)

    def vag(batch):
        ids, extra = preprocess(batch)
        if s == 0:
            x = model.embed(ids)
        else:
            x = torch.empty(*ids.shape, hidden, dtype=model.dtype,
                            device=ids.device)
        res = run(stage_fn, x, head_fn, extra, group, num_layers=model.layers,
                  num_microbatches=num_microbatches)
        if s == 0:
            torch.autograd.backward(x, res.dx)
        loss = _sum_grads(shared, group, res.loss)
        if data is not None:
            for p in model.parameters():
                with parallel.counted(p.grad):
                    tdist.all_reduce(p.grad, group=data)
                p.grad.div_(batch_shards)
        return loss

    return vag


# ---------------------------------------------------------------------------
# masked-LM objective
# ---------------------------------------------------------------------------


# the losses' coefficients of the MoE aux terms (the JAX package's defaults)
# the loss's extra outputs (``train_lib.loss_extras``) after a MoE step,
# in this order; the dropless layer drops nothing and has no ``dropped``
MOE_METRICS = ("load_balance", "router_z", "dropped")


def moe_terms(metrics: List[Dict[str, torch.Tensor]], mesh=None
              ) -> Dict[str, torch.Tensor]:
    """The aux terms of a MoE forward from its layers' ``moe_ffn`` metrics:
    the mean over the layers of the load balance and of the router z-loss
    (the JAX package's ``_mean_sown``), and this rank's dropped
    assignments summed over the layers (capacity-bound layers only).

    The load balance is the GLOBAL batch's, as the JAX package's data axis
    computes it: the per-expert top-1 counts and the token count (no grad)
    are summed over the ranks that hold distinct tokens (``mesh``'s token
    axes, or the world: ``train_lib.global_sum``), and the rank's own sum
    of probabilities (the differentiated factor) is scaled by their
    number, so the mean of this term over those ranks, and DDP's mean of
    its gradients, are the whole batch's.  The ranks of an expert or
    tensor group hold the same rows and are counted once.  The z-loss is
    a mean over equal local batches and needs nothing."""
    counts = train_lib.global_sum(torch.stack(
        [torch.cat([m["density_count"], m["tokens"][None]]) for m in metrics]),
        mesh)
    prob_sum = (torch.stack([m["prob_sum"] for m in metrics])
                * dist.token_shards(mesh))
    lb = parallel.load_balance(counts[:, :-1], prob_sum, counts[:, -1])
    terms = {"load_balance": lb.mean(),
             "router_z": torch.stack([m["router_z"] for m in metrics]).mean()}
    if "dropped" in metrics[0]:
        terms["dropped"] = torch.stack([m["dropped"] for m in metrics]).sum()
    return terms


def moe_forward(model: nn.Module, ids, loss_fn, positions=None, mesh=None):
    """``(logits, terms)`` of ``model`` (a ``Bert`` or its DDP wrapper) on
    ``ids`` (at ``positions``, a sequence shard's): ``terms`` are
    ``moe_terms`` over ``mesh`` for a MoE model, with the model's aux-loss
    coefficients (``coefs``), None for a dense one.  Their values
    (``MOE_METRICS``) are ``loss_fn``'s extra outputs
    (``train_lib.set_loss_extras``), which ``train`` reads after each
    step."""
    moe = getattr(model, "module", model).moe
    if moe is None:
        return model(ids, positions=positions), None
    logits, metrics = model(ids, with_metrics=True, positions=positions)
    terms = moe_terms(metrics, mesh)
    train_lib.set_loss_extras(
        loss_fn, torch.stack([terms[k] for k in MOE_METRICS if k in terms]))
    terms["coefs"] = (moe.aux_coef, moe.z_coef)
    return logits, terms


def with_moe_aux(loss, terms):
    """``loss`` plus the MoE aux terms, each at its coefficient (unchanged
    for a dense model; a zero coefficient adds nothing)."""
    if terms is None:
        return loss
    aux, z = terms.get("coefs", (MOE_AUX_COEF, MOE_Z_COEF))
    loss = loss + aux * terms["load_balance"]
    return loss + z * terms["router_z"] if z else loss


def mlm_loss(model: nn.Module, mask_id: int = 103, positions=None,
             mesh=None):
    """Masked LM: predict the original ids at the masked positions.
    ``mask_id`` is the [MASK] token (103, the WordPiece id, for synthetic
    vocabularies).  The log-softmax runs in the logits' dtype (bf16 under
    --bf16) and the masked mean in fp32, as in the JAX package.  A MoE
    model adds the load-balance aux loss and the router z-loss
    (``MOE_AUX_COEF``, ``MOE_Z_COEF``).

    The mean is over the GLOBAL batch's masked positions, which differ in
    number from rank to rank: each rank divides its sum by the global
    count over the ranks that hold distinct tokens (``mesh``'s token axes,
    or the world), scaled by their number, so their mean (the mean of the
    grads, and the reported loss) is the JAX package's loss of the whole
    batch.  A rank of a sequence group holds its columns of ids and mask,
    at ``positions``: the same sums cover them; the ranks of a tensor
    group hold the same tokens and are counted once."""

    def loss_fn(batch):
        ids, mask = batch  # mask: 1.0 where the position is predicted
        masked_ids = torch.where(mask > 0, mask_id, ids)
        logits, terms = moe_forward(model, masked_ids, loss_fn, positions,
                                    mesh)
        logp = torch.log_softmax(logits, dim=-1)
        tok_ll = torch.gather(logp, -1, ids[..., None])[..., 0]
        count = torch.clamp(train_lib.global_sum(mask.sum(), mesh), min=1.0)
        loss = -(tok_ll * mask).sum() * dist.token_shards(mesh) / count
        return with_moe_aux(loss, terms)

    return loss_fn


def mask_batch(ids: np.ndarray, seed: int, rate: float = 0.15):
    """(ids, mask): a fixed 15% mask drawn from ``seed`` (the JAX
    package's draw, so the masks are the same arrays)."""
    rng = np.random.RandomState(seed)
    mask = (rng.rand(*ids.shape) < rate).astype(np.float32)
    return ids, mask


# ---------------------------------------------------------------------------
# flag surface
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    """The JAX package's flag surface."""
    p = argparse.ArgumentParser(description="BERT-large / GPT transformer "
                                            "pretrain (PyTorch port)")
    p.add_argument("--vocab", type=int, default=30522)
    p.add_argument("--hidden", type=int, default=1024)
    p.add_argument("--layers", type=int, default=24)
    p.add_argument("--heads", type=int, default=16)
    p.add_argument("--kv-heads", type=int, default=0,
                   help="grouped-query attention: project K/V to this "
                        "many heads (must divide --heads; 0 = MHA)")
    p.add_argument("--position", choices=["learned", "rope"],
                   default="learned",
                   help="positional encoding: learned absolute embedding "
                        "or rotary on q/k")
    p.add_argument("--intermediate", type=int, default=4096)
    p.add_argument("--block", choices=["post_ln", "pre_rms"],
                   default="post_ln",
                   help="block family: post_ln (the JAX package's trunk: "
                        "post-LN LayerNorm blocks, GELU, biases, a LayerNorm "
                        "after the embedding) or pre_rms (pre-norm RMSNorm "
                        "blocks, SwiGLU FFN or experts, no biases); pre_rms "
                        "runs on one device or under data parallelism")
    p.add_argument("--head-dim", type=int, default=0,
                   help="size of each attention head (0 = hidden / heads); "
                        "the query width is heads x head-dim")
    p.add_argument("--attention-pattern", default="",
                   help="per-layer attention, one letter a layer, repeated "
                        "over the layers: S a sliding window of "
                        "--attention-window, F full context (e.g. SSSF); "
                        "empty = every layer takes --attention-window")
    p.add_argument("--rope-theta", type=float, default=10000.0,
                   help="rotary base (with --position rope)")
    p.add_argument("--yarn-factor", type=float, default=0.0,
                   help="YaRN context scaling of the rotary frequencies on "
                        "the full-context layers (0 = off)")
    p.add_argument("--yarn-original-positions", type=int, default=0,
                   help="YaRN's original context length")
    p.add_argument("--untied-head", action="store_true",
                   help="an output projection of its own (lm_head) instead "
                        "of the embedding table")
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=32, help="global batch")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr-schedule", choices=["constant", "cosine"],
                   default="constant",
                   help="constant (optionally warmed up) or cosine decay "
                        "to 0 at --steps")
    p.add_argument("--warmup-steps", type=int, default=0,
                   help="linear LR warmup from 0 over this many steps")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="average grads over this many mini-steps per "
                        "optimizer update (effective batch multiplier)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="size of the tensor-parallel axis (Megatron: the "
                        "heads, the FFN and the vocab split over it)")
    p.add_argument("--sequence-parallel", type=int, default=1,
                   help="size of the sequence-parallel axis (ranks that "
                        "split each sequence)")
    p.add_argument("--sp-mode", choices=["ring", "ulysses"], default="ring",
                   help="sequence-parallel attention: ring (K/V blocks "
                        "passed around the group, the zigzag schedule "
                        "for causal attention) or ulysses (all-to-all "
                        "sequence -> heads; --attention flash runs the "
                        "kernels on the re-sharded heads)")
    p.add_argument("--attention", choices=["dense", "flash"], default="dense",
                   help="attention: dense (torch) or flash (the "
                        "hand-written Hopper kernels)")
    p.add_argument("--attention-window", type=int, default=0,
                   help="causal sliding-window attention: each query sees "
                        "at most this many trailing positions (0 = full "
                        "context); the flash kernels skip whole "
                        "out-of-window tiles. Causal (gpt) family only")
    p.add_argument("--moe-experts", type=int, default=0,
                   help="replace each FFN with a sparse MoE of this many "
                        "experts (0 = dense)")
    p.add_argument("--moe-k", type=int, default=2,
                   help="experts routed per token")
    p.add_argument("--moe-capacity-factor", type=float, default=1.25,
                   help="per-expert buffer slack over perfect balance")
    p.add_argument("--moe-expert-width", type=int, default=0,
                   help="each expert's FFN width (0 = --intermediate)")
    p.add_argument("--expert-parallel", type=int, default=1,
                   help="size of the expert-parallel axis (the experts "
                        "split over it; needs --moe-experts divisible by "
                        "it)")
    p.add_argument("--pipeline-parallel", type=int, default=1,
                   help="size of the pipeline axis (the layers split into "
                        "that many stages, each rank holding its stage's)")
    p.add_argument("--pipeline-microbatches", type=int, default=0,
                   help="microbatches a stage streams per step (0 = the "
                        "stage count); must divide the per-rank batch")
    p.add_argument("--pipeline-schedule", choices=["gpipe", "1f1b"],
                   default="gpipe",
                   help="gpipe (every forward, then every backward) or "
                        "1f1b (interleaved: the activation stash bounded "
                        "by the stage count)")
    p.add_argument("--fsdp", type=int, default=1,
                   help="size of the FSDP axis (ZeRO-3: parameters and "
                        "optimizer state sharded over it; it also splits "
                        "the batch)")
    p.add_argument("--no-remat", dest="remat", action="store_false", default=True)
    p.add_argument("--log-interval", type=int, default=20)
    train_lib.add_profile_flags(p)
    p.add_argument("--checkpoint-interval", type=int, default=0,
                   help="steps between checkpoints; 0 disables")
    p.add_argument("--data-file", default=None,
                   help="train on this file's raw bytes as a byte-level "
                        "corpus instead of synthetic tokens (vocab >= 256; "
                        "the MLM objective needs >= 257 — id 256 is "
                        "[MASK]); batches cycle the chunks "
                        "deterministically per step")
    p.add_argument("--tokenizer", default=None, metavar="bpe:PATH[:V]",
                   help="tokenize --data-file with a trained byte-level "
                        "BPE instead of raw bytes: 'bpe:PATH' loads PATH; "
                        "'bpe:PATH:V' additionally trains a V-id tokenizer "
                        "on the corpus and saves it to PATH when missing. "
                        "Tokens cache to a memory-mapped sidecar next to "
                        "the corpus")
    p.add_argument("--dir", default="logs")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def moe_config_from(args) -> Optional[MoEConfig]:
    """Validate the MoE flag surface and build the config (None = dense),
    with the JAX package's rules."""
    n_experts = getattr(args, "moe_experts", 0)
    ep = getattr(args, "expert_parallel", 1)
    width = getattr(args, "moe_expert_width", 0)
    if n_experts <= 0:
        if ep > 1:
            raise ValueError("--expert-parallel needs --moe-experts > 0")
        if width:
            raise ValueError("--moe-expert-width needs --moe-experts > 0")
        return None
    if args.moe_k < 1:
        # k=0 would silently zero every MoE FFN (all gates empty)
        raise ValueError(f"--moe-k must be >= 1, got {args.moe_k}")
    if ep > 1 and n_experts % ep != 0:
        raise ValueError(
            f"--moe-experts {n_experts} must divide evenly over "
            f"--expert-parallel {ep}")
    if width < 0:
        raise ValueError(f"--moe-expert-width must be >= 0, got {width}")
    if getattr(args, "block", "post_ln") == "pre_rms":
        # the pre-norm family's experts are dropless SwiGLU ones
        return MoEConfig(experts=n_experts, k=args.moe_k,
                         expert_width=width, aux_coef=DROPLESS_AUX_COEF,
                         z_coef=DROPLESS_Z_COEF)
    return MoEConfig(experts=n_experts, k=args.moe_k,
                     capacity_factor=args.moe_capacity_factor,
                     expert_width=width)


def head_dim_of(args) -> int:
    """The attention heads' size: ``--head-dim``, else hidden / heads."""
    return getattr(args, "head_dim", 0) or args.hidden // args.heads


def layer_windows(args) -> Optional[List[int]]:
    """Each layer's attention window from ``--attention-pattern`` (S: the
    window, F: 0, the letters repeated over the layers), or None without a
    pattern (every layer takes ``--attention-window``)."""
    pattern = getattr(args, "attention_pattern", "")
    if not pattern:
        return None
    window = getattr(args, "attention_window", 0)
    return [window if pattern[i % len(pattern)] == "S" else 0
            for i in range(args.layers)]


def yarn_of(args) -> Optional[YaRN]:
    """``--yarn-*`` as a ``YaRN``, or None with ``--yarn-factor`` 0."""
    factor = getattr(args, "yarn_factor", 0.0)
    if not factor:
        return None
    return YaRN(factor, args.yarn_original_positions)


def validate_block_flags(args, causal: Optional[bool] = None) -> None:
    """The port's own rules for the block family, the head dim, the
    per-layer pattern, YaRN and the untied head: what the flags name must
    be used, and ``--block pre_rms`` runs on one device or under data
    parallelism only."""
    if getattr(args, "head_dim", 0) < 0:
        raise ValueError(f"--head-dim must be >= 0, got {args.head_dim}")
    pattern = getattr(args, "attention_pattern", "")
    if pattern:
        if set(pattern) - {"S", "F"}:
            raise ValueError(f"--attention-pattern takes the letters S and "
                             f"F, got {pattern!r}")
        if "S" in pattern and getattr(args, "attention_window", 0) <= 0:
            raise ValueError("--attention-pattern's S layers need "
                             "--attention-window > 0")
        if causal is False:
            raise ValueError("--attention-pattern (sliding windows) applies "
                             "to the causal family (gpt)")
    if getattr(args, "yarn_factor", 0.0):
        if getattr(args, "position", "learned") != "rope":
            raise ValueError("--yarn-factor scales rotary positions: it "
                             "needs --position rope")
        if args.yarn_factor < 1 or args.yarn_original_positions <= 0:
            raise ValueError("--yarn-factor must be >= 1, with "
                             "--yarn-original-positions > 0")
    if getattr(args, "block", "post_ln") == "pre_rms" or \
            getattr(args, "untied_head", False):
        for flag in ("tensor_parallel", "sequence_parallel",
                     "expert_parallel", "pipeline_parallel", "fsdp"):
            if getattr(args, flag, 1) > 1:
                raise ValueError(
                    f"--block pre_rms and --untied-head run on one device or "
                    f"under data parallelism in this release, not with "
                    f"--{flag.replace('_', '-')}")


def validate_pipeline_flags(args) -> int:
    """Coherence checks for --pipeline-parallel (the JAX package's, with
    its ValueErrors); returns the stage count."""
    pp = getattr(args, "pipeline_parallel", 1)
    micro = getattr(args, "pipeline_microbatches", 0)
    sched = getattr(args, "pipeline_schedule", "gpipe")
    if micro < 0:
        raise ValueError(f"--pipeline-microbatches must be >= 0, got {micro}")
    if micro > 0 and pp <= 1:
        # never drop a requested flag silently
        raise ValueError("--pipeline-microbatches needs --pipeline-parallel > 1")
    if sched != "gpipe" and pp <= 1:
        raise ValueError("--pipeline-schedule needs --pipeline-parallel > 1")
    if sched == "1f1b" and getattr(args, "tensor_parallel", 1) > 1:
        raise ValueError(
            "--pipeline-schedule=1f1b does not compose with "
            "--tensor-parallel in this release; use the gpipe schedule "
            "for TP x PP")
    if pp > 1:
        if getattr(args, "sequence_parallel", 1) > 1:
            raise ValueError(
                "--pipeline-parallel composes with data and tensor "
                "parallelism (the Megatron TP x PP layout) and with "
                "--attention=flash; not with --sequence-parallel in this "
                "release (two nested manual regions over sequence and "
                "pipeline)")
        if getattr(args, "moe_experts", 0) > 0:
            raise ValueError(
                "--pipeline-parallel does not compose with --moe-experts "
                "(the MoE metrics collection cannot cross the pipeline's "
                "manual region)")
        if args.layers % pp != 0:
            raise ValueError(
                f"--layers {args.layers} must divide over "
                f"--pipeline-parallel {pp}")
    if getattr(args, "fsdp", 1) > 1 and pp > 1:
        raise ValueError(
            "--fsdp does not compose with --pipeline-parallel (the "
            "stage param stacks enter the pipeline's manual region "
            "and would be re-gathered whole); pair --fsdp with "
            "--tensor-parallel or --moe-experts instead")
    return pp


def validate_sp_flags(args, causal: Optional[bool] = None) -> None:
    """The JAX package's ValueErrors for the attention flags and for every
    combination with ``--sequence-parallel``, from the flags alone: its
    ``build_model``'s window, Ulysses and flash rules (which it checks
    against the mesh, and the heads at the first Ulysses call).  The
    window's causal-only rule needs ``causal`` (skipped when None)."""
    window = getattr(args, "attention_window", 0)
    sp = getattr(args, "sequence_parallel", 1)
    if window:
        if window < 0:
            raise ValueError(
                f"--attention-window must be >= 1, got {window}")
        if causal is False:
            raise ValueError(
                "--attention-window (causal sliding window) applies to "
                "the causal family (gpt), not the bidirectional MLM")
        if sp > 1:
            raise ValueError(
                "--attention-window does not compose with "
                "--sequence-parallel in this release (the ring/Ulysses "
                "schedules assume full causal visibility)")
    if sp <= 1:
        return
    if getattr(args, "sp_mode", "ring") == "ulysses":
        if getattr(args, "tensor_parallel", 1) > 1:
            raise ValueError(
                "--sp-mode=ulysses does not compose with "
                "--tensor-parallel (the all_to_all consumes the head "
                "dim); use --sp-mode=ring for SP x TP")
        heads = args.heads
        hkv = getattr(args, "kv_heads", 0) or heads
        if heads % sp != 0:
            raise ValueError(
                f"ulysses attention needs heads ({heads}) divisible by the "
                f"'sequence' axis size ({sp}); use ring_attention otherwise")
        if hkv != heads and hkv % sp != 0:
            raise ValueError(
                f"ulysses attention needs KV heads ({hkv}) divisible by the "
                f"'sequence' axis size ({sp}); use ring_attention otherwise")
    elif getattr(args, "attention", "dense") == "flash":
        # never drop a requested kernel silently: the ring's per-hop
        # block update is its own flash-style loop
        raise ValueError(
            "--attention=flash pairs with --sp-mode=ulysses or no "
            "sequence parallelism; the ring path already runs a "
            "fused flash-style block loop")


def validate_tp_flags(args) -> None:
    """The JAX package's ValueErrors for tensor parallelism, from the
    flags alone: flash with TP (its ``build_model``: no partitioning rule
    for the kernel's call, so the JAX package refuses it; the port keeps
    the refusal), then its ``validate_parallel_flags``' KV-head rule.
    Then the port's own rule: the heads, the intermediate dim and the
    padded vocab must split over the tensor ranks (the JAX package's
    placement of such a parameter fails)."""
    tp = getattr(args, "tensor_parallel", 1)
    if (tp > 1 and getattr(args, "sequence_parallel", 1) <= 1
            and getattr(args, "attention", "dense") == "flash"):
        raise ValueError(
            "--attention=flash does not compose with --tensor-parallel "
            "(no GSPMD rule for the Pallas call); use dense attention "
            "with TP, or flash without TP")
    kvh = getattr(args, "kv_heads", 0)
    if kvh > 0 and args.heads % kvh == 0 and tp > 1 and kvh % tp != 0:
        # the K/V projection's output dim is kv_heads*head_dim; a TP
        # split that doesn't divide the KV heads would shard across a
        # head boundary
        raise ValueError(
            f"--kv-heads {kvh} must divide evenly over "
            f"--tensor-parallel {tp}")
    if tp > 1:
        for what, n in (("--heads", args.heads),
                        ("--intermediate", args.intermediate),
                        ("the vocab padded to 128", -(-args.vocab // 128) * 128)):
            if n % tp:
                raise ValueError(f"{what} ({n}) must divide evenly over "
                                 f"--tensor-parallel {tp}")


def validate_parallel_flags(args, causal: Optional[bool] = None) -> int:
    """The flag-coherence rules of every strategy (data, sequence, tensor,
    expert and pipeline parallelism, FSDP, and MoE), in the JAX package's
    order so that its ValueErrors come first: the MoE flags', the RoPE
    and KV-head rules, the pipeline's (``validate_pipeline_flags``, FSDP
    with the pipeline among them), then its ``build_model``'s attention,
    sequence-parallel and tensor-parallel rules (``validate_sp_flags``,
    ``validate_tp_flags``).  Returns the pipeline stage count."""
    moe_config_from(args)
    validate_block_flags(args, causal)
    if getattr(args, "position", "learned") == "rope" \
            and head_dim_of(args) % 2 != 0:
        raise ValueError(
            f"--position rope needs an even head dim, got "
            f"{head_dim_of(args)} (hidden {args.hidden} / heads "
            f"{args.heads}, or --head-dim)")
    kvh = getattr(args, "kv_heads", 0)
    if kvh:
        if kvh < 0:
            raise ValueError(f"--kv-heads must be >= 1, got {kvh}")
        if args.heads % kvh != 0:
            raise ValueError(
                f"--kv-heads {kvh} must divide --heads {args.heads}")
    pp = validate_pipeline_flags(args)
    validate_sp_flags(args, causal)
    validate_tp_flags(args)
    if getattr(args, "grad_accum", 1) < 1:
        raise ValueError(f"grad accumulation must be >= 1, got "
                         f"{args.grad_accum}")
    return pp


def make_mesh_for(args, pe=None) -> "dist.Mesh":
    """The job's mesh from the flags (after the flag checks, so a wrong
    world reports the actionable error): ``mesh_axes``, data soaking up
    the ranks the other axes leave.  Every process calls it together (one
    process group an axis)."""
    validate_parallel_flags(args)
    return dist.make_mesh(mesh_axes(args), env=pe)


def mesh_axes(args) -> Dict[str, int]:
    """The mesh axes the flags ask for (``make_mesh`` takes them; data is
    the ``-1`` wildcard): the port takes its strategy from the flags, where
    the JAX package's ``run`` takes it from the mesh it is handed."""
    axes = {"data": -1}
    if getattr(args, "fsdp", 1) > 1:
        axes["fsdp"] = args.fsdp
    if args.tensor_parallel > 1:
        axes["tensor"] = args.tensor_parallel
    if args.sequence_parallel > 1:
        axes["sequence"] = args.sequence_parallel
    if getattr(args, "expert_parallel", 1) > 1:
        axes["expert"] = args.expert_parallel
    if getattr(args, "pipeline_parallel", 1) > 1:
        axes["pipeline"] = args.pipeline_parallel
    return axes


def seq_positions(args, mesh, causal: bool) -> Optional[np.ndarray]:
    """The global positions of this rank's tokens along the sequence (None
    without sequence parallelism): the zigzag pair of chunks for the
    causal ring when the sequence tiles into 2n chunks
    (``parallel.ring_layout_zigzag``), else the contiguous block
    (``distributed.local_seq_slice``; Ulysses gathers whole sequences in
    that order)."""
    n = mesh.size("sequence") if mesh is not None else 1
    if n == 1:
        return None
    start, size = dist.local_seq_slice(args.seq_len, mesh)
    if getattr(args, "sp_mode", "ring") == "ring" \
            and parallel.ring_layout_zigzag(args.seq_len, n, causal):
        return parallel.zigzag_index(args.seq_len, n, mesh.index("sequence"))
    return np.arange(start, start + size)


def tokenizer_from_args(args, reserve: int = 0):
    """``--tokenizer`` as a ``BPETokenizer``, or None for raw bytes.

    ``bpe:PATH`` loads PATH; ``bpe:PATH:V`` trains a V-id tokenizer on the
    corpus and saves it to PATH when missing (deterministic, so every
    process trains the same one).  ``reserve``: ids the objective needs
    past the tokenizer's (the MLM [MASK]), checked against --vocab before
    any tokenizer is trained."""
    spec = getattr(args, "tokenizer", None)
    if not spec:
        return None
    if not getattr(args, "data_file", None):
        raise ValueError("--tokenizer needs --data-file (it tokenizes the "
                         "real corpus, not synthetic ids)")
    parts = spec.split(":")
    if parts[0] != "bpe" or len(parts) not in (2, 3) or not parts[1]:
        raise ValueError(
            f"--tokenizer must be 'bpe:PATH' or 'bpe:PATH:VOCAB', "
            f"got {spec!r}")
    path = parts[1]
    if len(parts) == 3:
        target = int(parts[2])
        if args.vocab < target + reserve:
            # fail before training a tokenizer the model cannot hold
            raise ValueError(
                f"--vocab {args.vocab} is too small for a {target}-id "
                f"tokenizer{' plus the [MASK] id' if reserve else ''}: "
                f"need >= {target + reserve}")
        tok = toklib.load_or_train(path, args.data_file, target)
    elif os.path.exists(path):
        tok = toklib.BPETokenizer.load(path)
    else:
        raise ValueError(
            f"--tokenizer {spec!r}: {path} does not exist; use "
            f"'bpe:{path}:VOCAB' to train it on the corpus, or run "
            "python -m tpujob_torch.workloads.tokenizer train")
    if args.vocab < tok.vocab_size + reserve:
        need = tok.vocab_size + reserve
        raise ValueError(
            f"--vocab {args.vocab} is too small for the "
            f"{tok.vocab_size}-id tokenizer"
            f"{' plus the [MASK] id' if reserve else ''}: need >= {need}")
    return tok


def token_batches(args, pe, tokenizer=None, mesh=None):
    """(this process's rows of the first batch, ``provider(step) -> rows``
    or None, global row 0).

    The synthetic batch by default (one fixed batch, no provider).  With
    ``--data-file`` the corpus in [n, seq_len] chunks, raw bytes or BPE
    tokens when ``tokenizer`` is set (both memory-mapped), and a provider
    that cycles them deterministically by step, so a resume replays the
    same stream.  Row 0 is the global one, the same in every process.
    With ``mesh`` the rows are split over its data axes only: the ranks of
    a sequence group get the same whole rows, each trainer then takes its
    columns (``seq_positions``)."""
    lo, sz = dist.local_batch_slice(args.batch_size, pe, mesh)
    if not getattr(args, "data_file", None):
        ids = datalib.synthetic_token_batch(args.batch_size, args.seq_len,
                                            args.vocab)
        return ids[lo : lo + sz], None, ids[0:1]
    if tokenizer is not None:
        chunks = datalib.bpe_token_dataset(args.data_file, args.seq_len,
                                           tokenizer)
    else:
        if args.vocab < 256:
            raise ValueError(
                f"--data-file is a byte-level corpus: --vocab {args.vocab} "
                "must be >= 256")
        chunks = datalib.byte_token_dataset(args.data_file, args.seq_len)

    def provider(step: int):
        # only this process's rows of the global step batch; the
        # fancy-indexed read materialises just those rows off the memmap
        idx = (np.arange(lo, lo + sz) + step * args.batch_size) % len(chunks)
        return np.asarray(chunks[idx], dtype=np.int32)

    return provider(0), provider, np.asarray(chunks[0:1], dtype=np.int32)


def build_model(args, device, *, causal: bool = False,
                final_ln: bool = False, mesh=None) -> Bert:
    """The transformer from the flag surface, on ``device``.  ``causal``
    threads a causal mask through the attention path the flags pick:
    dense, flash, or under ``--sequence-parallel`` the ring
    (``parallel.ring_attention``, dense per hop) or Ulysses
    (``parallel.ulysses_attention``, with ``--attention flash`` the
    kernels as its local attention) over ``mesh``'s sequence group
    (``make_mesh_for``'s when None).  Under ``--tensor-parallel`` the
    model is this rank's Megatron blocks over ``mesh``'s tensor group,
    and the attention sees the rank's heads: the ring on them is the JAX
    package's ring with ``head_axis="tensor"``.  A MoE model's FFN runs
    on ``mesh``'s expert, tensor and sequence groups
    (``parallel.moe_groups``), the rank holding its experts under
    ``--expert-parallel``.  Under ``--pipeline-parallel`` the model
    holds its stage's layers only (``parallel.stage_layers``).  FSDP is
    applied by ``train`` (after any weights are loaded into this
    module).  ``--block``, ``--head-dim``, ``--attention-pattern`` (each
    layer's window), ``--rope-theta``, ``--yarn-*`` and ``--untied-head``
    pick the block family and its parts (``Bert``)."""
    from tpujob_torch.workloads import flash

    validate_parallel_flags(args, causal)
    window = getattr(args, "attention_window", 0)
    use_flash = getattr(args, "attention", "dense") == "flash"
    sp = getattr(args, "sequence_parallel", 1)
    tp = getattr(args, "tensor_parallel", 1)
    ep = getattr(args, "expert_parallel", 1)
    pp = getattr(args, "pipeline_parallel", 1)
    if mesh is None and (sp > 1 or tp > 1 or ep > 1 or pp > 1):
        mesh = make_mesh_for(args)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    moe = moe_config_from(args)
    if torch.device(device).type == "cuda":
        # fail at build, not at the first step
        if use_flash:
            flash.check_supported(dtype, head_dim_of(args))
        if moe is not None and getattr(args, "block", "post_ln") == "pre_rms":
            from tpujob_torch.workloads import moe_gemm

            moe_gemm.check_supported(dtype)

    def flash_fn(q, k, v, causal=causal, scale=None):
        return flash.flash_attention(q, k, v, causal=causal, scale=scale,
                                     window=window)

    def whole_fn(q, k, v):
        if use_flash:
            return flash_fn(q, k, v)
        return parallel.full_attention(q, k, v, causal=causal, window=window)

    if sp > 1:
        group = mesh.group("sequence")
        local = args.seq_len // sp
        if args.sp_mode == "ulysses":
            def exchange(q, k, v):
                return parallel.ulysses_attention(
                    q, k, v, group, causal=causal,
                    attention_impl=flash_fn if use_flash else None)
        else:
            def exchange(q, k, v):
                return parallel.ring_attention(q, k, v, group, causal=causal)

        def attention_fn(q, k, v):
            if q.shape[1] != local:
                raise ValueError(
                    f"sequence-parallel attention takes this rank's {local} "
                    f"of the {args.seq_len} positions, got {q.shape[1]}: a "
                    "sequence-parallel model decodes with "
                    "gpt.generate_cached")
            return exchange(q, k, v)
    elif use_flash or causal:
        attention_fn = whole_fn
    else:
        attention_fn = None

    def attention_for(w):
        # one layer's attention under --attention-pattern (one device: the
        # flag checks refuse a window under sequence parallelism)
        if use_flash:
            return lambda q, k, v: flash.flash_attention(
                q, k, v, causal=causal, window=w)
        return lambda q, k, v: parallel.full_attention(
            q, k, v, causal=causal, window=w)

    windows = layer_windows(args)
    model = Bert(
        vocab=args.vocab, hidden=args.hidden, layers=args.layers,
        heads=args.heads, intermediate=args.intermediate, max_seq=args.seq_len,
        dtype=dtype,
        attention_fn=attention_fn, remat=args.remat, final_ln=final_ln,
        kv_heads=getattr(args, "kv_heads", 0) or None,
        use_rope=getattr(args, "position", "learned") == "rope",
        window=window, seed=args.seed, moe=moe,
        exchanges=sp > 1 or getattr(args, "fsdp", 1) > 1,
        tp_group=mesh.group("tensor") if tp > 1 else None,
        moe_groups=parallel.moe_groups(mesh) if moe else None,
        # a MoE model's full-route decode forwards whole sequences
        whole_attention_fn=whole_fn if sp > 1 and moe else None,
        stage=parallel.stage_layers(args.layers, mesh),
        block=getattr(args, "block", "post_ln"), head_dim=head_dim_of(args),
        layer_windows=windows,
        attention_for=attention_for if windows is not None else None,
        rope_theta=getattr(args, "rope_theta", 10000.0), yarn=yarn_of(args),
        untied_head=getattr(args, "untied_head", False),
    )
    return model.to(device)


def train(args, pe, model: Bert, loss_of: Callable[[nn.Module], Callable],
          batch, *, tag: str = "bert",
          batch_provider: Optional[Callable] = None,
          on_step: Optional[Callable[[int], None]] = None,
          capture: bool = True, mesh=None,
          make_f1b: Optional[Callable] = None) -> Dict[str, Any]:
    """The training loop: AdamW with the flag surface's schedule, gradient
    accumulation (``--grad-accum``, optax.MultiSteps), step-exact
    checkpoint/resume, ``--profile-dir``, and honest throughput (the clock
    starts after set-up, ends after the device has finished, and leaves
    out the time spent writing a trace).

    ``loss_of(module)`` builds ``loss_fn(batch) -> scalar`` that runs
    ``module``: ``model`` itself, or with a process group its DDP wrapper,
    so that every forward goes through DDP (a loss that called
    ``model.embed`` directly would bypass it).  Each rank feeds its own
    rows of the global batch; losses are the global batch's.  ``batch`` is
    a tuple of tensors already on the model's device, the batch of every
    step unless ``batch_provider(step) -> tuple of host arrays`` gives
    each step its own (the ``--data-file`` path; deterministic in the
    step, so a resume replays the same stream).  Its copy to the device
    (``train_lib.put_batch``) is inside the clock, as in the JAX package.
    ``on_step(i)``, if given, runs after step ``i`` inside the clock (a
    caller's timer or profiler); if it raises, the loop ends and the log
    is closed with every row written.  The checkpointed and returned state
    holds ``model``, never the wrapper.  While a profiler runs, each call's
    host work is in spans (``train_lib.span``): ``tpujob.feed`` (the
    provider and ``put_batch``), ``tpujob.step``, ``tpujob.log`` (loss
    extras, the scalar writer) and ``tpujob.checkpoint``.

    On one card the step is compiled (``train_lib.make_train_step``): the
    first step (with ``--grad-accum``, the first group) runs eagerly, after
    any restore, and the others replay its CUDA graph; ``step_mode`` in the result (and the first log line) says
    which ran.  ``capture=False`` keeps it eager, to hold the graph
    against.  A MoE model's result holds ``moe_metrics``, each step's
    ``MOE_METRICS`` (the aux terms its loss added, and the dropped
    assignments) as a dict.

    ``mesh`` (``make_mesh_for``'s): the gradients are averaged over its
    token axes only, and the reported loss too (the ranks of a tensor or
    expert group hold the same rows and different weights: they are not
    replicas); under ``--fsdp`` the model is sharded here
    (``parallel.fully_shard_model``) before the optimizer is made, so its
    moments are sharded too; a sharded state is checkpointed whole
    (``parallel.ParamShards`` over the tensor and expert groups).
    Without it, the whole world is one data axis, unless the flags name
    another axis: then the flags' mesh (``make_mesh_for``).

    Under ``--pipeline-parallel`` ``model`` is this rank's stage and the
    step is the schedule's fused forward and backward
    (``make_pipeline_value_and_grad``, eager), its per-microbatch loss
    from ``make_f1b(micro, shards) -> (preprocess, head_loss)`` (the
    workloads' ``run``; under GPipe with ``micro`` 1, the whole batch's
    loss); the checkpoint gathers the stages' layers whole."""
    pp = validate_parallel_flags(args)
    if mesh is None and any(getattr(args, a, 1) > 1 for a in (
            "fsdp", "tensor_parallel", "sequence_parallel",
            "expert_parallel", "pipeline_parallel")):
        mesh = make_mesh_for(args, pe)  # never a sharded run as data
    accum = getattr(args, "grad_accum", 1)
    if accum > 1 and args.steps % accum != 0:
        raise ValueError(
            f"--steps {args.steps} must be a multiple of --grad-accum "
            f"{accum} (trailing mini-steps would accumulate gradients "
            "that never apply)")
    if accum > 1 and getattr(args, "warmup_steps", 0) % accum != 0:
        raise ValueError(
            f"--warmup-steps {args.warmup_steps} must be a multiple of "
            f"--grad-accum {accum} (the schedule advances once per "
            "accumulated update)")
    device = next(model.parameters()).device
    writer = train_lib.SummaryWriter(args.dir, enabled=pe.process_id == 0)
    # the schedule advances once per optimizer update: the flag surface's
    # mini-step units become update units
    lr_fn = train_lib.make_lr_schedule(
        args.lr, getattr(args, "lr_schedule", "constant"),
        getattr(args, "warmup_steps", 0) // accum, args.steps // accum)
    shards = None
    if mesh is not None and mesh.size("tensor", "fsdp", "expert") > 1:
        if mesh.size("fsdp") > 1:
            parallel.fully_shard_model(model, mesh)
        shards = parallel.ParamShards(mesh.group("tensor"),
                                      mesh.group("expert"))
    optimizer = train_lib.adamw(model.parameters(), args.lr)
    accumulator = train_lib.with_grad_accum(model.parameters(), accum)
    state = train_lib.init_state(model, optimizer)
    if accumulator is not None:
        state["accum"] = accumulator  # checkpointed: resume mid-group

    ckpt = None
    start_step = 0
    if args.checkpoint_interval > 0:
        ckpt = train_lib.Checkpointer(
            args.dir + "/ckpt", shards=shards,
            stages=mesh.group("pipeline") if pp > 1 else None)
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(latest, state)
            start_step = latest
            print(f"resumed from checkpoint step {latest}")

    loss_fn = vag = None
    if pp > 1:
        if make_f1b is None:
            raise ValueError(
                "--pipeline-parallel is not supported for this workload "
                "(no per-microbatch loss decomposition)")
        micro = getattr(args, "pipeline_microbatches", 0) or pp
        schedule = getattr(args, "pipeline_schedule", "gpipe")
        # ONE shard decision, shared by the loss scaling and the schedule
        shards_of_batch = pipeline_schedule.batch_shard_count(
            mesh, args.batch_size)
        preprocess, head_loss = make_f1b(
            micro if schedule == "1f1b" else 1, shards_of_batch)
        vag = make_pipeline_value_and_grad(
            model, mesh, micro, head_loss, preprocess, schedule=schedule,
            batch_shards=shards_of_batch)
    else:
        loss_fn = loss_of(train_lib.data_parallel(model, mesh))
    train_step = train_lib.make_train_step(loss_fn, optimizer, lr_fn,
                                           accumulator, capture=capture,
                                           mesh=mesh, value_and_grad_fn=vag)
    if pe.process_id == 0:
        print(f"{tag}: step_mode={train_step.mode}")
    if start_step >= args.steps:
        # restarted after the final checkpoint (the preemption race):
        # report completion instead of training further
        if vag is not None:
            final_loss = float(train_lib.global_mean(vag(batch), mesh))
            optimizer.zero_grad(set_to_none=True)
        else:
            with torch.no_grad():
                final_loss = float(train_lib.global_mean(loss_fn(batch),
                                                         mesh))
        if pe.process_id == 0:
            print(f"already complete: resumed at step {start_step} >= "
                  f"--steps {args.steps}")
        writer.close()
        return {"samples_per_sec": 0.0, "tokens_per_sec": 0.0, "wall_s": 0.0,
                "final_loss": final_loss, "losses": [], "state": state,
                "step_mode": train_step.mode}

    if device.type == "cuda" and getattr(args, "attention", "dense") == "flash":
        # build the kernels before the clock starts (the counterpart of the
        # JAX trainer's AOT compile): no optimizer update happens outside
        # the counted loop, so a resumed run stays step-exact
        from tpujob_torch.kernels import build

        build.load_all()
    profiler = train_lib.profiler_from_args(args, pe, device)
    train_lib.sync(device)
    t0 = time.perf_counter()
    losses, moe_metrics = [], []
    loss = None
    try:
        for i in range(start_step, args.steps):
            profiler.step(i - start_step, block_on=loss)
            if batch_provider is not None:
                with train_lib.span("tpujob.feed", i):
                    batch = train_lib.put_batch(batch_provider(i), device)
            with train_lib.span("tpujob.step", i):
                state, loss = train_step(state, batch)
            losses.append(loss)  # the step's own copy: no wait for the card
            with train_lib.span("tpujob.log", i):
                extras = train_lib.loss_extras(loss_fn)
                if extras is not None:
                    moe_metrics.append(extras)
                if i % args.log_interval == 0:
                    writer.add_scalar("loss", loss, i)
            if ckpt and (i + 1) % args.checkpoint_interval == 0:
                with train_lib.span("tpujob.checkpoint", i):
                    ckpt.save(i + 1, state)
            if on_step is not None:
                on_step(i)
        train_lib.sync(device)
        # a trace written mid-loop is not training time
        wall = time.perf_counter() - t0 - profiler.overhead_s
    finally:
        profiler.close(block_on=loss)
        writer.close()  # rows still in flight land, also when on_step raised
    steps_run = args.steps - start_step
    sps = steps_run * args.batch_size / wall
    tps = sps * args.seq_len
    losses = [float(x) for x in losses]
    final_loss = losses[-1]
    extra = {}
    if moe_metrics:
        extra["moe_metrics"] = [dict(zip(MOE_METRICS, m.tolist()))
                                for m in moe_metrics]
    if pe.process_id == 0:
        print(f"{tag}(h{args.hidden}xl{args.layers}): {sps:.1f} samples/sec, "
              f"{tps:.0f} tokens/sec, loss={final_loss:.3f}")
    return {"samples_per_sec": sps, "tokens_per_sec": tps, "wall_s": wall,
            "final_loss": final_loss, "losses": losses, "state": state,
            "profile_overhead_s": profiler.overhead_s,
            "step_mode": train_step.mode, **extra}


def batch_to_device(ids: np.ndarray, device) -> torch.Tensor:
    """int32 host ids as the int64 device tensor embedding/gather take."""
    return train_lib.put_batch((ids,), device)[0]


def mask_id_from_args(args, tokenizer) -> int:
    """The MLM's [MASK] id, one past the real token alphabet so that no
    real token is confused with a masked position: the WordPiece 103 on
    synthetic ids, 256 on raw bytes (which needs --vocab >= 257), the
    tokenizer's size on BPE tokens."""
    if tokenizer is not None:
        return tokenizer.vocab_size
    if getattr(args, "data_file", None):
        if args.vocab < 257:
            raise ValueError(
                f"--data-file with the MLM objective needs --vocab >= 257 "
                f"(256 byte values + the [MASK] token), got {args.vocab}")
        return 256
    return 103


def run(args, *, on_step: Optional[Callable[[int], None]] = None,
        capture: bool = True) -> Dict[str, Any]:
    """BERT masked-LM pretraining from the flags: the synthetic batch with
    one fixed mask drawn from ``--seed``, or with ``--data-file`` a new
    corpus batch every step and its mask drawn from ``seed + step``.
    ``on_step(i)`` runs after each step and ``capture=False`` keeps the
    card's step eager (see ``train``)."""
    device = dist.local_device(getattr(args, "device", "cuda"))
    pe = dist.initialize(device=device)
    tok = tokenizer_from_args(args, reserve=1)
    mask_id = mask_id_from_args(args, tok)
    mesh = make_mesh_for(args, pe)
    model = build_model(args, device, mesh=mesh)
    ids0, provider, _ = token_batches(args, pe, tokenizer=tok, mesh=mesh)
    lo, sz = dist.local_batch_slice(args.batch_size, pe, mesh)
    pos = seq_positions(args, mesh, causal=False)
    cols = slice(None) if pos is None else pos

    def masked(ids_local, seed):
        # the GLOBAL mask (one seed in every process), sliced to this
        # process's rows (and sequence columns): masking the local rows
        # directly would repeat one pattern in every process
        _, mask = mask_batch(
            np.zeros((args.batch_size, args.seq_len), np.int32), seed)
        return ids_local[:, cols], mask[lo : lo + sz, cols]

    bp = None
    if provider is not None:
        bp = lambda step: masked(provider(step), args.seed + step)
    positions = None if pos is None else torch.from_numpy(pos).to(device)

    def make_f1b(micro: int, shards: int):
        """The masked LM a microbatch at a time, for the pipeline: each
        microbatch's masked sum over the GLOBAL masked count (summed over
        the data group, carried in ``extra`` as a row each), scaled by
        ``micro * shards``, so that the mean over the microbatches is the
        rank's ``mlm_loss`` and the data group's mean the global one."""

        def preprocess(batch):
            ids, mask = batch
            total = torch.clamp(train_lib.global_sum(mask.sum(), mesh),
                                min=1.0)
            return (torch.where(mask > 0, mask_id, ids),
                    (ids, mask, total.expand(ids.shape[0])))

        def head_loss(logits, extra):
            ids, mask, total = extra
            logp = torch.log_softmax(logits, dim=-1)
            tok_ll = torch.gather(logp, -1, ids[..., None])[..., 0]
            return -(tok_ll * mask).sum() / total[0] * (micro * shards)

        return preprocess, head_loss

    return train(args, pe, model,
                 lambda net: mlm_loss(net, mask_id=mask_id,
                                      positions=positions, mesh=mesh),
                 train_lib.put_batch(masked(ids0, args.seed), device),
                 batch_provider=bp, on_step=on_step, capture=capture,
                 mesh=mesh, make_f1b=make_f1b)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    run(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
