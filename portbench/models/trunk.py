"""The transformer trunk the port's ``bert`` and ``gpt`` trainers share:
post-LN blocks, learned positions, a LayerNorm after the embedding,
``ln_f`` before the tied head where the configuration has one.

Leaves carry the names the JAX package gives them (flax's, which the port
keeps): ``token_embed.weight`` (the table padded to a multiple of 128
rows), ``pos_embed``, ``ln_embed.*``, ``ln_f.*``, and a block's
``layer_<i>.attn.{query,key,value,out}.*``, ``layer_<i>.ln_attn.*``,
``layer_<i>.mlp_wi.*``, ``layer_<i>.mlp_wo.*``, ``layer_<i>.ln_mlp.*``;
matrices are torch's ``[out, in]``.  Every matrix and table is drawn
normal, biases 0, LayerNorm scales 1.

Model FLOPs: a token costs 6 x (the parameters that enter a matrix
product, the tied head counted once, at the true vocabulary) for its
forward and backward, plus 12 x layers x hidden x seq for attention's two
products (QK^T and PV, forward and backward), halved when causal.
Recomputation (remat) is not counted: these are the model's FLOPs, not
the device's.  Biases, LayerNorms and the embedding lookup are not
products and are left out.
"""
from __future__ import annotations

from typing import List

from portbench import roofline


def padded_vocab(vocab: int) -> int:
    return -(-vocab // 128) * 128


def _dense(prefix: str, d_in: int, d_out: int) -> list:
    return [(f"{prefix}.weight", (d_out, d_in), "normal"),
            (f"{prefix}.bias", (d_out,), "zeros")]


def _norm(prefix: str, h: int) -> list:
    return [(f"{prefix}.weight", (h,), "ones"), (f"{prefix}.bias", (h,), "zeros")]


def groups(model: dict) -> List[list]:
    """The leaves in groups: the embeddings and final norm first, then one
    group a block."""
    h, f = model["hidden"], model["intermediate"]
    first = [("token_embed.weight", (padded_vocab(model["vocab"]), h), "normal"),
             ("pos_embed", (model["max_positions"], h), "normal")]
    first += _norm("ln_embed", h)
    if model["final_layer_norm"]:
        first += _norm("ln_f", h)
    out = [first]
    for i in range(model["layers"]):
        p = f"layer_{i}"
        out.append(_dense(f"{p}.attn.query", h, h) + _dense(f"{p}.attn.key", h, h)
                   + _dense(f"{p}.attn.value", h, h) + _dense(f"{p}.attn.out", h, h)
                   + _norm(f"{p}.ln_attn", h) + _dense(f"{p}.mlp_wi", h, f)
                   + _dense(f"{p}.mlp_wo", f, h) + _norm(f"{p}.ln_mlp", h))
    return out


def port_flags(model: dict) -> List[str]:
    """The sizes as ``gpt`` / ``bert.build_parser`` take them; the
    model's positions as ``--seq-len`` (the traffic's rows may be
    shorter)."""
    flags = ["--hidden", model["hidden"], "--layers", model["layers"],
             "--heads", model["heads"], "--intermediate", model["intermediate"],
             "--vocab", model["vocab"], "--seq-len", model["max_positions"]]
    return [str(f) for f in flags]


def matmul_params(model: dict) -> int:
    h, f = model["hidden"], model["intermediate"]
    per_layer = 4 * h * h + 2 * h * f  # query, key, value, out; the MLP
    return model["layers"] * per_layer + model["vocab"] * h


def flops_per_token(model: dict, seq: int) -> int:
    attention = 12 * model["layers"] * model["hidden"] * seq
    if model["causal"]:
        attention //= 2
    return 6 * matmul_params(model) + attention


def flops_per_call(model: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one call of the train step (one micro-step under
    gradient accumulation: every call trains ``batch x seq`` tokens)."""
    return batch * seq * flops_per_token(model, seq)


def attention_bound_ms_per_call(model: dict, batch: int, seq: int,
                                remat: bool, elem_bytes: int) -> float:
    """The roofline-bound ms of one train-step call's attention: a forward
    a layer (two with remat, whose backward runs the forward again), one
    dQ and one dK/dV a layer.  It depends on the shapes only, never on
    which kernel computes the call."""
    d = model["hidden"] // model["heads"]
    calls = roofline.attention_call_bytes_flops(batch, seq, model["heads"], d,
                                                model["causal"], elem_bytes)
    per = {k: roofline.bound(*bf)[0] for k, bf in calls.items()}
    fwd = 2 if remat else 1
    return model["layers"] * (fwd * per["flash_fwd"] + per["flash_dq"]
                              + per["flash_dkv"])


def counts(model: dict, batch: int, seq: int, remat: bool,
           elem_bytes: int) -> dict:
    return {"flops_per_call": flops_per_call(model, batch, seq),
            "attention_bound_ms_per_call": attention_bound_ms_per_call(
                model, batch, seq, remat, elem_bytes)}
