"""Mellum2's block family on the port: pre-norm RMSNorm blocks, grouped-query
attention at a head size of its own, sliding-window and full layers by a
pattern (rotary positions; YaRN on the full layers), a dropless top-k
mixture of SwiGLU experts in every layer, an RMSNorm before an untied head.

Leaves carry the port's names (``tpujob_torch.workloads.bert``'s ``Bert``
with ``--block pre_rms``): ``token_embed.weight`` and ``lm_head.weight``
(the vocabulary padded to a multiple of 128 rows), ``ln_f.weight``, and a
block's ``layer_<i>.ln_attn.weight``, ``layer_<i>.attn.{query,key,value,
out}.weight`` (no biases), ``layer_<i>.ln_mlp.weight`` and
``layer_<i>.moe.{router,wi,wo}``: the router ``[hidden, E]``, the experts
stacked ``[E, hidden, 2 x width]`` (gate, then up) and ``[E, width,
hidden]``.  Matrices are torch's ``[out, in]``; every matrix, table and
expert is drawn normal, the RMSNorm scales 1.

Model FLOPs: a token costs 6 x (the parameters it multiplies by: the
attention's projections, the router, its k experts' three matrices, the
head) for its forward and backward, plus 12 x query width x the keys it
sees, summed over the layers (attention's two products, forward and
backward), where a sliding layer's query sees at most the window.  No
recompute; norms and the embedding lookup are not products.

Nothing here imports the port.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from portbench import roofline


def padded_vocab(vocab: int) -> int:
    return -(-vocab // 128) * 128


def windows(model: dict) -> List[int]:
    """Each layer's attention window (0: full context)."""
    return [model["window"] if t == "sliding_attention" else 0
            for t in model["layer_types"][: model["layers"]]]


def groups(model: dict) -> List[list]:
    """The embeddings, head and final norm first, then one group a block."""
    h, d = model["hidden"], model["head_dim"]
    q, kv = model["heads"] * d, model["kv_heads"] * d
    e, f = model["experts"], model["expert_width"]
    v = padded_vocab(model["vocab"])
    out = [[("token_embed.weight", (v, h), "normal"),
            ("lm_head.weight", (v, h), "normal"),
            ("ln_f.weight", (h,), "ones")]]
    for i in range(model["layers"]):
        p = f"layer_{i}"
        out.append([(f"{p}.ln_attn.weight", (h,), "ones"),
                    (f"{p}.attn.query.weight", (q, h), "normal"),
                    (f"{p}.attn.key.weight", (kv, h), "normal"),
                    (f"{p}.attn.value.weight", (kv, h), "normal"),
                    (f"{p}.attn.out.weight", (h, q), "normal"),
                    (f"{p}.ln_mlp.weight", (h,), "ones"),
                    (f"{p}.moe.router", (h, e), "normal"),
                    (f"{p}.moe.wi", (e, h, 2 * f), "normal"),
                    (f"{p}.moe.wo", (e, f, h), "normal")])
    return out


def port_flags(model: dict) -> List[str]:
    """The sizes and mechanisms as ``gpt.build_parser`` takes them (the
    port's YaRN takes HF's default betas and attention factor, the
    published ones)."""
    letters = "".join("S" if w else "F" for w in windows(model))
    yarn = model["yarn"]
    flags = ["--block", "pre_rms", "--hidden", model["hidden"],
             "--layers", model["layers"], "--heads", model["heads"],
             "--kv-heads", model["kv_heads"], "--head-dim", model["head_dim"],
             "--intermediate", model["intermediate"],
             "--vocab", model["vocab"], "--seq-len", model["max_positions"],
             "--position", "rope", "--rope-theta", model["rope_theta"],
             "--attention-pattern", letters,
             "--attention-window", model["window"],
             "--yarn-factor", yarn["factor"],
             "--yarn-original-positions", yarn["original_max_position_embeddings"],
             "--untied-head", "--moe-experts", model["experts"],
             "--moe-k", model["top_k"],
             "--moe-expert-width", model["expert_width"]]
    return [str(f) for f in flags]


def matmul_params_per_token(model: dict) -> int:
    """Parameters a token multiplies by: per layer the projections, the
    router and its k experts; then the head."""
    h, d = model["hidden"], model["head_dim"]
    q, kv = model["heads"] * d, model["kv_heads"] * d
    attn = h * q + 2 * h * kv + q * h
    experts = model["top_k"] * 3 * h * model["expert_width"]
    per_layer = attn + h * model["experts"] + experts
    return model["layers"] * per_layer + model["vocab"] * h


def flops_per_call(model: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one call of the train step."""
    width = model["heads"] * model["head_dim"]
    pairs = sum(roofline.visible_pairs(seq, seq, model["causal"], w)
                for w in windows(model))
    return (6 * matmul_params_per_token(model) * batch * seq
            + 12 * width * pairs * batch)


def attention_bound_ms_per_call(model: dict, batch: int, seq: int,
                                   remat: bool, elem_bytes: int) -> float:
    """The roofline-bound ms of a call's attention, each layer at its
    window (only its visible pairs counted): a forward a layer (two with
    remat), a dQ and a dK/dV, at the query heads (the kernels take K/V
    repeated up to them)."""
    fwd = 2 if remat else 1
    total = 0.0
    for w in windows(model):
        calls = roofline.attention_call_bytes_flops(
            batch, seq, model["heads"], model["head_dim"], model["causal"],
            elem_bytes, w)
        per = {k: roofline.bound(*bf)[0] for k, bf in calls.items()}
        total += fwd * per["flash_fwd"] + per["flash_dq"] + per["flash_dkv"]
    return total


def grouped_gemm_bytes_flops(rows: int, k_dim: int, n_dim: int, experts: int,
                             elem_bytes: int) -> Dict[str, Tuple[int, int]]:
    """{kernel: (bytes, flops)} of the grouped products over ``rows``
    sorted rows, ``[rows, k] x [E, k, n]``: the forward (``[rows, n]``
    out), dX (``[rows, n] x [E, k, n]^T``) and dW (``[E, k, n]`` out, fp32);
    each input read once, each output written once."""
    flops = 2 * rows * k_dim * n_dim
    a, out = rows * k_dim * elem_bytes, rows * n_dim * elem_bytes
    w = experts * k_dim * n_dim * elem_bytes
    return {"moe_gemm_fwd": (a + w + out, flops),
            "moe_gemm_dx": (out + w + a, flops),
            "moe_gemm_dw": (a + out + experts * k_dim * n_dim * 4, flops)}


def moe_gemm_bound_ms_per_call(model: dict, batch: int, seq: int,
                               remat: bool, elem_bytes: int) -> float:
    """The roofline-bound ms of a call's grouped products: a layer's two
    (``[R, h] x [E, h, 2f]`` and ``[R, f] x [E, f, h]``, R = batch x seq x
    k rows, every assignment: dropless) forward (twice with remat), dX and
    dW.  It depends on the shapes alone, not on the routing."""
    rows = batch * seq * model["top_k"]
    h, f, e = model["hidden"], model["expert_width"], model["experts"]
    fwd = 2 if remat else 1
    total = 0.0
    for k_dim, n_dim in ((h, 2 * f), (f, h)):
        calls = grouped_gemm_bytes_flops(rows, k_dim, n_dim, e, elem_bytes)
        per = {k: roofline.bound(*bf)[0] for k, bf in calls.items()}
        total += fwd * per["moe_gemm_fwd"] + per["moe_gemm_dx"] + per["moe_gemm_dw"]
    return model["layers"] * total


def counts(model: dict, batch: int, seq: int, remat: bool,
           elem_bytes: int) -> dict:
    return {"flops_per_call": flops_per_call(model, batch, seq),
            "attention_bound_ms_per_call": attention_bound_ms_per_call(
                model, batch, seq, remat, elem_bytes),
            "moe_gemm_bound_ms_per_call": moe_gemm_bound_ms_per_call(
                model, batch, seq, remat, elem_bytes)}
