"""Tensor parallelism (Megatron) in the port against the JAX package, on
the CPU.

A tensor-parallel ``Block`` on 2 gloo ranks against one process's
``Block`` from the same seed (dense MHA, and GQA with RoPE): the output
and the grads of ``sum(out * ct)`` gathered whole.  Then ``gpt.run`` and ``bert.run`` for 3
steps under ``--tensor-parallel 2``, data 2 x tensor 2 (world 4), GQA
with RoPE, and tensor 2 x sequence 2 (the ring on each rank's heads: the
JAX package's ring with ``head_axis="tensor"``), each rank loading its
blocks of the JAX package's initial weights (``convert.params_from_flax``
over its mesh), against the JAX package's ``run`` on the same mesh of
virtual CPU devices.  The tensor x sequence runs are held to the JAX
package's run at tensor 2: its ring over the tensor-split heads computes
the same function (held shard by shard to the port's ring in
``tests/test_torch_sp.py``) and compiles much more slowly on the
CPU than the run without it.  Then decode under TP, and the flag rules.

Tolerances: the block fp32, outputs 1e-5 and grads 1e-4 (the partial
products summed in another order); runs fp32, 3 steps, losses 1e-4
relative, the parameters after step 3 within 1e-4 of the JAX package's,
and every parameter the tensor group holds whole (positions, LayerNorms,
row-parallel biases) bit-equal on its ranks.  One run in bf16, GPT at
tensor 2 against the JAX package's bf16 run, to bf16's and AdamW's
tolerances (``BF16_ATOL``, ``BF16_UPDATE_RTOL``, with their reason).
"""
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from test_torch_spawn import (bf16_tp_sum_ranks, shard_trainer_ranks,
                              spawn, tp_block_ranks)
from tpujob.workloads import bert as jbert
from tpujob.workloads import distributed as jdist
from tpujob.workloads import gpt as jgpt
from tpujob_torch.workloads import bert as tbert
from tpujob_torch.workloads import convert
from tpujob_torch.workloads import gpt as tgpt

SMALL = ["--hidden", "64", "--layers", "2", "--heads", "4", "--intermediate",
         "128", "--vocab", "211", "--seq-len", "128", "--batch-size", "4",
         "--no-bf16", "--lr", "3e-3", "--log-interval", "1", "--steps", "3",
         "--lr-schedule", "cosine"]
TP = ["--tensor-parallel", "2"]
ROPE_GQA = ["--position", "rope", "--kv-heads", "2"]
JMODULES = {"gpt": jgpt, "bert": jbert}


def _block_cases():
    rng = np.random.RandomState(0)
    out = {}
    for name, (heads, kvh, rope, causal) in {
            "mha": (4, 4, False, False),
            "gqa_rope_causal": (4, 2, True, True)}.items():
        out[name] = dict(hidden=32, heads=heads, kv_heads=kvh, rope=rope,
                         causal=causal, seed=3,
                         x=rng.randn(2, 8, 32).astype(np.float32),
                         ct=rng.randn(2, 8, 32).astype(np.float32))
    return out


def test_tp_block_matches_one_process_block(tmp_path):
    """Each rank's block output (1e-5) and its grads gathered whole (1e-4)
    against one process's block from the same seed; two all-reduces a
    forward (after ``out`` and ``mlp_wo``)."""
    cases = _block_cases()
    ranks = spawn(tp_block_ranks, 2, tmp_path, cases)
    for name in cases:
        for out in ranks:
            one, tp = out[name]
            np.testing.assert_allclose(tp["o"], one["o"], rtol=1e-5,
                                       atol=1e-5, err_msg=name)
            assert set(tp["grads"]) == set(one["grads"])
            for k, g in one["grads"].items():
                np.testing.assert_allclose(tp["grads"][k], g, rtol=1e-4,
                                           atol=1e-4, err_msg=f"{name} {k}")
            assert (one["forward_exchanges"], tp["forward_exchanges"]) == (0,
                                                                          2)


def _logged_losses(logdir):
    rows = [json.loads(x) for x in
            (logdir / "scalars.jsonl").read_text().splitlines()]
    return [r["value"] for r in rows if r["tag"] == "loss"]


def flax_init(jmodule, argv):
    """The JAX package's initial weights for ``argv`` (numpy leaves): its
    init on a one-device mesh, as its run draws them on any mesh."""
    ja = jmodule.build_parser().parse_args(argv)
    jm = jmodule.build_model(ja, Mesh(np.array(jax.devices()[:1]), ("data",)))
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 128), jnp.int32))["params"]
    return jax.tree.map(np.asarray, {"params": params})


def jax_run(jmodule, argv, axes, logdir):
    """The JAX package's run of ``argv`` on a mesh of ``axes`` over the
    virtual devices: its logged losses, and its parameters after the run
    as a whole torch state dict."""
    n = int(np.prod(list(axes.values())))
    mesh = jdist.make_mesh(axes, env=jdist.process_env({}),
                           devices=jax.devices()[:n])
    res = jmodule.run(jmodule.build_parser().parse_args(
        argv + ["--dir", str(logdir)]), mesh)
    params = jax.tree.map(np.asarray, res["state"]["params"])
    return _logged_losses(logdir), {
        k: v.numpy() for k, v in convert.params_from_flax(params).items()}


def port(argv, logdir):
    return argv + ["--device", "cpu", "--dir", str(logdir)]


# The key projection's bias gets no gradient: adding it shifts every
# score of a query by one constant, which the softmax removes.  What its
# gradient holds is rounding, which AdamW turns into a step of about the
# lr, of either sign, in each package; so it is held to its bound instead
# of to JAX's value: within 3 steps' lr (3e-3 each) of it.
ZERO_GRAD = r"attn\.key\.bias$"
ZERO_GRAD_ATOL = 2 * 3 * 3e-3


def check_runs(ranks, jlosses, jparams, *, shards=1):
    """Every rank's 3 losses within 1e-4 relative of JAX's, its
    parameters after step 3 gathered whole within 1e-4 of JAX's (the key
    biases within ``ZERO_GRAD_ATOL``), every parameter its tensor group
    holds whole bit-equal across that group, and (``shards``: the fsdp
    axis) a 1/``shards`` share of the tensor group's parameters and AdamW
    moments on each rank."""
    for r in ranks:
        assert r["step"] == 3 and len(r["losses"]) == 3
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-4)
        assert set(r["whole"]) == set(jparams)
        for k, v in jparams.items():
            tol = ZERO_GRAD_ATOL if re.search(ZERO_GRAD, k) else 1e-4
            np.testing.assert_allclose(r["whole"][k], v, rtol=1e-4,
                                       atol=tol, err_msg=k)
        peers = [ranks[i] for i in r["groups"]["tensor"]]
        for k, v in r["replicated"].items():
            for p in peers:
                np.testing.assert_array_equal(p["replicated"][k], v,
                                              err_msg=k)
        tp = len(r["groups"]["tensor"])
        total = sum(v.size for v in jparams.values())
        replicated = sum(v.size for v in r["replicated"].values()) * shards
        local = (total - replicated) // tp + replicated
        assert r["param_numel"] * shards == local
        assert r["moment_numel"] == 2 * r["param_numel"]


def check_decode(ranks, tmp_path):
    """``--generate 4``'s tokens: the same on every rank, and one
    process's from the same weights (the run's, gathered whole) and the
    same prompt (global row 0's first 8 ids)."""
    tokens = [r["generated"] for r in ranks]
    assert all(t == tokens[0] for t in tokens)
    assert len(tokens[0][0]) == 8 + 4
    args = tgpt.build_parser().parse_args(port(SMALL, tmp_path / "one"))
    one = tgpt.build_model(args, "cpu")
    one.load_state_dict({k: torch.from_numpy(v)
                         for k, v in ranks[0]["whole"].items()})
    prompt = torch.tensor(tokens[0])[:, :8]
    assert tgpt.generate_cached(one, prompt, 4).tolist() == tokens[0]


@pytest.fixture(scope="module")
def jax_tp(tmp_path_factory):
    """The JAX package's runs the TP cases are held to: each trainer at
    tensor 2 and at data 2 x tensor 2, and GPT with RoPE and 2 KV heads at
    tensor 2, with the weights each starts from."""
    out = {}
    for key, name, flags, axes in (
            ("gpt", "gpt", [], {"data": 1, "tensor": 2}),
            ("bert", "bert", [], {"data": 1, "tensor": 2}),
            ("gpt_data2", "gpt", [], {"data": 2, "tensor": 2}),
            ("bert_data2", "bert", [], {"data": 2, "tensor": 2}),
            ("gpt_rope_gqa", "gpt", ROPE_GQA, {"data": 1, "tensor": 2})):
        argv = SMALL + TP + flags
        jm = JMODULES[name]
        out[key] = (jax_run(jm, argv, axes, tmp_path_factory.mktemp(key)),
                    flax_init(jm, argv))
    return out


def test_runs_at_tensor_2_match_jax(tmp_path, jax_tp):
    """``gpt.run`` and ``bert.run`` at tensor 2, GPT with RoPE and GQA
    (each rank one KV head and its two query heads), and GPT decoding 4
    tokens after training: both ranks decode the same tokens, which are
    one process's from the same weights (the run's, gathered)."""
    runs = {"gpt": ("gpt", SMALL + TP + ["--generate", "4"]),
            "bert": ("bert", SMALL + TP),
            "gpt_rope_gqa": ("gpt", SMALL + TP + ROPE_GQA)}
    outs = spawn(shard_trainer_ranks, 2, tmp_path, [
        (name, port(argv, tmp_path / key), jax_tp[key][1])
        for key, (name, argv) in runs.items()])
    for i, key in enumerate(runs):
        (jlosses, jparams), _ = jax_tp[key]
        check_runs([o[i] for o in outs], jlosses, jparams)
        assert _logged_losses(tmp_path / key) == outs[0][i]["losses"]
    check_decode([o[0] for o in outs], tmp_path)


def test_runs_at_world_4_match_jax(tmp_path, jax_tp):
    """Four ranks: data 2 x tensor 2 (the data axis takes the ranks the
    tensor axis leaves; each tensor pair feeds half the rows, DDP averages
    over the data pair), and tensor 2 x sequence 2 on the ring (the
    zigzag layout for GPT), for both trainers.  The process groups of
    several axes are the row-major mesh's: a rank's replica and token
    groups are the ranks of its tensor index (the data pair, or the
    sequence pair); its expert x tensor group is its tensor pair."""
    runs = {"gpt_data2": ("gpt", "gpt_data2", SMALL + TP),
            "bert_data2": ("bert", "bert_data2", SMALL + TP),
            "gpt_ring": ("gpt", "gpt", SMALL + TP
                         + ["--sequence-parallel", "2"]),
            "bert_ring": ("bert", "bert", SMALL + TP
                          + ["--sequence-parallel", "2"])}
    outs = spawn(shard_trainer_ranks, 4, tmp_path, [
        (name, port(argv, tmp_path / key), jax_tp[ref][1])
        for key, (name, ref, argv) in runs.items()])
    for i, (key, (_, ref, _)) in enumerate(runs.items()):
        (jlosses, jparams), _ = jax_tp[ref]
        check_runs([o[i] for o in outs], jlosses, jparams)
        for r, o in enumerate(outs):
            pair = [r % 2, r % 2 + 2]
            tensor = [r - r % 2, r - r % 2 + 1]
            assert o[i]["groups"] == {"tensor": tensor, "ffn": tensor,
                                      "replica": pair, "tokens": pair}, key


# bf16 at tensor 2 against the JAX package's bf16 run: a 3-step run of
# lr 3e-3 moves no weight farther than about 3 x lr (AdamW's step is
# lr x m / sqrt(v), about lr in size), and a weight whose gradient rounds
# to the other sign in bf16 lands up to 2 x lr a step from the other
# package's: every weight within BF16_ATOL of JAX's.  ``update_err``
# (the distance over how far the run moved the weights) within
# BF16_UPDATE_RTOL: the JAX package's own tensor-2 run reads 0.058 against
# its one-device run here, the port's 0.069 against JAX's tensor-2 run
# and 0.067 at one process against JAX's one device (read on the CPU).
# Losses within one bf16 ulp.
BF16_ATOL = 2 * 3 * 3e-3
BF16_UPDATE_RTOL = 0.1


def bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def update_err(got, ref, init) -> float:
    """||got - ref|| / ||ref - init|| over every parameter but the key
    biases (see ``ZERO_GRAD``)."""
    keys = [k for k in ref if not re.search(ZERO_GRAD, k)]
    num = sum(float(((got[k] - ref[k]) ** 2).sum()) for k in keys)
    den = sum(float(((ref[k] - init[k]) ** 2).sum()) for k in keys)
    return float(np.sqrt(num / den))


BF16_TP = [a for a in SMALL if a != "--no-bf16"] + TP


@pytest.fixture(scope="module")
def jax_bf16(tmp_path_factory):
    """The JAX package's bf16 GPT run at tensor 2, its initial weights,
    and those as a torch state dict."""
    jrun = jax_run(jgpt, BF16_TP, {"data": 1, "tensor": 2},
                   tmp_path_factory.mktemp("jax_bf16"))
    tree = flax_init(jgpt, BF16_TP)
    init = {k: v.numpy() for k, v in convert.params_from_flax(tree).items()}
    return jrun, tree, init


def test_run_at_tensor_2_in_bf16_matches_jax(tmp_path, jax_bf16):
    """``gpt.run`` at tensor 2 in bf16 (the card's dtype) against the
    JAX package's bf16 run on the same mesh, from the same weights.  The
    row-parallel products' fp32 partials are summed in fp32 and rounded
    once (``parallel.reduce_from_tensor``), as the JAX package's
    partitioned product all-reduces its f32 dot; so are the
    column-parallel products' input-gradient partials
    (``parallel.column_parallel``).  Tolerances (``BF16_ATOL``,
    ``BF16_UPDATE_RTOL``, one bf16 ulp of each loss) are bf16's and
    AdamW's, stated with their reason above; the parameters the tensor
    group holds whole bit-equal on its ranks."""
    (jlosses, jparams), tree, init = jax_bf16
    ranks = [o[0] for o in spawn(shard_trainer_ranks, 2, tmp_path, [
        ("gpt", port(BF16_TP, tmp_path / "port"), tree)])]
    for r in ranks:
        assert len(r["losses"]) == 3
        for x, y in zip(r["losses"], jlosses):
            assert abs(x - y) <= bf16_ulp(y)
        for k, v in jparams.items():
            np.testing.assert_allclose(r["whole"][k], v, rtol=0,
                                       atol=BF16_ATOL, err_msg=k)
        assert update_err(r["whole"], jparams, init) <= BF16_UPDATE_RTOL
        for k, v in r["replicated"].items():
            np.testing.assert_array_equal(ranks[0]["replicated"][k], v,
                                          err_msg=k)


def test_fp32_sums_of_input_gradients_bring_tp_closer_to_jax(tmp_path,
                                                            jax_bf16):
    """The JAX package's CPU partitioner transposes a column-parallel
    product as an fp32 dot of the rank's partial, an fp32 all-reduce
    (one for q, k and v together) and one rounding to bf16 each, then
    bf16 adds; the port's ``column_parallel`` does the same.  Against the
    earlier sum (the products' bf16 gradients added, then all-reduced in
    bf16, ``bf16_tp_sum_ranks``), the run's ``update_err`` to the JAX
    package's run falls, and its losses stay within one bf16 ulp."""
    (jlosses, jparams), tree, init = jax_bf16
    runs = [("gpt", port(BF16_TP, tmp_path / "port"), tree)]
    now = spawn(shard_trainer_ranks, 2, tmp_path, runs)[0][0]
    before = spawn(bf16_tp_sum_ranks, 2, tmp_path, runs)[0][0]
    errs = [update_err(r["whole"], jparams, init) for r in (now, before)]
    print("update_err fp32 sums, bf16 sums:", errs)
    assert errs[0] < errs[1], errs
    for x, y in zip(now["losses"], jlosses):
        assert abs(x - y) <= bf16_ulp(y)


# ---------------------------------------------------------------------------
# the flag rules
# ---------------------------------------------------------------------------

# combinations the JAX package refuses with a ValueError: (flags, causal)
JAX_REFUSALS = {
    "flash_with_tp": (TP + ["--attention", "flash"], True),
    "ulysses_with_tp": (TP + ["--sequence-parallel", "2", "--sp-mode",
                              "ulysses"], True),
    "kv_heads_do_not_divide_over_tp": (["--tensor-parallel", "4",
                                        "--kv-heads", "2"], True),
    "fsdp_with_pp": (["--fsdp", "2", "--pipeline-parallel", "2"], False),
}


def jax_error(flags, causal):
    """The JAX package's ValueError for ``flags`` (None if it builds): its
    flag checks, its mesh on the 8 virtual devices, and its build."""
    jmodule = jgpt if causal else jbert
    args = jmodule.build_parser().parse_args(SMALL + flags)
    try:
        mesh = jbert.make_mesh_for(args, jdist.process_env({}))
        jbert.build_model(args, mesh, causal=causal)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("name", sorted(JAX_REFUSALS))
def test_tp_and_fsdp_combinations_jax_refuses_raise_its_value_error(name):
    """The port raises the JAX package's own ValueError, before any "not
    yet ported" refusal and before any process group is needed."""
    flags, causal = JAX_REFUSALS[name]
    want = jax_error(flags, causal)
    assert want is not None
    module = tgpt if causal else tbert
    args = module.build_parser().parse_args(SMALL + flags)
    with pytest.raises(ValueError) as err:
        tbert.build_model(args, "cpu", causal=causal)
    assert str(err.value) == want


@pytest.mark.parametrize("flags", [
    ["--expert-parallel", "2", "--moe-experts", "4"],
    ["--pipeline-parallel", "2"],
    ["--moe-experts", "4", "--sequence-parallel", "2"],
    ["--moe-experts", "4", "--tensor-parallel", "2"],
    ["--moe-experts", "4", "--fsdp", "2"]])
def test_strategies_still_unported_raise_not_yet_ported(flags):
    """No strategy the JAX package builds is refused any more: expert
    parallelism and MoE with SP, TP or FSDP (``tests/test_torch_ep.py``
    runs them) and the pipeline (``tests/test_torch_pipeline*.py``) pass
    the flag checks; one process cannot hold their axis of 2 (the mesh's
    own error)."""
    assert jax_error(flags, True) is None
    args = tgpt.build_parser().parse_args(SMALL + flags)
    tbert.validate_parallel_flags(args, causal=True)
    with pytest.raises(ValueError, match="not divisible by fixed axes"):
        tbert.make_mesh_for(args, tbert.dist.process_env({}))


def test_tp_needs_ranks_to_split_over():
    """One process cannot hold a tensor axis of 2: the mesh's own error,
    before the trainer runs."""
    args = tgpt.build_parser().parse_args(port(SMALL + TP, "unused"))
    with pytest.raises(ValueError, match="not divisible by fixed axes"):
        tgpt.run(args)
