"""Expert parallelism, and sparse MoE under tensor parallelism, FSDP and
sequence parallelism, in the port against the JAX package, on the CPU.

- ``moe_ffn`` on 2 and 4 expert ranks, and on expert 2 x tensor 2,
  against the JAX package's ``moe_ffn`` on a data x expert (x tensor)
  mesh of virtual devices, its experts placed over the expert axis (the
  port's side of ``test_ep_sharding_matches_unsharded``): outputs and
  the load balance within 1e-5, the gradients of x, of the router and of
  the experts (gathered whole) within 1e-4; the router's and x's
  gradients bit-equal on every rank.
- The sequence-group routing: each shard of a sequence split over 2 and
  4 ranks, in the contiguous layout (Ulysses) and the zigzag one (the
  causal ring), at capacity factor 0.5 (assignments dropped) and with a
  validity mask: its experts, slots, keep flags and dropped count equal
  as integers to the JAX ``moe_ffn``'s on the whole sequence (its two
  one-hots recorded, as ``tests/test_torch_moe.py`` reads them), and its
  output within 1e-5.
- ``gpt.run`` and ``bert.run``, fp32, 3 steps, each rank loading its
  blocks of the JAX package's initial weights (``convert.params_from_
  flax`` over its mesh): at world 2 expert 2 (both trainers), MoE at
  tensor 2, fsdp 2 and sequence 2 on the ring without EP; at world 4
  data 2 x expert 2, fsdp 2 x expert 2, tensor 2 x expert 2, and
  sequence 2 x expert 2 on the ring and under Ulysses on the flash
  kernels.  Losses within 1e-4 relative and the parameters after step 3
  within 1e-4 of the JAX package's (``test_torch_tp.check_runs``' rule,
  the key bias to its bound), every parameter the expert x tensor group
  holds whole bit-equal on its ranks, and each rank's share of the
  parameters and AdamW moments.  The JAX package's expert, sequence,
  tensor and fsdp axes are annotations, its numerics one function on any
  mesh (its ``test_moe_ep_matches_single_device_numerics``,
  ``test_moe_composes_with_sequence_parallel``,
  ``test_fsdp_composes_with_moe``), so each layout is held to its
  trainer's one JAX run (``JAX_RUNS``: GPT at expert 2 x sequence 2
  under Ulysses on the flash kernels, in Pallas interpret mode; BERT at
  fsdp 2 x expert 2), which its JAX compile makes the file's largest
  cost.
- Decode under EP 2 and under MoE x SP: every rank's ``--generate 4``
  tokens are one process's from the same weights.
- Checkpoints: expert 2's step-2 checkpoint resumes at one process, and
  one process's at expert 2, each to the uninterrupted run's step 3.
- The ``moe_terms`` repair: a data-parallel MoE run's load balance is
  the world's formula's bit for bit, and an expert-parallel run's load
  balance, z-loss and dropped assignments are one process's.
- The flag rules: the JAX package's ValueErrors for EP without experts
  and for experts that do not divide over EP, and for MoE with the
  pipeline; MoE with TP, FSDP or SP and EP alone pass the flag checks.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from test_torch_fsdp import one_process
from test_torch_spawn import (ep_ffn_ranks, seq_route_ranks,
                              shard_trainer_ranks, spawn)
from test_torch_tp import (JMODULES, SMALL, TP, ZERO_GRAD, ZERO_GRAD_ATOL,
                           flax_init, jax_error, jax_run, port)
from tpujob.workloads import distributed as jdist
from tpujob.workloads import parallel as jpar
from tpujob_torch.workloads import bert as tbert
from tpujob_torch.workloads import convert
from tpujob_torch.workloads import gpt as tgpt
from tpujob_torch.workloads import parallel as tpar

MOE = SMALL + ["--moe-experts", "4"]
EP = ["--expert-parallel", "2"]
FSDP = ["--fsdp", "2"]
RING = ["--sequence-parallel", "2"]
ULYSSES_FLASH = ["--sequence-parallel", "2", "--sp-mode", "ulysses",
                 "--attention", "flash"]
CKPT = ["--checkpoint-interval", "2"]
GEN = ["--generate", "4"]

# the JAX package's runs, one a trainer: key -> (flags, mesh)
JAX_RUNS = {
    "gpt": (EP + ULYSSES_FLASH, {"data": 1, "expert": 2, "sequence": 2}),
    "bert": (EP + FSDP, {"data": 1, "fsdp": 2, "expert": 2}),
}
# the port's layouts: name -> (trainer, flags, world); each is held to
# its trainer's JAX run
CASES = {
    "gpt_ep": ("gpt", EP, 2),
    "bert_ep": ("bert", EP, 2),
    "gpt_tp": ("gpt", TP, 2),
    "bert_fsdp": ("bert", FSDP, 2),
    "gpt_ring": ("gpt", RING, 2),
    "gpt_data": ("gpt", [], 2),
    "gpt_data_ep": ("gpt", EP, 4),
    "bert_fsdp_ep": ("bert", FSDP + EP, 4),
    "gpt_tp_ep": ("gpt", TP + EP, 4),
    "bert_ring_ep": ("bert", RING + EP, 4),
    "gpt_ulysses_ep": ("gpt", ULYSSES_FLASH + EP, 4),
}
# the runs that decode after training (``gpt_ep`` also checkpoints)
DECODES = ("gpt_ep", "gpt_ring")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# moe_ffn on the expert (and tensor) group
# ---------------------------------------------------------------------------


def _ffn_case(axes, seed, e=8, b=4, s=16, d=8, f=12):
    rng = np.random.RandomState(seed)
    return dict(axes=axes, k=2, cf=1.0,
                x=rng.randn(b, s, d).astype(np.float32),
                router=(rng.randn(d, e) * 0.5).astype(np.float32),
                wi=(rng.randn(e, d, f) * 0.3).astype(np.float32),
                wo=(rng.randn(e, f, d) * 0.3).astype(np.float32),
                ct=rng.randn(b, s, d).astype(np.float32))


FFN_CASES = {
    2: {"expert2": _ffn_case({"expert": 2}, 0)},
    4: {"expert4": _ffn_case({"expert": 4}, 1),
        "expert2_tensor2": _ffn_case({"expert": 2, "tensor": 2}, 2)},
}


def jax_ffn(c):
    """The JAX package's ``moe_ffn`` under jit on a data 2 x (the case's
    axes) mesh, ``wi``/``wo`` placed as its partition rules place them:
    y, metrics and the gradients of ``sum(y * ct) + lb + z``."""
    axes = {"data": 2, **c["axes"]}
    mesh = jdist.make_mesh(axes, env=jdist.process_env({}),
                           devices=jax.devices()[:int(np.prod(list(
                               axes.values())))])
    tensor = "tensor" if "tensor" in axes else None
    wi = jax.device_put(c["wi"], NamedSharding(mesh, P("expert", None,
                                                       tensor)))
    wo = jax.device_put(c["wo"], NamedSharding(mesh, P("expert", tensor,
                                                       None)))

    def loss(x, router, wi, wo):
        y, m = jpar.moe_ffn(x, router, wi, wo, mesh, k=c["k"],
                            capacity_factor=c["cf"])
        return (y * c["ct"]).sum() + m["load_balance"] + m["router_z"], (y, m)

    (_, (y, m)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(
            jnp.asarray(c["x"]), jnp.asarray(c["router"]), wi, wo)
    return np.asarray(y), {k: float(v) for k, v in m.items()}, \
        [np.asarray(g) for g in grads]


@pytest.mark.parametrize("world", [2, 4])
def test_moe_ffn_on_expert_ranks_matches_jax(tmp_path, world):
    """Each rank routes every row with the whole router and runs its E/n
    experts (under tensor 2 on its half of d_ff); the partial outputs
    are summed over the expert x tensor group.  Outputs 1e-5, load
    balance 1e-5, gradients 1e-4 against the JAX package's on its mesh;
    the router's and x's gradients bit-equal across the ranks (the gate's
    and the dispatch's partial gradients are summed over the group, the
    router path's is not summed)."""
    cases = FFN_CASES[world]
    ranks = spawn(ep_ffn_ranks, world, tmp_path, cases)
    for name, c in cases.items():
        jy, jm, jgrads = jax_ffn(c)
        for r in ranks:
            out = r[name]
            assert out["local_experts"] * c["axes"]["expert"] == 8
            assert _rel(out["y"], jy) <= 1e-5, name
            np.testing.assert_allclose(out["metrics"]["load_balance"],
                                       jm["load_balance"], rtol=1e-5)
            np.testing.assert_allclose(out["metrics"]["router_z"],
                                       jm["router_z"], rtol=1e-5)
            for key, g in zip(("x", "router", "wi", "wo"), jgrads):
                assert _rel(out[key], g) <= 1e-4, f"{name} {key}"
            for key in ("router", "x", "y"):
                np.testing.assert_array_equal(out[key], ranks[0][name][key])


# ---------------------------------------------------------------------------
# the sequence group's routing
# ---------------------------------------------------------------------------


def _route_cases(world):
    rng = np.random.RandomState(world)
    b, s, d, f, e = 2, 32, 8, 12, 4
    x = rng.randn(b, s, d).astype(np.float32)
    router = (rng.randn(d, e) * 0.8).astype(np.float32)
    wi = (rng.randn(e, d, f) * 0.3).astype(np.float32)
    wo = (rng.randn(e, f, d) * 0.3).astype(np.float32)
    valid = (np.arange(s)[None] < np.array([[s], [s - 11]])).astype(
        np.float32)
    base = dict(x=x, router=router, wi=wi, wo=wo, k=2, cf=0.5)
    return {"contiguous": dict(base, zigzag=False),
            "zigzag": dict(base, zigzag=True),
            "zigzag_valid": dict(base, zigzag=True, valid=valid),
            "contiguous_k1": dict(base, zigzag=False, k=1)}


def _jax_routing(monkeypatch, c):
    """The JAX ``moe_ffn`` on the whole sequence, eager, its two one-hots
    recorded: experts [b, S, k], slots [b, k*S]; and its output."""
    seen = []
    one_hot = jax.nn.one_hot

    def recording(idx, n, **kw):
        seen.append(np.asarray(idx))
        return one_hot(idx, n, **kw)

    valid = c.get("valid")
    with monkeypatch.context() as m:
        m.setattr(jax.nn, "one_hot", recording)
        y, _ = jpar.moe_ffn(
            *(jnp.asarray(c[k]) for k in ("x", "router", "wi", "wo")),
            k=c["k"], capacity_factor=c["cf"],
            valid=None if valid is None else jnp.asarray(valid))
    idx, slot = seen
    return idx, slot, np.asarray(y)


@pytest.mark.parametrize("world", [2, 4])
def test_sequence_group_routing_equals_jax_whole_sequence(
        tmp_path, monkeypatch, world):
    """A rank holds its shard of each sequence (contiguous, or zigzag
    chunks j and 2n-1-j); at capacity factor 0.5 assignments drop.  Each
    shard's experts, slots and keep flags equal, as integers, the JAX
    ``moe_ffn``'s at its positions on the whole sequence (the capacity of
    the whole sequence, its k-major slot order); the shards' dropped
    counts add up to the whole sequence's; the outputs within 1e-5."""
    cases = _route_cases(world)
    ranks = spawn(seq_route_ranks, world, tmp_path, cases)
    for name, c in cases.items():
        idx, slot, y = _jax_routing(monkeypatch, c)
        b, seq, k = idx.shape
        cap = jpar.moe_capacity(seq, c["router"].shape[1], k, c["cf"])
        slot = slot.reshape(b, k, seq)
        routed = np.ones((b, seq)) if c.get("valid") is None else c["valid"]
        dropped = ((slot >= cap) * routed[:, None]).sum()
        assert dropped > 0, name
        for r in ranks:
            out = r[name]
            pos = out["positions"]
            np.testing.assert_array_equal(out["expert_idx"], idx[:, pos])
            want = slot[:, :, pos].reshape(b, -1)
            np.testing.assert_array_equal(out["slot"], want)
            np.testing.assert_array_equal(out["keep"],
                                          (want < cap).astype(np.float32))
            assert _rel(out["y"], y[:, pos]) <= 1e-5, name
        assert sum(r[name]["dropped"] for r in ranks) == dropped, name
        assert sorted(np.concatenate([r[name]["positions"]
                                      for r in ranks])) == list(range(seq))


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    """Each JAX run's losses and parameters after it, and each trainer's
    initial weights."""
    runs = {name: jax_run(JMODULES[name], MOE + flags, axes,
                          tmp_path_factory.mktemp(name))
            for name, (flags, axes) in JAX_RUNS.items()}
    init = {name: flax_init(JMODULES[name], MOE) for name in ("gpt", "bert")}
    return runs, init


def _argv(name):
    _, flags, _ = CASES[name]
    return MOE + flags + (GEN if name in DECODES else [])


def check_moe_runs(ranks, jlosses, jparams):
    """``test_torch_tp.check_runs`` over the expert x tensor group: every
    rank's losses 1e-4 relative, its parameters gathered whole 1e-4 (the
    key biases to their bound), the parameters its ``ffn`` group holds
    whole bit-equal on that group's ranks, and its share of the
    parameters (E / ep experts, each 1/tp of d_ff, and 1/fsdp of all that)
    and of AdamW's moments."""
    for r in ranks:
        assert r["step"] == 3 and len(r["losses"]) == 3
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-4)
        assert set(r["whole"]) == set(jparams)
        for k, v in jparams.items():
            tol = ZERO_GRAD_ATOL if re.search(ZERO_GRAD, k) else 1e-4
            np.testing.assert_allclose(r["whole"][k], v, rtol=1e-4,
                                       atol=tol, err_msg=k)
        for i in r["groups"]["ffn"]:
            for k, v in r["replicated"].items():
                np.testing.assert_array_equal(ranks[i]["replicated"][k], v,
                                              err_msg=k)
        assert r["moment_numel"] == 2 * r["param_numel"]


def check_shares(ranks, jparams, flags):
    """Each rank's elements of the parameters: each one's size over the
    ranks that split it (expert, tensor), then over fsdp."""
    def size(flag):
        return int(flags[flags.index(flag) + 1]) if flag in flags else 1

    ep, tp, fsdp = (size("--expert-parallel"), size("--tensor-parallel"),
                    size("--fsdp"))
    local = sum(v.size // (ep if tpar.ep_dim(k) is not None else 1)
                // (tp if tpar.tp_dim(k) is not None else 1)
                for k, v in jparams.items())
    for r in ranks:
        assert r["param_numel"] * fsdp == local


def check_decode(ranks, tmp_path):
    """``--generate 4``'s tokens: the same on every rank, and one
    process's full route from the same weights (the run's, gathered) and
    prompt (global row 0's first 8 ids)."""
    tokens = [r["generated"] for r in ranks]
    assert all(t == tokens[0] for t in tokens)
    assert len(tokens[0][0]) == 8 + 4
    args = tgpt.build_parser().parse_args(port(MOE, tmp_path / "one"))
    one = tgpt.build_model(args, "cpu")
    one.load_state_dict({k: torch.from_numpy(v)
                         for k, v in ranks[0]["whole"].items()})
    prompt = torch.tensor(tokens[0])[:, :8]
    assert tgpt.generate_cached(one, prompt, 4).tolist() == tokens[0]


def _runs(world, tmp, init, extra=()):
    names = [n for n, c in CASES.items() if c[2] == world]
    runs = [(CASES[n][0], port(_argv(n) + (CKPT if n == "gpt_ep" else []),
                               tmp / n), init[CASES[n][0]]) for n in names]
    return names, runs + list(extra)


@pytest.fixture(scope="module")
def world_2(tmp_path_factory, jax_ep):
    """The world-2 layouts (GPT at expert 2 checkpointing at step 2), then
    GPT at expert 2 resuming one process's step-2 checkpoint, written
    before the spawn."""
    _, init = jax_ep
    tmp = tmp_path_factory.mktemp("world_2")
    one = one_process(port(MOE + CKPT, tmp / "one"), init["gpt"])
    names, runs = _runs(2, tmp, init, [
        ("gpt", port(MOE + EP + CKPT, tmp / "one"), init["gpt"])])
    return tmp, one, names, spawn(shard_trainer_ranks, 2, tmp, runs)


def test_runs_at_world_2_match_jax(jax_ep, world_2):
    """Expert 2 (each rank 2 of the 4 experts, every row), both trainers;
    MoE at tensor 2 (each expert's d_ff split), fsdp 2 (each expert's d
    split), sequence 2 on the ring (the zigzag layout, the slots of each
    whole sequence) and data 2; GPT decoding 4 tokens after the expert-2
    and the ring runs."""
    runs, _ = jax_ep
    tmp, _, names, outs = world_2
    for i, name in enumerate(names):
        ranks = [o[i] for o in outs]
        jlosses, jparams = runs[CASES[name][0]]
        check_moe_runs(ranks, jlosses, jparams)
        check_shares(ranks, jparams, CASES[name][1])
        if name in DECODES:
            check_decode(ranks, tmp)


def test_checkpoints_resume_across_expert_layouts(jax_ep, world_2):
    """Expert 2's step-2 checkpoint (gathered whole, written by rank 0)
    resumed at one process, and one process's resumed at expert 2: each
    resumed step 3 is the uninterrupted run's (losses 1e-4 relative,
    parameters 1e-4)."""
    _, init = jax_ep
    tmp, (one_losses, one_params), names, outs = world_2
    sharded = outs[0][names.index("gpt_ep")]
    losses, params = one_process(port(MOE + CKPT, tmp / "gpt_ep"),
                                 init["gpt"])
    np.testing.assert_allclose(losses, sharded["losses"][2:], rtol=1e-4)
    for k, v in sharded["whole"].items():
        np.testing.assert_allclose(params[k], v, rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    for o in outs:
        resumed = o[-1]
        assert resumed["step"] == 3
        np.testing.assert_allclose(resumed["losses"], one_losses[2:],
                                   rtol=1e-4)
        for k, v in one_params.items():
            np.testing.assert_allclose(resumed["whole"][k], v, rtol=1e-4,
                                       atol=1e-4, err_msg=k)


def test_runs_at_world_4_match_jax(tmp_path, jax_ep):
    """Four ranks: data 2 x expert 2 (DDP over the data pair of each
    expert index), fsdp 2 x expert 2, tensor 2 x expert 2 (each rank one
    half of d_ff of 2 experts), and sequence 2 x expert 2 on the ring
    (BERT) and under Ulysses on the flash kernels (GPT).  The groups are
    the row-major mesh's: a rank's ``ffn`` group is its expert (x
    tensor) ranks, its token group the other ranks of its expert
    index."""
    runs, init = jax_ep
    names, args = _runs(4, tmp_path, init)
    outs = spawn(shard_trainer_ranks, 4, tmp_path, args)
    for i, name in enumerate(names):
        ranks = [o[i] for o in outs]
        jlosses, jparams = runs[CASES[name][0]]
        check_moe_runs(ranks, jlosses, jparams)
        check_shares(ranks, jparams, CASES[name][1])
        for r, o in enumerate(outs):
            tokens = o[i]["groups"]["tokens"]
            assert r in tokens and o[i]["groups"]["ffn"] != tokens


# ---------------------------------------------------------------------------
# moe_terms over the mesh
# ---------------------------------------------------------------------------


def test_load_balance_over_the_token_group(jax_ep, world_2, tmp_path,
                                           monkeypatch):
    """``moe_terms`` sums the load balance's counts over the mesh's token
    group and scales by its size.  At data 2 (DDP) every step's value is
    the world formula's (the sums over the whole world the function made
    before it took the mesh), bit for bit; at expert 2 (the ranks of an
    expert group hold the same rows, counted once) each step's load
    balance and z-loss are one process's within 1e-5 relative, and its
    dropped assignments equal."""
    _, init = jax_ep
    _, _, names, outs = world_2
    for o in outs:
        equal = o[names.index("gpt_data")]["lb_world_equal"]
        assert len(equal) >= 3 and all(equal)
    build = tbert.build_model
    monkeypatch.setattr(tbert, "build_model", lambda *a, **kw: _load(
        build(*a, **kw), init["gpt"]))
    one = tgpt.run(tgpt.build_parser().parse_args(port(MOE, tmp_path)))
    for o in outs:
        got = o[names.index("gpt_ep")]["moe_metrics"]
        assert len(got) == len(one["moe_metrics"]) == 3
        for g, w in zip(got, one["moe_metrics"]):
            assert g["dropped"] == w["dropped"]
            for k in ("load_balance", "router_z"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)


def _load(model, tree):
    model.load_state_dict(convert.params_from_flax(tree), strict=True)
    return model


# ---------------------------------------------------------------------------
# the flag rules
# ---------------------------------------------------------------------------

JAX_REFUSALS = {
    "ep_without_experts": ["--expert-parallel", "2"],
    "experts_do_not_divide": ["--moe-experts", "3", "--expert-parallel",
                              "2"],
}


@pytest.mark.parametrize("name", sorted(JAX_REFUSALS))
def test_ep_flags_jax_refuses_raise_its_value_error(name):
    """The JAX package's own ValueError, before any mesh is needed."""
    flags = JAX_REFUSALS[name]
    want = jax_error(flags, True)
    assert want is not None
    args = tgpt.build_parser().parse_args(SMALL + flags)
    with pytest.raises(ValueError) as err:
        tgpt.build_model(args, "cpu")
    assert str(err.value) == want


@pytest.mark.parametrize("flags", [
    EP, TP, FSDP, RING, ULYSSES_FLASH, EP + TP, EP + FSDP, EP + RING])
def test_moe_compositions_pass_the_flag_checks(flags):
    """EP, and MoE with TP, FSDP or SP (with EP or without), pass the
    flag checks that used to refuse them; the JAX package builds each."""
    assert jax_error(["--moe-experts", "4"] + flags, True) is None
    args = tgpt.build_parser().parse_args(MOE + flags)
    tbert.validate_parallel_flags(args, causal=True)


def test_pipeline_is_still_refused():
    """The pipeline is ported, but not with MoE: the JAX package's
    ValueError, word for word."""
    flags = ["--moe-experts", "4", "--pipeline-parallel", "2"]
    want = jax_error(flags, True)
    assert want is not None
    args = tgpt.build_parser().parse_args(MOE + ["--pipeline-parallel",
                                                 "2"])
    with pytest.raises(ValueError) as err:
        tgpt.build_model(args, "cpu")
    assert str(err.value) == want
