"""Sequence parallelism in the port against the JAX package, on the CPU.

The port's ``ring_attention`` (contiguous, zigzag, and untileable causal)
and ``ulysses_attention`` (dense, and through flash's plain versions) on
2 and 4 gloo ranks, each holding its shard of the sequence, against the
JAX package's functions on a mesh of as many virtual CPU devices (its
flash in Pallas interpret mode), from numpy inputs made from a seed:
every rank's output shard and the grads of ``sum(out * ct)`` for its q, k
and v.  Then ``gpt.run`` and ``bert.run`` under ``--sequence-parallel 2``
in both modes, and data 2 x sequence 2, against the JAX package's run at
sequence 2 from the same flax weights.  Then the flag rules.

Tolerances: attention fp32, outputs 1e-5 and grads 1e-4 (rtol and atol:
the same exact softmax in another summation order); runs fp32, 3 steps,
losses 1e-4 relative (the DDP test's 1e-5 on a model whose attention now
adds its blocks in another order), and the ranks' params equal (one
averaged gradient).  Several cases run in one spawn, as
``tests/test_torch_spawn.py``'s bodies do, to keep the spawns few.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from test_torch_spawn import sp_attention_ranks, sp_trainer_ranks, spawn
from tpujob.workloads import bert as jbert
from tpujob.workloads import distributed as jdist
from tpujob.workloads import flash as jflash
from tpujob.workloads import gpt as jgpt
from tpujob.workloads import parallel as jparallel
from tpujob_torch.workloads import bert as tbert
from tpujob_torch.workloads import convert
from tpujob_torch.workloads import gpt as tgpt

SMALL = ["--hidden", "64", "--layers", "2", "--heads", "4", "--intermediate",
         "128", "--vocab", "211", "--seq-len", "128", "--batch-size", "4",
         "--no-bf16", "--lr", "3e-3", "--log-interval", "1", "--steps", "3",
         "--lr-schedule", "cosine"]
RING = ["--sequence-parallel", "2"]
ULYSSES = ["--sequence-parallel", "2", "--sp-mode", "ulysses"]
ROPE_GQA = ["--position", "rope", "--kv-heads", "2"]


def _cases(n: int) -> dict:
    """name -> (mode, causal, seq, heads, kv heads, flash): ring
    non-causal, zigzag causal (seq tiles into 2n chunks), untileable causal
    (contiguous), GQA; Ulysses causal, non-causal, GQA, and through flash
    (seq 128: the Pallas kernel's one block)."""
    return {
        "ring_noncausal": ("ring", False, 16, 4, 4, False),
        "ring_zigzag": ("ring", True, 16, 4, 4, False),
        "ring_untileable": ("ring", True, 3 * n, 4, 4, False),
        "ring_gqa": ("ring", True, 16, 4, 2, False),
        "ulysses": ("ulysses", True, 16, 4, 4, False),
        "ulysses_noncausal": ("ulysses", False, 16, 4, 4, False),
        "ulysses_gqa": ("ulysses", True, 16, 2 * n, n, False),
        "ulysses_flash": ("ulysses", True, 128, 4, 4, True),
    }


def _inputs(n: int) -> dict:
    rng = np.random.RandomState(n)
    out = {}
    for name, (mode, causal, seq, h, hkv, fl) in _cases(n).items():
        b, d = (1, 16) if fl else (2, 8)
        out[name] = dict(
            mode=mode, causal=causal, flash=fl,
            q=rng.randn(b, seq, h, d).astype(np.float32),
            k=rng.randn(b, seq, hkv, d).astype(np.float32),
            v=rng.randn(b, seq, hkv, d).astype(np.float32),
            ct=rng.randn(b, seq, h, d).astype(np.float32))
    return out


def _jax_case(c, n):
    """The JAX package's output and grads of one case on n devices."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("sequence",))
    if c["mode"] == "ring":
        def f(q, k, v):
            return jparallel.ring_attention(q, k, v, mesh,
                                            causal=c["causal"])
    else:
        impl = jflash.flash_attention if c["flash"] else None

        def f(q, k, v):
            return jparallel.ulysses_attention(
                q, k, v, mesh, causal=c["causal"], attention_impl=impl)

    @jax.jit
    def out_and_grads(q, k, v, ct):
        out, vjp = jax.vjp(f, q, k, v)
        return out, vjp(ct)

    out, grads = out_and_grads(*(jnp.asarray(c[x])
                                 for x in ("q", "k", "v", "ct")))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n", [2, 4])
def test_attention_matches_jax_on_every_shard(tmp_path, n):
    """Every case on n ranks: each rank's output shard (1e-5) and its q, k,
    v grads (1e-4) against the JAX package's global ones at the rank's
    positions; one stacked all-to-all for q, k, v when the heads are
    equal (two under GQA) and one back, n - 1 shifts on the ring.  At
    n = 4 the data 2 x sequence 2 mesh's process groups are those of the
    row-major layout."""
    cases = _inputs(n)
    ranks = spawn(sp_attention_ranks, n, tmp_path, cases)
    for name, c in cases.items():
        jo, jgrads = _jax_case(c, n)
        for out, _ in ranks:
            r = out[name]
            idx = r["idx"]
            np.testing.assert_allclose(r["o"], jo[:, idx], rtol=1e-5,
                                       atol=1e-5, err_msg=name)
            for x, got, want in zip("qkv", r["grads"], jgrads):
                np.testing.assert_allclose(got, want[:, idx], rtol=1e-4,
                                           atol=1e-4, err_msg=f"{name} d{x}")
            gqa = c["k"].shape[2] != c["q"].shape[2]
            want_calls = (n - 1 if c["mode"] == "ring"
                          else (3 if gqa else 2))
            assert r["forward_exchanges"] == want_calls, name
        # the shards cover the sequence once
        assert sorted(np.concatenate([o[name]["idx"] for o, _ in ranks])
                      ) == list(range(c["q"].shape[1]))
    if n == 4:
        assert [g for _, g in ranks] == [
            {"data": [0, 2], "sequence": [0, 1]},
            {"data": [1, 3], "sequence": [0, 1]},
            {"data": [0, 2], "sequence": [2, 3]},
            {"data": [1, 3], "sequence": [2, 3]}]


def _logged_losses(logdir):
    rows = [json.loads(x) for x in
            (logdir / "scalars.jsonl").read_text().splitlines()]
    return [r["value"] for r in rows if r["tag"] == "loss"]


def _init(jmodule, argv):
    """The weights the JAX package's run starts from, as a state_dict
    (its init on a one-device mesh: the attention path holds no params)."""
    ja = jmodule.build_parser().parse_args(argv)
    jm = jmodule.build_model(ja, Mesh(np.array(jax.devices()[:1]), ("data",)))
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 128), jnp.int32))["params"]
    return convert.params_from_flax(
        jax.tree.map(np.asarray, {"params": params}))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Each trainer's JAX run at data 1 x sequence 2 under Ulysses (GPT
    through its flash kernel, in interpret mode; and a GPT with RoPE and
    2 KV heads, dense): its losses, and the weights it started from.  Its ring attention computes the same
    function (held to the port's above, shard by shard) and compiles four
    times slower on the CPU, so these losses are the reference of both of
    the port's modes."""
    out = {}
    for name, jmodule, flags in (("gpt", jgpt, ["--attention", "flash"]),
                                 ("bert", jbert, []),
                                 ("gpt_rope_gqa", jgpt, ROPE_GQA)):
        argv = SMALL + ULYSSES + flags
        logdir = tmp_path_factory.mktemp(f"jax_{name}")
        mesh = jdist.make_mesh({"data": 1, "sequence": 2},
                               devices=jax.devices()[:2])
        jmodule.run(jmodule.build_parser().parse_args(
            argv + ["--dir", str(logdir)]), mesh)
        out[name] = (_logged_losses(logdir), _init(jmodule, argv))
    return out


def _port(argv, logdir):
    return argv + ["--device", "cpu", "--dir", str(logdir)]


def _check_runs(outs, jlosses):
    """Every rank's 3 losses within 1e-4 of JAX's, and the ranks' params
    equal."""
    for out in outs:
        assert out["step"] == 3 and len(out["losses"]) == 3
        np.testing.assert_allclose(out["losses"], jlosses, rtol=1e-4)
        for name, v in outs[0]["state"].items():
            np.testing.assert_array_equal(out["state"][name], v,
                                          err_msg=name)


def test_runs_at_two_ranks_match_jax(tmp_path, jax_runs):
    """``gpt.run`` (ring: the zigzag layout; Ulysses through flash; RoPE
    with GQA on the ring, the rotary phases at each token's zigzag
    position) and ``bert.run`` (ring, Ulysses) at sequence 2 against the
    JAX package's run at sequence 2, 3 steps from the same weights."""
    runs = {
        "gpt_ring": ("gpt", "gpt", SMALL + RING),
        "gpt_ulysses_flash": ("gpt", "gpt", SMALL + ULYSSES
                              + ["--attention", "flash"]),
        "gpt_rope_gqa_ring": ("gpt", "gpt_rope_gqa",
                              SMALL + RING + ROPE_GQA),
        "bert_ring": ("bert", "bert", SMALL + RING),
        "bert_ulysses": ("bert", "bert", SMALL + ULYSSES),
    }
    outs = spawn(sp_trainer_ranks, 2, tmp_path, [
        (name, _port(argv, tmp_path / key), jax_runs[ref][1])
        for key, (name, ref, argv) in runs.items()])
    for i, (key, (_, ref, _)) in enumerate(runs.items()):
        _check_runs([ranks[i] for ranks in outs], jax_runs[ref][0])
        assert _logged_losses(tmp_path / key) == outs[0][i]["losses"]


def test_gpt_at_data_2_by_sequence_2_matches_jax(tmp_path, jax_runs):
    """Four ranks, data 2 x sequence 2 (Ulysses through flash): each
    sequence pair feeds half the batch's rows, DDP averages over all four;
    the global batch's losses are JAX's."""
    argv = SMALL + ULYSSES + ["--attention", "flash"]
    jlosses, init = jax_runs["gpt"]
    outs = spawn(sp_trainer_ranks, 4, tmp_path,
                 [("gpt", _port(argv, tmp_path / "t"), init)])
    _check_runs([o[0] for o in outs], jlosses)


# ---------------------------------------------------------------------------
# the flag rules
# ---------------------------------------------------------------------------

# combinations with --sequence-parallel 2 the JAX package refuses with a
# ValueError: (flags, causal family)
JAX_REFUSALS = {
    "flash_with_ring": (["--attention", "flash"], True),
    "ulysses_with_tp": (["--sp-mode", "ulysses", "--tensor-parallel", "2"],
                        True),
    "window_with_sp": (["--attention-window", "8"], True),
    "heads_do_not_divide": (["--sp-mode", "ulysses", "--heads", "2",
                             "--hidden", "32", "--sequence-parallel", "4"],
                            False),
    "kv_heads_do_not_divide": (["--sp-mode", "ulysses", "--heads", "4",
                                "--kv-heads", "1"], True),
    "pipeline_with_sp": (["--pipeline-parallel", "2"], True),
}


def _jax_error(flags, causal, trace=False):
    """The JAX package's ValueError for ``flags`` (None if it builds):
    its flag checks, its mesh on the 8 virtual devices, its build, and
    with ``trace`` one forward (the Ulysses head checks run at trace)."""
    jmodule = jgpt if causal else jbert
    args = jmodule.build_parser().parse_args(SMALL + RING + flags)
    try:
        mesh = jbert.make_mesh_for(args, jdist.process_env({}))
        model = jbert.build_model(args, mesh, causal=causal)
        if trace:
            jax.eval_shape(model.init, jax.random.PRNGKey(0),
                           jnp.zeros((2, args.seq_len), jnp.int32))
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("name", sorted(JAX_REFUSALS))
def test_sp_combinations_jax_refuses_raise_its_value_error(name):
    """The port raises the JAX package's own ValueError, before any
    "not yet ported" refusal and before any process group is needed."""
    flags, causal = JAX_REFUSALS[name]
    want = _jax_error(flags, causal, trace="heads" in name)
    assert want is not None
    module = tgpt if causal else tbert
    args = module.build_parser().parse_args(SMALL + RING + flags)
    with pytest.raises(ValueError) as err:
        tbert.build_model(args, "cpu", causal=causal)
    assert str(err.value) == want


@pytest.mark.parametrize("flags", [
    ["--moe-experts", "4"], ["--moe-experts", "4", "--tensor-parallel", "2"],
    ["--moe-experts", "4", "--fsdp", "2"],
    ["--moe-experts", "4", "--expert-parallel", "2"]])
def test_unported_strategies_with_sp_raise_not_yet_ported(flags):
    """MoE with SP (its capacity and slots are each whole sequence's:
    ``parallel.seq_route``), alone or beside TP or FSDP, and EP, which the
    JAX package composes with the ring, are ported now
    (``tests/test_torch_ep.py`` runs them): the flags pass, and one
    process cannot hold the sequence axis (the mesh's own error)."""
    assert _jax_error(flags, True) is None
    args = tgpt.build_parser().parse_args(SMALL + RING + flags)
    tbert.validate_parallel_flags(args, causal=True)
    with pytest.raises(ValueError, match="not divisible by fixed axes"):
        tgpt.build_model(args, "cpu")


def test_sp_needs_ranks_to_split_over():
    """One process cannot hold a sequence axis of 2: the mesh's own
    error, before the trainer runs."""
    args = tgpt.build_parser().parse_args(
        _port(SMALL + RING, "unused"))
    with pytest.raises(ValueError, match="not divisible by fixed axes"):
        tgpt.run(args)
