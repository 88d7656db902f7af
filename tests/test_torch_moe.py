"""The port's sparse MoE (``--moe-experts``) on one device against
the JAX package's, on the CPU, from the same numpy inputs and weights
(``convert.params_from_flax`` carries flax's ``moe/{router,wi,wo}`` as
they are).

Inputs come from ``np.random.RandomState`` seeds with continuous values,
so no two router probabilities tie: ``torch.topk`` and ``jax.lax.top_k``
break ties differently, and the routing decisions are compared exactly.

Tolerances (fp32 throughout; in bf16 the two frameworks round the
router's input differently and a near tie may route otherwise):
- ``moe_ffn`` outputs 1e-5 relative (max-abs error over max-abs value),
  gradients with respect to x, router, wi and wo 1e-4 on the same
  measure, both metrics 1e-6 relative; the chosen experts and each
  assignment's slot and keep flag equal as integers;
- the MoE layer, block and whole model: 1e-5 relative;
- ``lm_loss`` / ``mlm_loss`` with their aux terms: loss 1e-6 relative,
  grads 1e-4 (max-abs over max-abs, per parameter);
- 3-step ``gpt.run`` / ``bert.run`` loss trajectories 1e-4 relative;
- decode: greedy tokens equal, and the realized positions' logits under
  the mask equal to 1e-5 whatever the suffix holds.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpujob.workloads import bert as jbert
from tpujob.workloads import gpt as jgpt
from tpujob.workloads import parallel as jpar
from tpujob_torch.workloads import bert as tbert
from tpujob_torch.workloads import convert
from tpujob_torch.workloads import distributed as tdist
from tpujob_torch.workloads import gpt as tgpt
from tpujob_torch.workloads import parallel as tpar
from tpujob_torch.workloads import train_lib

SMALL = ["--hidden", "32", "--layers", "2", "--heads", "2",
         "--intermediate", "64", "--vocab", "97", "--batch-size", "2",
         "--no-bf16", "--moe-experts", "4"]
OUT_TOL, GRAD_TOL, METRIC_TOL = 1e-5, 1e-4, 1e-6


def _mesh():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _weights(d=16, f=24, e=4, b=2, s=24, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, d).astype(np.float32),
            (rng.randn(d, e) * 0.5).astype(np.float32),
            (rng.randn(e, d, f) * 0.3).astype(np.float32),
            (rng.randn(e, f, d) * 0.3).astype(np.float32))


@pytest.mark.parametrize("tokens,experts,k,cf", [
    (1, 1, 1, 1.0), (16, 4, 1, 0.25), (24, 4, 2, 0.5), (1024, 8, 2, 1.25),
    (512, 8, 2, 1.25), (64, 8, 2, 0.5), (7, 3, 2, 2.0), (100, 16, 1, 1.0),
    (5, 8, 1, 0.01)])
def test_moe_capacity_matches_jax(tokens, experts, k, cf):
    assert tpar.moe_capacity(tokens, experts, k, cf) == \
        jpar.moe_capacity(tokens, experts, k, cf)


def _jax_routing(monkeypatch, x, router, wi, wo, k, cf, valid):
    """The reference's ``moe_ffn`` run eagerly, its two one-hots recorded:
    the chosen experts and each assignment's slot (k-major order)."""
    seen = []
    one_hot = jax.nn.one_hot

    def recording(idx, n, **kw):
        seen.append(np.asarray(idx))
        return one_hot(idx, n, **kw)

    with monkeypatch.context() as m:
        m.setattr(jax.nn, "one_hot", recording)
        jpar.moe_ffn(jnp.asarray(x), jnp.asarray(router), jnp.asarray(wi),
                     jnp.asarray(wo), k=k, capacity_factor=cf,
                     valid=None if valid is None else jnp.asarray(valid))
    expert_idx, pos = seen
    return expert_idx, pos


@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_ffn_matches_jax(k, masked, monkeypatch):
    """At capacity factor 0.5 (assignments dropped): the same experts and
    slots, outputs, metrics, and the gradients of y . g + lb + z with
    respect to every input.  (At k = 1 the renormalised gate is g / g = 1,
    whose gradient is rounding noise, about 3e-7 here: the aux terms carry
    the router's gradient, at coefficient 1 so that it stands above it.)"""
    x, router, wi, wo = _weights()
    b, s = x.shape[:2]
    cf = 0.5
    valid = (np.arange(s)[None] < np.array([[s], [s - 9]])).astype(
        np.float32) if masked else None
    g = np.random.RandomState(7).randn(*x.shape).astype(np.float32)

    def jloss(x, router, wi, wo):
        y, m = jpar.moe_ffn(x, router, wi, wo, k=k, capacity_factor=cf,
                            valid=None if valid is None else jnp.asarray(valid))
        return (y * g).sum() + m["load_balance"] + m["router_z"], (y, m)

    jargs = tuple(jnp.asarray(a) for a in (x, router, wi, wo))
    (_, (jy, jm)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(*jargs)

    targs = [torch.from_numpy(a).requires_grad_() for a in (x, router, wi, wo)]
    ty, tm = tpar.moe_ffn(*targs, k=k, capacity_factor=cf,
                          valid=None if valid is None else torch.from_numpy(valid))
    ((ty * torch.from_numpy(g)).sum() + tm["load_balance"]
     + tm["router_z"]).backward()

    assert _rel(ty.detach(), jy) <= OUT_TOL
    for name in ("load_balance", "router_z"):
        np.testing.assert_allclose(tm[name].item(), float(jm[name]),
                                   rtol=METRIC_TOL, err_msg=name)
    for name, t, j in zip(("x", "router", "wi", "wo"), targs, jgrads):
        assert _rel(t.grad, j) <= GRAD_TOL, name

    cap = tpar.moe_capacity(s, wi.shape[0], k, cf)
    j_idx, j_pos = _jax_routing(monkeypatch, x, router, wi, wo, k, cf, valid)
    r = tpar.moe_route(*(torch.from_numpy(a) for a in (x, router)), k, cap,
                       None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(r.expert_idx.numpy(), j_idx)
    np.testing.assert_array_equal(r.pos.long().numpy(), j_pos)
    np.testing.assert_array_equal(r.keep.numpy(),
                                  (j_pos < cap).astype(np.float32))
    routed = r.oh_prio.sum(-1)
    assert 0 < tm["dropped"].item() == (routed * (1 - r.keep)).sum().item()
    if masked:  # unrouted positions hold no slot and output 0
        assert routed.reshape(b, k, s)[1, :, s - 9:].sum() == 0
        assert ty.detach()[1, s - 9:].abs().max() == 0


@pytest.mark.parametrize("k", [0, 5])
def test_top_k_outside_the_experts_raises(k):
    x, router, wi, wo = (torch.from_numpy(a) for a in _weights())
    with pytest.raises(ValueError, match="top-k"):
        tpar.moe_ffn(x, router, wi, wo, k=k)


def test_balanced_router_load_balance_is_one():
    """Uniform routing probabilities give the Switch aux loss exactly 1."""
    x, router, wi, wo = (torch.from_numpy(a) for a in _weights())
    _, m = tpar.moe_ffn(x, torch.zeros_like(router), wi, wo, k=2)
    np.testing.assert_allclose(m["load_balance"].item(), 1.0, rtol=1e-6)


def _jax_model(module, argv, seq):
    ja = module.build_parser().parse_args(argv)
    jm = module.build_model(ja, _mesh())
    params = {"params": jm.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, seq), jnp.int32))["params"]}
    return jm, params


def _load(model, params):
    model.load_state_dict(convert.params_from_flax(
        jax.tree.map(np.asarray, params)), strict=True)
    return model


def _port_model(module, argv, params):
    args = module.build_parser().parse_args(argv + ["--device", "cpu"])
    return _load(module.build_model(args, torch.device("cpu")), params)


def _sown(sown, name):
    return [float(v) for p, v in
            jax.tree_util.tree_flatten_with_path(sown)[0]
            if any(getattr(q, "key", None) == name for q in p)]


def test_moe_layer_block_and_model_match_jax():
    """A flax MoE tree loads with ``strict=True`` (router [d, E], wi
    [E, d, f], wo [E, f, d] as flax keeps them); the layer, the block and
    the whole GPT agree with the JAX package's, and so do every layer's
    sown metrics."""
    argv = SMALL + ["--seq-len", "32"]
    jm, params = _jax_model(jgpt, argv, 32)
    model = _port_model(tgpt, argv, params)
    lp = params["params"]["layer_0"]
    assert model.layer_0.moe.wi.shape == lp["moe"]["wi"].shape == (4, 32, 64)
    assert not hasattr(model.layer_0, "mlp_wi")
    rng = np.random.RandomState(3)
    x = rng.randn(2, 32, 32).astype(np.float32)
    cfg = jbert.MoEConfig(experts=4)

    jy = jax.jit(jbert.MoEMlp(32, 64, cfg).apply)({"params": lp["moe"]},
                                                  jnp.asarray(x))
    ty, _ = model.layer_0.moe(torch.from_numpy(x))
    assert _rel(ty.detach(), jy) <= OUT_TOL

    jblk = jbert.Block(32, 2, 64, attention_fn=jm.attention_fn, moe=cfg)
    jy, sown = jax.jit(functools.partial(jblk.apply, mutable=["moe_metrics"]))(
        {"params": lp}, jnp.asarray(x))
    (ty, tm) = model.layer_0(torch.from_numpy(x))
    assert _rel(ty.detach(), jy) <= OUT_TOL
    np.testing.assert_allclose(tm["load_balance"].item(),
                               _sown(sown, "load_balance")[0], rtol=METRIC_TOL)

    ids = rng.randint(0, 97, (2, 32))
    jlogits, sown = jax.jit(functools.partial(
        jm.apply, mutable=["moe_metrics"]))(params, jnp.asarray(ids))
    with torch.no_grad():
        logits, metrics = model(torch.from_numpy(ids), with_metrics=True)
    assert _rel(logits, jlogits) <= OUT_TOL
    for name in ("load_balance", "router_z"):
        np.testing.assert_allclose([m[name].item() for m in metrics],
                                   _sown(sown, name), rtol=METRIC_TOL)


@pytest.mark.parametrize("family", ["gpt", "mlm"])
def test_losses_with_aux_terms_match_jax(family):
    """``lm_loss`` / ``mlm_loss`` on a MoE model add 0.01 x the mean load
    balance and 1e-3 x the mean z-loss over the layers: loss and every
    parameter's gradient against ``jax.value_and_grad`` of the JAX loss."""
    module, tmod = (jgpt, tgpt) if family == "gpt" else (jbert, tbert)
    argv = SMALL + ["--seq-len", "32"]
    jm, params = _jax_model(module, argv, 32)
    model = _port_model(tmod, argv, params)
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 97, (2, 32)).astype(np.int32)
    if family == "gpt":
        jfn, tfn = jgpt.lm_loss(jm), tgpt.lm_loss(model)
        jbatch, tbatch = (jnp.asarray(ids),), (torch.from_numpy(ids).long(),)
    else:
        _, mask = tbert.mask_batch(ids, 0)
        jfn, tfn = jbert.mlm_loss(jm), tbert.mlm_loss(model)
        jbatch = (jnp.asarray(ids), jnp.asarray(mask))
        tbatch = (torch.from_numpy(ids).long(), torch.from_numpy(mask))
    jloss, jgrads = jax.jit(jax.value_and_grad(jfn))(params, jbatch)
    jgrads = convert.params_from_flax(jax.tree.map(np.asarray, jgrads))
    loss = tfn(tbatch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    # the aux terms are in: the plain loss differs by more than the tolerance
    lb, z, dropped = train_lib.loss_extras(tfn).tolist()
    assert 0.01 * lb > 1e-3 * abs(float(jloss)) and z > 0 and dropped >= 0
    for name, p in model.named_parameters():
        if name.endswith("attn.key.bias"):
            continue  # exact gradient 0: both hold rounding noise
        assert _rel(p.grad, jgrads[name]) <= GRAD_TOL, name


def _logged_losses(logdir):
    rows = [json.loads(x) for x in
            (logdir / "scalars.jsonl").read_text().splitlines()]
    return [r["value"] for r in rows if r["tag"] == "loss"]


@pytest.mark.parametrize("family", ["gpt", "mlm"])
def test_three_step_runs_match_jax(family, tmp_path, monkeypatch):
    """``gpt.run`` / ``bert.run`` with ``--moe-experts 4`` (flash attention
    on the GPT: Pallas in interpret mode, the plain versions on the port's
    side) from the JAX run's initial weights: the three losses, and each
    step's reported aux terms finite."""
    module, tmod = (jgpt, tgpt) if family == "gpt" else (jbert, tbert)
    argv = SMALL + ["--seq-len", "64", "--steps", "3", "--lr", "3e-3",
                    "--lr-schedule", "cosine", "--log-interval", "1"]
    if family == "gpt":
        argv += ["--attention", "flash"]
    module.run(module.build_parser().parse_args(
        argv + ["--dir", str(tmp_path / "j")]), _mesh())
    jlosses = _logged_losses(tmp_path / "j")
    _, params = _jax_model(module, argv, 64)
    build = tbert.build_model
    monkeypatch.setattr(tbert, "build_model",
                        lambda *a, **kw: _load(build(*a, **kw), params))
    res = tmod.run(tmod.build_parser().parse_args(
        argv + ["--device", "cpu", "--dir", str(tmp_path / "t")]))
    assert len(jlosses) == 3
    np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-4)
    assert len(res["moe_metrics"]) == 3
    for m in res["moe_metrics"]:
        assert sorted(m) == sorted(tbert.MOE_METRICS)
        assert all(np.isfinite(v) for v in m.values())
        assert 0.0 < m["load_balance"] <= 4.0  # E at worst


def test_train_reports_each_steps_aux_terms(tmp_path):
    """With ``--grad-accum 2`` each mini-step's reported terms are its own
    forward's: those of the loss function on the same weights and batch."""
    args = tbert.build_parser().parse_args(
        SMALL + ["--seq-len", "32", "--steps", "2", "--grad-accum", "2",
                 "--lr", "0", "--device", "cpu", "--dir", str(tmp_path)])
    model = tbert.build_model(args, torch.device("cpu"))
    ids = np.random.RandomState(5).randint(0, 97, (2, 32)).astype(np.int32)
    batch = train_lib.put_batch(tbert.mask_batch(ids, 1), "cpu")
    want = tbert.mlm_loss(model)
    with torch.no_grad():
        want(batch)
    res = tbert.train(args, tdist.process_env({}), model,
                      tbert.mlm_loss, batch)
    for m in res["moe_metrics"]:
        np.testing.assert_allclose([m[k] for k in tbert.MOE_METRICS],
                                   train_lib.loss_extras(want).tolist(),
                                   rtol=1e-6)


def _gpt_pair(cf, seq=32):
    argv = SMALL + ["--seq-len", str(seq), "--moe-capacity-factor", str(cf)]
    jm, params = _jax_model(jgpt, argv, seq)
    return jm, params, _port_model(tgpt, argv, params)


def test_masked_decode_is_causal_and_unmasked_is_not():
    """At a tight capacity (factor 0.5) the realized positions' logits do
    not change when the suffix buffer does, with the validity mask; they
    do without it (the JAX package's ``test_moe_generate_is_causal``)."""
    _, _, model = _gpt_pair(0.5)
    rng = np.random.RandomState(1)
    prompt = torch.from_numpy(rng.randint(0, 97, (2, 6)))
    total, p = 12, 6
    valid = (torch.arange(total)[None] < p).float().expand(2, total)
    bufs = [torch.cat([prompt, pad], 1) for pad in (
        torch.zeros(2, total - p, dtype=torch.long),
        torch.from_numpy(rng.randint(0, 97, (2, total - p))))]
    with torch.no_grad():
        masked = [model(b, valid=valid)[:, :p] for b in bufs]
        raw = [model(b)[:, :p] for b in bufs]
    torch.testing.assert_close(masked[0], masked[1], rtol=1e-5, atol=1e-5)
    assert (raw[0] - raw[1]).abs().max() > 1e-4, \
        "perturbation has no teeth: unmasked forward already invariant"


def test_decode_matches_jax_and_the_prefix_reforward():
    """At a capacity that never overflows (factor E/k): ``generate`` equals
    the JAX package's ``generate`` and a token-by-token re-forward of the
    realized prefix alone, and ``generate_cached`` falls back to it."""
    jm, params, model = _gpt_pair(2.0)
    prompt = np.random.RandomState(2).randint(0, 97, (2, 6)).astype(np.int32)
    jgen = np.asarray(jgpt.generate(jm, params, jnp.asarray(prompt), 4))
    tprompt = torch.from_numpy(prompt).long()
    gen = tgpt.generate(model, tprompt, 4)
    np.testing.assert_array_equal(gen.numpy(), jgen)
    toks = tprompt
    with torch.no_grad():
        for _ in range(4):
            nxt = model(toks)[:, -1].argmax(-1)
            toks = torch.cat([toks, nxt[:, None]], 1)
    torch.testing.assert_close(gen, toks, rtol=0, atol=0)
    torch.testing.assert_close(tgpt.generate_cached(model, tprompt, 4), gen,
                               rtol=0, atol=0)


def test_moe_config_from_has_the_reference_rules():
    p = tbert.build_parser()

    def parse(*flags):
        return p.parse_args(list(flags))

    assert tbert.moe_config_from(parse()) is None
    assert tbert.moe_config_from(parse("--moe-experts", "8")) == \
        tbert.MoEConfig(experts=8, k=2, capacity_factor=1.25)
    assert tbert.moe_config_from(parse(
        "--moe-experts", "8", "--moe-k", "1", "--moe-capacity-factor",
        "2")) == tbert.MoEConfig(experts=8, k=1, capacity_factor=2.0)
    with pytest.raises(ValueError, match="needs --moe-experts"):
        tbert.moe_config_from(parse("--expert-parallel", "2"))
    with pytest.raises(ValueError, match="--moe-k must be >= 1"):
        tbert.moe_config_from(parse("--moe-experts", "4", "--moe-k", "0"))
    with pytest.raises(ValueError, match="divide evenly"):
        tbert.moe_config_from(parse("--moe-experts", "3",
                                    "--expert-parallel", "2"))


REFUSALS = [
    (["--moe-k", "0"], ValueError, "--moe-k must be >= 1"),
    (["--expert-parallel", "2"], ValueError, "not divisible by fixed axes"),
    (["--pipeline-parallel", "2"], ValueError,
     "does not compose with --moe-experts"),
    (["--moe-experts", "0", "--expert-parallel", "2"], ValueError,
     "needs --moe-experts"),
    (["--moe-experts", "3", "--expert-parallel", "2"], ValueError,
     "divide evenly"),
]


@pytest.mark.parametrize("flags,error,match", REFUSALS)
def test_entry_points_refuse_what_one_device_cannot_run(flags, error, match):
    """``--moe-experts`` builds on one device; expert parallelism over 2
    ranks cannot run on one (the mesh's own error: EP itself is ported,
    ``tests/test_torch_ep.py``), the pipeline with MoE raises the JAX
    package's ValueError; the MoE flags' own errors are the JAX package's
    ValueErrors too."""
    args = tgpt.build_parser().parse_args(SMALL + ["--device", "cpu"] + flags)
    with pytest.raises(error, match=match):
        tgpt.build_model(args, torch.device("cpu"))


@pytest.mark.parametrize("flags,error,match", REFUSALS)
def test_train_refuses_as_build_model_does(flags, error, match):
    """``train`` checks the flags, and makes the mesh they name when given
    none, before it touches the model or batch."""
    args = tgpt.build_parser().parse_args(SMALL + ["--device", "cpu"] + flags)
    with pytest.raises(error, match=match):
        tbert.train(args, tdist.process_env({}), None, tgpt.lm_loss, None)


def test_init_matches_flax_initializers():
    """The port's seeded init draws what flax's initializers draw: router
    normal(0.02); wi and wo lecun_normal with the expert axis in the fan-in
    (std sqrt(1 / (d E)) and sqrt(1 / (f E))), truncated at 2 std."""
    d, f, e = 64, 128, 8
    mlp = tbert.MoEMlp(d, f, tbert.MoEConfig(experts=e), torch.float32,
                       torch.Generator().manual_seed(0))
    flax = jbert.MoEMlp(d, f, jbert.MoEConfig(experts=e)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, d)))["params"]
    for name, std in (("router", 0.02), ("wi", (d * e) ** -0.5),
                      ("wo", (f * e) ** -0.5)):
        w = getattr(mlp, name).detach().numpy()
        assert w.shape == flax[name].shape and w.dtype == np.float32
        ref = float(np.asarray(flax[name]).std())
        np.testing.assert_allclose(w.std(), std, rtol=0.03, err_msg=name)
        np.testing.assert_allclose(ref, std, rtol=0.03, err_msg=name)
        bound = np.abs(w).max() / std
        assert (bound <= 2 / 0.8796 + 1e-3) if name != "router" else bound > 3
