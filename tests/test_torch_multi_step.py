"""The port's compiled step and multi-step (``train_lib.make_train_step``,
``make_multi_step``, ``init_state``, ``step_mode``) against the JAX
package's, on the CPU, where every step is eager.

- ``make_multi_step`` on the MNIST ``Net`` with SGD (lr 0.01, momentum
  0.5), k = 4, one batch reused and a stacked ``[k]`` batch: the losses
  ``[k]`` at 1e-6 relative and the params at 1e-6 / 1e-7, the tolerances
  of the JAX package's own ``TestMultiStep`` (fp32; observed 1.2e-7 and a
  fifth of the bound);
- on the GPT trunk (width 64, 2 layers, fp32, flash attention: Pallas in
  interpret mode, the plain versions on the port's side) with AdamW and a
  cosine schedule over the k steps: losses and params 1e-5, as
  ``tests/test_torch_train_lib.py`` holds a whole AdamW run (the key bias
  skipped: its exact gradient is 0 and Adam normalises rounding noise);
- the port's multi-step against k of its own single steps: bit-equal;
- ``init_state``'s structure against JAX's; the k-mismatch error with
  JAX's message.

The captured step's own tests (the step-mode rule, and on the card the
graph against the eager step) are in ``tests/test_torch_graph.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from tpujob.workloads import data as jdata
from tpujob.workloads import gpt as jgpt
from tpujob.workloads import mnist as jmnist
from tpujob.workloads import train_lib as jtl
from tpujob_torch.workloads import bert as tbert
from tpujob_torch.workloads import convert
from tpujob_torch.workloads import gpt as tgpt
from tpujob_torch.workloads import mnist as tmnist
from tpujob_torch.workloads import train_lib

K = 4


def _mesh():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def _torch_state(variables):
    return convert.params_from_flax(jax.tree.map(np.asarray, variables))


def _mnist_setup():
    params = jmnist.Net().init(jax.random.PRNGKey(0),
                               jnp.zeros((1,) + jdata.IMAGE_SHAPE))
    x, y = jdata.synthetic_split(64, seed=0)
    x = (x - jdata.MEAN) / jdata.STD
    model = tmnist.Net()
    model.load_state_dict(_torch_state(params))
    opt = train_lib.sgd(model.parameters(), 0.01, 0.5)
    return params, x, y, model, opt


def _stack(x, y):
    return (np.stack([x + 0.01 * i for i in range(K)]),
            np.stack([y] * K).astype(np.int64))


@pytest.mark.parametrize("stacked", [False, True])
def test_mnist_multi_step_matches_jax(stacked):
    params, x, y, model, opt = _mnist_setup()
    jopt = jtl.sgd(0.01, 0.5)
    mesh = _mesh()
    multi = jtl.make_multi_step(jmnist.nll_loss, jopt, mesh, k=K,
                                donate=False, stacked=stacked)
    if stacked:
        xs, ys = _stack(x, y)
        jstate, jlosses = multi(jtl.init_state(params, jopt, mesh),
                                (jnp.asarray(xs), jnp.asarray(ys)))
        batch = (torch.from_numpy(xs), torch.from_numpy(ys))
    else:
        jstate, jlosses = multi(jtl.init_state(params, jopt, mesh),
                                jtl.put_batch((x, y), mesh))
        batch = train_lib.put_batch((x, y), "cpu")
    step = train_lib.make_multi_step(lambda b: tmnist.nll_loss(model, b),
                                     opt, K, stacked=stacked)
    assert step.mode == "eager"
    state, losses = step(train_lib.init_state(model, opt), batch)
    assert state["step"] == int(jstate["step"]) == K
    assert losses.shape == (K,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-6)
    want = _torch_state(jstate["params"])
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("stacked", [False, True])
def test_multi_step_is_k_single_steps_bit_for_bit(stacked):
    _, x, y, model, opt = _mnist_setup()
    _, _, _, model1, opt1 = _mnist_setup()
    batch = (_stack(x, y) if stacked
             else (x, y.astype(np.int64)))
    batch = tuple(torch.from_numpy(b) for b in batch)
    multi = train_lib.make_multi_step(
        lambda b: tmnist.nll_loss(model, b), opt, K, stacked=stacked)
    _, losses = multi(train_lib.init_state(model, opt), batch)
    single = train_lib.make_train_step(
        lambda b: tmnist.nll_loss(model1, b), opt1, lambda count: 0.01)
    state, seq = train_lib.init_state(model1, opt1), []
    for j in range(K):
        state, loss = single(state, tuple(t[j] for t in batch)
                             if stacked else batch)
        seq.append(loss)
    assert torch.equal(losses, torch.stack(seq)) and state["step"] == K
    for p, q in zip(model.parameters(), model1.parameters()):
        assert torch.equal(p, q)


def test_stacked_k_mismatch_raises_with_jax_message():
    params, x, y, model, opt = _mnist_setup()
    xs, ys = _stack(x, y)
    jopt = jtl.sgd(0.01, 0.5)
    mesh = _mesh()
    multi = jtl.make_multi_step(jmnist.nll_loss, jopt, mesh, k=K + 1,
                                donate=False, stacked=True)
    with pytest.raises(ValueError) as jerr:
        multi(jtl.init_state(params, jopt, mesh),
              (jnp.asarray(xs), jnp.asarray(ys)))
    step = train_lib.make_multi_step(lambda b: tmnist.nll_loss(model, b),
                                     opt, K + 1, stacked=True)
    with pytest.raises(ValueError) as err:
        step(train_lib.init_state(model, opt),
             (torch.from_numpy(xs), torch.from_numpy(ys)))
    assert str(err.value) == str(jerr.value)
    assert "stacked batch carries 4 microbatches" in str(err.value)
    for k in (0, -1):
        with pytest.raises(ValueError, match="multi-step k must be >= 1"):
            jtl.make_multi_step(jmnist.nll_loss, jopt, mesh, k=k)
        with pytest.raises(ValueError, match="multi-step k must be >= 1"):
            train_lib.make_multi_step(lambda b: b, opt, k)


GPT_ARGV = ["--hidden", "64", "--layers", "2", "--heads", "4",
            "--intermediate", "128", "--vocab", "211", "--seq-len", "32",
            "--batch-size", "2", "--no-bf16", "--attention", "flash",
            "--lr", "3e-3"]


def test_gpt_multi_step_adamw_cosine_matches_jax():
    """AdamW with a cosine decay over the k updates (the lr moves every
    step, as the ``[k]`` lr tensor carries it on the card)."""
    ja = jgpt.build_parser().parse_args(GPT_ARGV)
    mesh = _mesh()
    jm = jgpt.build_model(ja, mesh)
    params = {"params": jm.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 32), jnp.int32))["params"]}
    jopt = jtl.adamw(jtl.make_lr_schedule(3e-3, "cosine", 0, K))
    ids = jdata.synthetic_token_batch(2, 32, 211)
    multi = jtl.make_multi_step(jgpt.lm_loss(jm), jopt, mesh, k=K,
                                donate=False)
    jstate, jlosses = multi(jtl.init_state(params, jopt, mesh),
                            jtl.put_batch((ids,), mesh))

    args = tgpt.build_parser().parse_args(GPT_ARGV + ["--device", "cpu"])
    model = tgpt.build_model(args, "cpu")
    model.load_state_dict(_torch_state(params), strict=True)
    opt = train_lib.adamw(model.parameters(), 3e-3)
    step = train_lib.make_multi_step(
        tgpt.lm_loss(model), opt, K,
        lr_fn=train_lib.make_lr_schedule(3e-3, "cosine", 0, K))
    state, losses = step(train_lib.init_state(model, opt),
                         (tbert.batch_to_device(ids, "cpu"),))
    assert state["step"] == K
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-5)
    want = _torch_state(jstate["params"])
    for name, p in model.named_parameters():
        if name.endswith("attn.key.bias"):
            continue  # exact gradient 0: Adam normalises rounding noise
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_init_state_matches_jax_structure():
    """Both: step 0, the optimizer's state empty of updates until the
    first one (optax holds zero moments and count 0, torch creates them at
    the first step), ``extra`` carried."""
    params, x, y, model, opt = _mnist_setup()
    jopt = jtl.adamw(1e-3)
    jstate = jtl.init_state(params, jopt, _mesh(), extra={"stats": 1})
    topt = train_lib.adamw(model.parameters(), 1e-3)
    state = train_lib.init_state(model, topt, extra={"stats": 1})
    assert sorted(jstate) == ["extra", "opt", "params", "step"]
    assert sorted(state) == ["extra", "model", "opt", "step"]
    assert int(jstate["step"]) == state["step"] == 0
    assert jstate["extra"] == state["extra"] == {"stats": 1}
    adam = jstate["opt"][0]
    assert isinstance(adam, optax.ScaleByAdamState) and int(adam.count) == 0
    assert all(not np.asarray(m).any()
               for m in jax.tree.leaves((adam.mu, adam.nu)))
    assert state["opt"] is topt and state["model"] is model
    assert topt.state == {}
    assert "extra" not in train_lib.init_state(model, topt)
    step = train_lib.make_train_step(lambda b: tmnist.nll_loss(model, b),
                                     topt, lambda count: 1e-3)
    state, _ = step(state, train_lib.put_batch((x, y), "cpu"))
    assert state["step"] == 1 and state["extra"] == {"stats": 1}
    assert len(topt.state) == len(list(model.parameters()))
