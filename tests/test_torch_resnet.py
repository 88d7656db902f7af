"""The port's ResNet (``tpujob_torch.workloads.resnet``) against the JAX
package's, on the CPU, with the params and the BatchNorm statistics
carried across by ``convert.params_from_flax``.

ResNet-50 (depth 50) at width 8, 32x32 images, a batch of 4, fp32, against
JAX's ``build_loss`` and ``make_train_step``.  Tolerances, from the
observed agreement with margin:
- logits 5e-5 absolute (logits near 1; observed 1.4e-5), the loss 1e-5
  relative (observed 7e-7);
- every gradient, and every param after one SGD step, normwise
  ``||got - want|| <= 5e-4 ||want||`` (observed <= 6.0e-5: 53 fp32
  convolutions and BatchNorms over 4 samples, computed by two libraries);
- the running mean and var after a step: rtol 1e-4, atol 1e-5 (observed
  5.2e-6 absolute);
- a 1 + 3 step ``run`` from the same weights at lr 0.01: losses 1e-3
  relative (observed 1.2e-4 at the last step; BatchNorm over 4 samples
  grows the difference about 5x a step);
- single layers (the padding trap, BatchNorm, the max-pool): 1e-5.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax.sharding import Mesh

from tpujob.workloads import data as jdata
from tpujob.workloads import resnet as jresnet
from tpujob.workloads import train_lib as jtl
from tpujob_torch.workloads import convert, resnet, train_lib

ARGV = ["--width", "8", "--image-size", "32", "--batch-size", "4"]
NORM_TOL = 5e-4


def _mesh():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


@functools.lru_cache(maxsize=None)
def _init():
    """flax's init of the width-8 ResNet-50, compiled once: the params and
    statistics do not depend on the compute dtype."""
    model = jresnet.make_model(jresnet.build_parser().parse_args(ARGV))
    return jax.jit(lambda rng: model.init(rng, jnp.zeros((1, 32, 32, 3)),
                                          train=False))


def _variables(argv, seed=0):
    model = jresnet.make_model(jresnet.build_parser().parse_args(argv))
    return model, _init()(jax.random.PRNGKey(seed))


def _torch_model(argv, variables):
    model = resnet.make_model(resnet.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    model.load_state_dict(convert.params_from_flax(
        jax.tree.map(np.asarray, dict(variables))), strict=True)
    return model.train()


def _batch():
    return jdata.synthetic_imagenet_batch(4, 32, seed=7)


def _torch_batch(x, y):
    return torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))


def _normwise(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope="module")
def fp32_step():
    """One train-mode forward and backward on both sides, fp32."""
    argv = ARGV + ["--no-bf16"]
    jm, variables = _variables(argv, seed=3)
    x, y = _batch()
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        jresnet.build_loss(jm), has_aux=True))(
        variables["params"], variables["batch_stats"],
        (jnp.asarray(x), jnp.asarray(y)))
    jlogits, _ = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    model = _torch_model(argv, variables)
    logits = model(torch.from_numpy(x))
    model.load_state_dict(convert.params_from_flax(
        jax.tree.map(np.asarray, dict(variables))))  # undo the stats update
    loss = resnet.build_loss(model)(_torch_batch(x, y))
    loss.backward()
    return dict(jloss=float(jloss), jlogits=np.asarray(jlogits),
                jgrads=convert.params_from_flax(
                    jax.tree.map(np.asarray, jgrads)),
                jstats=convert.params_from_flax(
                    {"params": {}, "batch_stats": jax.tree.map(
                        np.asarray, jstats)}),
                loss=loss.item(), logits=logits.detach().numpy(),
                model=model)


def test_train_mode_logits_and_loss_match_jax(fp32_step):
    s = fp32_step
    assert s["logits"].shape == (4, 1000) and s["logits"].dtype == np.float32
    np.testing.assert_allclose(s["logits"], s["jlogits"], rtol=1e-5,
                               atol=5e-5)
    np.testing.assert_allclose(s["loss"], s["jloss"], rtol=1e-5)


def test_every_gradient_matches_jax(fp32_step):
    model, want = fp32_step["model"], fp32_step["jgrads"]
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want) and len(names) == 161
    for name, p in model.named_parameters():
        err = _normwise(p.grad.numpy(), want[name].numpy())
        assert err <= NORM_TOL, (name, err)


def test_running_stats_after_a_step_match_jax(fp32_step):
    """flax's update: momentum 0.9 on the old value and the BIASED batch
    variance (torch's own BatchNorm would fold in the unbiased one, n/(n-1)
    larger: 4/3 at the last stage's 1x1 maps)."""
    model, want = fp32_step["model"], fp32_step["jstats"]
    buffers = dict(model.named_buffers())
    assert sorted(buffers) == sorted(want) and len(buffers) == 2 * 53
    for name, b in buffers.items():
        np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_one_sgd_step_matches_jax_train_step():
    """JAX's ``make_train_step`` (has_extra: the batch statistics threaded
    through) against the port's ``make_train_step`` with ``sgd``: params
    and running statistics after one update."""
    argv = ARGV + ["--no-bf16"]
    jm, variables = _variables(argv, seed=1)
    opt = jtl.sgd(0.1, 0.9)
    mesh = _mesh()
    state = jtl.init_state(variables["params"], opt, mesh,
                           extra=variables["batch_stats"])
    step = jtl.make_train_step(jresnet.build_loss(jm), opt, mesh,
                               has_extra=True, donate=False)
    x, y = _batch()
    jstate, jloss = step(state, jtl.put_batch((x, y), mesh))
    want = convert.params_from_flax(jax.tree.map(np.asarray, {
        "params": jstate["params"], "batch_stats": jstate["extra"]}))

    model = _torch_model(argv, variables)
    topt = train_lib.sgd(model.parameters(), 0.1, 0.9)
    tstep = train_lib.make_train_step(resnet.build_loss(model), topt,
                                      lambda count: 0.1)
    tstate, loss = tstep({"model": model, "opt": topt, "step": 0},
                         _torch_batch(x, y))
    assert tstate["step"] == 1
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for name, t in model.state_dict().items():
        got, ref = t.numpy(), want[name].numpy()
        if "running" in name:
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        else:
            assert _normwise(got, ref) <= NORM_TOL, name


@pytest.mark.parametrize("size,kernel,stride,pads", [
    (8, 3, 2, (0, 1)), (7, 3, 2, (1, 1)), (8, 3, 1, (1, 1)),
    (8, 1, 2, (0, 0)), (224, 7, 2, (2, 3)), (56, 3, 2, (0, 1))])
def test_same_padding_values(size, kernel, stride, pads):
    assert resnet.same_padding(size, kernel, stride) == pads


@pytest.mark.parametrize("size", [8, 7])
def test_stride2_same_padding_trap(size):
    """A flax 'SAME' 3x3 conv at stride 2 pads 0 before and 1 after on an
    even size; the port's ``Conv`` does the same, where torch's
    ``padding=1`` (1 on both sides) shifts the whole output on an even
    size."""
    rng = np.random.RandomState(size)
    x = rng.randn(2, size, size, 5).astype(np.float32)
    conv = fnn.Conv(6, (3, 3), strides=(2, 2), use_bias=False)
    params = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(params, jnp.asarray(x)))  # NHWC
    port = resnet.Conv(5, 6, 3, 2, torch.float32, torch.Generator())
    port.load_state_dict(convert.params_from_flax(
        jax.tree.map(np.asarray, params)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = port(xt).permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape == (2, (size + 1) // 2, (size + 1) // 2, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    symmetric = torch.nn.functional.conv2d(xt, port.weight, stride=2,
                                           padding=1)
    symmetric = symmetric.permute(0, 2, 3, 1).detach().numpy()
    assert np.allclose(symmetric, want, atol=1e-4) == (size % 2 == 1)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_batchnorm_matches_flax_over_two_steps_and_in_eval(dtype):
    """Two train-mode calls (output and running statistics each time),
    then the eval-mode output on the running averages; under bf16 the
    output is bf16 and the statistics fp32."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.RandomState(0)
    xs = [(3.0 * rng.randn(4, 5, 5, 6) + 1.5).astype(np.float32)
          for _ in range(2)]
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jdt)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    port = resnet.BatchNorm(6, tdt)
    port.weight.data.uniform_(0.5, 1.5, generator=torch.Generator())
    variables = {"params": {"scale": port.weight.detach().numpy(),
                            "bias": np.full(6, 0.25, np.float32)},
                 "batch_stats": variables["batch_stats"]}
    port.bias.data.fill_(0.25)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "fp32" else \
        dict(rtol=1e-2, atol=1e-2)  # one bf16 rounding of the output
    for x in xs:
        want, mutated = bn.apply(variables, jnp.asarray(x),
                                 mutable=["batch_stats"])
        variables = {"params": variables["params"], **mutated}
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert got.dtype == tdt and port.running_var.dtype == torch.float32
        np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).detach(),
                                   np.asarray(want, np.float32), **tol)
        stats = variables["batch_stats"]
        np.testing.assert_allclose(port.running_mean, stats["mean"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(port.running_var, stats["var"],
                                   rtol=1e-5, atol=1e-6)
    want = fnn.BatchNorm(use_running_average=True, momentum=0.9,
                         epsilon=1e-5, dtype=jdt).apply(
        variables, jnp.asarray(xs[1]))
    port.eval()
    got = port(torch.from_numpy(xs[1]).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).detach(),
                               np.asarray(want, np.float32), **tol)


def test_max_pool_pads_with_minus_infinity():
    """All-negative input: a pool padded with 0 would put 0 on the border;
    flax's and the port's pad with -inf."""
    x = -1.0 - np.random.RandomState(1).rand(2, 8, 8, 3).astype(np.float32)
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                   padding=((1, 1), (1, 1))))
    got = torch.nn.functional.max_pool2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, padding=1)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6)
    assert (want < 0).all()


def test_structure_matches_flax():
    """Names, shapes and the init that parity hangs on: each bottleneck's
    last BatchNorm scale is 0, the head is fp32 even under bf16."""
    _, variables = _variables(ARGV)
    model = resnet.make_model(resnet.build_parser().parse_args(
        ARGV + ["--device", "cpu"]))
    sd = convert.params_from_flax(jax.tree.map(np.asarray, dict(variables)))
    own = model.state_dict()
    assert sorted(own) == sorted(sd)
    for k in own:
        assert own[k].shape == sd[k].shape, k
    assert model.blocks == 16
    for i in range(16):
        blk = getattr(model, f"Bottleneck_{i}")
        assert not blk.BatchNorm_2.weight.any()
        assert blk.project == (i in (0, 3, 7, 13))
    logits = model(torch.zeros(2, 32, 32, 3))
    assert logits.dtype == torch.float32 and model.conv_init.dtype == \
        torch.bfloat16
    with torch.no_grad():
        y = model.conv_init(torch.zeros(1, 3, 32, 32))
    assert y.dtype == torch.bfloat16
    assert all(b.dtype == torch.float32 for b in model.buffers())


def test_bf16_loss_near_jax():
    """Under --bf16 (bf16 activations, fp32 statistics and head) the loss
    of one train-mode forward is within 5e-3 of the JAX package's
    (observed 6e-4: bf16 activations through 53 layers)."""
    jm, variables = _variables(ARGV, seed=2)
    x, y = _batch()
    jloss, _ = jax.jit(jresnet.build_loss(jm))(
        variables["params"], variables["batch_stats"],
        (jnp.asarray(x), jnp.asarray(y)))
    model = _torch_model(ARGV, variables)
    loss = resnet.build_loss(model)(_torch_batch(x, y))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=5e-3)


def test_run_matches_jax_from_the_same_weights(tmp_path, monkeypatch):
    """``resnet.run`` (1 warm-up step, 3 timed) against the JAX package's
    ``run`` on a one-device mesh from the same weights: the logged losses
    of the timed steps."""
    argv = ARGV + ["--no-bf16", "--warmup-steps", "1", "--steps", "3",
                   "--log-interval", "1", "--lr", "0.01"]
    jargs = jresnet.build_parser().parse_args(argv + ["--dir",
                                                      str(tmp_path / "j")])
    jres = jresnet.run(jargs, _mesh())
    jlosses = [json.loads(x)["value"] for x in
               (tmp_path / "j" / "scalars.jsonl").read_text().splitlines()]
    _, variables = _variables(argv)
    make = resnet.make_model

    def carried(args):
        model = make(args)
        model.load_state_dict(convert.params_from_flax(
            jax.tree.map(np.asarray, dict(variables))))
        return model

    monkeypatch.setattr(resnet, "make_model", carried)
    res = resnet.run(resnet.build_parser().parse_args(
        argv + ["--device", "cpu", "--dir", str(tmp_path / "t")]))
    assert len(res["losses"]) == 4 and len(jlosses) == 3
    np.testing.assert_allclose(res["losses"][1:], jlosses, rtol=1e-3)
    np.testing.assert_allclose(res["final_loss"], jres["final_loss"],
                               rtol=1e-3)
    assert res["samples_per_sec"] > 0 and res["state"]["step"] == 4


def test_convert_rejects_unknown_shapes():
    with pytest.raises(ValueError, match="2-D Dense or 4-D Conv"):
        convert.params_from_flax({"a": {"kernel": np.zeros((2, 2, 2))}})
    with pytest.raises(ValueError, match="mean or var"):
        convert.params_from_flax({"params": {},
                                  "batch_stats": {"bn": {"count": 1.0}}})
