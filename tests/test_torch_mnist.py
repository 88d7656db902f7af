"""The port's MNIST example (``tpujob_torch.workloads.mnist``), its data
(``data``) and its optimizer (``train_lib.sgd``) against the JAX
package's, on the CPU, with weights carried across by
``convert.params_from_flax`` (HWIO conv kernels as OIHW).

Tolerances:
- the datasets and batches: array-equal (one numpy recipe);
- ``Net`` logits, loss and every gradient (fp32): 1e-5 relative, 1e-6
  absolute (the flatten before ``fc1`` in NHWC order is what this pins:
  NCHW order would put every fc1 gradient in the wrong place);
- SGD with momentum: params after 2 updates 1e-6 (the same two fp32
  multiply-adds);
- a whole 4-step ``run`` from the same weights: the logged losses and the
  final params 1e-5 relative, the accuracy equal;
- learning: above 0.9 on the synthetic set (the JAX package's bar) and
  above 0.8 on the UCI digits.
"""
import gzip
import json
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpujob.workloads import data as jdata
from tpujob.workloads import distributed as jdist
from tpujob.workloads import mnist as jmnist
from tpujob.workloads import train_lib as jtl
from tpujob_torch.workloads import convert, data, distributed
from tpujob_torch.workloads import mnist as tmnist
from tpujob_torch.workloads import train_lib


def _jax_params(seed=0):
    return jmnist.Net().init(jax.random.PRNGKey(seed),
                             jnp.zeros((1,) + jdata.IMAGE_SHAPE))


def _torch_net(params):
    net = tmnist.Net()
    net.load_state_dict(convert.params_from_flax(
        jax.tree.map(np.asarray, params)), strict=True)
    return net


def _batch(n=16, seed=0):
    x, y = data.synthetic_split(n, seed=seed)
    return (x - data.MEAN) / data.STD, y


def test_net_shapes_match_flax():
    net = tmnist.Net()
    assert net.conv1.weight.shape == (20, 1, 5, 5)
    assert net.conv2.weight.shape == (50, 20, 5, 5)
    assert net.fc1.weight.shape == (500, 4 * 4 * 50)
    assert net.fc2.weight.shape == (10, 500)
    names = sorted(convert.params_from_flax(
        jax.tree.map(np.asarray, _jax_params())))
    assert names == sorted(n for n, _ in net.named_parameters())


def test_init_is_lecun_normal_and_zero_bias():
    """flax's lecun-normal: a truncated normal of variance 1/fan_in."""
    net = tmnist.Net(seed=3)
    for m, fan_in in ((net.conv1, 25), (net.conv2, 500), (net.fc1, 800),
                      (net.fc2, 500)):
        w = m.weight.detach()
        assert torch.equal(m.bias.detach(), torch.zeros_like(m.bias))
        assert w.abs().max() <= 2 * fan_in ** -0.5 / 0.8796 + 1e-6
        np.testing.assert_allclose(w.var().item(), 1.0 / fan_in, rtol=0.2)
    assert not torch.equal(tmnist.Net(seed=4).fc1.weight, net.fc1.weight)


def test_logits_loss_and_grads_match_jax():
    params = _jax_params(seed=5)
    x, y = _batch(16)
    jlogp = jmnist.Net().apply(params, jnp.asarray(x))
    jloss, jgrads = jax.value_and_grad(jmnist.nll_loss)(
        params, (jnp.asarray(x), jnp.asarray(y)))
    net = _torch_net(params)
    tx, ty = train_lib.put_batch((x, y), "cpu")
    logp = net(tx)
    np.testing.assert_allclose(logp.detach().numpy(), np.asarray(jlogp),
                               rtol=1e-5, atol=1e-6)
    loss = tmnist.nll_loss(net, (tx, ty))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    loss.backward()
    want = convert.params_from_flax(jax.tree.map(np.asarray, jgrads))
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_eval_metrics_match_jax():
    params = _jax_params(seed=2)
    x, y = _batch(32, seed=4)
    jsum, jcorrect = jmnist.eval_metrics(params, (jnp.asarray(x),
                                                  jnp.asarray(y)))
    tsum, tcorrect = tmnist.eval_metrics(_torch_net(params),
                                         train_lib.put_batch((x, y), "cpu"))
    np.testing.assert_allclose(tsum.item(), float(jsum), rtol=1e-5)
    assert int(tcorrect) == int(jcorrect)


def test_sgd_momentum_matches_optax_two_updates():
    """optax.sgd(lr, momentum) (the trace) and torch's SGD with no
    dampening take the same two updates from the same grads."""
    rng = np.random.RandomState(0)
    init = {"w": rng.randn(4, 3).astype(np.float32),
            "b": rng.randn(3).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in init.items()} for _ in range(2)]
    opt = jtl.sgd(0.01, 0.5)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in init.items()}
    topt = train_lib.sgd(tp.values(), 0.01, 0.5)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                    state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k in init:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n,seed", [(100, 0), (37, 1)])
def test_synthetic_split_matches_jax(n, seed):
    x, y = data.synthetic_split(n, seed)
    jx, jy = jdata.synthetic_split(n, seed)
    assert x.shape == (n, 28, 28, 1) and x.dtype == np.float32
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("dataset", ["synthetic", "digits"])
def test_mnist_datasets_match_jax(dataset):
    got = data.mnist_datasets(None, 300, 100, dataset=dataset)
    want = jdata.mnist_datasets(None, 300, 100, dataset=dataset)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _write_idx(path, arr, code):
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, code, arr.ndim)
                + struct.pack(">" + "I" * arr.ndim, *arr.shape)
                + arr.tobytes())


def test_idx_files_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    raw = tmp_path / "FashionMNIST" / "raw"
    raw.mkdir(parents=True)
    for stem, n in (("train", 20), ("t10k", 8)):
        _write_idx(raw / f"{stem}-images-idx3-ubyte.gz",
                   rng.randint(0, 256, (n, 28, 28)).astype(np.uint8), 8)
        _write_idx(raw / f"{stem}-labels-idx1-ubyte.gz",
                   rng.randint(0, 10, n).astype(np.uint8), 8)
    assert data.resolve_dataset(str(tmp_path)) == "idx" == \
        jdata.resolve_dataset(str(tmp_path))
    got = data.mnist_datasets(str(tmp_path))
    want = jdata.mnist_datasets(str(tmp_path))
    assert got[0].shape == (20, 28, 28, 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(FileNotFoundError, match="no IDX files"):
        data.mnist_datasets(str(tmp_path / "none"), dataset="idx")


def test_batches_and_imagenet_batch_match_jax():
    x, y = data.synthetic_split(130, seed=0)
    for kw in ({"seed": 3}, {"shuffle": False}, {"drop_remainder": False}):
        got = list(data.batches(x, y, 64, **kw))
        want = list(jdata.batches(x, y, 64, **kw))
        assert len(got) == len(want)
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    for g, w in zip(data.synthetic_imagenet_batch(3, 32, seed=2),
                    jdata.synthetic_imagenet_batch(3, 32, seed=2)):
        np.testing.assert_array_equal(g, w)


def test_digits_without_sklearn_raises(monkeypatch):
    """Without scikit-learn, ``--dataset digits`` raises a clear error; it
    never serves another set in its place."""
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    with pytest.raises(ImportError, match="needs scikit-learn"):
        data.mnist_datasets(None, dataset="digits")


ARGV = ["--train-size", "256", "--test-size", "128", "--batch-size", "64",
        "--test-batch-size", "64", "--epochs", "1", "--log-interval", "1"]


def test_four_step_run_matches_jax(tmp_path, monkeypatch):
    """``mnist.run`` against the JAX package's ``run`` on a one-device mesh
    from the same weights: each step's logged loss, the accuracy and the
    final params."""
    mesh = jdist.make_mesh({"data": 1}, env=jdist.process_env({}),
                           devices=jax.devices()[:1])
    jres = jmnist.run(jmnist.build_parser().parse_args(
        ARGV + ["--dir", str(tmp_path / "j")]), mesh=mesh)
    rows = [json.loads(x) for x in
            (tmp_path / "j" / "scalars.jsonl").read_text().splitlines()]
    jlosses = [r["value"] for r in rows if r["tag"] == "loss"]
    params = _jax_params(seed=1)  # the run's init, from --seed 1
    net = tmnist.Net
    monkeypatch.setattr(tmnist, "Net", lambda seed=0: _torch_net(params)
                        if seed == 1 else net(seed))
    res = tmnist.run(tmnist.build_parser().parse_args(
        ARGV + ["--device", "cpu", "--dir", str(tmp_path / "t")]))
    rows = [json.loads(x) for x in
            (tmp_path / "t" / "scalars.jsonl").read_text().splitlines()]
    losses = [r["value"] for r in rows if r["tag"] == "loss"]
    assert len(losses) == len(jlosses) == 4
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert res["accuracy"] == jres["accuracy"]
    assert res["state"]["step"] == int(jres["state"]["step"]) == 4
    assert res["samples"] == jres["samples"] == 256
    want = convert.params_from_flax(jax.tree.map(
        np.asarray, jres["state"]["params"]))
    for name, p in res["state"]["model"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_run_learns_synthetic_and_logs(tmp_path, capsys):
    """One epoch on 2,048 synthetic images reaches the JAX package's bar
    (> 0.9), with the reference's log lines and scalars."""
    res = tmnist.run(tmnist.build_parser().parse_args(
        ["--train-size", "2048", "--test-size", "512", "--device", "cpu",
         "--test-batch-size", "256", "--dir", str(tmp_path)]))
    assert res["accuracy"] > 0.9, res["accuracy"]
    assert res["dataset"] == "synthetic" and res["samples"] == 2048
    out = capsys.readouterr().out
    assert "Train Epoch: 1 [0/2048 (0%)]\tloss=" in out
    assert "\naccuracy=" in out
    tags = [json.loads(x)["tag"] for x in
            (tmp_path / "scalars.jsonl").read_text().splitlines()]
    assert tags.count("loss") == 4 and tags[-1] == "accuracy"


def test_run_learns_real_digits(tmp_path):
    """The UCI handwritten digits (real images, offline) to above 0.8, the
    JAX package's bar on this set."""
    res = tmnist.run(tmnist.build_parser().parse_args(
        ["--dataset", "digits", "--epochs", "6", "--device", "cpu",
         "--dir", str(tmp_path)]))
    assert res["dataset"] == "digits"
    assert res["accuracy"] > 0.8, res["accuracy"]


def test_save_model_checkpoints_and_heartbeats(tmp_path, monkeypatch):
    """``--save-model`` writes a checkpoint at the last step; the run's
    heartbeats (``TrainTelemetry``, as the JAX package calls it) are the
    first step, the checkpoint and the close, each forced past the rate
    limit but the first."""
    shipped = []
    monkeypatch.setattr(
        train_lib.TrainTelemetry, "from_env", classmethod(
            lambda cls: cls(distributed.ProgressReporter(
                shipped.append, interval_s=1e9), enabled=True)))
    res = tmnist.run(tmnist.build_parser().parse_args(
        ARGV + ["--device", "cpu", "--save-model", "--dir", str(tmp_path)]))
    ckpt = train_lib.Checkpointer(str(tmp_path / "ckpt"))
    assert ckpt.latest_step() == res["state"]["step"] == 4
    restored = ckpt.restore(4, {"model": tmnist.Net(), "opt": None,
                                "step": 0})
    assert torch.equal(restored["model"].fc2.bias,
                       res["state"]["model"].fc2.bias)
    from tpujob.api.progress import parse_progress

    beats = [parse_progress(v) for v in shipped]
    assert [(b.step, b.checkpoint_step) for b in beats] == \
        [(1, None), (4, None), (4, 4)]
    assert beats[-1].samples_per_sec > 0
