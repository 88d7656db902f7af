"""Data parallelism across processes in the port's four trainers: two gloo
ranks on the CPU against the JAX package at one process on the global
batch, from the same weights (``convert.params_from_flax``) and the same
numpy inputs, and against the port itself at one process.

Each rank feeds half of the global batch; DDP averages the grads, the
reported loss is the ranks' mean (MLM: the global masked mean), ResNet's
BatchNorm takes its statistics over both ranks' rows, MNIST's test sums
are the whole test set's.  The JAX models live on a one-device mesh.

Tolerances: those the single-process test of each trainer states (the
two halves' mean gradient differs from the whole batch's by fp32
rounding only):
- GPT (``--attention flash``; Pallas in interpret mode, the plain
  versions on the port's side) and BERT MLM, fp32, 3 steps (4 with
  ``--grad-accum 2``): losses 1e-5 relative, params rtol 1e-5 and atol
  1e-4 (the key bias skipped: its exact gradient is 0 and Adam
  normalises rounding noise).  The atol is lr / 30, the single-process
  corpus MLM test's: the two halves' gradients add in another order than
  the whole batch's, and Adam turns rounding noise in a near-zero
  gradient element into a visible fraction of lr.  Observed: BERT 2.3e-5
  in one of 16,384; GPT at most 5.4e-6 in five runs of one machine (the
  ranks at 1 to 8 threads: one answer), and 1.81e-5 in one of 8,192
  elements of ``layer_0.mlp_wi.weight`` (0.6% of lr; 1.5e-6 on the first
  machine) in a run of the whole suite under six test workers, which
  failed the former atol 1e-5;
- MNIST, 4 steps and the test epoch: losses and params 1e-5, the
  accuracy and the correct count equal, the summed test loss 1e-5;
- ResNet-50 at width 8, fp32, one SGD step: loss 1e-5, every gradient and
  param normwise 5e-4, running statistics rtol 1e-4 / atol 1e-5;
  ``resnet.run`` 1 + 2 steps against the port at one process: losses
  1e-4 (BatchNorm over 4 samples grows the difference about 5x a step).
- The MoE GPT (``--moe-experts 4``): as the GPT; its load balance is
  the global batch's;
- The two ranks' states after a run: equal (one averaged gradient).
- A checkpoint written at world 2 resumed at world 1: losses 1e-5 of the
  two-rank run's continuation.
"""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh

from test_torch_spawn import (checkpoint_ranks, mnist_ranks, moe_ranks,
                              resnet_ranks, spawn, trainer_ranks)
from tpujob.workloads import bert as jbert
from tpujob.workloads import data as jdata
from tpujob.workloads import gpt as jgpt
from tpujob.workloads import mnist as jmnist
from tpujob.workloads import resnet as jresnet
from tpujob.workloads import train_lib as jtl
from tpujob_torch.workloads import bert as tbert
from tpujob_torch.workloads import convert
from tpujob_torch.workloads import gpt as tgpt
from tpujob_torch.workloads import mnist as tmnist
from tpujob_torch.workloads import resnet as tresnet
from tpujob_torch.workloads import train_lib

SMALL = ["--hidden", "64", "--layers", "2", "--heads", "4", "--intermediate",
         "128", "--vocab", "211", "--seq-len", "128", "--batch-size", "4",
         "--no-bf16", "--lr", "3e-3", "--log-interval", "1"]
GPT_ARGV = SMALL + ["--attention", "flash", "--steps", "3",
                    "--lr-schedule", "cosine"]
BERT_RUNS = [SMALL + ["--steps", "3", "--lr-schedule", "cosine"],
             SMALL + ["--steps", "4", "--grad-accum", "2"]]
MNIST_ARGV = ["--train-size", "256", "--test-size", "128", "--batch-size",
              "64", "--test-batch-size", "64", "--epochs", "1",
              "--log-interval", "1"]
RESNET_ARGV = ["--width", "8", "--image-size", "32", "--batch-size", "4",
               "--no-bf16"]
NORM_TOL = 5e-4


def _mesh():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def _logged_losses(logdir):
    rows = [json.loads(x) for x in
            (logdir / "scalars.jsonl").read_text().splitlines()]
    return [r["value"] for r in rows if r["tag"] == "loss"]


def _torch_state(variables):
    return convert.params_from_flax(jax.tree.map(np.asarray, variables))


def _trunk_init(jmodule, argv):
    """The weights the JAX package's trunk run starts from."""
    ja = jmodule.build_parser().parse_args(argv)
    jm = jmodule.build_model(ja, _mesh())
    return _torch_state({"params": jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128), jnp.int32))["params"]})


def _jax_trunk_run(jmodule, argv, logdir):
    jres = jmodule.run(jmodule.build_parser().parse_args(
        argv + ["--dir", str(logdir)]), _mesh())
    return _logged_losses(logdir), _torch_state(jres["state"]["params"])


def _port_run(module, owner, attr, state, argv, monkeypatch):
    """The port's ``module.run`` at one process from ``state``."""
    build = getattr(owner, attr)

    def built(*a, **kw):
        model = build(*a, **kw)
        model.load_state_dict(state, strict=True)
        return model

    with monkeypatch.context() as m:
        m.setattr(owner, attr, built)
        return module.run(module.build_parser().parse_args(argv))


def _params_close(got, want, rtol=1e-5, atol=1e-5):
    for name, w in want.items():
        if name.endswith("attn.key.bias"):
            continue  # exact gradient 0: Adam normalises rounding noise
        np.testing.assert_allclose(got[name], w.numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


def _ranks_equal(outs):
    for name, v in outs[0]["state"].items():
        np.testing.assert_array_equal(outs[1]["state"][name], v,
                                      err_msg=name)


def _port_argv(argv, logdir):
    return argv + ["--device", "cpu", "--dir", str(logdir)]


def test_gpt_two_ranks_match_jax_on_the_global_batch(tmp_path, monkeypatch):
    jlosses, jparams = _jax_trunk_run(jgpt, GPT_ARGV, tmp_path / "j")
    init = _trunk_init(jgpt, GPT_ARGV)
    [out], [out1] = spawn(trainer_ranks, 2, tmp_path, "gpt",
                          [_port_argv(GPT_ARGV, tmp_path / "t")], init)
    assert out["step"] == 3 and len(out["losses"]) == 3
    np.testing.assert_allclose(out["losses"], jlosses, rtol=1e-5)
    assert _logged_losses(tmp_path / "t") == out["losses"]  # rank 0 logs
    _params_close(out["state"], jparams, atol=1e-4)
    _ranks_equal([out, out1])
    one = _port_run(tgpt, tbert, "build_model", init,
                    _port_argv(GPT_ARGV, tmp_path / "one"), monkeypatch)
    np.testing.assert_allclose(out["losses"], one["losses"], rtol=1e-5)


def _within(got, want, rtol=1e-5, atol=1e-4) -> bool:
    return all(np.allclose(got[name], w.numpy(), rtol=rtol, atol=atol)
               for name, w in want.items()
               if not name.endswith("attn.key.bias"))


def test_moe_gpt_two_ranks_match_jax_with_a_global_load_balance(
        tmp_path, monkeypatch):
    """A MoE GPT (4 experts, top-2) at two ranks against JAX at one
    process: the load balance's top-1 counts and token count are summed
    over the ranks, as the JAX package's data axis takes them over the
    global batch.  A rank-local load balance misses the same tolerances
    (observed: losses 2.3e-5 relative, params 6e-3 absolute, where the
    global one reads 1.4e-6 and 3.6e-5)."""
    argv = GPT_ARGV + ["--moe-experts", "4"]
    jlosses, jparams = _jax_trunk_run(jgpt, argv, tmp_path / "j")
    init = _trunk_init(jgpt, argv)
    outs = spawn(moe_ranks, 2, tmp_path, _port_argv(argv, tmp_path / "t"),
                 _port_argv(argv, tmp_path / "local"), init)
    (out, local), (out1, _) = outs
    assert len(out["losses"]) == 3
    np.testing.assert_allclose(out["losses"], jlosses, rtol=1e-5)
    _params_close(out["state"], jparams, atol=1e-4)
    _ranks_equal([out, out1])
    assert not np.allclose(local["losses"], jlosses, rtol=1e-5)
    assert not _within(local["state"], jparams)
    one = _port_run(tgpt, tbert, "build_model", init,
                    _port_argv(argv, tmp_path / "one"), monkeypatch)
    np.testing.assert_allclose(out["losses"], one["losses"], rtol=1e-5)


def test_bert_mlm_two_ranks_match_jax_with_and_without_accumulation(
        tmp_path, monkeypatch):
    """The masked positions differ in number between the two halves of
    the batch: the loss divides by the global count."""
    init = _trunk_init(jbert, BERT_RUNS[0])
    jax_runs = [_jax_trunk_run(jbert, argv, tmp_path / f"j{i}")
                for i, argv in enumerate(BERT_RUNS)]
    outs = spawn(trainer_ranks, 2, tmp_path, "bert",
                 [_port_argv(argv, tmp_path / f"t{i}")
                  for i, argv in enumerate(BERT_RUNS)], init)
    for i, (jlosses, jparams) in enumerate(jax_runs):
        out = outs[0][i]
        assert len(out["losses"]) == len(jlosses) == [3, 4][i]
        np.testing.assert_allclose(out["losses"], jlosses, rtol=1e-5)
        _params_close(out["state"], jparams, atol=1e-4)
        _ranks_equal([outs[0][i], outs[1][i]])
    one = _port_run(tbert, tbert, "build_model", init,
                    _port_argv(BERT_RUNS[1], tmp_path / "one"), monkeypatch)
    np.testing.assert_allclose(outs[0][1]["losses"], one["losses"],
                               rtol=1e-5)


def test_mnist_two_ranks_match_jax_with_global_test_sums(tmp_path,
                                                         monkeypatch):
    jres = jmnist.run(jmnist.build_parser().parse_args(
        MNIST_ARGV + ["--dir", str(tmp_path / "j")]), mesh=_mesh())
    jlosses = _logged_losses(tmp_path / "j")
    init = _torch_state(jmnist.Net().init(
        jax.random.PRNGKey(1), jnp.zeros((1,) + jdata.IMAGE_SHAPE)))
    jparams = _torch_state(jres["state"]["params"])
    x, y = jdata.synthetic_split(64, seed=5)
    x = (x - jdata.MEAN) / jdata.STD
    jsum, jcorrect = jmnist.eval_metrics(
        jax.tree.map(jnp.asarray, jres["state"]["params"]),
        (jnp.asarray(x), jnp.asarray(y)))
    out, out1 = spawn(mnist_ranks, 2, tmp_path,
                      _port_argv(MNIST_ARGV, tmp_path / "t"), init, x, y)
    losses = _logged_losses(tmp_path / "t")
    assert len(losses) == len(jlosses) == 4 and out["step"] == 4
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    # every test row counted once: the accuracy of the whole set
    assert out["accuracy"] == out1["accuracy"] == jres["accuracy"]
    _params_close(out["state"], jparams)
    _ranks_equal([out, out1])
    for sums in (out["eval_sums"], out1["eval_sums"]):
        np.testing.assert_allclose(sums[0], float(jsum), rtol=1e-5)
        assert sums[1] == int(jcorrect)
    one = _port_run(tmnist, tmnist, "Net", init,
                    _port_argv(MNIST_ARGV, tmp_path / "one"), monkeypatch)
    assert one["accuracy"] == out["accuracy"]


def _normwise(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_resnet_two_ranks_match_jax_with_global_batch_statistics(
        tmp_path, monkeypatch):
    """One SGD step against JAX's ``make_train_step`` on the global batch
    of 4 (2 a rank: at the last stage's 1x1 maps a rank's own statistics
    would cover 2 values, the global ones 4); then ``resnet.run`` at two
    ranks against one."""
    jargs = jresnet.build_parser().parse_args(RESNET_ARGV)
    jm = jresnet.make_model(jargs)
    variables = jax.jit(lambda rng: jm.init(rng, jnp.zeros((1, 32, 32, 3)),
                                            train=False))(
        jax.random.PRNGKey(1))
    x, y = jdata.synthetic_imagenet_batch(4, 32, seed=7)
    (_, _), jgrads = jax.jit(jax.value_and_grad(
        jresnet.build_loss(jm), has_aux=True))(
        variables["params"], variables["batch_stats"],
        (jnp.asarray(x), jnp.asarray(y)))
    opt = jtl.sgd(0.1, 0.9)
    mesh = _mesh()
    step = jtl.make_train_step(jresnet.build_loss(jm), opt, mesh,
                               has_extra=True, donate=False)
    jstate, jloss = step(jtl.init_state(variables["params"], opt, mesh,
                                        extra=variables["batch_stats"]),
                         jtl.put_batch((x, y), mesh))
    want = _torch_state({"params": jstate["params"],
                         "batch_stats": jstate["extra"]})
    jgrads = _torch_state(jgrads)
    init = _torch_state(dict(variables))
    run_argv = _port_argv(RESNET_ARGV + ["--warmup-steps", "1", "--steps",
                                         "2", "--lr", "0.01"],
                          tmp_path / "t")
    outs = spawn(resnet_ranks, 2, tmp_path, RESNET_ARGV + ["--device", "cpu"],
                 init, x, y, run_argv)
    out = outs[0]
    np.testing.assert_allclose(out["loss"], float(jloss), rtol=1e-5)
    assert sorted(out["grads"]) == sorted(jgrads)
    for name, g in out["grads"].items():
        assert _normwise(g, jgrads[name].numpy()) <= NORM_TOL, name
    for name, v in out["state"].items():
        ref = want[name].numpy()
        if "running" in name:
            np.testing.assert_allclose(v, ref, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
        else:
            assert _normwise(v, ref) <= NORM_TOL, name
    _ranks_equal(outs)
    _ranks_equal([o["run"] for o in outs])  # running statistics included
    one = _port_run(tresnet, tresnet, "make_model", init,
                    run_argv[:-1] + [str(tmp_path / "one")], monkeypatch)
    np.testing.assert_allclose(out["run"]["losses"], one["losses"],
                               rtol=1e-4)
    for name, v in one["state"]["model"].state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(out["run"]["state"][name], v.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def test_checkpoint_written_at_two_ranks_resumes_at_one(tmp_path, capsys,
                                                        monkeypatch):
    """Rank 0 alone writes (checkpoints at steps 2 and 4), the file holds
    the unwrapped module's names (no ``module.`` prefix), every rank takes
    rank 0's latest step, and one process resumes from step 2 where the
    two ranks went on."""
    argv = GPT_ARGV[:-4] + ["--steps", "4", "--checkpoint-interval", "2"]
    init = _trunk_init(jgpt, argv)
    ckdir = tmp_path / "t" / "ckpt"
    outs = spawn(checkpoint_ranks, 2, tmp_path,
                 _port_argv(argv, tmp_path / "t"), init, str(ckdir))
    assert [len(o["saves"]) for o in outs] == [2, 0]
    assert [o["latest"] for o in outs] == [4, 4]
    assert sorted(p.name for p in ckdir.iterdir()) == ["2", "4"]
    saved = torch.load(ckdir / "2" / "state.pt", weights_only=True)
    assert sorted(saved["model"]) == sorted(init)
    assert saved["step"] == 2
    resumed = tmp_path / "one"
    shutil.copytree(ckdir / "2", resumed / "ckpt" / "2")
    capsys.readouterr()
    one = _port_run(tgpt, tbert, "build_model", init,
                    _port_argv(argv, resumed), monkeypatch)
    assert "resumed from checkpoint step 2" in capsys.readouterr().out
    assert len(one["losses"]) == 2
    np.testing.assert_allclose(one["losses"], outs[0]["losses"][2:],
                               rtol=1e-5)
    assert train_lib.Checkpointer(str(resumed / "ckpt")).latest_step() == 4
