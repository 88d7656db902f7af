"""The port's BERT masked-LM pretraining (``tpujob_torch.workloads.bert``
``mask_batch``, ``mlm_loss``, ``run``, ``main``) against the JAX package's,
on the CPU, with the same weights carried across by
``convert.params_from_flax``.

A 2-layer, hidden-64, 4-head BERT at seq 128, with dense attention and with
``--attention flash`` (the Pallas kernels in interpret mode on the JAX
side, non-causal; the plain versions of the CUDA kernels on the torch
side).  The JAX model lives on a 1-device mesh.

Tolerances, from the observed agreement with margin:
- ``mask_batch``: array-equal (one numpy draw on both sides);
- fp32: loss 1e-6 relative, every gradient rtol 1e-3 / atol 1e-6 (observed
  <= 9.7e-8); a 3-step ``run``: losses 1e-5 relative, params 1e-5;
- bf16: loss 2e-3 relative (the loss is an fp32 mean of bf16
  log-probabilities; observed <= 1.4e-4), gradients rtol 1e-3 / atol 2e-3
  (observed <= 1.95e-3, one bf16 ulp at 0.25-0.5): the frameworks round
  bf16 at different places.  One row differs by more: the [MASK] id's
  (103) row of the embedding table, whose gradient is a bf16 sum over
  every masked position (40 here), each term already a few bf16 ulps apart
  between the frameworks, summed in different orders with cancellation.
  It is held normwise, ||got - want|| <= 3e-2 ||want|| (observed 1.24e-2
  dense, 1.16e-2 flash), and in fp32 element-wise like the rest.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpujob.workloads import bert as jbert
from tpujob_torch.workloads import bert as tbert
from tpujob_torch.workloads import convert, data

ROOT = Path(__file__).resolve().parent.parent
ARGV = ["--hidden", "64", "--layers", "2", "--heads", "4",
        "--intermediate", "128", "--vocab", "211", "--seq-len", "128",
        "--batch-size", "2"]
TOL = {"fp32": dict(loss=1e-6, grads=1e-6), "bf16": dict(loss=2e-3, grads=2e-3)}


def _mesh():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def _argv(dtype, attention):
    return ARGV + ["--attention", attention] + (
        [] if dtype == "bf16" else ["--no-bf16"])


def _jax_params(jm, seq=128):
    """The parameters the JAX package's ``train`` starts from."""
    return {"params": jm.init(jax.random.PRNGKey(0),
                              jnp.zeros((1, seq), jnp.int32))["params"]}


def _load(model, params):
    model.load_state_dict(convert.params_from_flax(
        jax.tree.map(np.asarray, params)), strict=True)
    return model


@pytest.mark.parametrize("seed,shape", [(0, (2, 128)), (5, (8, 512)),
                                        (17, (3, 7))])
def test_mask_batch_matches_jax(seed, shape):
    ids = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    got_ids, got = tbert.mask_batch(ids, seed)
    _, want = jbert.mask_batch(ids, seed)
    assert got_ids is ids and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mlm_loss_and_grads_match_jax(dtype, attention):
    argv = _argv(dtype, attention)
    ja = jbert.build_parser().parse_args(argv)
    jm = jbert.build_model(ja, _mesh())
    params = _jax_params(jm)
    ids = data.synthetic_token_batch(2, 128, 211)
    _, mask = jbert.mask_batch(ids, 0)
    loss, grads = jax.jit(jax.value_and_grad(jbert.mlm_loss(jm)))(
        params, (jnp.asarray(ids), jnp.asarray(mask)))
    jgrads = convert.params_from_flax(jax.tree.map(
        lambda a: np.asarray(a, np.float32), grads))

    args = tbert.build_parser().parse_args(argv + ["--device", "cpu"])
    model = _load(tbert.build_model(args, torch.device("cpu")), params)
    got = tbert.mlm_loss(model)((tbert.batch_to_device(ids, "cpu"),
                                 torch.from_numpy(mask)))
    assert got.dtype == torch.float32
    tol = TOL[dtype]
    np.testing.assert_allclose(got.item(), float(loss), rtol=tol["loss"])
    got.backward()
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(jgrads)
    for name, p in model.named_parameters():
        got_g, want_g = p.grad.numpy(), jgrads[name].numpy()
        if name == "token_embed.weight" and dtype == "bf16":
            row_g, row_w = got_g[103], want_g[103]
            assert (np.linalg.norm(row_g - row_w)
                    <= 3e-2 * np.linalg.norm(row_w))
            got_g, want_g = np.delete(got_g, 103, 0), np.delete(want_g, 103, 0)
        np.testing.assert_allclose(got_g, want_g, rtol=1e-3,
                                   atol=tol["grads"], err_msg=name)


def test_mlm_loss_counts_only_masked_positions():
    """Unmasked positions do not enter the loss; no mask gives 0, not a
    division by zero."""
    args = tbert.build_parser().parse_args(ARGV + ["--no-bf16", "--device",
                                                   "cpu"])
    model = tbert.build_model(args, torch.device("cpu"))
    ids = tbert.batch_to_device(data.synthetic_token_batch(2, 128, 211), "cpu")
    none = tbert.mlm_loss(model)((ids, torch.zeros(2, 128)))
    assert none.item() == 0.0
    mask = torch.zeros(2, 128)
    mask[0, 5] = 1.0
    with torch.no_grad():
        logits = model(torch.where(mask > 0, 103, ids))
    want = -torch.log_softmax(logits[0, 5], -1)[ids[0, 5]]
    got = tbert.mlm_loss(model)((ids, mask))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_three_step_run_matches_jax(tmp_path, monkeypatch):
    """``bert.run`` (its fixed mask from --seed, AdamW, cosine schedule)
    against the JAX package's ``run`` from the same initial weights: the
    three losses (the JAX run's scalars.jsonl) and the final params
    (fp32)."""
    argv = _argv("fp32", "dense") + [
        "--steps", "3", "--lr", "3e-3", "--lr-schedule", "cosine",
        "--log-interval", "1"]
    ja = jbert.build_parser().parse_args(argv + ["--dir", str(tmp_path / "j")])
    mesh = _mesh()
    jres = jbert.run(ja, mesh)
    rows = [json.loads(x) for x in
            (tmp_path / "j" / "scalars.jsonl").read_text().splitlines()]
    jlosses = [r["value"] for r in rows if r["tag"] == "loss"]
    assert len(jlosses) == 3
    params = _jax_params(jbert.build_model(ja, mesh))

    build = tbert.build_model
    monkeypatch.setattr(tbert, "build_model",
                        lambda *a, **kw: _load(build(*a, **kw), params))
    res = tbert.run(tbert.build_parser().parse_args(
        argv + ["--device", "cpu", "--dir", str(tmp_path / "t")]))
    np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-5)
    np.testing.assert_allclose(res["final_loss"], jres["final_loss"],
                               rtol=1e-5)
    want = convert.params_from_flax(jax.tree.map(
        np.asarray, jres["state"]["params"]))
    for name, p in res["state"]["model"].named_parameters():
        if name.endswith("attn.key.bias"):
            continue  # exact gradient 0: Adam normalises rounding noise
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_run_flag_errors():
    p = tbert.build_parser()
    with pytest.raises(ValueError, match="causal family"):
        tbert.run(p.parse_args(ARGV + ["--device", "cpu",
                                       "--attention-window", "8"]))
    # the corpus flags are ported: their own checks apply
    with pytest.raises(ValueError, match="needs --vocab >= 257"):
        tbert.run(p.parse_args(ARGV + ["--device", "cpu",
                                       "--data-file", "x.txt"]))
    with pytest.raises(ValueError, match="needs --data-file"):
        tbert.run(p.parse_args(ARGV + ["--device", "cpu",
                                       "--tokenizer", "bpe:x"]))
    # expert parallelism over 2 ranks: one process cannot hold its axis
    with pytest.raises(ValueError, match="not divisible by fixed axes"):
        tbert.run(p.parse_args(ARGV + ["--device", "cpu", "--moe-experts",
                                       "4", "--expert-parallel", "2"]))


def test_module_entry_point_on_cpu(tmp_path):
    """``python -m tpujob_torch.workloads.bert --device cpu`` at a tiny
    size trains and reports its rate."""
    out = subprocess.run(
        [sys.executable, "-m", "tpujob_torch.workloads.bert", "--device",
         "cpu", "--hidden", "32", "--layers", "1", "--heads", "2",
         "--intermediate", "64", "--vocab", "211", "--seq-len", "16",
         "--batch-size", "2", "--steps", "2", "--attention", "flash",
         "--dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "bert(h32xl1):" in out.stdout and "tokens/sec" in out.stdout


def test_entry_point_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tbert.main(ARGV + ["--steps", "1"])
