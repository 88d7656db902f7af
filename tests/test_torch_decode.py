"""The port's decode (``tpujob_torch.workloads.gpt`` ``sample_next``,
``generate``, ``generate_cached`` and ``bert.Bert``'s KV-cache mode)
against the JAX package's, on the CPU, with the same weights carried
across by ``convert.params_from_flax``.

A 2-layer, hidden-64, 4-head GPT with seq 32, in two trunk configurations:
learned positions with multi-head attention, and RoPE with 2 KV heads and
a sliding window of 8 (shorter than the 16 positions decoded, so the
window's mask on the cache is exercised).

Tolerances, from the observed agreement with margin:
- cached decode, teacher-forced logits at every step: fp32 atol/rtol 1e-5
  (observed <= 1.9e-6); bf16 atol/rtol 6.25e-2 (observed <= 4.7e-2 at
  |logit| up to 5.6: the JAX package's decode attention runs its scores, mask and
  softmax in bf16, as the port's does, and the frameworks round bf16 at
  different places inside the softmax and the products);
- greedy decodes: token for token in fp32, both routes, dense and flash;
- sampling: ``truncate``'s keep-masks equal to the ones JAX's
  ``sample_next`` hands to ``jax.random.categorical`` (fp32, ties planted
  by rounding the logits to a grid of 0.25), and the kept logits within
  1e-6.  The draws themselves cannot match: torch's generator and JAX's
  keys differ, so draws are checked by their support sets and by
  determinism under one seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpujob.workloads import gpt as jgpt
from tpujob_torch.workloads import convert
from tpujob_torch.workloads import gpt as tgpt

BASE = ["--hidden", "64", "--layers", "2", "--heads", "4",
        "--intermediate", "128", "--vocab", "97", "--seq-len", "32",
        "--batch-size", "2"]
TRUNKS = {
    "learned_mha": [],
    "rope_gqa_window": ["--position", "rope", "--kv-heads", "2",
                        "--attention-window", "8"],
}
LOGIT_TOL = {"fp32": 1e-5, "bf16": 6.25e-2}
L = 16  # positions decoded in the teacher-forced comparison


def _argv(trunk, dtype, attention="dense"):
    return (BASE + TRUNKS[trunk] + ["--attention", attention]
            + ([] if dtype == "bf16" else ["--no-bf16"]))


def _jax_model(argv):
    ja = jgpt.build_parser().parse_args(argv)
    jm = jgpt.build_model(ja, Mesh(np.array(jax.devices()[:1]), ("data",)))
    params = {"params": jm.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 32), jnp.int32))["params"]}
    return jm, params


def _torch_model(argv, params):
    args = tgpt.build_parser().parse_args(argv + ["--device", "cpu"])
    model = tgpt.build_model(args, torch.device("cpu"))
    model.load_state_dict(convert.params_from_flax(
        jax.tree.map(np.asarray, params)), strict=True)
    return model


def _jax_cached_logits(jm, params, ids):
    """Teacher-forced per-step logits of the JAX package's decode mode."""
    dm = jm.clone(decode=ids.shape[1], attention_fn=None, remat=False)
    shapes = jax.eval_shape(dm.init, jax.random.PRNGKey(0),
                            jnp.zeros((ids.shape[0], 1), jnp.int32))["cache"]
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    step = jax.jit(lambda c, tok: dm.apply({**params, "cache": c}, tok,
                                           mutable=["cache"]))
    outs = []
    for t in range(ids.shape[1]):
        lg, mut = step(cache, jnp.asarray(ids[:, t:t + 1]))
        cache = mut["cache"]
        outs.append(np.asarray(lg[:, 0].astype(jnp.float32)))
    return np.stack(outs, 1)


def _torch_cached_logits(model, ids):
    ids = torch.from_numpy(ids.astype(np.int64))
    cache = model.new_cache(ids.shape[0], ids.shape[1])
    outs = []
    with torch.no_grad():
        for t in range(ids.shape[1]):
            lg, cache = model(ids[:, t:t + 1], cache=cache)
            outs.append(lg[:, 0].float())
    assert cache.index == cache.position == ids.shape[1]
    return torch.stack(outs, 1).numpy()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("trunk", sorted(TRUNKS))
def test_cached_decode_logits_match_jax(trunk, dtype):
    argv = _argv(trunk, dtype)
    jm, params = _jax_model(argv)
    model = _torch_model(argv, params)
    ids = np.random.RandomState(3).randint(0, 97, (2, L)).astype(np.int32)
    want = _jax_cached_logits(jm, params, ids)
    got = _torch_cached_logits(model, ids)
    tol = LOGIT_TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # the port's cached decode is the same function as its full forward
    with torch.no_grad():
        full = model(torch.from_numpy(ids.astype(np.int64))).float().numpy()
    np.testing.assert_allclose(got, full, rtol=tol, atol=tol)


def test_cache_holds_kv_heads_only():
    model = _torch_model(_argv("rope_gqa_window", "bf16"),
                         _jax_model(_argv("rope_gqa_window", "bf16"))[1])
    cache = model.new_cache(2, 9)
    assert len(cache.k) == len(cache.v) == 2
    assert cache.k[0].shape == (2, 9, 2, 16)
    assert cache.k[0].dtype == torch.bfloat16
    assert (cache.index, cache.position) == (0, 0)


@pytest.mark.parametrize("trunk", sorted(TRUNKS))
def test_greedy_decodes_match_jax(trunk):
    """Both routes, token for token with JAX's (fp32), from a 6-token
    prompt for 10 new tokens (past the window of 8)."""
    argv = _argv(trunk, "fp32")
    jm, params = _jax_model(argv)
    model = _torch_model(argv, params)
    prompt = np.random.RandomState(1).randint(0, 97, (2, 6)).astype(np.int32)
    want_full = np.asarray(jgpt.generate(jm, params, jnp.asarray(prompt), 10))
    want_cached = np.asarray(jgpt.generate_cached(jm, params,
                                                  jnp.asarray(prompt), 10))
    tp = torch.from_numpy(prompt.astype(np.int64))
    np.testing.assert_array_equal(tgpt.generate(model, tp, 10).numpy(),
                                  want_full)
    np.testing.assert_array_equal(tgpt.generate_cached(model, tp, 10).numpy(),
                                  want_cached)
    np.testing.assert_array_equal(want_full, want_cached)


@pytest.mark.parametrize("trunk", sorted(TRUNKS))
def test_flash_generate_matches_jax(trunk):
    """``generate`` with --attention flash (the kernels' plain versions on
    the CPU) decodes JAX's greedy tokens (fp32)."""
    jm, params = _jax_model(_argv(trunk, "fp32"))
    model = _torch_model(_argv(trunk, "fp32", "flash"), params)
    prompt = np.random.RandomState(2).randint(0, 97, (2, 6)).astype(np.int32)
    want = np.asarray(jgpt.generate(jm, params, jnp.asarray(prompt), 10))
    got = tgpt.generate(model, torch.from_numpy(prompt.astype(np.int64)), 10)
    np.testing.assert_array_equal(got.numpy(), want)


def _planted_logits(seed):
    """Random fp32 logits rounded to a grid of 0.25: many exact ties,
    at the k-th value and at the nucleus cutoff among them."""
    x = np.random.RandomState(seed).randn(6, 40).astype(np.float32) * 2
    return np.round(x * 4) / 4


def _jax_truncated(logit, monkeypatch, **kw):
    """The logits JAX's sample_next hands to jax.random.categorical."""
    seen = []

    def capture(key, lg):
        seen.append(np.asarray(lg))
        return jnp.argmax(lg, -1)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jgpt.sample_next(jnp.asarray(logit), jax.random.PRNGKey(0), **kw)
    monkeypatch.undo()
    return seen[0]


@pytest.mark.parametrize("kw", [
    dict(top_k=1), dict(top_k=3), dict(top_k=10), dict(top_p=0.3),
    dict(top_p=0.6), dict(top_p=0.9), dict(top_k=10, top_p=0.6),
    dict(), dict(temperature=0.5, top_p=0.6),
], ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()) or "plain")
def test_truncation_masks_match_jax(kw, monkeypatch):
    kw = dict(dict(temperature=0.7), **kw)
    for seed in range(3):
        logit = _planted_logits(seed)
        want = _jax_truncated(logit, monkeypatch, **kw)
        got = tgpt.truncate(torch.from_numpy(logit), **kw).numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        keep = np.isfinite(want)
        np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)
        if kw.get("top_k") or kw.get("top_p"):
            assert not keep.all()  # the truncation dropped something


def test_sample_next_support_sets():
    """The same support sets as the JAX package's own test: nucleus with
    the crossing token in, top-k, plain sampling, greedy ignoring both."""
    logit = torch.log(torch.tensor([[0.6, 0.3, 0.1]])).expand(300, 3)

    def draws(**kw):
        rng = torch.Generator().manual_seed(0)
        d = tgpt.sample_next(logit, rng, temperature=1.0, **kw)
        return set(d.unique().tolist())

    assert draws(top_p=0.5) == {0}
    assert draws(top_p=0.7) == {0, 1}
    assert draws(top_k=2) == {0, 1}
    assert draws(top_k=1) == {0}
    assert draws() == {0, 1, 2}
    assert tgpt.sample_next(logit[:1], None, temperature=0.0, top_k=2,
                            top_p=0.1).tolist() == [0]


def test_sampling_is_deterministic_under_one_seed():
    argv = _argv("learned_mha", "fp32")
    model = _torch_model(argv, _jax_model(argv)[1])
    prompt = torch.from_numpy(
        np.random.RandomState(1).randint(0, 97, (2, 5)).astype(np.int64))
    runs = []
    for fn in (tgpt.generate, tgpt.generate, tgpt.generate_cached):
        rng = torch.Generator().manual_seed(7)
        runs.append(fn(model, prompt, 4, temperature=0.8, rng=rng))
    assert torch.equal(runs[0], runs[1])
    # one draw a new token on both routes: the same stream, the same ids
    assert torch.equal(runs[0], runs[2])
    assert ((runs[0] >= 0) & (runs[0] < 97)).all()


def test_decode_argument_errors():
    argv = _argv("learned_mha", "fp32")
    model = _torch_model(argv, _jax_model(argv)[1])
    prompt = torch.zeros((2, 5), dtype=torch.long)
    for fn in (tgpt.generate, tgpt.generate_cached):
        with pytest.raises(ValueError, match="max_seq"):
            fn(model, prompt, 64)
        with pytest.raises(ValueError, match="rng"):
            fn(model, prompt, 2, temperature=1.0)
    with pytest.raises(ValueError, match="one position at a time"):
        model(prompt, cache=model.new_cache(2, 8))


@pytest.mark.parametrize("extra,match", [
    (["--generate", "32"], "must leave room"),
    (["--generate", "4", "--generate-top-p", "0.9"], "generate-temperature"),
    (["--generate", "4", "--generate-top-k", "5"], "generate-temperature"),
])
def test_run_rejects_generate_flags_before_training(extra, match, tmp_path):
    args = tgpt.build_parser().parse_args(
        _argv("learned_mha", "fp32") + ["--device", "cpu", "--steps", "1",
                                        "--dir", str(tmp_path / "logs")]
        + extra)
    with pytest.raises(ValueError, match=match):
        tgpt.run(args)
    assert not (tmp_path / "logs").exists()  # nothing trained


def test_run_generates_after_training(tmp_path, capsys):
    """The entry point end to end on the CPU: train, then decode from the
    first 8 ids of the batch's row 0 and print them (greedy, flash)."""
    res = tgpt.run(tgpt.build_parser().parse_args(
        _argv("rope_gqa_window", "fp32", "flash")
        + ["--device", "cpu", "--steps", "1", "--generate", "6",
           "--dir", str(tmp_path)]))
    out = res["generated"]
    assert out.shape == (1, 14)
    assert f"generated ids: {out[0].tolist()}" in capsys.readouterr().out
    want = tgpt.generate(res["state"]["model"], out[:, :8], 6)
    assert torch.equal(out, want)


def test_run_with_sampling_flags_on_cpu(tmp_path):
    res = tgpt.run(tgpt.build_parser().parse_args(
        _argv("learned_mha", "fp32")
        + ["--device", "cpu", "--steps", "1", "--generate", "5",
           "--generate-temperature", "0.9", "--generate-top-k", "20",
           "--generate-top-p", "0.8", "--dir", str(tmp_path)]))
    assert res["generated"].shape == (1, 13)


def test_generate_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tgpt.main(_argv("learned_mha", "fp32") + ["--steps", "1",
                                                 "--generate", "4"])
