"""The corpus path of the port's transformer trainers (``--data-file``,
``--tokenizer``: ``bert.tokenizer_from_args``, ``token_batches``'
provider, ``mask_id_from_args``, ``train``'s ``batch_provider`` and
``train_lib.put_batch``,
``bert.run``/``gpt.run``) against the JAX package's, on the CPU.

Tolerances:
- the batches and masks of every step: array-equal (one numpy recipe on
  both sides, captured from each package's own ``run``);
- a 3-step fp32 run on a corpus: losses 1e-5 relative (the synthetic
  path's bound in ``test_torch_bert_mlm.py``), final params rtol 1e-5 and
  atol 1e-4: Adam divides each gradient by its own rms, so where a
  gradient is near 0 the frameworks' rounding noise becomes a step of up
  to the learning rate (3e-3); observed 1.6e-5 on one element of 4,096;
- a resumed run: bit-identical to an uninterrupted one.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpujob.workloads import bert as jbert
from tpujob.workloads import distributed as jdist
from tpujob.workloads import gpt as jgpt
from tpujob.workloads import tokenizer as jtok
from tpujob_torch.workloads import bert as tbert
from tpujob_torch.workloads import convert, distributed
from tpujob_torch.workloads import gpt as tgpt
from tpujob_torch.workloads import train_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--hidden", "64", "--layers", "2", "--heads", "4",
         "--intermediate", "128", "--seq-len", "32", "--no-bf16",
         "--log-interval", "1"]


def _mesh():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


@pytest.fixture
def corpus(tmp_path):
    """About 20 KB of real text: 9 chunks of 2,048 bytes, so a batch of 4
    wraps around the end of the corpus at step 2."""
    text = b""
    for name in ("tokenizer.py", "data.py"):
        with open(os.path.join(ROOT, "tpujob", "workloads", name), "rb") as f:
            text += f.read()
    path = tmp_path / "corpus.txt"
    path.write_bytes((text * 2)[: 9 * 2048 + 100])
    return str(path)


def _captured(monkeypatch, module, run, args):
    """(template batch, provider) that ``module.run`` hands to its
    ``train`` (which is stubbed out)."""
    seen = {}

    def fake_train(*a, **kw):
        seen["batch"], seen["provider"] = a[-1], kw.get("batch_provider")
        return {}

    monkeypatch.setattr(module, "train", fake_train)
    run(args)
    return seen["batch"], seen["provider"]


def _parse(parser, argv, tmp_path, name, torch_side):
    extra = ["--device", "cpu"] if torch_side else []
    return parser().parse_args(argv + extra + ["--dir", str(tmp_path / name)])


@pytest.mark.parametrize("tokenizer", [None, "bpe"])
def test_mlm_batches_and_masks_match_jax(tmp_path, corpus, monkeypatch,
                                         tokenizer):
    """Every step's (ids, mask) from the port's ``bert.run`` equals the JAX
    package's, for 6 steps of a batch of 4 over a corpus of 9 chunks (the
    rows wrap at step 2); each step's mask is drawn from seed + step."""
    argv = SMALL + ["--batch-size", "4", "--seq-len", "2048", "--vocab", "300",
                    "--data-file", corpus, "--seed", "3"]
    if tokenizer:
        # the 9-chunk file encodes to fewer chunks: use seq 256
        argv += ["--tokenizer", f"bpe:{tmp_path}/tok.json:290",
                 "--seq-len", "256"]
    ja = _parse(jbert.build_parser, argv, tmp_path, "j", False)
    jtemplate, jprov = _captured(monkeypatch, jbert,
                                 lambda a: jbert.run(a, _mesh()), ja)
    ta = _parse(tbert.build_parser, argv, tmp_path, "t", True)
    template, prov = _captured(monkeypatch, tbert, tbert.run, ta)
    np.testing.assert_array_equal(template[0].numpy(), jtemplate[0])
    np.testing.assert_array_equal(template[1].numpy(), jtemplate[1])
    masks = []
    for step in range(6):
        (ids, mask), (jids, jmask) = prov(step), jprov(step)
        assert ids.dtype == np.int32 and mask.dtype == np.float32
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(mask, jmask)
        masks.append(mask)
    assert not np.array_equal(masks[0], masks[1])  # a new mask each step
    if not tokenizer:
        chunks = np.fromfile(corpus, np.uint8)[: 9 * 2048].reshape(9, 2048)
        np.testing.assert_array_equal(prov(2)[0],
                                      chunks[[8, 0, 1, 2]])  # the wrap


@pytest.mark.parametrize("process_id", [0, 1])
def test_token_batches_rows_match_jax_per_process(corpus, process_id):
    """The provider's rows, ``(arange(lo, lo + sz) + step * batch) % n``,
    for each of two processes, raw bytes and BPE, over several steps."""
    env = {"WORLD_SIZE": "2", "RANK": str(process_id)}
    args = tgpt.build_parser().parse_args(
        SMALL + ["--batch-size", "6", "--vocab", "300", "--data-file", corpus])
    tok = jtok.BPETokenizer.train(open(corpus, "rb").read(), 280)
    for t in (None, tok):
        local, prov, sample = tbert.token_batches(
            args, distributed.process_env(env), tokenizer=t)
        jlocal, jprov, jsample = jbert.token_batches(
            args, jdist.process_env(env), tokenizer=t)
        np.testing.assert_array_equal(local, jlocal)
        np.testing.assert_array_equal(sample, jsample)
        assert local.shape == (3, 32) and sample.shape == (1, 32)
        for step in (1, 2, 5, 97):
            np.testing.assert_array_equal(prov(step), jprov(step))


@pytest.mark.parametrize("argv,tokenizer,want", [
    ([], False, 103),
    (["--data-file", "{c}", "--vocab", "257"], False, 256),
    (["--data-file", "{c}", "--vocab", "300",
      "--tokenizer", "bpe:{t}/tok.json:280"], True, 280),
])
def test_mask_id_rules(tmp_path, corpus, argv, tokenizer, want):
    argv = [a.format(c=corpus, t=tmp_path) for a in argv]
    args = tbert.build_parser().parse_args(SMALL + argv)
    tok = tbert.tokenizer_from_args(args, reserve=1)
    assert (tok is not None) == tokenizer
    assert tbert.mask_id_from_args(args, tok) == want


@pytest.mark.parametrize("argv,match", [
    (["--data-file", "{c}", "--vocab", "256"], "needs --vocab >= 257"),
    (["--data-file", "{c}", "--vocab", "200"], "needs --vocab >= 257"),
    (["--tokenizer", "bpe:{t}/tok.json"], "needs --data-file"),
    (["--data-file", "{c}", "--tokenizer", "wordpiece:x"],
     "must be 'bpe:PATH'"),
    (["--data-file", "{c}", "--tokenizer", "bpe:"], "must be 'bpe:PATH'"),
    (["--data-file", "{c}", "--tokenizer", "bpe:{t}/missing.json"],
     "does not exist"),
    (["--data-file", "{c}", "--vocab", "280",
      "--tokenizer", "bpe:{t}/tok.json:280"], "plus the \\[MASK\\] id"),
])
def test_corpus_flag_errors_match_jax(tmp_path, corpus, argv, match):
    """Each flag error of the port's ``bert.run`` is the JAX package's,
    raised before any training."""
    argv = SMALL + ["--batch-size", "2", "--steps", "1"] + [
        a.format(c=corpus, t=tmp_path) for a in argv]
    with pytest.raises(ValueError, match=match):
        jbert.run(_parse(jbert.build_parser, argv, tmp_path, "j", False),
                  _mesh())
    with pytest.raises(ValueError, match=match):
        tbert.run(_parse(tbert.build_parser, argv, tmp_path, "t", True))
    assert not os.path.exists(tmp_path / "tok.json")  # nothing trained


def test_gpt_corpus_flag_errors(tmp_path, corpus):
    p = tgpt.build_parser()
    with pytest.raises(ValueError, match="must be >= 256"):
        tgpt.run(p.parse_args(SMALL + ["--device", "cpu", "--vocab", "200",
                                       "--data-file", corpus]))
    with pytest.raises(ValueError, match="too small for the 280-id"):
        jtok.BPETokenizer.train(open(corpus, "rb").read(), 280).save(
            str(tmp_path / "t.json"))
        tgpt.run(p.parse_args(SMALL + ["--device", "cpu", "--vocab", "279",
                                       "--data-file", corpus, "--tokenizer",
                                       f"bpe:{tmp_path}/t.json"]))


def _jax_losses(logdir):
    rows = [json.loads(x) for x in
            (logdir / "scalars.jsonl").read_text().splitlines()]
    return [r["value"] for r in rows if r["tag"] == "loss"]


def _carry(monkeypatch, module, params):
    build = module.build_model

    def build_with(*a, **kw):
        model = build(*a, **kw)
        model.load_state_dict(convert.params_from_flax(
            jax.tree.map(np.asarray, params)), strict=True)
        return model

    monkeypatch.setattr(module, "build_model", build_with)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_three_step_byte_corpus_mlm_matches_jax(tmp_path, corpus,
                                                monkeypatch, attention):
    """``bert.run --data-file`` (raw bytes, [MASK] 256, a new batch and
    mask each step) against the JAX package's from the same weights:
    three losses and the final params, fp32, 1e-5."""
    argv = SMALL + ["--vocab", "257", "--batch-size", "2", "--seq-len", "128",
                    "--steps", "3", "--lr", "3e-3", "--data-file", corpus,
                    "--attention", attention]
    ja = _parse(jbert.build_parser, argv, tmp_path, "j", False)
    mesh = _mesh()
    jres = jbert.run(ja, mesh)
    jlosses = _jax_losses(tmp_path / "j")
    assert len(jlosses) == 3
    params = {"params": jbert.build_model(ja, mesh).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 128), jnp.int32))["params"]}
    _carry(monkeypatch, tbert, params)
    res = tbert.run(_parse(tbert.build_parser, argv, tmp_path, "t", True))
    np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-5)
    want = convert.params_from_flax(jax.tree.map(
        np.asarray, jres["state"]["params"]))
    for name, p in res["state"]["model"].named_parameters():
        if name.endswith("attn.key.bias"):
            continue  # exact gradient 0: Adam normalises rounding noise
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-4, err_msg=name)


def test_three_step_bpe_corpus_gpt_matches_jax(tmp_path, corpus,
                                               monkeypatch):
    """``gpt.run --data-file --tokenizer bpe:PATH:V`` against the JAX
    package's: the tokenizer trained by the JAX run is loaded by the port
    (one file, one token cache), the same three losses (fp32, 1e-5), and
    the prompt of ``--generate`` is the corpus' first chunk."""
    tok = f"bpe:{tmp_path}/tok.json:300"
    argv = SMALL + ["--vocab", "300", "--batch-size", "2", "--steps", "3",
                    "--lr", "3e-3", "--data-file", corpus, "--tokenizer", tok]
    ja = _parse(jgpt.build_parser, argv, tmp_path, "j", False)
    mesh = _mesh()
    jgpt.run(ja, mesh)
    jlosses = _jax_losses(tmp_path / "j")
    caches = [p for p in os.listdir(tmp_path) if p.endswith(".tokens")]
    params = {"params": jgpt.build_model(ja, mesh).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32), jnp.int32))["params"]}
    _carry(monkeypatch, tgpt, params)
    res = tgpt.run(_parse(tgpt.build_parser, argv + ["--generate", "4"],
                          tmp_path, "t", True))
    assert [p for p in os.listdir(tmp_path) if p.endswith(".tokens")] == caches
    np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-5)
    first = jtok.BPETokenizer.load(str(tmp_path / "tok.json")).encode(
        open(corpus, "rb").read())[:8]
    np.testing.assert_array_equal(res["generated"][0, :8].numpy(), first)
    assert res["generated"].shape == (1, 12)


def test_each_step_trains_on_its_provider_batch(tmp_path, corpus,
                                                monkeypatch):
    """What ``train`` copies to the device at step i is ``provider(i)``:
    the stream, not the template, reaches the model."""
    copied = []
    put = train_lib.put_batch

    def recording(arrays, device):
        copied.append([np.array(a) for a in arrays])
        return put(arrays, device)

    monkeypatch.setattr(train_lib, "put_batch", recording)
    args = _parse(tbert.build_parser, SMALL + [
        "--vocab", "257", "--batch-size", "4", "--steps", "5",
        "--seq-len", "256", "--data-file", corpus], tmp_path, "t", True)
    tbert.run(args)
    assert len(copied) == 1 + 5  # the template, then one a step
    steps = copied[1:]
    _, prov = _captured(monkeypatch, tbert, tbert.run, args)
    for step, arrays in enumerate(steps):
        for got, want in zip(arrays, prov(step)):
            np.testing.assert_array_equal(got, want)


def test_resume_replays_the_stream_bit_exact(tmp_path, corpus):
    """Preempted after a checkpoint at step 2, the rerun continues the
    stream at step 2 and lands bit-identical to an uninterrupted 5-step
    run: losses, params and moments."""
    def run(steps, interval, name):
        return tbert.run(_parse(tbert.build_parser, SMALL + [
            "--vocab", "257", "--batch-size", "4", "--seq-len", "128",
            "--steps", str(steps), "--checkpoint-interval", str(interval),
            "--warmup-steps", "2", "--data-file", corpus],
            tmp_path, name, True))

    straight = run(5, 0, "straight")
    run(3, 2, "resumed")  # checkpoint at step 2 only
    resumed = run(5, 2, "resumed")
    assert len(resumed["losses"]) == 3
    assert resumed["losses"] == straight["losses"][2:]
    a = straight["state"]["model"].state_dict()
    b = resumed["state"]["model"].state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    sa = straight["state"]["opt"].state_dict()["state"]
    sb = resumed["state"]["opt"].state_dict()["state"]
    for k in sa:
        assert torch.equal(sa[k]["exp_avg"], sb[k]["exp_avg"]), k


def test_module_entry_point_trains_a_bpe_corpus(tmp_path, corpus, capsys):
    """``python -m tpujob_torch.workloads.gpt`` on a corpus with a
    tokenizer it trains itself (``bpe:PATH:V``)."""
    assert tgpt.main(SMALL + [
        "--device", "cpu", "--vocab", "290", "--batch-size", "2",
        "--steps", "2", "--attention", "flash", "--data-file", corpus,
        "--tokenizer", f"bpe:{tmp_path}/tok.json:290",
        "--dir", str(tmp_path / "logs")]) == 0
    out = capsys.readouterr().out
    assert "trained BPE tokenizer (290 ids)" in out and "gpt(h64xl2):" in out
