"""Both trainers under pipeline parallelism at two ranks in the port
against the JAX package, on the CPU.

``gpt.run`` and ``bert.run`` for 3 steps at ``--pipeline-parallel 2
--pipeline-microbatches 4`` (4 layers, 2 a stage) under each schedule,
each rank loading its stage's layers of the JAX package's initial weights
(``convert.params_from_flax`` over its mesh), against the JAX package's
``run`` with the same flags on a mesh of virtual CPU devices: losses 1e-4
relative, the parameters after step 3 (the stages' merged) within 1e-4
(``check_pipeline_runs``), each rank holding only its stage's layers and
their moments, and the parameters and gradients every stage holds
bit-equal across the stages.  1F1B equal to GPipe (losses 1e-5, the
parameters 1e-5), the microbatch count without effect, and GPT on the
flash kernels' plain versions (the JAX run on dense attention: the same
function) decoding 4 tokens through the pipeline.  Then the shared
parameters' gradients of step 1 against one process's, and checkpoints
across layouts: pipeline 2's step-2 checkpoint (written whole) resumed
at one process, and one process's resumed at pipeline 2; each resumed
step 3 is the uninterrupted run's (losses 1e-4 relative, parameters
1e-4).
"""
import re

import numpy as np
import pytest
import torch

from test_torch_fsdp import assert_params_close, one_process
from test_torch_spawn import shard_trainer_ranks, spawn
from test_torch_tp import (JMODULES, SMALL, ZERO_GRAD, ZERO_GRAD_ATOL,
                           flax_init, jax_run, port, update_err)
from tpujob_torch.workloads import bert as tbert
from tpujob_torch.workloads import convert
from tpujob_torch.workloads import gpt as tgpt
from tpujob_torch.workloads import parallel as tpar

LAYERS4 = SMALL + ["--layers", "4"]
PP = ["--pipeline-parallel", "2", "--pipeline-microbatches", "4"]
F1B = ["--pipeline-schedule", "1f1b"]
CKPT = ["--checkpoint-interval", "2"]

# name -> (trainer, flags, the JAX package's run it is held to)
CASES = {
    "gpt_gpipe": ("gpt", PP, "gpt_gpipe"),
    "gpt_1f1b": ("gpt", PP + F1B, "gpt_1f1b"),
    "bert_gpipe": ("bert", PP, "bert_gpipe"),
    "bert_1f1b": ("bert", PP + F1B, "bert_1f1b"),
    "gpt_gpipe_m2": ("gpt", ["--pipeline-parallel", "2",
                             "--pipeline-microbatches", "2"], "gpt_gpipe"),
    "gpt_1f1b_flash": ("gpt", PP + F1B + ["--attention", "flash",
                                          "--generate", "4"], "gpt_1f1b"),
}


@pytest.fixture(scope="module")
def jax_pp(tmp_path_factory):
    """The JAX package's runs (losses, parameters after step 3) and the
    weights each starts from."""
    out = {}
    for key in ("gpt_gpipe", "gpt_1f1b", "bert_gpipe", "bert_1f1b"):
        name, flags, _ = CASES[key]
        argv = LAYERS4 + flags
        jm = JMODULES[name]
        out[key] = (jax_run(jm, argv, {"data": 1, "pipeline": 2},
                            tmp_path_factory.mktemp(key)),
                    flax_init(jm, argv))
    return out


def merged(ranks) -> dict:
    """The parameters of every stage, one dict."""
    out = {}
    for r in ranks:
        out.update(r["whole"])
    return out


# Under TP the parameters are held normwise: ``update_err`` (the
# distance over how far the run moved them) within 1e-4, and every weight
# within AdamW's bound (``ZERO_GRAD_ATOL``).  The port's TP run without
# the pipeline (BERT, 4 layers, fp32) reads 7.5e-5 against the JAX
# package's TP run, with one weight of layer 3's out projection 1.3e-4
# from JAX's (a weight whose early gradients are near 0, where AdamW's
# normalised step turns rounding into a move; the JAX package's own TP
# and one-device runs read 2.9e-5 against each other); the pipeline moves
# the run 4.6e-7 (read on the CPU).
TP_UPDATE_RTOL = 1e-4


def check_pipeline_runs(ranks, jlosses, jparams, steps=3, init=None):
    """Every rank's losses (the same on all) within 1e-4 relative of
    JAX's; the stages' parameters after the run, merged, within 1e-4 of
    JAX's (the key biases within ``ZERO_GRAD_ATOL``; with ``init``, the
    initial parameters, as ``TP_UPDATE_RTOL`` says); each rank holding
    the shared parameters and exactly its stage's layers (under TP its
    blocks of them: ``param_numel``), and AdamW's moments of those only;
    the parameters and gradients every stage holds bit-equal on the
    ranks of each pipeline group."""
    for i, r in enumerate(ranks):
        assert r["step"] == steps and len(r["losses"]) == steps
        assert r["losses"] == ranks[0]["losses"]
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-4)
        group = r["pipeline_group"]
        stage, n = group.index(i), len(group)
        layers = sorted({int(re.match(r"layer_(\d+)\.", k).group(1))
                         for k in r["whole"] if k.startswith("layer_")})
        per = len({k.split(".")[0] for k in jparams
                   if k.startswith("layer_")}) // n
        assert layers == list(range(stage * per, (stage + 1) * per))
        tp = len(r["groups"]["tensor"])
        assert r["param_numel"] == sum(
            jparams[k].size // (tp if tpar.tp_dim(k) is not None else 1)
            for k in r["whole"])
        assert r["moment_numel"] == 2 * r["param_numel"]
        for peer in (ranks[j] for j in group):
            for k, v in r["replicated"].items():
                if not k.startswith("layer_"):
                    np.testing.assert_array_equal(peer["replicated"][k], v,
                                                  err_msg=k)
            assert set(peer["shared_grads"]) == set(r["shared_grads"])
            for k, g in r["shared_grads"].items():
                np.testing.assert_array_equal(peer["shared_grads"][k], g,
                                              err_msg=k)
    whole = merged(ranks)
    assert set(whole) == set(jparams)
    if init is not None:
        assert update_err(whole, jparams, init) <= TP_UPDATE_RTOL
    for k, v in jparams.items():
        tol = ZERO_GRAD_ATOL if init is not None or re.search(ZERO_GRAD, k) \
            else 1e-4
        np.testing.assert_allclose(whole[k], v, rtol=1e-4, atol=tol,
                                   err_msg=k)


def one_process_grads(argv, tree):
    """``gpt.run`` of ``argv`` (one step) in this process from ``tree``:
    its shared parameters' gradients."""
    build = tbert.build_model

    def built(args, device, **kw):
        model = build(args, device, **kw)
        model.load_state_dict(convert.params_from_flax(tree), strict=True)
        return model

    tbert.build_model = built
    try:
        res = tgpt.run(tgpt.build_parser().parse_args(argv))
    finally:
        tbert.build_model = build
    return {n: p.grad.numpy().copy()
            for n, p in res["state"]["model"].named_parameters()
            if not n.startswith("layer_")}


@pytest.fixture(scope="module")
def world_2(tmp_path_factory, jax_pp):
    """Every case at two ranks; then GPipe and 1F1B for one step (the
    shared gradients of step 1); then GPipe checkpointing at step 2 as it
    goes, and a pipeline run resuming a one-process run's step-2
    checkpoint (written here first)."""
    tmp = tmp_path_factory.mktemp("world_2")
    tree = jax_pp["gpt_gpipe"][1]
    one = one_process(port(LAYERS4 + CKPT, tmp / "one"), tree)
    runs = [(CASES[k][0], port(LAYERS4 + CASES[k][1], tmp / k),
             jax_pp[CASES[k][2]][1]) for k in CASES]
    for tag, sched in (("gpipe", []), ("1f1b", F1B)):
        runs.append(("gpt", port(LAYERS4 + PP + sched + ["--steps", "1"],
                                 tmp / f"step1_{tag}"), tree))
    runs.append(("gpt", port(LAYERS4 + PP + CKPT, tmp / "pp_ckpt"), tree))
    runs.append(("gpt", port(LAYERS4 + PP + F1B + CKPT, tmp / "one"), tree))
    return tmp, one, spawn(shard_trainer_ranks, 2, tmp, runs)


@pytest.mark.parametrize("key", list(CASES))
def test_runs_at_pipeline_2_match_jax(jax_pp, world_2, key):
    """Each trainer under each schedule (and GPipe at 2 microbatches, and
    1F1B on the flash kernels) against the JAX package's run."""
    _, _, outs = world_2
    i = list(CASES).index(key)
    (jlosses, jparams), _ = jax_pp[CASES[key][2]]
    check_pipeline_runs([o[i] for o in outs], jlosses, jparams)


def test_1f1b_equals_gpipe_and_microbatches_change_nothing(world_2):
    """The two schedules compute one function (the JAX package allows
    1e-3 between their losses; here 1e-5, and the parameters after 3
    steps within 1e-5), and so do 2 and 4 microbatches."""
    _, _, outs = world_2
    keys = list(CASES)
    for a, b in (("gpt_gpipe", "gpt_1f1b"), ("bert_gpipe", "bert_1f1b"),
                 ("gpt_gpipe", "gpt_gpipe_m2")):
        ra = [o[keys.index(a)] for o in outs]
        rb = [o[keys.index(b)] for o in outs]
        np.testing.assert_allclose(ra[0]["losses"], rb[0]["losses"],
                                   rtol=1e-5, err_msg=f"{a} {b}")
        wa, wb = merged(ra), merged(rb)
        for k, v in wa.items():
            tol = ZERO_GRAD_ATOL if re.search(ZERO_GRAD, k) else 1e-5
            np.testing.assert_allclose(wb[k], v, rtol=1e-5, atol=tol,
                                       err_msg=f"{a} {b} {k}")


def test_decode_through_the_pipeline(tmp_path, world_2):
    """``--generate 4`` under the pipeline (the full route through
    ``bert.pipeline_apply``): both stages decode the same tokens, one
    process's from the same weights."""
    _, _, outs = world_2
    i = list(CASES).index("gpt_1f1b_flash")
    tokens = [o[i]["generated"] for o in outs]
    assert tokens[0] == tokens[1] and len(tokens[0][0]) == 8 + 4
    one = tgpt.build_model(tgpt.build_parser().parse_args(
        port(LAYERS4, tmp_path)), "cpu")
    one.load_state_dict({k: torch.from_numpy(v) for k, v in
                         merged([o[i] for o in outs]).items()})
    prompt = torch.tensor(tokens[0])[:, :8]
    assert tgpt.generate_cached(one, prompt, 4).tolist() == tokens[0]


def test_shared_gradients_are_one_process_s(world_2, jax_pp):
    """Step 1's gradients of the parameters every stage holds (the tied
    embedding, the positions, ``ln_embed``, ``ln_f``): each the sum of
    the first stage's embedding part and the last stage's head part, the
    same on both stages (``check_pipeline_runs``) and one process's to
    fp32 rounding (the stages run microbatches of one row: other
    summation orders)."""
    tmp, _, outs = world_2
    want = one_process_grads(port(LAYERS4 + ["--steps", "1"], tmp / "g1"),
                             jax_pp["gpt_gpipe"][1])
    for j in (len(CASES), len(CASES) + 1):
        for o in outs:
            got = o[j]["shared_grads"]
            assert set(got) == set(want)
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=1e-5,
                                           atol=1e-7, err_msg=k)


def test_checkpoints_resume_across_pipeline_layouts(world_2, jax_pp):
    """Pipeline 2's step-2 checkpoint (the stages' layers and moments
    gathered whole by rank 0) resumed at one process, and one process's
    resumed at pipeline 2 under 1F1B: each resumed step 3 is the
    uninterrupted run's."""
    tmp, (one_losses, one_params), outs = world_2
    piped = [o[len(CASES) + 2] for o in outs]
    losses, params = one_process(port(LAYERS4 + CKPT, tmp / "pp_ckpt"),
                                 jax_pp["gpt_gpipe"][1])
    np.testing.assert_allclose(losses, piped[0]["losses"][2:], rtol=1e-4)
    assert_params_close(params, merged(piped))
    resumed = [o[len(CASES) + 3] for o in outs]
    for r in resumed:
        assert r["step"] == 3
        np.testing.assert_allclose(r["losses"], one_losses[2:], rtol=1e-4)
    assert_params_close(merged(resumed), one_params)
