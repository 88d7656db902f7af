"""FSDP (ZeRO-3, through FSDP2's ``fully_shard``) in the port against the
JAX package, on the CPU.

``gpt.run`` and ``bert.run`` for 3 steps under ``--fsdp 2``, fsdp 2 x
tensor 2, and fsdp 2 x sequence 2 with Ulysses on the flash kernels
(their plain versions here; the JAX package's in Pallas interpret mode)
and, for GPT, on the ring,
each rank loading its tensor blocks of the JAX package's initial weights
before FSDP shards them, against the JAX package's ``run`` on the same
mesh of virtual CPU devices: losses 1e-4 relative, the parameters after
step 3 gathered whole within 1e-4 (``test_torch_tp.check_runs``), and
each rank holding 1/2 of its tensor group's parameters and of AdamW's
moments (the port's form of the JAX package's "moments must shard too").
Decode on the sharded model, as under TP.  Then checkpoints across layouts: a run under fsdp 2 x tensor 2 writes
its step-2 checkpoint whole and one process resumes it, and the reverse;
each resumed step 3 is the uninterrupted run's (losses 1e-4 relative,
parameters 1e-4).
"""
import re

import numpy as np
import pytest

from test_torch_spawn import shard_trainer_ranks, spawn
from test_torch_tp import (JMODULES, SMALL, TP, ZERO_GRAD, ZERO_GRAD_ATOL,
                           check_decode, check_runs, flax_init, jax_run,
                           port)
from tpujob_torch.workloads import bert as tbert
from tpujob_torch.workloads import convert

FSDP = ["--fsdp", "2"]
ULYSSES_FLASH = ["--sequence-parallel", "2", "--sp-mode", "ulysses",
                 "--attention", "flash"]
RING = ["--sequence-parallel", "2"]
CKPT = ["--checkpoint-interval", "2"]

# name -> (trainer, flags, the JAX package's mesh)
CASES = {
    "gpt_fsdp": ("gpt", FSDP, {"data": 1, "fsdp": 2}),
    "bert_fsdp": ("bert", FSDP, {"data": 1, "fsdp": 2}),
    "gpt_fsdp_tp": ("gpt", FSDP + TP, {"data": 1, "fsdp": 2, "tensor": 2}),
    "bert_fsdp_tp": ("bert", FSDP + TP, {"data": 1, "fsdp": 2, "tensor": 2}),
    "gpt_fsdp_ulysses": ("gpt", FSDP + ULYSSES_FLASH,
                         {"data": 1, "fsdp": 2, "sequence": 2}),
    "bert_fsdp_ulysses": ("bert", FSDP + ULYSSES_FLASH,
                          {"data": 1, "fsdp": 2, "sequence": 2}),
}


@pytest.fixture(scope="module")
def jax_fsdp(tmp_path_factory):
    """Each case's JAX run (losses and parameters after it) and the
    weights it starts from."""
    out = {}
    for key, (name, flags, axes) in CASES.items():
        argv = SMALL + flags
        jm = JMODULES[name]
        out[key] = (jax_run(jm, argv, axes, tmp_path_factory.mktemp(key)),
                    flax_init(jm, argv))
    return out


def one_process(argv, tree):
    """``gpt.run`` of ``argv`` in this process from the flax weights
    ``tree``: its losses and its parameters after the run."""
    from tpujob_torch.workloads import gpt as tgpt

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
    return res["losses"], {n: p.detach().numpy().copy()
                           for n, p in res["state"]["model"].named_parameters()}


def assert_params_close(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        tol = ZERO_GRAD_ATOL if re.search(ZERO_GRAD, k) else 1e-4
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=tol,
                                   err_msg=k)


def test_runs_at_fsdp_2_match_jax(tmp_path, jax_fsdp):
    """Both trainers at fsdp 2 (each rank half the rows and half of every
    parameter and moment), GPT decoding 4 tokens after training: every
    rank decodes global row 0's prompt on the sharded model, to one
    process's tokens from the same weights."""
    keys = ["gpt_fsdp", "bert_fsdp"]
    outs = spawn(shard_trainer_ranks, 2, tmp_path, [
        (CASES[k][0], port(SMALL + CASES[k][1] + (
            ["--generate", "4"] if k == "gpt_fsdp" else []), tmp_path / k),
         jax_fsdp[k][1]) for k in keys])
    for i, k in enumerate(keys):
        (jlosses, jparams), _ = jax_fsdp[k]
        check_runs([o[i] for o in outs], jlosses, jparams, shards=2)
    check_decode([o[0] for o in outs], tmp_path)


@pytest.fixture(scope="module")
def world_4(tmp_path_factory, jax_fsdp):
    """Four ranks: the fsdp 2 x tensor 2 and fsdp 2 x sequence 2 cases
    (GPT's fsdp x tensor run checkpointing at step 2 as it goes), after a
    one-process GPT run checkpointing at step 2 whose checkpoint the last
    of the four-rank runs resumes under fsdp 2 x tensor 2."""
    tmp = tmp_path_factory.mktemp("world_4")
    tree = jax_fsdp["gpt_fsdp_tp"][1]
    one = one_process(port(SMALL + CKPT, tmp / "one"), tree)
    runs = [(CASES[k][0], port(SMALL + CASES[k][1]
                               + (CKPT if k == "gpt_fsdp_tp" else []),
                               tmp / k), jax_fsdp[k][1])
            for k in ("gpt_fsdp_tp", "bert_fsdp_tp", "gpt_fsdp_ulysses",
                      "bert_fsdp_ulysses")]
    runs.append(("gpt", port(SMALL + FSDP + TP + CKPT, tmp / "one"), tree))
    runs.append(("gpt", port(SMALL + FSDP + RING, tmp / "gpt_fsdp_ring"),
                 jax_fsdp["gpt_fsdp_ulysses"][1]))
    return tmp, one, spawn(shard_trainer_ranks, 4, tmp, runs)


def test_runs_at_world_4_match_jax(jax_fsdp, world_4):
    """fsdp 2 x tensor 2 (each rank half of its tensor blocks) and fsdp 2
    x sequence 2 under Ulysses on the flash kernels, for both trainers;
    and GPT at fsdp 2 x sequence 2 on the ring (the zigzag layout), held
    to the JAX package's Ulysses run (the same function:
    ``tests/test_torch_sp.py`` holds the two attentions to each other
    shard by shard; the JAX ring compiles much more slowly on the
    CPU)."""
    _, _, outs = world_4
    for i, k in ((0, "gpt_fsdp_tp"), (1, "bert_fsdp_tp"),
                 (2, "gpt_fsdp_ulysses"), (3, "bert_fsdp_ulysses"),
                 (5, "gpt_fsdp_ulysses")):
        (jlosses, jparams), _ = jax_fsdp[k]
        check_runs([o[i] for o in outs], jlosses, jparams, shards=2)


def test_checkpoints_resume_across_layouts(jax_fsdp, world_4):
    """fsdp 2 x tensor 2's step-2 checkpoint (written whole by rank 0)
    resumed at one process, and one process's resumed at fsdp 2 x tensor
    2: each resumed step 3 is the uninterrupted run's."""
    tmp, (one_losses, one_params), outs = world_4
    sharded = outs[0][0]
    # the restore overwrites the weights the build loads
    losses, params = one_process(port(SMALL + CKPT, tmp / "gpt_fsdp_tp"),
                                 jax_fsdp["gpt_fsdp_tp"][1])
    np.testing.assert_allclose(losses, sharded["losses"][2:], rtol=1e-4)
    assert_params_close(params, sharded["whole"])
    for o in outs:
        resumed = o[4]
        assert resumed["step"] == 3
        np.testing.assert_allclose(resumed["losses"], one_losses[2:],
                                   rtol=1e-4)
        assert_params_close(resumed["whole"], one_params)
