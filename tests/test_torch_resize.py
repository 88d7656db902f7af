"""Elastic resize, the workload half (``tpujob_torch.workloads.distributed``)
against the JAX package's, on the CPU.

- ``plan_resize`` gives the JAX package's answer on every combination of
  a small table (process id, world, committed world, drain target) and on
  hypothesis-drawn ones; ``parse_downward_annotations`` and
  ``parse_world_signal`` (through ``read_world_signal``) on generated
  downward-API annotation text.  The constants are the JAX package's.
- ``reinitialize`` refuses a drained process before it tears anything
  down: the live group still works.
- A 2 -> 1 shrink: two gloo ranks train GPT to a checkpoint, the drain
  signal plans checkpoint / leave, rank 1 leaves, rank 0 re-initializes
  at world 1 and resumes from the latest checkpoint; its losses equal a
  one-process run resumed from the same file (1e-6 relative: the same
  code on the same file, only the thread count differs).
"""
import dataclasses
import itertools
import json
import shutil

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_spawn import shrink_ranks, spawn
from tpujob.api import constants as c
from tpujob.workloads import distributed as jdist
from tpujob_torch.workloads import distributed as dist
from tpujob_torch.workloads import gpt as tgpt

KEYS = (dist.ANNOTATION_WORLD_SIZE, dist.ANNOTATION_TARGET_WORLD_SIZE,
        dist.ANNOTATION_RESIZE_GENERATION)


def test_constants_are_the_jax_packages():
    assert KEYS == (c.ANNOTATION_WORLD_SIZE, c.ANNOTATION_TARGET_WORLD_SIZE,
                    c.ANNOTATION_RESIZE_GENERATION)
    assert dist.RESIZE_SIGNAL_ENV == jdist.RESIZE_SIGNAL_ENV
    assert (dist.PLAN_CHECKPOINT, dist.PLAN_LEAVE, dist.PLAN_REJOIN) == \
        (jdist.PLAN_CHECKPOINT, jdist.PLAN_LEAVE, jdist.PLAN_REJOIN)


def _both(pid, num, world, target, gen=0):
    env = {"TPUJOB_NUM_PROCESSES": str(num), "TPUJOB_PROCESS_ID": str(pid)}
    return (dist.plan_resize(dist.process_env(env),
                             dist.WorldSignal(world, target, gen)),
            jdist.plan_resize(jdist.process_env(env),
                              jdist.WorldSignal(world, target, gen)))


def test_plan_resize_matches_jax_on_the_table():
    seen = set()
    for pid, num, world, target in itertools.product(
            range(5), range(1, 5), range(1, 5), [None, 1, 2, 3, 4]):
        if pid >= max(num, world, target or 0) + 1:
            continue
        ours, want = _both(pid, num, world, target)
        assert ours == want, (pid, num, world, target)
        seen.add(ours)
    assert seen == {None, dist.PLAN_CHECKPOINT, dist.PLAN_LEAVE,
                    dist.PLAN_REJOIN}
    env = dist.process_env({"TPUJOB_NUM_PROCESSES": "2"})
    assert dist.plan_resize(env, None) is None


@settings(max_examples=200, deadline=None)
@given(st.integers(0, 64), st.integers(1, 64), st.integers(1, 64),
       st.one_of(st.none(), st.integers(0, 64)), st.integers(0, 9))
def test_plan_resize_matches_jax_on_generated_signals(pid, num, world,
                                                      target, gen):
    ours, want = _both(pid, num, world, target, gen)
    assert ours == want


_value = st.one_of(st.integers(-3, 99).map(str),
                   st.text(alphabet='ab1 "\\\n\t=', max_size=8),
                   st.just(""))
_key = st.sampled_from(KEYS + ("tpujob.dev/other", "app"))
# the kubelet writes ``key="value"`` with the value Go-quoted (ASCII here,
# where JSON's string escapes are Go's); a bare ``key=value`` is read too
_line = st.tuples(_key, _value, st.booleans()).map(
    lambda kv: f"{kv[0]}={json.dumps(kv[1])}" if kv[2]
    else f"{kv[0]}=" + kv[1].replace("\n", " ").replace('"', ""))


@settings(max_examples=300, deadline=None)
@given(st.lists(_line, max_size=6), st.integers(1, 8))
def test_signal_parsers_match_jax_on_generated_annotations(lines, default):
    text = "\n".join(lines)
    ann = dist.parse_downward_annotations(text)
    assert ann == jdist.parse_downward_annotations(text)
    assert dataclasses.astuple(dist.parse_world_signal(ann, default)) == \
        dataclasses.astuple(jdist.parse_world_signal(ann, default))


def test_read_world_signal_matches_jax(tmp_path, monkeypatch):
    path = tmp_path / "annotations"
    path.write_text(f'{KEYS[0]}="3"\n{KEYS[1]}="2"\n{KEYS[2]}="5"\n'
                    'kubectl.kubernetes.io/x="a\\"b"\n')
    sig = dist.read_world_signal(str(path), default_world=4)
    assert dataclasses.astuple(sig) == (3, 2, 5) == dataclasses.astuple(
        jdist.read_world_signal(str(path), default_world=4))
    assert sig.drain_pending
    monkeypatch.setenv(dist.RESIZE_SIGNAL_ENV, str(path))
    monkeypatch.setenv("TPUJOB_NUM_PROCESSES", "3")
    assert dataclasses.astuple(dist.read_world_signal()) == (3, 2, 5)
    assert dist.read_world_signal(str(tmp_path / "missing")) is None
    monkeypatch.delenv(dist.RESIZE_SIGNAL_ENV)
    assert dist.read_world_signal() is None


def test_reinitialize_refuses_a_drained_process_and_keeps_the_group():
    pe = dist.process_env({})
    dist.init_group(pe)  # a live one-process group on an in-memory store
    try:
        drained = dist.process_env({"TPUJOB_NUM_PROCESSES": "2",
                                    "TPUJOB_PROCESS_ID": "1"})
        with pytest.raises(ValueError, match="drained process must exit"):
            dist.reinitialize(drained, 1)
        assert torch.distributed.is_initialized()
        x = torch.ones(2)
        torch.distributed.all_reduce(x)
        assert x.tolist() == [1.0, 1.0]
    finally:
        dist.shutdown()
    assert not torch.distributed.is_initialized()
    dist.shutdown()  # no group: a no-op


SMALL = ["--hidden", "64", "--layers", "2", "--heads", "4", "--intermediate",
         "128", "--vocab", "211", "--seq-len", "64", "--batch-size", "4",
         "--no-bf16", "--lr", "3e-3", "--log-interval", "1", "--device",
         "cpu", "--checkpoint-interval", "2"]


def _signal(path, **ann):
    path.write_text("".join(f'{k}="{v}"\n' for k, v in ann.items()))
    return str(path)


def test_two_to_one_shrink_resumes_from_the_checkpoint(tmp_path):
    run_dir = tmp_path / "t"
    first = SMALL + ["--steps", "2", "--dir", str(run_dir)]
    resume = SMALL + ["--steps", "4", "--dir", str(run_dir)]
    args = tgpt.build_parser().parse_args(first)
    init = {k: v.clone() for k, v in
            tgpt.build_model(args, torch.device("cpu")).state_dict().items()}
    draining = _signal(tmp_path / "draining", **{KEYS[0]: 2, KEYS[1]: 1,
                                                 KEYS[2]: 0})
    committed = _signal(tmp_path / "committed", **{KEYS[0]: 1, KEYS[2]: 1})
    outs = spawn(shrink_ranks, 2, tmp_path, first, init, resume, draining,
                 committed)
    r0, r1 = outs
    assert r0["plan_draining"] == dist.PLAN_CHECKPOINT
    assert r1["plan_draining"] == dist.PLAN_LEAVE
    assert r1["refused"] and r1["group_live"] and r1["goodbye"] == 2.0
    assert r0["plan_committed"] == dist.PLAN_REJOIN
    assert r0["new"] == (1, 0, False)  # one process: no group
    assert len(r0["first"]["losses"]) == 2 and len(r0["resumed"]) == 2

    # one process resumed from a copy of the same file
    alone = tmp_path / "alone"
    shutil.copytree(run_dir / "ckpt" / "2", alone / "ckpt" / "2")
    res = tgpt.run(tgpt.build_parser().parse_args(
        SMALL + ["--steps", "4", "--dir", str(alone)]))
    np.testing.assert_allclose(r0["resumed"], res["losses"], rtol=1e-6)
