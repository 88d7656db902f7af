"""The port's training core (``tpujob_torch.workloads.train_lib``) and
bootstrap (``distributed``, ``data``) against the JAX package's.

AdamW and the learning-rate schedules are held against optax over three
updates on the same numpy params and grads, at 1e-6 in fp32 (torch
computes sqrt(nu)/sqrt(bc2) where optax computes sqrt(nu/bc2): a few ulp).
Gradient accumulation is held against ``optax.MultiSteps`` the same way
(1e-6 after every mini-step), and a whole accumulated ``bert.run`` against
the JAX package's from the same weights at 1e-5 (fp32).
Checkpoint resume must be step-exact: bit-identical to an uninterrupted
run on the CPU, mid-accumulation included.
"""
import json
import os
import time

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import jax
from jax.sharding import Mesh

from tpujob.workloads import bert as jbert
from tpujob.workloads import data as jdata
from tpujob.workloads import distributed as jdist
from tpujob.workloads import train_lib as jtl
from tpujob_torch.workloads import bert as tbert
from tpujob_torch.workloads import convert, data, distributed
from tpujob_torch.workloads import gpt as tgpt
from tpujob_torch.workloads import train_lib

SCHEDULES = [("constant", 0), ("constant", 2), ("cosine", 0), ("cosine", 2)]
SHAPES = {"w": (4, 3), "emb": (5, 4), "b": (3,), "scale": (4,)}


@pytest.mark.parametrize("kind,warmup", SCHEDULES)
def test_lr_schedule_values_match_optax(kind, warmup):
    total = 7
    ours = train_lib.make_lr_schedule(2e-3, kind, warmup, total)
    ref = jtl.make_lr_schedule(2e-3, kind, warmup, total)
    for count in range(total + 3):
        want = float(ref(count)) if callable(ref) else ref
        np.testing.assert_allclose(ours(count), want, rtol=1e-6, atol=1e-12,
                                   err_msg=f"count {count}")


@pytest.mark.parametrize("kind,warmup", SCHEDULES)
def test_adamw_matches_optax_three_updates(kind, warmup):
    """optax.adamw(schedule, mask=ndim>=2) and the port's AdamW + schedule
    take the same three steps."""
    rng = np.random.RandomState(0)
    init = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(3)]

    opt = jtl.adamw(jtl.make_lr_schedule(1e-2, kind, warmup, 5))
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = opt.init(jp)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in init.items()}
    topt = train_lib.adamw(tp.values(), 1e-2)
    lr_fn = train_lib.make_lr_schedule(1e-2, kind, warmup, 5)
    for count, g in enumerate(grads):
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                    state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        train_lib.set_lr(topt, lr_fn(count))
        topt.step()
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{k} step {count}")


@pytest.mark.parametrize("kind,warmup", [("constant", 2), ("cosine", 0)])
def test_grad_accum_matches_optax_multisteps(kind, warmup):
    """make_train_step with a GradAccum against optax.MultiSteps(adamw, 2)
    over six mini-steps with a different gradient each (the loss sum(p*g)
    has gradient g exactly): params after every mini-step (unchanged on the
    odd ones), and the update count."""
    rng = np.random.RandomState(1)
    init = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(6)]
    opt = jtl.with_grad_accum(
        jtl.adamw(jtl.make_lr_schedule(1e-2, kind, warmup // 2, 3)), 2)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    state = opt.init(jp)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in init.items()}
    topt = train_lib.adamw(tp.values(), 1e-2)
    accum = train_lib.with_grad_accum(tp.values(), 2)
    lr_fn = train_lib.make_lr_schedule(1e-2, kind, warmup // 2, 3)

    def loss_fn(g):
        return sum((tp[k] * torch.from_numpy(g[k])).sum() for k in tp)

    step = train_lib.make_train_step(loss_fn, topt, lr_fn, accum)
    tstate = {"step": 0}
    for n, g in enumerate(grads):
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                    state, jp)
        jp = optax.apply_updates(jp, updates)
        before = {k: p.detach().clone() for k, p in tp.items()}
        tstate, _ = step(tstate, g)
        assert tstate["step"] == n + 1
        if n % 2 == 0:
            assert all(torch.equal(before[k], tp[k]) for k in tp)
        assert accum.gradient_step == int(state.gradient_step) == (n + 1) // 2
        assert accum.mini_step == int(state.mini_step)
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{k} mini {n}")


def test_with_grad_accum_plain_and_invalid():
    params = [torch.nn.Parameter(torch.zeros(2))]
    assert train_lib.with_grad_accum(params, 1) is None
    assert train_lib.with_grad_accum(params, 3).every == 3
    for bad in (0, -2):
        with pytest.raises(ValueError, match="must be >= 1"):
            train_lib.with_grad_accum(params, bad)


def test_decay_mask_groups_by_ndim():
    params = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES.values()]
    opt = train_lib.adamw(params, 1e-3)
    decay, no_decay = opt.param_groups
    assert decay["weight_decay"] == 0.01 and no_decay["weight_decay"] == 0.0
    assert [p.ndim for p in decay["params"]] == [2, 2]
    assert [p.ndim for p in no_decay["params"]] == [1, 1]


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown lr schedule"):
        train_lib.make_lr_schedule(1e-3, "linear", 0, 10)


def test_summary_writer_jsonl(tmp_path):
    w = train_lib.SummaryWriter(str(tmp_path), enabled=True)
    w.add_scalar("loss", 1.5, 3)
    w.close()
    rec = json.loads((tmp_path / "scalars.jsonl").read_text())
    assert (rec["tag"], rec["value"], rec["step"]) == ("loss", 1.5, 3)
    off = train_lib.SummaryWriter(str(tmp_path / "off"), enabled=False)
    off.add_scalar("loss", 1.0, 0)
    assert not (tmp_path / "off").exists()


def test_checkpointer_latest_and_max_to_keep(tmp_path):
    ck = train_lib.Checkpointer(str(tmp_path / "ckpt"), max_to_keep=2)
    assert ck.latest_step() is None
    assert ck.restore_latest({"step": 0}) == (None, {"step": 0})
    lin = torch.nn.Linear(2, 2)
    for step in (2, 4, 6):
        with torch.no_grad():
            lin.weight.fill_(step)
        ck.save(step, {"model": lin, "step": step})
    assert ck.latest_step() == 6
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["4", "6"]
    fresh = torch.nn.Linear(2, 2)
    step, state = ck.restore_latest({"model": fresh, "step": 0})
    assert step == 6 and state["step"] == 6 and state["model"] is fresh
    assert torch.all(fresh.weight == 6)


ARGV = ["--hidden", "32", "--layers", "2", "--heads", "2",
        "--intermediate", "64", "--vocab", "97", "--seq-len", "16",
        "--batch-size", "2", "--attention", "flash", "--device", "cpu",
        "--lr", "3e-3", "--warmup-steps", "3"]


def _run(tmp_path, steps, interval=0, name="run"):
    args = tgpt.build_parser().parse_args(
        ARGV + ["--steps", str(steps), "--checkpoint-interval", str(interval),
                "--dir", str(tmp_path / name)])
    return tgpt.run(args)


def test_resume_is_step_exact(tmp_path):
    """Preempted after a checkpoint at step 4, the rerun resumes there and
    lands bit-identical to an uninterrupted 6-step run (params, moments,
    schedule position).  The schedule is a warmed-up constant: a cosine
    decays over --steps, so runs with different --steps differ by design,
    in the JAX package too."""
    straight = _run(tmp_path, 6, name="straight")
    _run(tmp_path, 4, interval=2, name="resumed")
    resumed = _run(tmp_path, 6, interval=2, name="resumed")
    assert resumed["losses"] == straight["losses"][4:]
    a = straight["state"]["model"].state_dict()
    b = resumed["state"]["model"].state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_already_complete_reports_without_training(tmp_path, capsys):
    _run(tmp_path, 2, interval=2)
    res = _run(tmp_path, 2, interval=2)
    assert "already complete: resumed at step 2 >= --steps 2" in \
        capsys.readouterr().out
    assert res["losses"] == [] and np.isfinite(res["final_loss"])


ACCUM_ARGV = ["--hidden", "32", "--layers", "2", "--heads", "2",
              "--intermediate", "64", "--vocab", "211", "--seq-len", "16",
              "--batch-size", "2", "--no-bf16", "--lr", "3e-3",
              "--log-interval", "1"]


def test_grad_accum_equals_plain_run_and_jax(tmp_path, monkeypatch):
    """With the same batch every mini-step, --grad-accum 2 over 4 steps
    applies the 2 updates of a plain 2-step run (bit for bit: the mean of
    two equal grads is exact), and lands where the JAX package's
    accumulated run does from the same weights (fp32, 1e-5)."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    ja = jbert.build_parser().parse_args(
        ACCUM_ARGV + ["--steps", "4", "--grad-accum", "2",
                      "--dir", str(tmp_path / "j")])
    jres = jbert.run(ja, mesh)
    assert int(jres["state"]["opt"].gradient_step) == 2
    init = {"params": jbert.build_model(ja, mesh).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))["params"]}
    build = tbert.build_model
    monkeypatch.setattr(tbert, "build_model", lambda *a, **kw:
                        _with_weights(build(*a, **kw), init))

    def run(steps, accum, name):
        return tbert.run(tbert.build_parser().parse_args(
            ACCUM_ARGV + ["--device", "cpu", "--steps", str(steps),
                          "--grad-accum", str(accum),
                          "--dir", str(tmp_path / name)]))

    plain, acc = run(2, 1, "plain"), run(4, 2, "accum")
    assert acc["state"]["accum"].gradient_step == 2
    assert acc["state"]["step"] == 4
    opt_steps = {int(s["step"]) for s in acc["state"]["opt"].state.values()}
    assert opt_steps == {2}
    # the loss is each mini-step's own, unscaled
    assert acc["losses"][0::2] == plain["losses"]
    assert acc["losses"][1::2] == plain["losses"]
    a = plain["state"]["model"].state_dict()
    b = acc["state"]["model"].state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    want = convert.params_from_flax(jax.tree.map(
        np.asarray, jres["state"]["params"]))
    for name, p in acc["state"]["model"].named_parameters():
        if name.endswith("attn.key.bias"):
            continue  # exact gradient 0: Adam normalises rounding noise
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def _with_weights(model, params):
    model.load_state_dict(convert.params_from_flax(
        jax.tree.map(np.asarray, params)), strict=True)
    return model


@pytest.mark.parametrize("extra,match", [
    (["--steps", "5", "--grad-accum", "2"], "multiple of --grad-accum"),
    (["--steps", "4", "--grad-accum", "4", "--lr-schedule", "cosine",
      "--warmup-steps", "2"], "--warmup-steps 2 must be a multiple"),
])
def test_grad_accum_divisibility_errors(extra, match, tmp_path):
    args = tbert.build_parser().parse_args(
        ACCUM_ARGV + ["--device", "cpu", "--dir", str(tmp_path)] + extra)
    with pytest.raises(ValueError, match=match):
        tbert.run(args)


def test_resume_mid_accumulation_is_step_exact(tmp_path):
    """A checkpoint at step 3 of accumulation 2 falls inside a group: it
    holds the running mean and the mini-step, and the rerun lands bit for
    bit where an uninterrupted 8-step run does."""
    def run(steps, interval, name):
        return tbert.run(tbert.build_parser().parse_args(
            ACCUM_ARGV + ["--device", "cpu", "--steps", str(steps),
                          "--grad-accum", "2", "--warmup-steps", "2",
                          "--checkpoint-interval", str(interval),
                          "--dir", str(tmp_path / name)]))

    straight = run(8, 0, "straight")
    run(4, 3, "resumed")  # checkpoint at 3 only: mid-group
    saved = torch.load(tmp_path / "resumed" / "ckpt" / "3" / "state.pt",
                       weights_only=True)
    assert saved["accum"]["mini_step"] == 1
    assert saved["accum"]["gradient_step"] == 1
    assert any(a.abs().sum() > 0 for a in saved["accum"]["acc"])
    resumed = run(8, 3, "resumed")
    assert resumed["losses"] == straight["losses"][3:]
    a = straight["state"]["model"].state_dict()
    b = resumed["state"]["model"].state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert resumed["state"]["accum"].gradient_step == 4


def test_profile_dir_writes_trace_and_leaves_it_out_of_the_clock(
        tmp_path, monkeypatch):
    """--profile-dir writes one torch.profiler Chrome trace of the window
    on the CPU; the time spent writing it (made 2 s longer here) is in
    ``profile_overhead_s`` and not in ``wall_s``."""
    write = train_lib.Profiler._write

    def slow_write(self, prof):
        write(self, prof)
        time.sleep(2.0)

    monkeypatch.setattr(train_lib.Profiler, "_write", slow_write)
    stamps = []
    res = tbert.run(tbert.build_parser().parse_args(
        ACCUM_ARGV + ["--device", "cpu", "--steps", "6",
                      "--profile-dir", str(tmp_path / "trace"),
                      "--profile-start-step", "1", "--profile-steps", "2",
                      "--dir", str(tmp_path / "logs")]),
        on_step=lambda i: stamps.append(time.perf_counter()))
    files = os.listdir(tmp_path / "trace")
    assert files == ["trace_steps1-2.pt.trace.json"]
    trace = json.loads((tmp_path / "trace" / files[0]).read_text())
    assert trace["traceEvents"]
    assert res["profile_overhead_s"] >= 2.0
    # the window closed at the top of step 3, inside the clock
    assert stamps[3] - stamps[2] >= 2.0
    assert res["wall_s"] < stamps[-1] - stamps[0]


def test_profiler_off_without_dir_and_closes_an_open_window(tmp_path):
    off = train_lib.Profiler(None, start_step=0, num_steps=1, enabled=True)
    off.step(0)
    off.close()
    assert off.path is None and off.overhead_s == 0.0
    prof = train_lib.Profiler(str(tmp_path), start_step=0, num_steps=5,
                              enabled=True)
    prof.step(0)
    torch.ones(4).sum()
    prof.close()  # a short run: the window is still open
    assert os.path.exists(prof.path) and not prof.enabled
    prof.step(1)  # one window a run
    assert os.listdir(tmp_path) == [os.path.basename(prof.path)]


def test_synthetic_batch_matches_reference():
    np.testing.assert_array_equal(data.synthetic_token_batch(4, 16, 211, seed=3),
                                  jdata.synthetic_token_batch(4, 16, 211, seed=3))


def test_token_batches_slices_this_process_rows():
    args = tgpt.build_parser().parse_args(ARGV + ["--batch-size", "4"])
    pe = distributed.process_env({"WORLD_SIZE": "2", "RANK": "1"})
    local, provider, sample = tbert.token_batches(args, pe)
    full = data.synthetic_token_batch(4, 16, 97)
    np.testing.assert_array_equal(local, full[2:4])
    np.testing.assert_array_equal(sample, full[0:1])
    assert provider is None


@pytest.mark.parametrize("env", [
    {},
    {"WORLD_SIZE": "4", "RANK": "2", "MASTER_ADDR": "m", "MASTER_PORT": "1"},
    {"TPUJOB_NUM_PROCESSES": "8", "TPUJOB_PROCESS_ID": "3",
     "TPUJOB_COORDINATOR_ADDRESS": "c:9", "TPUJOB_NUM_SLICES": "2",
     "TPUJOB_SLICE_ID": "1", "TPU_ACCELERATOR_TYPE": "v4-16"},
])
def test_process_env_matches_reference(env):
    import dataclasses

    ours = dataclasses.asdict(distributed.process_env(env))
    want = dataclasses.asdict(jdist.process_env(env))
    # the port's own field: no launcher in these envs, so local rank 0
    assert ours.pop("local_rank") == 0
    assert ours == want
    assert distributed.local_batch_slice(8, distributed.process_env(env)) == \
        jdist.local_batch_slice(8, jdist.process_env(env))


def test_initialize_single_process_and_rejects_multi():
    """One process makes no group; a multi-process env without a
    coordinator to rendezvous at is refused before any group is made."""
    assert distributed.initialize(distributed.process_env({})).num_processes == 1
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="needs a coordinator"):
        distributed.initialize(distributed.process_env({"WORLD_SIZE": "2"}))
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="not divisible"):
        distributed.local_batch_slice(3, distributed.process_env({"WORLD_SIZE": "2"}))
