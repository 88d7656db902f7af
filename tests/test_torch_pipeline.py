"""Pipeline parallelism's schedules in the port against the JAX package,
on the CPU.

The 1F1B timetable (``pipeline_schedule.build_1f1b_tables``) equal to the
JAX package's, array for array.  Then a stack of ``tanh(x @ w)`` layers
(the JAX package's ``TestPipeline`` / ``Test1F1B`` stack) over gloo
processes, at pipeline 4 and at data 2 x pipeline 2, each rank holding
its stage's layers and its rows, against the JAX package's
``parallel.pipeline`` and ``pipeline_schedule.pipeline_1f1b`` on a mesh
of virtual CPU devices from the same numpy draws:

- GPipe (``parallel.pipeline``): the output (1e-5), the grads of its sum
  for the layers (summed over a stage's data ranks) and the input
  (2e-4 / 2e-5, the JAX test's), ``skip_idle`` either way bit-equal, and
  the exchanges a forward makes;
- 1F1B (``pipeline_schedule.pipeline_1f1b``): the loss (1e-5) and the
  stage, head and input grads (2e-4 / 2e-5) equal to the JAX package's
  and to the port's fused GPipe (``pipeline_gpipe``), and the stash
  counted at every tick: at most ``stash_depth`` microbatches, the same
  at m 8 and m 32, where GPipe's holds all m;
- the JAX package's two ValueErrors, and its flag rules.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_spawn import pipeline_stack_ranks, spawn
from test_torch_tp import SMALL, jax_error
from tpujob.workloads import distributed as jdist
from tpujob.workloads import parallel as jpar
from tpujob.workloads import pipeline_schedule as jps
from tpujob_torch.workloads import bert as tbert
from tpujob_torch.workloads import gpt as tgpt
from tpujob_torch.workloads import parallel as tpar
from tpujob_torch.workloads import pipeline_schedule as tps


@pytest.mark.parametrize("n,m", [(2, 4), (4, 8), (3, 5), (2, 16), (8, 32)])
def test_tables_equal_jax(n, m):
    """Every field of the timetable is the JAX package's; the tick count
    is the optimal 2 (m + n - 1)."""
    want, got = jps.build_1f1b_tables(n, m), tps.build_1f1b_tables(n, m)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=f.name)
            assert b.dtype == a.dtype
        else:
            assert b == a, f.name
    assert got.ticks == 2 * (m + n - 1)


def test_stash_depth_depends_on_the_stages_only():
    assert (tps.build_1f1b_tables(2, 4).stash_depth
            == tps.build_1f1b_tables(2, 64).stash_depth == 3)
    with pytest.raises(ValueError, match="need n >= 1, m >= 1"):
        tps.build_1f1b_tables(2, 0)


def _stack(L=8, d=16, B=8, seed=0):
    rng = np.random.RandomState(seed)
    return dict(ws=(rng.randn(L, d, d) * 0.3).astype(np.float32),
                x=rng.randn(B, d).astype(np.float32),
                h=(rng.randn(d, 4) * 0.5).astype(np.float32),
                y=rng.randn(B, 4).astype(np.float32))


def _jax_stage(ws, xb):
    return jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), xb, ws)[0]


def _jax_head(h, yb, ex):
    return jnp.mean((yb @ h - ex) ** 2)


def _mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jdist.make_mesh(axes, env=jdist.process_env({}),
                           devices=jax.devices()[:n])


PP4, DP2_PP2 = {"pipeline": 4}, {"data": 2, "pipeline": 2}


def _cases():
    small, big = _stack(), _stack(B=32)
    out = {}
    for tag, axes in (("pp4", PP4), ("dp2_pp2", DP2_PP2)):
        for skip in (True, False):
            out[f"pipeline_{tag}_skip{skip}"] = dict(
                small, axes=axes, m=4 if tag == "pp4" else 2,
                skip_idle=skip, schedule="pipeline")
        for schedule in ("1f1b", "gpipe"):
            for m in (8, 32 if tag == "pp4" else 16):
                out[f"{schedule}_{tag}_m{m}"] = dict(
                    big, axes=axes, m=m, skip_idle=True, schedule=schedule)
    return out


@pytest.fixture(scope="module")
def stack_runs(tmp_path_factory):
    cases = _cases()
    ranks = spawn(pipeline_stack_ranks, 4, tmp_path_factory.mktemp("pp"),
                  cases)
    return cases, ranks


def _by_stage(ranks, name, key, reduce):
    """Each stage's ``key``, reduced over its data ranks, in stage
    order."""
    stages = {}
    for r in ranks:
        stages.setdefault(r[name]["stage"], []).append(r[name][key])
    return [reduce(stages[s]) for s in sorted(stages)]


def _rows(ranks, name, key, scale=1.0):
    """The ranks' per-row ``key`` of stage 0, assembled over the batch."""
    parts = sorted((r[name]["rows"][0], r[name][key]) for r in ranks
                   if r[name]["stage"] == 0)
    return np.concatenate([p for _, p in parts]) * scale


@pytest.mark.parametrize("tag,axes", [("pp4", PP4), ("dp2_pp2", DP2_PP2)])
def test_gpipe_matches_jax(stack_runs, tag, axes):
    """The output on every rank (its rows) and the layers' and input's
    grads of its sum, against the JAX package's ``parallel.pipeline`` and
    its grads."""
    cases, ranks = stack_runs
    name = f"pipeline_{tag}_skipTrue"
    c = cases[name]
    mesh = _mesh(axes)
    f = lambda ws, x: jpar.pipeline(_jax_stage, ws, x, mesh,  # noqa: E731
                                    num_microbatches=c["m"]).sum()
    y = np.asarray(jpar.pipeline(_jax_stage, c["ws"], c["x"], mesh,
                                 num_microbatches=c["m"]))
    dws, dx = (np.asarray(g) for g in jax.grad(f, (0, 1))(c["ws"], c["x"]))
    for r in ranks:
        lo, sz = r[name]["rows"]
        np.testing.assert_allclose(r[name]["o"], y[lo : lo + sz], rtol=1e-5,
                                   atol=1e-5)
        if r[name]["stage"]:
            assert not r[name]["dx"].any()  # only stage 0 reads the input
    n = axes["pipeline"]
    got = np.concatenate(_by_stage(ranks, name, "dw", sum))
    np.testing.assert_allclose(got, dws, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(_rows(ranks, name, "dx"), dx, rtol=2e-4,
                               atol=2e-5)
    assert got.shape[0] == n * (len(c["ws"]) // n)


@pytest.mark.parametrize("tag", ["pp4", "dp2_pp2"])
def test_skip_idle_changes_nothing(stack_runs, tag):
    """Skipping the bubble's compute is a schedule choice: the outputs
    and every grad bit-equal either way, and the same exchanges."""
    _, ranks = stack_runs
    for r in ranks:
        a, b = (r[f"pipeline_{tag}_skip{s}"] for s in (True, False))
        for key in ("o", "dw", "dx"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert a["exchanges"] == b["exchanges"]


@pytest.mark.parametrize("tag,axes", [("pp4", PP4), ("dp2_pp2", DP2_PP2)])
def test_gpipe_exchanges_carry_microbatches_only(stack_runs, tag, axes):
    """A forward's exchanges: one a tick in which the stage sends or
    receives a microbatch (m on the first and last stage, m + 1 on a
    middle one, which receives microbatch j + 1 as it sends j), and the
    output's broadcast; the JAX schedule's lock-step permutes every one of
    its m + n - 1 ticks.  The backward mirrors them."""
    cases, ranks = stack_runs
    name = f"pipeline_{tag}_skipTrue"
    m, n = cases[name]["m"], axes["pipeline"]
    for r in ranks:
        s = r[name]["stage"]
        ticks = m + (0 < s < n - 1)
        assert r[name]["forward_exchanges"] == ticks + 1
        assert r[name]["exchanges"] == 2 * ticks + 1


@pytest.mark.parametrize("tag,axes", [("pp4", PP4), ("dp2_pp2", DP2_PP2)])
def test_1f1b_matches_jax_and_gpipe(stack_runs, tag, axes):
    """The loss and the stage, head and input grads of ``pipeline_1f1b``
    against the JAX package's (its loss and grads are the global batch's:
    the port's rank values are averaged over a stage's data ranks, its
    input grads divided by their number), and the port's fused GPipe on
    the same inputs."""
    cases, ranks = stack_runs
    shards = axes.get("data", 1)
    c = cases[f"1f1b_{tag}_m8"]
    loss, dws, dh, dx = jax.jit(lambda ws, h, x: jps.pipeline_1f1b(
        _jax_stage, ws, x, _jax_head, h, c["y"], _mesh(axes),
        num_microbatches=8))(c["ws"], c["h"], c["x"])
    for schedule in ("1f1b", "gpipe"):
        name = f"{schedule}_{tag}_m8"
        last = [r[name] for r in ranks
                if r[name]["stage"] == axes["pipeline"] - 1]
        np.testing.assert_allclose(
            np.mean([r["loss"] for r in last]), float(loss), rtol=1e-5)
        np.testing.assert_allclose(
            np.mean([r["dh"] for r in last], axis=0), np.asarray(dh),
            rtol=2e-4, atol=2e-5)
        got = np.concatenate(_by_stage(
            ranks, name, "dw", lambda g: sum(g) / shards))
        np.testing.assert_allclose(got, np.asarray(dws), rtol=2e-4,
                                   atol=2e-5, err_msg=name)
        np.testing.assert_allclose(_rows(ranks, name, "dx", 1 / shards),
                                   np.asarray(dx), rtol=2e-4, atol=2e-5,
                                   err_msg=name)
        for r in ranks:  # the head runs on the last stage only
            assert (r[name]["dh"] is not None) == (
                r[name]["stage"] == axes["pipeline"] - 1)


@pytest.mark.parametrize("tag,axes", [("pp4", PP4), ("dp2_pp2", DP2_PP2)])
def test_1f1b_stash_is_bounded_by_the_stages(stack_runs, tag, axes):
    """Counted at every tick: a 1F1B stage holds at most ``stash_depth``
    microbatch activations, as many at m 32 (16 per data rank) as at m
    8; GPipe's holds all m.  The loss and grads do not depend on m."""
    cases, ranks = stack_runs
    n = axes["pipeline"]
    m_big = 32 if tag == "pp4" else 16
    t = tps.build_1f1b_tables(n, 8)
    for r in ranks:
        small, big = r[f"1f1b_{tag}_m8"], r[f"1f1b_{tag}_m{m_big}"]
        assert 1 <= small["stash_peak"] == big["stash_peak"] <= t.stash_depth
        assert big["cot_peak"] <= t.cot_depth
        assert r[f"gpipe_{tag}_m{m_big}"]["stash_peak"] == m_big
        np.testing.assert_allclose(big["dw"], small["dw"], rtol=2e-4,
                                   atol=2e-5)
    # the first stage holds the most (2n - 1: a microbatch stays until
    # its cotangent has come back down the pipeline)
    first = [r[f"1f1b_{tag}_m8"]["stash_peak"] for r in ranks
             if r[f"1f1b_{tag}_m8"]["stage"] == 0]
    assert first == [t.stash_depth] * len(first) == [2 * n - 1] * len(first)


def test_layout_value_errors_are_jax_s():
    """A stack that does not divide over the stages, a per-rank batch
    that does not divide into the microbatches: the JAX package's
    ValueErrors, word for word."""
    c = _stack(L=6)
    with pytest.raises(ValueError) as want:
        jpar.pipeline(_jax_stage, c["ws"], c["x"], _mesh(PP4))
    with pytest.raises(ValueError) as got:
        tpar.check_pipeline(6, 4, 8, 4)
    assert str(got.value) == str(want.value)
    c = _stack()
    with pytest.raises(ValueError) as want:
        jpar.pipeline(_jax_stage, c["ws"], c["x"], _mesh({"pipeline": 8}),
                      num_microbatches=3)
    with pytest.raises(ValueError) as got:
        tpar.check_pipeline(8, 8, 8, 3)
    assert str(got.value) == str(want.value)


PP = ["--pipeline-parallel", "2", "--layers", "4"]
# combinations the JAX package refuses with a ValueError: (flags, causal)
JAX_REFUSALS = {
    "1f1b_with_tp": (PP + ["--pipeline-schedule", "1f1b",
                           "--tensor-parallel", "2"], True),
    "pp_with_sp": (PP + ["--sequence-parallel", "2"], True),
    "pp_with_moe": (PP + ["--moe-experts", "4"], False),
    "layers_do_not_divide": (["--pipeline-parallel", "2", "--layers", "3"],
                             True),
    "negative_microbatches": (PP + ["--pipeline-microbatches", "-1"], False),
    "microbatches_without_pp": (["--pipeline-microbatches", "4"], True),
    "schedule_without_pp": (["--pipeline-schedule", "1f1b"], True),
    "fsdp_with_pp": (PP + ["--fsdp", "2"], False),
}


@pytest.mark.parametrize("name", sorted(JAX_REFUSALS))
def test_pipeline_combinations_jax_refuses_raise_its_value_error(name):
    flags, causal = JAX_REFUSALS[name]
    want = jax_error(flags, causal)
    assert want is not None
    module = tgpt if causal else tbert
    args = module.build_parser().parse_args(SMALL + flags)
    with pytest.raises(ValueError) as err:
        tbert.build_model(args, "cpu", causal=causal)
    assert str(err.value) == want


@pytest.mark.parametrize("flags", [
    PP, PP + ["--pipeline-schedule", "1f1b", "--pipeline-microbatches", "4"],
    PP + ["--tensor-parallel", "2"], PP + ["--attention", "flash"]])
def test_pipeline_flags_pass_and_need_ranks(flags):
    """What the JAX package builds passes the flag checks (no "not yet
    ported"); one process cannot hold a pipeline axis of 2 (the mesh's
    own error)."""
    assert jax_error(flags, True) is None
    args = tgpt.build_parser().parse_args(SMALL + flags)
    assert tbert.validate_parallel_flags(args, causal=True) == 2
    with pytest.raises(ValueError, match="not divisible by fixed axes"):
        tgpt.build_model(args, "cpu")


def test_value_and_grad_fn_step_is_the_loss_step():
    """``make_train_step``'s ``value_and_grad_fn`` (the pipeline's hook):
    a function that leaves the loss's gradients in ``.grad`` updates as
    the loss's own step does (the same AdamW update and loss), eagerly;
    one that sets loss extras is refused before it updates, as the JAX
    package refuses ``has_extra``."""
    import torch

    from tpujob_torch.workloads import train_lib

    def fresh():
        torch.manual_seed(0)
        model = torch.nn.Linear(4, 3)
        return model, train_lib.adamw(model.parameters(), 1e-2)

    batch = (torch.randn(5, 4),)
    loss_of = lambda m: lambda b: (m(b[0]) ** 2).mean()  # noqa: E731
    ref, opt = fresh()
    step = train_lib.make_train_step(loss_of(ref), opt, lambda c: 1e-2)
    _, want = step({"step": 0}, batch)

    model, opt = fresh()

    def vag(b):
        loss = loss_of(model)(b)
        loss.backward()
        return loss.detach()

    step = train_lib.make_train_step(None, opt, lambda c: 1e-2,
                                     value_and_grad_fn=vag)
    assert step.mode == "eager"
    state, got = step({"step": 0}, batch)
    assert state["step"] == 1 and torch.equal(got, want)
    for a, b in zip(model.parameters(), ref.parameters()):
        assert torch.equal(a, b)

    def with_extras(b):
        train_lib.set_loss_extras(with_extras, torch.zeros(2))
        return vag(b)

    before = [p.detach().clone() for p in model.parameters()]
    step = train_lib.make_train_step(None, opt, lambda c: 1e-2,
                                     value_and_grad_fn=with_extras)
    with pytest.raises(ValueError, match="does not support loss extras"):
        step({"step": 1}, batch)
    for a, b in zip(model.parameters(), before):
        assert torch.equal(a, b)
