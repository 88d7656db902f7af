"""The port's ``tpujob_torch/graft_entry.py`` against
``__graft_entry__.py``, on the CPU.

- ``entry``: the same function of ``(params, ids)`` as the reference's,
  from the same weights (the JAX package's, carried across by
  ``convert.params_from_flax``).  Both packages' ``Bert`` is shrunk to a
  2-layer model for the comparison (BERT-large's forward is a full-size
  run, which belongs on the card: ``chip_smoke.py`` phase ``dryrun``);
  that ``entry`` builds ``Bert`` at its defaults, and that those are the
  reference's, is checked without building it.  Logits in bf16 (both
  compute in bf16 on fp32 parameters, rounding at other places, each
  rounding 2^-8 relative): within 5e-2 x rms(logits) element by element
  (a few ulps; 3.3e-2 read) and 1e-2 normwise (6.8e-3 read).
- ``dryrun_cases(n)``: the reference's matrix, recorded from its own
  ``dryrun_multichip(n)`` (its body run in this process on the virtual
  CPU devices, ``bertlib.run`` recorded): the same cases in the same
  order under the same guards at n = 2, 4 and 8, each case's flags giving
  the mesh the reference hands its ``run`` and every flag the reference
  sets.
- The dryrun at 8 gloo ranks against the reference's own dryrun at 8
  virtual devices, every case from the JAX package's initial weights:
  each case's loss within ``LOSS_RTOL`` of JAX's and the parameters after
  the step within ``UPDATE_RTOL`` (``update_err``), 1F1B's loss within
  1e-3 of GPipe's (the reference's bound; here they are equal).
- ``python -m tpujob_torch.graft_entry 4 --device cpu`` prints the
  reference's lines; without a card the default device raises.
"""
import inspect
import os
import re
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import __graft_entry__ as ref
from test_torch_spawn import dryrun_ranks, spawn
from test_torch_tp import update_err
from tpujob.workloads import bert as jbert
from tpujob.workloads import distributed as jdist
from tpujob_torch import graft_entry
from tpujob_torch.workloads import bert as tbert
from tpujob_torch.workloads import convert
from tpujob_torch.workloads import distributed as tdist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab=211, hidden=64, layers=2, heads=4, intermediate=128)
# fp32, one step from the same weights on the same batch: the losses are
# one forward apart (summation order only; 1.6e-7 read, GPipe and TP x
# PP); AdamW's first step is lr x sign(g) wherever |g| is well above eps,
# so a parameter whose gradient is near 0 can move by lr in either
# package: the update is held normwise, over how far the step moved the
# parameters (5.5e-5 to 1.1e-4 read, the most under EP)
LOSS_RTOL = 1e-6
UPDATE_RTOL = 5e-4
DRYRUN_TIMEOUT_S = 240.0


def test_entry_builds_bert_large_at_the_reference_defaults():
    """``entry`` builds ``Bert`` with no width argument (its defaults, in
    bf16), and the port's defaults are the JAX package's BERT-large."""
    port = inspect.signature(tbert.Bert).parameters
    for name in ("vocab", "hidden", "layers", "heads", "intermediate",
                 "max_seq", "remat"):
        assert port[name].default == getattr(jbert.Bert, name), name
    src = inspect.getsource(graft_entry.entry)
    assert "bert.Bert(dtype=torch.bfloat16)" in src
    assert "Bert(dtype=jnp.bfloat16)" in inspect.getsource(ref.entry)


def test_entry_matches_the_reference_from_the_same_weights(monkeypatch):
    """Both packages' ``entry`` with ``Bert`` at ``SMALL`` widths: the
    port's fn on the JAX params gives the JAX fn's logits, [4, 128,
    vocab], and its example args are the reference's (zeros [4, 128])."""
    jax_bert, port_bert = jbert.Bert, tbert.Bert
    monkeypatch.setattr(jbert, "Bert",
                        lambda **kw: jax_bert(**{**SMALL, **kw}))
    monkeypatch.setattr(tbert, "Bert",
                        lambda **kw: port_bert(**{**SMALL, **kw}))
    jfn, (jparams, jids) = ref.entry()
    want = np.asarray(jfn(jparams, jids).astype(jnp.float32))
    fn, (params, ids) = graft_entry.entry(device="cpu")
    assert ids.dtype == torch.int64 and ids.shape == (4, 128)
    assert not ids.any() and not np.asarray(jids).any()
    tree = jax.tree.map(np.asarray, jparams)
    loaded = convert.params_from_flax(tree)
    assert set(loaded) == set(params)
    with torch.no_grad():
        got = fn(loaded, ids).float().numpy()
    assert got.shape == want.shape == (4, 128, SMALL["vocab"])
    rms = np.sqrt(np.mean(want ** 2))
    assert np.abs(got - want).max() <= 5e-2 * rms
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


def reference_calls(n, monkeypatch, run):
    """The reference's ``dryrun_multichip(n)`` body in this process (past
    its re-exec, on the virtual CPU devices), each ``bertlib.run`` call
    handed to ``run(args, mesh)``: [(args, mesh axes, result)]."""
    monkeypatch.setenv("_TPUJOB_DRYRUN_REEXEC", "1")
    calls = []

    def recorded(args, mesh=None):
        res = run(args, mesh)
        calls.append((args, dict(mesh.shape), res))
        return res

    monkeypatch.setattr(jbert, "run", recorded)
    ref.dryrun_multichip(n)
    return calls


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_cases_are_the_reference_matrix(n, monkeypatch):
    """The same cases, in order, under the same guards; each case's flags
    give the reference's mesh, set every flag the reference's argv sets,
    and the base argv is the reference's."""
    calls = reference_calls(n, monkeypatch,
                            lambda args, mesh: {"final_loss": 0.0})
    cases = graft_entry.dryrun_cases(n)
    if not jdist.shard_map_supports_partial_manual():
        cases = [c for c in cases if c.name != "tp_pp"]  # it skips, we run
    assert len(cases) == len(calls) == {2: 5, 4: 8, 8: 8}[n]
    defaults = vars(jbert.build_parser().parse_args([]))
    port_parser = tbert.build_parser()
    for case, (jargs, jmesh, _) in zip(cases, calls):
        assert graft_entry.case_mesh(case, n) == jmesh, case.name
        args = port_parser.parse_args(
            graft_entry.base_argv(n, "cpu", "logs") + list(case.flags))
        assert dict(zip(*tdist.mesh_shape(tbert.mesh_axes(args), n))) == jmesh, \
            case.name
        for key, value in vars(jargs).items():
            if key != "dir" and value != defaults[key]:
                assert getattr(args, key) == value, (case.name, key)


def flax_init_args(args):
    """The JAX package's initial weights for ``args`` (numpy leaves), as
    its ``run`` draws them on any mesh (tests/test_torch_tp.py's
    ``flax_init``, at the args' sequence length)."""
    model = jbert.build_model(args, Mesh(np.array(jax.devices()[:1]),
                                         ("data",)))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, args.seq_len), jnp.int32))["params"]
    return jax.tree.map(np.asarray, {"params": params})


@pytest.fixture(scope="module")
def dryrun_8(tmp_path_factory):
    """The reference's dryrun at 8 virtual devices (each case's loss, its
    initial weights and its parameters after the step) and the port's at
    8 gloo ranks from those weights.  The port's ranks run in a thread
    while the reference runs here: the cases' weights are drawn first,
    from the reference's own argv (recorded without running)."""
    tmp = tmp_path_factory.mktemp("dryrun_8")
    monkeypatch = pytest.MonkeyPatch()
    trees = {}  # the cases draw one model, and the expert case a MoE one

    def tree_of(args):
        key = args.moe_experts
        trees[key] = trees.get(key) or flax_init_args(args)
        return trees[key]

    try:
        planned = reference_calls(
            8, monkeypatch, lambda args, mesh: {"final_loss": 0.0})
    finally:
        monkeypatch.undo()
    case_trees = [tree_of(args) for args, _, _ in planned]
    port = {}

    def port_ranks():
        try:
            port["ranks"] = spawn(dryrun_ranks, 8, tmp, 8, case_trees,
                                  str(tmp / "port"),
                                  timeout=DRYRUN_TIMEOUT_S)
        except BaseException as e:  # pytest.fail's, raised again below
            port["error"] = e

    thread = threading.Thread(target=port_ranks)
    thread.start()
    real_run = jbert.run

    def run(args, mesh):
        args.dir = str(tmp / "jax")
        res = real_run(args, mesh)
        params = jax.tree.map(np.asarray, res["state"]["params"])
        return {"final_loss": res["final_loss"], "tree": tree_of(args),
                "params": {k: v.numpy() for k, v in
                           convert.params_from_flax(params).items()}}

    try:
        calls = reference_calls(8, monkeypatch, run)
    finally:
        monkeypatch.undo()
        thread.join()
    if "error" in port:
        raise port["error"]
    return calls, port["ranks"]


def test_dryrun_at_8_ranks_matches_the_reference(dryrun_8):
    """Every case: each rank's loss within LOSS_RTOL of the reference's
    (the same on every rank), the parameters after the step gathered
    whole within UPDATE_RTOL of the reference's (``update_err`` over the
    step), 1F1B's loss within 1e-3 of GPipe's."""
    calls, ranks = dryrun_8
    cases = graft_entry.dryrun_cases(8)
    assert [c.name for c in cases] == list(ranks[0][0])
    for case, (_, _, jres) in zip(cases, calls):
        losses = [r[0][case.name] for r in ranks]
        assert len(set(losses)) == 1, (case.name, losses)
        np.testing.assert_allclose(losses[0], jres["final_loss"],
                                   rtol=LOSS_RTOL, err_msg=case.name)
        whole = {}
        for r in ranks:
            whole.update(r[1][case.name]["whole"])
        init = {k: v.numpy()
                for k, v in convert.params_from_flax(jres["tree"]).items()}
        assert set(whole) == set(jres["params"]) == set(init), case.name
        err = update_err(whole, jres["params"], init)
        assert err <= UPDATE_RTOL, (case.name, err)
    port = ranks[0][0]
    assert abs(port["1f1b"] - port["gpipe"]) < graft_entry.F1B_ATOL


def test_module_prints_the_reference_lines():
    """``python -m tpujob_torch.graft_entry 4 --device cpu``: exit 0 and
    one line a case, the reference's words with the case's mesh."""
    proc = subprocess.run(
        [sys.executable, "-m", "tpujob_torch.graft_entry", "4", "--device",
         "cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("dryrun_multichip(4): ")]
    cases = graft_entry.dryrun_cases(4)
    assert len(lines) == len(cases) == 8
    for line, case in zip(lines, cases):
        head = "dryrun_multichip(4): " + case.line.split("{loss")[0].format(
            mesh=graft_entry.case_mesh(case, 4))
        assert line.startswith(head), (line, head)
        assert re.search(r"loss=\d+\.\d{3}", line)
    assert "one full train step executed" in lines[0]


def test_default_device_raises_without_a_card(monkeypatch):
    """``cuda`` is the default; without a card the dryrun raises before
    it spawns anything, and ``entry`` raises: neither moves to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")

    def no_spawn(*a, **kw):
        raise AssertionError("spawned without a card")

    monkeypatch.setattr(tdist, "spawn_local", no_spawn)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        graft_entry.main(["2"])
