"""Spawned process groups for the port's multi-process tests (CPU, gloo),
and the bodies their ranks run.

``spawn(body, world, tmp_path, *args)`` starts ``world`` processes with
``torch.multiprocessing`` (start method ``spawn``), each with the env the
operator would inject (``TPUJOB_COORDINATOR_ADDRESS``,
``TPUJOB_NUM_PROCESSES``, ``TPUJOB_PROCESS_ID``): by default a ``file://``
rendezvous under the test's own ``tmp_path``, so concurrent test workers
never race for a port.  Each rank runs ``body(rank, *args)`` and its
return value comes back through a file.  A rank that raises fails the
test with its traceback; a spawn that outlives its timeout is killed and
fails the test.  Inside a rank, ``join()`` brings the group up with a
collective timeout of its own, so a lost peer ends in an error, not a hang.

This file imports no JAX: a rank pays for importing torch and the port
only.  The tests at the end hold the harness to its contract.
"""
import datetime
import itertools
import os
import time
import traceback
import weakref

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from tpujob_torch.workloads import distributed as dist

RANK_TIMEOUT = datetime.timedelta(seconds=60)  # rendezvous and collectives
SPAWN_TIMEOUT_S = 240.0  # the whole spawn, the ranks' imports included
_spawns = itertools.count()


def file_envs(tmp_path, world: int):
    """The operator's per-rank env with a fresh ``file://`` rendezvous."""
    rdzv = tmp_path / f"rdzv-{os.getpid()}-{next(_spawns)}"
    return [{"TPUJOB_COORDINATOR_ADDRESS": f"file://{rdzv}",
             "TPUJOB_NUM_PROCESSES": str(world),
             "TPUJOB_PROCESS_ID": str(rank)} for rank in range(world)]


def _entry(rank, body, envs, args, out_dir):
    os.environ.update(envs[rank])
    torch.set_num_threads(2)  # several ranks of several test workers share the host
    try:
        result = ("ok", body(rank, *args))
    except BaseException:  # reported to the parent, which fails the test
        result = ("error", traceback.format_exc())
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn(body, world, tmp_path, *args, envs=None, timeout=SPAWN_TIMEOUT_S):
    """Each rank's ``body(rank, *args)``, in rank order."""
    envs = envs or file_envs(tmp_path, world)
    out_dir = tmp_path / f"ranks-{next(_spawns)}"
    out_dir.mkdir()
    ctx = tmp.start_processes(_entry, args=(body, envs, args, str(out_dir)),
                              nprocs=world, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"spawn of {world} ranks outlived its {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    results = []
    for rank in range(world):
        status, value = torch.load(out_dir / f"rank{rank}.pt",
                                   weights_only=False)
        if status != "ok":
            pytest.fail(f"rank {rank} of {world} failed:\n{value}")
        results.append(value)
    return results


def join(device="cpu"):
    """Bring this rank's group up from the env, with ``RANK_TIMEOUT``."""
    return dist.initialize(device=torch.device(device), timeout=RANK_TIMEOUT)


def leave():
    """Wait for every rank, then take the group down: a rank whose peers
    exit while its gloo threads still hold their connections can abort
    at exit ("terminate called without an active exception")."""
    import torch.distributed as tdist

    tdist.barrier()
    dist.shutdown()


def numpy_state(module):
    return {k: v.detach().float().numpy().copy()
            for k, v in module.state_dict().items()}


def loading(build, state):
    """``build`` whose model starts from ``state`` (a state_dict)."""
    def built(*a, **kw):
        model = build(*a, **kw)
        model.load_state_dict(state, strict=True)
        return model
    return built


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------


def smoke_ranks(rank, corrupt_rank=None):
    """``smoke_dist.main`` twice on the env's group, which it brings up and
    tears down itself each time (the second run re-rendezvouses on the
    same coordinator), the second time with ``corrupt_rank``'s result
    off by one when given.  The exit codes."""
    from tpujob_torch.workloads import smoke_dist

    codes = [smoke_dist.main(["--device", "cpu"])]
    if corrupt_rank == rank:
        smoke_dist.work = lambda x: x * x + 1.0
    codes.append(smoke_dist.main(["--device", "cpu"]))
    return codes


def operator_ranks(rank):
    """The smoke, then a heartbeat through ``TrainTelemetry.from_env``
    with a recording publisher: (exit code, ProcessEnv, heartbeats sent,
    publisher factory calls)."""
    from tpujob_torch.workloads import smoke_dist, train_lib

    shipped, made = [], []

    def publisher():
        made.append(rank)
        return shipped.append

    dist.progress_publisher_from_env = publisher
    code = smoke_dist.main(["--device", "cpu"])
    telemetry = train_lib.TrainTelemetry.from_env()
    telemetry.step(1, samples=8)
    telemetry.close()
    return code, dist.process_env(), shipped, made


# where each trainer builds its model: patched in the rank to load weights
BUILDERS = {"gpt": ("bert", "build_model"), "bert": ("bert", "build_model"),
            "mnist": ("mnist", "Net"), "resnet": ("resnet", "make_model")}


def trainer_ranks(rank, module_name, runs, state):
    """``module.run`` for each argv in ``runs``, from the weights
    ``state``: each run's losses, accuracy, final step and state."""
    import importlib

    join()
    module = importlib.import_module(f"tpujob_torch.workloads.{module_name}")
    owner_name, attr = BUILDERS[module_name]
    owner = importlib.import_module(f"tpujob_torch.workloads.{owner_name}")
    setattr(owner, attr, loading(getattr(owner, attr), state))
    out = []
    for argv in runs:
        res = module.run(module.build_parser().parse_args(argv))
        out.append({"losses": res.get("losses"),
                    "accuracy": res.get("accuracy"),
                    "final_loss": res.get("final_loss"),
                    "state": numpy_state(res["state"]["model"]),
                    "step": res["state"]["step"]})
    return out


def moe_ranks(rank, argv, local_argv, state):
    """``gpt.run`` of a MoE model from ``state`` (``trainer_ranks``), then
    (``local_argv``) again with each rank's load balance its own rows'
    (the layers' ``moe_ffn`` value, not summed over the ranks): the fault
    the global one prevents.  Both results."""
    from tpujob_torch.workloads import bert

    [out] = trainer_ranks(rank, "gpt", [argv], state)
    global_terms = bert.moe_terms

    def local_terms(metrics, mesh=None):
        terms = global_terms(metrics, mesh)
        terms["load_balance"] = torch.stack(
            [m["load_balance"] for m in metrics]).mean()
        return terms

    bert.moe_terms = local_terms
    [local] = trainer_ranks(rank, "gpt", [local_argv], state)
    return out, local


def group_ranks(rank):
    """``initialize`` from a ``host:port`` coordinator: the group it makes,
    a second call (idempotent), calls with a conflicting env (refused),
    one all-reduce, the loss helpers; then, with a DDP wrapper still
    holding the old group, ``reinitialize`` at the same world and the same
    port, and one all-reduce on the new group."""
    import torch.distributed as tdist

    from tpujob_torch.workloads import train_lib

    pe = join()
    group = weakref.ref(tdist.group.WORLD)
    out = {"pe": pe, "backend": tdist.get_backend(),
           "world": tdist.get_world_size(), "rank": tdist.get_rank()}
    out["again_same_group"] = (dist.initialize(timeout=RANK_TIMEOUT) == pe
                               and tdist.group.WORLD is group())
    refused = []
    for over in ({"TPUJOB_NUM_PROCESSES": "3"},
                 {"TPUJOB_PROCESS_ID": str(1 - rank)}):
        try:
            dist.initialize(dist.process_env({**os.environ, **over}))
        except RuntimeError as e:
            refused.append("already initialized" in str(e))
    out["refused"] = refused
    x = torch.tensor([float(rank + 1)])
    tdist.all_reduce(x)
    out["sum"] = x.item()
    out["global_sum"] = train_lib.global_sum(torch.tensor(rank + 1.0)).item()
    out["global_mean_bf16"] = train_lib.global_mean(
        torch.tensor(rank + 1.0, dtype=torch.bfloat16))
    # DDP's hooks keep the group, and rank 0's store server, alive
    ddp = train_lib.data_parallel(torch.nn.Linear(2, 2))
    out["data_parallel"] = type(ddp).__name__
    new = dist.reinitialize(pe, 2, timeout=RANK_TIMEOUT)
    y = torch.tensor([10.0 * (rank + 1)])
    tdist.all_reduce(y)
    out["after_reinit"] = (new == pe, tdist.group.WORLD is not group(),
                           y.item())
    dist.shutdown()
    out["shut_down"] = not tdist.is_initialized()
    return out


def mnist_ranks(rank, argv, state, x, y):
    """``mnist.run`` from ``state``, then ``make_eval_step`` over this
    rank's rows of (x, y) with the trained model: the run's result and the
    eval step's sums."""
    from tpujob_torch.workloads import mnist, train_lib

    [out] = trainer_ranks(rank, "mnist", [argv], state)
    model = mnist.Net()
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in out["state"].items()})
    lo, sz = dist.local_batch_slice(len(x), dist.process_env())
    eval_step = train_lib.make_eval_step(
        lambda batch: mnist.eval_metrics(model, batch))
    sums = eval_step(train_lib.put_batch((x[lo : lo + sz], y[lo : lo + sz]),
                                         "cpu"))
    out["eval_sums"] = [s.item() for s in sums]
    return out


def resnet_ranks(rank, argv, state, x, y, run_argv):
    """One SGD step of the ResNet on this rank's rows of (x, y) through
    DDP: the loss, every gradient and the state after it; then
    ``resnet.run`` from ``state`` (``run_argv``): its losses and final
    state, running statistics included."""
    from tpujob_torch.workloads import resnet, train_lib

    join()
    model = resnet.make_model(resnet.build_parser().parse_args(argv))
    model.load_state_dict(state, strict=True)
    model.train()
    opt = train_lib.sgd(model.parameters(), 0.1, 0.9)
    step = train_lib.make_train_step(
        resnet.build_loss(train_lib.data_parallel(model)), opt,
        lambda count: 0.1)
    lo, sz = dist.local_batch_slice(len(x), dist.process_env())
    _, loss = step({"model": model, "opt": opt, "step": 0},
                   (torch.from_numpy(x[lo : lo + sz]),
                    torch.from_numpy(y[lo : lo + sz].astype(np.int64))))
    out = {"loss": loss.item(), "state": numpy_state(model),
           "grads": {n: p.grad.numpy().copy()
                     for n, p in model.named_parameters()}}
    [out["run"]] = trainer_ranks(rank, "resnet", [run_argv], state)
    return out


def checkpoint_ranks(rank, argv, state, directory):
    """``gpt.run`` with checkpoints every 2 steps into one shared
    ``directory``, counting this process's ``torch.save`` calls; then
    ``latest_step`` with rank 1 blind to the directory (it must still
    answer rank 0's step)."""
    from tpujob_torch.workloads import train_lib

    saves = []
    save = torch.save

    def counting(obj, path, *a, **kw):
        saves.append(str(path))
        return save(obj, path, *a, **kw)

    torch.save = counting
    [out] = trainer_ranks(rank, "gpt", [argv], state)
    torch.save = save
    ckpt = train_lib.Checkpointer(directory)
    if rank == 1:
        ckpt._steps = lambda: []
    out["saves"] = saves
    out["latest"] = ckpt.latest_step()
    return out


def shrink_ranks(rank, argv, state, resume_argv, draining, committed):
    """The 2 -> 1 shrink: both ranks train to a checkpoint; the drain
    signal (``draining``, a downward-API annotations file) plans
    checkpoint / leave; rank 1 tries to rejoin the smaller world
    (refused, its group untouched), and leaves after one last collective;
    rank 0 reads the committed signal, re-initializes at world 1 and
    resumes from the latest checkpoint (``resume_argv``)."""
    import torch.distributed as tdist

    from tpujob_torch.workloads import bert, gpt

    [first] = trainer_ranks(rank, "gpt", [argv], state)
    pe = dist.process_env()
    out = {"first": first,
           "plan_draining": dist.plan_resize(
               pe, dist.read_world_signal(draining))}
    if rank == 1:
        try:
            dist.reinitialize(pe, 1)
        except ValueError as e:
            out["refused"] = "drained process must exit" in str(e)
    out["group_live"] = tdist.is_initialized()
    goodbye = torch.tensor([1.0])
    tdist.all_reduce(goodbye)
    out["goodbye"] = goodbye.item()
    if rank == 1:
        return out
    signal = dist.read_world_signal(committed)
    out["plan_committed"] = dist.plan_resize(pe, signal)
    new = dist.reinitialize(pe, signal.world_size, timeout=RANK_TIMEOUT)
    out["new"] = (new.num_processes, new.process_id, tdist.is_initialized())
    args = gpt.build_parser().parse_args(resume_argv)
    model = gpt.build_model(args, torch.device("cpu"))
    ids, _, _ = bert.token_batches(args, new)
    res = bert.train(args, new, model, gpt.lm_loss,
                     (bert.batch_to_device(ids, "cpu"),), tag="gpt")
    out["resumed"] = res["losses"]
    return out


def sp_attention_ranks(rank, cases):
    """Each case of ``cases`` (name -> dict of global numpy ``q, k, v, ct``
    and ``mode``, ``causal``, ``flash``) on this rank's shard of the
    sequence, the whole world one sequence group: the shard's global
    positions (the ring's layout), its output and the grads of
    ``sum(out * ct)`` over every rank for its q, k and v, and the
    exchanges of the forward.  Then, at world 4, the process groups of a
    data 2 x sequence 2 mesh, as ``get_process_group_ranks`` reads them."""
    import torch.distributed as tdist

    from tpujob_torch.workloads import flash, parallel

    join()
    n = tdist.get_world_size()
    group = dist.make_mesh({"sequence": n}).group("sequence")
    out = {}
    for name, c in cases.items():
        seq = c["q"].shape[1]
        if c["mode"] == "ring" and parallel.ring_layout_zigzag(
                seq, n, c["causal"]):
            idx = parallel.zigzag_index(seq, n, rank)
        else:
            idx = np.arange(rank * seq // n, (rank + 1) * seq // n)
        xs = [torch.tensor(c[x][:, idx], requires_grad=True)
              for x in ("q", "k", "v")]
        parallel.reset_exchanges()
        if c["mode"] == "ring":
            o = parallel.ring_attention(*xs, group, causal=c["causal"])
        else:
            o = parallel.ulysses_attention(
                *xs, group, causal=c["causal"],
                attention_impl=flash.flash_attention if c["flash"] else None)
        calls = parallel.EXCHANGES["calls"]
        (o * torch.from_numpy(c["ct"][:, idx])).sum().backward()
        out[name] = {"idx": idx, "o": o.detach().numpy(),
                     "grads": [x.grad.numpy() for x in xs],
                     "forward_exchanges": calls}
    groups = None
    if n == 4:
        mesh = dist.make_mesh({"data": -1, "sequence": 2})
        groups = {a: tdist.get_process_group_ranks(mesh.group(a))
                  for a in mesh.axis_names}
    return out, groups


def sp_trainer_ranks(rank, runs):
    """``module.run`` for each ``(module name, argv, state)`` of ``runs``,
    from the weights ``state``: each run's losses, final step and state."""
    import importlib

    from tpujob_torch.workloads import bert

    join()
    build = bert.build_model
    out = []
    for name, argv, state in runs:
        module = importlib.import_module(f"tpujob_torch.workloads.{name}")
        bert.build_model = loading(build, state)
        res = module.run(module.build_parser().parse_args(argv))
        out.append({"losses": res["losses"], "step": res["state"]["step"],
                    "state": numpy_state(res["state"]["model"])})
    bert.build_model = build
    return out


def local_numel(t) -> int:
    """The elements this rank holds of ``t`` (a DTensor's local shard)."""
    return t.to_local().numel() if hasattr(t, "to_local") else t.numel()


def shard_trainer_ranks(rank, runs):
    """``module.run`` for each ``(module name, argv, flax params)`` of
    ``runs``, each rank starting from its own slice of the flax weights
    (``convert.params_from_flax`` over the run's mesh): each run's losses,
    final step and tokens generated; the parameters after the run gathered
    whole (``parallel.ParamShards``), every one this rank holds whole
    (``parallel.TP_RULES`` and ``EP_RULES`` split none of them) as it
    holds it, the elements this rank holds of the parameters and of
    AdamW's moments, the ranks of its mesh's groups (tensor, replica,
    token axes, and ``ffn``: expert x tensor; and the pipeline's), as
    ``get_process_group_ranks`` reads them, under a pipeline the
    gradients of the parameters outside the blocks after the last step,
    and a MoE run's
    ``moe_metrics`` and, for each forward, whether its load balance is
    the world formula's (``bert.moe_terms`` without the mesh) bit for
    bit."""
    import importlib

    import torch.distributed as tdist

    from tpujob_torch.workloads import bert, convert, parallel

    join()
    build, terms = bert.build_model, bert.moe_terms
    out = []
    for name, argv, tree in runs:
        meshes, lb_world_equal = [], []

        def recorded(metrics, mesh=None):
            got = terms(metrics, mesh)
            world = terms(metrics)["load_balance"]
            lb_world_equal.append(torch.equal(got["load_balance"], world))
            return got

        def built(args, device, *, mesh=None, **kw):
            model = build(args, device, mesh=mesh, **kw)
            model.load_state_dict(convert.params_from_flax(tree, mesh),
                                  strict=True)
            meshes.append(mesh)
            return model

        module = importlib.import_module(f"tpujob_torch.workloads.{name}")
        bert.build_model, bert.moe_terms = built, recorded
        res = module.run(module.build_parser().parse_args(argv))
        bert.build_model, bert.moe_terms = build, terms
        mesh, model = meshes[0], res["state"]["model"]
        shards = parallel.ParamShards(mesh.group("tensor"),
                                      mesh.group("expert"))
        groups = {key: mesh.group(*axes) for key, axes in (
            ("tensor", ("tensor",)), ("replica", dist.REPLICA_AXES),
            ("tokens", dist.TOKEN_AXES), ("ffn", ("expert", "tensor")))}
        opt = res["state"]["opt"]
        out.append({
            "losses": res["losses"], "step": res["state"]["step"],
            "generated": (res["generated"].tolist()
                          if "generated" in res else None),
            "whole": {n: shards.full(n, p).float().numpy()
                      for n, p in model.named_parameters()},
            "replicated": {n: (p.to_local() if hasattr(p, "to_local")
                               else p).detach().float().numpy().copy()
                           for n, p in model.named_parameters()
                           if parallel.tp_dim(n) is None
                           and parallel.ep_dim(n) is None},
            "param_numel": sum(local_numel(p) for p in model.parameters()),
            "moment_numel": sum(local_numel(st[k])
                                for st in opt.state.values()
                                for k in ("exp_avg", "exp_avg_sq")),
            "groups": {key: (tdist.get_process_group_ranks(g)
                             if g is not None else [rank])
                       for key, g in groups.items()},
            "pipeline_group": (tdist.get_process_group_ranks(
                mesh.group("pipeline")) if mesh.size("pipeline") > 1
                else [rank]),
            "moe_metrics": res.get("moe_metrics"),
            "lb_world_equal": lb_world_equal,
            "shared_grads": {n: p.grad.float().numpy().copy()
                             for n, p in model.named_parameters()
                             if not n.startswith("layer_")
                             and mesh.size("pipeline") > 1},
        })
    leave()
    return out


def dryrun_ranks(rank, n, trees, logdir):
    """``graft_entry.run_cases`` (the port's dryrun matrix) on this rank,
    each case's model loading its JAX package's initial weights from
    ``trees`` (one flax tree a case, in the matrix's order; this rank's
    blocks of them, ``convert.params_from_flax`` over the case's mesh):
    ``{case: loss}`` and, for each case, its losses and the parameters
    after the step, gathered whole (``parallel.ParamShards``; a pipeline
    rank's stage only)."""
    from tpujob_torch import graft_entry
    from tpujob_torch.workloads import bert, convert, parallel

    join()
    build, pending, meshes, out = bert.build_model, list(trees), [], {}

    def built(args, device, *, mesh=None, **kw):
        model = build(args, device, mesh=mesh, **kw)
        model.load_state_dict(convert.params_from_flax(pending.pop(0), mesh),
                              strict=True)
        meshes.append(mesh)
        return model

    def record(case, res):
        mesh, model = meshes[-1], res["state"]["model"]
        shards = parallel.ParamShards(mesh.group("tensor"),
                                      mesh.group("expert"))
        out[case.name] = {
            "losses": res["losses"],
            "whole": {name: shards.full(name, p).float().numpy()
                      for name, p in model.named_parameters()}}

    bert.build_model = built
    try:
        losses = graft_entry.run_cases(n, "cpu", logdir, on_case=record)
    finally:
        bert.build_model = build
    leave()
    return losses, out


def pipeline_stack_ranks(rank, cases):
    """Each case of ``cases`` (name -> dict of the mesh ``axes``, numpy
    ``ws`` [L, d, d], ``x`` [B, d], ``h`` [d, k], ``y`` [B, k], the
    microbatches ``m``, ``skip_idle`` and the ``schedule``) on the stack
    of ``tanh(x @ w)`` layers, this rank holding its stage's layers
    (``parallel.stage_layers``) and its rows of the batch
    (``distributed.local_batch_slice``):

    - ``"pipeline"``: ``parallel.pipeline``'s output and the grads of its
      sum for the stage's layers and the rows;
    - ``"1f1b"`` / ``"gpipe"``: ``pipeline_schedule.pipeline_1f1b`` /
      ``pipeline_gpipe`` with the head ``mean((y @ h - target) ** 2)``:
      the loss, the grads of the stage's layers and of ``h``, ``dx`` and
      the stash peaks.

    Each with the rank's stage, its rows and the exchanges' calls."""
    from tpujob_torch.workloads import parallel, pipeline_schedule

    join()
    out = {}
    for name, c in cases.items():
        mesh = dist.make_mesh(c["axes"])
        group = mesh.group("pipeline")
        num_layers = len(c["ws"])
        layers = (parallel.stage_layers(num_layers, mesh)
                  or range(num_layers))
        lo, sz = dist.local_batch_slice(len(c["x"]), mesh=mesh)
        w = torch.tensor(c["ws"][layers.start:layers.stop],
                         requires_grad=True)

        def stage_fn(xb):
            for wi in w:
                xb = torch.tanh(xb @ wi)
            return xb

        x = torch.tensor(c["x"][lo : lo + sz], requires_grad=True)
        h = torch.tensor(c["h"], requires_grad=True)
        target = torch.from_numpy(c["y"][lo : lo + sz])
        parallel.reset_exchanges()
        res = {"stage": mesh.index("pipeline"), "rows": (lo, sz)}
        if c["schedule"] == "pipeline":
            o = parallel.pipeline(stage_fn, x, group, num_layers=num_layers,
                                  num_microbatches=c["m"],
                                  skip_idle=c["skip_idle"])
            res["forward_exchanges"] = parallel.EXCHANGES["calls"]
            o.sum().backward()
            res.update(o=o.detach().numpy(), dx=x.grad.numpy())
        else:
            run = {"1f1b": pipeline_schedule.pipeline_1f1b,
                   "gpipe": pipeline_schedule.pipeline_gpipe}[c["schedule"]]
            r = run(stage_fn, x.detach(),
                    lambda yb, ex: torch.mean((yb @ h - ex[0]) ** 2),
                    (target,), group, num_layers=num_layers,
                    num_microbatches=c["m"])
            res.update(loss=r.loss.item(), dx=r.dx.numpy(),
                       stash_peak=r.stash_peak, cot_peak=r.cot_peak,
                       dh=None if h.grad is None else h.grad.numpy())
        res["dw"] = w.grad.numpy()
        res["exchanges"] = parallel.EXCHANGES["calls"]
        out[name] = res
    leave()
    return out


def bf16_tp_sum_ranks(rank, runs):
    """``shard_trainer_ranks`` with the column-parallel products' input
    gradient summed as the port summed it before: the products' own
    gradients (each rounded to the compute dtype) added, then all-reduced
    in that dtype (Megatron's f on the input, ``copy_to_tensor``)."""
    import torch.nn.functional as F

    from tpujob_torch.workloads import parallel

    def column_parallel(x, pairs, group):
        x = parallel.copy_to_tensor(x, group)
        return [F.linear(x, w, b) for w, b in pairs]

    parallel.column_parallel = column_parallel
    return shard_trainer_ranks(rank, runs)


def tp_block_ranks(rank, cases):
    """Each case of ``cases`` (name -> dict of ``hidden``, ``heads``,
    ``kv_heads``, ``rope``, ``causal``, the seed and numpy ``x``, ``ct``)
    as one process's ``Block`` and as a ``Block`` split over the whole
    world's tensor group, from one seed: both outputs, both sets of grads
    of ``sum(out * ct)`` (the split one's gathered whole), and the
    exchanges of the split forward."""
    import torch.distributed as tdist

    from tpujob_torch.workloads import bert, parallel

    join()
    group = dist.make_mesh({"tensor": tdist.get_world_size()}).group("tensor")
    out = {}
    for name, c in cases.items():
        def attn(q, k, v):
            return parallel.full_attention(q, k, v, causal=c["causal"])

        res = []
        for g in (None, group):
            blk = bert.Block(c["hidden"], c["heads"], 2 * c["hidden"],
                             torch.float32, attn,
                             torch.Generator().manual_seed(c["seed"]),
                             kv_heads=c["kv_heads"], use_rope=c["rope"],
                             tp_group=g)
            parallel.tp_shard_(blk, g)
            parallel.reset_exchanges()
            o = blk(torch.from_numpy(c["x"]))
            calls = parallel.EXCHANGES["calls"]
            (o * torch.from_numpy(c["ct"])).sum().backward()
            shards = parallel.ParamShards(g)
            res.append({"o": o.detach().numpy(), "forward_exchanges": calls,
                        "grads": {k: shards.full(k, p.grad).numpy()
                                  for k, p in blk.named_parameters()}})
        out[name] = res
    return out


def ep_ffn_ranks(rank, cases):
    """Each case of ``cases`` (name -> dict of the mesh ``axes``, numpy
    ``x``, ``router``, ``wi``, ``wo``, ``ct``, ``k``, ``cf``): ``moe_ffn``
    on the mesh's groups, this rank holding its experts and tensor block
    of ``wi``/``wo`` (``parallel.mesh_local``) and every row.  Its output,
    metrics, and the gradients of ``sum(y * ct) + lb + z``: x's and the
    router's as held, the experts' gathered whole."""
    from tpujob_torch.workloads import parallel

    join()
    out = {}
    for name, c in cases.items():
        mesh = dist.make_mesh(c["axes"])
        x, router = (torch.from_numpy(c[n]).requires_grad_()
                     for n in ("x", "router"))
        wi, wo = (parallel.mesh_local(f"moe.{n}", torch.from_numpy(c[n]),
                                      mesh).clone().requires_grad_()
                  for n in ("wi", "wo"))
        y, m = parallel.moe_ffn(x, router, wi, wo, k=c["k"],
                                capacity_factor=c["cf"],
                                groups=parallel.moe_groups(mesh))
        ((y * torch.from_numpy(c["ct"])).sum() + m["load_balance"]
         + m["router_z"]).backward()
        shards = parallel.ParamShards(mesh.group("tensor"),
                                      mesh.group("expert"))
        out[name] = {"y": y.detach().numpy(),
                     "metrics": {k: v.detach().numpy()
                                 for k, v in m.items()},
                     "x": x.grad.numpy(), "router": router.grad.numpy(),
                     "wi": shards.full("moe.wi", wi.grad).numpy(),
                     "wo": shards.full("moe.wo", wo.grad).numpy(),
                     "local_experts": wi.shape[0]}
    leave()
    return out


def seq_route_ranks(rank, cases):
    """Each case of ``cases`` (name -> dict of numpy ``x`` [b, S, d],
    ``router``, ``wi``, ``wo``, ``k``, ``cf``, optional ``valid`` [b, S],
    and ``zigzag``): this rank's shard of each sequence over the world's
    sequence group (its contiguous block, or the zigzag pair of chunks)
    through ``moe_route`` + ``seq_route`` and ``moe_ffn``: its positions,
    experts, slots, keep flags, dropped count and output."""
    import torch.distributed as tdist

    from tpujob_torch.workloads import parallel

    join()
    n = tdist.get_world_size()
    group = dist.make_mesh({"sequence": n}).group("sequence")
    out = {}
    for name, c in cases.items():
        seq = c["x"].shape[1]
        pos = (parallel.zigzag_index(seq, n, rank) if c["zigzag"]
               else np.arange(rank * seq // n, (rank + 1) * seq // n))
        x = torch.from_numpy(c["x"][:, pos])
        valid = (None if c.get("valid") is None
                 else torch.from_numpy(c["valid"][:, pos]))
        positions = torch.from_numpy(pos)
        num_experts = c["router"].shape[1]
        cap = parallel.moe_capacity(seq, num_experts, c["k"], c["cf"])
        r = parallel.moe_route(x, torch.from_numpy(c["router"]), c["k"],
                               cap, valid)
        r = parallel.seq_route(r, group, positions, cap)
        y, m = parallel.moe_ffn(
            x, *(torch.from_numpy(c[k]) for k in ("router", "wi", "wo")),
            k=c["k"], capacity_factor=c["cf"], valid=valid,
            groups=parallel.MoEGroups(sequence=group), positions=positions)
        out[name] = {"positions": pos, "expert_idx": r.expert_idx.numpy(),
                     "slot": r.pos.long().numpy(), "keep": r.keep.numpy(),
                     "dropped": m["dropped"].item(), "y": y.numpy()}
    leave()
    return out


# ---------------------------------------------------------------------------
# the harness's own contract
# ---------------------------------------------------------------------------


def _echo(rank, fail_rank=None, sleep_s=0.0):
    if rank == fail_rank:
        raise ValueError(f"rank {rank} was told to fail")
    time.sleep(sleep_s)
    return rank, dist.process_env()


def test_results_come_back_in_rank_order_with_the_operators_env(tmp_path):
    outs = spawn(_echo, 3, tmp_path)
    for rank, (got, pe) in enumerate(outs):
        assert got == pe.process_id == rank and pe.num_processes == 3
        assert pe.coordinator_address.startswith(f"file://{tmp_path}")


def test_a_failing_rank_fails_the_test_with_its_traceback(tmp_path):
    with pytest.raises(pytest.fail.Exception,
                       match="(?s)rank 1 of 2 failed.*was told to fail"):
        spawn(_echo, 2, tmp_path, 1)


def test_a_spawn_past_its_timeout_is_killed(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match="outlived its 5 s"):
        spawn(_echo, 2, tmp_path, None, 600.0, timeout=5)
    assert time.monotonic() - t0 < 60
