"""The port of ``__graft_entry__.py``: its ``entry`` and
``dryrun_multichip`` on PyTorch.

``entry(device)`` returns the forward of the flagship model (BERT-large,
``workloads/bert.py``, bf16, dense attention) as a function of
``(params, ids)`` with example arguments, ready for ``torch.compile`` or a
CUDA graph by its caller.

``dryrun_multichip(n, device)`` runs the JAX package's multi-device matrix
(``dryrun_cases``: every strategy at n ranks, the data axis above 1 where
n allows) as ``n`` processes over gloo, each rank one full training step
of a tiny BERT per case through ``workloads/bert.run``, and raises unless
every case ran with the mesh the reference hands its ``run``, a finite
loss, and 1F1B's loss within 1e-3 of GPipe's.  On the card all ``n``
ranks share it (gloo carries their collectives: NCCL refuses two ranks on
one card).

    python -m tpujob_torch.graft_entry [n] [--device cpu]

Two differences from the reference, deliberate:

- The JAX package's ``run`` takes its strategy from the mesh it is handed;
  the port's takes it from its flags (``bert.mesh_axes``).  So each case's
  argv carries the flags that give the reference's mesh, and the dryrun
  checks on every rank that they give exactly that mesh.
- The reference fails on XLA's "Involuntary full rematerialization"
  warning (an SPMD resharding of a tensor every step).  The port has no
  compiler that inserts resharding: every exchange is a collective it
  writes, so there is no counterpart to check.  Nor does it skip TP x PP
  (the reference does where its JAX cannot partial-manual ``shard_map``).
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import math
import sys
import tempfile
from typing import Callable, Dict, List, Optional

import torch

# a rank's rendezvous and collectives, and the whole spawn (the reference
# gives its dryrun subprocess 1,800 s)
RANK_TIMEOUT = datetime.timedelta(seconds=600)
DRYRUN_TIMEOUT_S = 1800.0
# 1F1B computes GPipe's step with another schedule (the reference's bound)
F1B_ATOL = 1e-3


def entry(device="cuda"):
    """(fn, (params, ids)): BERT-large's MLM logits as a function of its
    parameters (a name -> tensor dict) and ``ids`` ([4, 128] zeros)."""
    from tpujob_torch import resolve_device
    from tpujob_torch.workloads import bert

    dev = resolve_device(device)
    model = bert.Bert(dtype=torch.bfloat16).to(dev)  # BERT-large defaults
    params = dict(model.named_parameters())
    ids = torch.zeros((4, 128), dtype=torch.int64, device=dev)

    def fn(params, ids):
        return torch.func.functional_call(model, params, (ids,))

    return fn, (params, ids)


def _pick_axes(n: int) -> dict:
    """Real parallelism axes for an n-device mesh: tensor and sequence get
    ICI-neighbour factors, data absorbs the rest (can exceed 1 only when n
    has enough factors)."""
    axes = {"data": -1}
    rem = n
    if rem % 2 == 0:
        axes["tensor"] = 2
        rem //= 2
    if rem % 2 == 0:
        axes["sequence"] = 2
        rem //= 2
    return axes


@dataclasses.dataclass(frozen=True)
class Case:
    """One case of the matrix: the flags beside the base argv, the axes the
    JAX package hands ``bertlib.run`` as its mesh, and the reference's
    line (``{mesh}`` and ``{loss}`` filled in)."""

    name: str
    flags: tuple
    axes: dict
    line: str


def dryrun_cases(n: int) -> List[Case]:
    """The reference's matrix at ``n`` ranks, in its order and under its
    guards (``n % 2`` for Ulysses, EP, GPipe and 1F1B; ``n % 4`` for
    FSDP x TP, TP x PP and FSDP x SP)."""
    axes = _pick_axes(n)
    flags = (("--tensor-parallel", "2") if "tensor" in axes else ()) + (
        ("--sequence-parallel", "2") if "sequence" in axes else ())
    cases = [Case("dp_tp_sp", flags, axes,
                  "mesh axes {mesh} ok, one full train step executed, "
                  "loss={loss:.3f}")]
    pp = ("--pipeline-parallel", "2", "--pipeline-microbatches", "4")
    if n % 2 == 0:
        cases += [
            Case("ulysses", ("--sequence-parallel", "2", "--sp-mode",
                             "ulysses"), {"data": -1, "sequence": 2},
                 "ulysses SP mesh {mesh} ok, loss={loss:.3f}"),
            Case("expert", ("--moe-experts", "4", "--expert-parallel", "2"),
                 {"data": -1, "expert": 2},
                 "expert-parallel MoE mesh {mesh} ok, loss={loss:.3f}"),
            Case("gpipe", pp, {"data": -1, "pipeline": 2},
                 "pipeline mesh {mesh} ok, loss={loss:.3f}"),
            Case("1f1b", pp + ("--pipeline-schedule", "1f1b"),
                 {"data": -1, "pipeline": 2},
                 "1f1b schedule ok, loss={loss:.3f} (matches gpipe)"),
        ]
    if n % 4 == 0:
        cases += [
            Case("fsdp_tp", ("--fsdp", "2", "--tensor-parallel", "2"),
                 {"data": -1, "fsdp": 2, "tensor": 2},
                 "fsdp x tensor mesh {mesh} ok, loss={loss:.3f}"),
            Case("tp_pp", ("--pipeline-parallel", "2", "--tensor-parallel",
                           "2", "--pipeline-microbatches", "4"),
                 {"data": -1, "pipeline": 2, "tensor": 2},
                 "data x pipeline x tensor mesh {mesh} ok, loss={loss:.3f}"),
            Case("fsdp_sp", ("--fsdp", "2", "--sequence-parallel", "2"),
                 {"data": -1, "fsdp": 2, "sequence": 2},
                 "fsdp x sequence mesh {mesh} ok, loss={loss:.3f}"),
        ]
    return cases


def base_argv(n: int, device: str, logdir: str) -> List[str]:
    """The reference's base argv (a 2-layer BERT at hidden 64, vocab 211,
    seq 64, a global batch of 4 rows a rank, fp32, one step), on
    ``device`` and logging under ``logdir``."""
    return ["--vocab", "211", "--hidden", "64", "--layers", "2", "--heads",
            "4", "--intermediate", "128", "--seq-len", "64", "--batch-size",
            str(4 * n), "--steps", "1", "--no-bf16", "--log-interval", "1",
            "--dir", logdir, "--device", device]


def case_mesh(case: Case, n: int) -> Dict[str, int]:
    """The mesh the reference runs ``case`` on: its axes at ``n`` ranks."""
    from tpujob_torch.workloads import distributed as dist

    return dict(zip(*dist.mesh_shape(case.axes, n)))


def run_case(case: Case, n: int, device: str, logdir: str) -> dict:
    """One case on this rank through ``bert.run``: its result, after the
    checks that its flags give the case's mesh and its loss is finite."""
    from tpujob_torch.workloads import bert
    from tpujob_torch.workloads import distributed as dist

    args = bert.build_parser().parse_args(
        base_argv(n, device, logdir) + list(case.flags))
    got = dict(zip(*dist.mesh_shape(bert.mesh_axes(args), n)))
    if got != case_mesh(case, n):
        raise RuntimeError(f"dryrun_multichip({n}) {case.name}: the flags "
                           f"{list(case.flags)} give the mesh {got}, the "
                           f"reference runs on {case_mesh(case, n)}")
    res = bert.run(args)
    if not math.isfinite(res["final_loss"]):
        raise RuntimeError(f"dryrun_multichip({n}) {case.name}: loss is "
                           f"{res['final_loss']}")
    return res


def run_cases(n: int, device: str, logdir: str,
              on_case: Optional[Callable[[Case, dict], None]] = None,
              ) -> Dict[str, float]:
    """Every case of ``dryrun_cases(n)`` in order on this rank of an
    ``n``-rank group (every rank runs them together, so each makes its
    meshes' groups in one order): ``{case: final loss}``, the reference's
    line printed for each, ``on_case(case, result)`` after each."""
    losses = {}
    for case in dryrun_cases(n):
        res = run_case(case, n, device, logdir)
        loss = losses[case.name] = res["final_loss"]
        if case.name == "1f1b" and abs(loss - losses["gpipe"]) >= F1B_ATOL:
            raise RuntimeError(f"dryrun_multichip({n}): 1f1b loss {loss} != "
                               f"gpipe {losses['gpipe']}")
        print(f"dryrun_multichip({n}): " + case.line.format(
            mesh=case_mesh(case, n), loss=loss), flush=True)
        if on_case is not None:
            on_case(case, res)
    return losses


def _dryrun_rank(rank: int, n: int, device: str, logdir: str) -> dict:
    """One spawned rank: the group over gloo (on the card too), then every
    case."""
    import torch.distributed as tdist

    from tpujob_torch.workloads import distributed as dist

    dist.initialize(device=dist.local_device(device), backend="gloo",
                    timeout=RANK_TIMEOUT)
    losses = run_cases(n, device, logdir)
    tdist.barrier()
    dist.shutdown()
    return losses


def dryrun_multichip(n: int, device: str = "cuda") -> Dict[str, float]:
    """The matrix at ``n`` gloo ranks on ``device`` (``n`` processes, once):
    ``{case: final loss}``.  Raises if a rank fails or outlives
    ``DRYRUN_TIMEOUT_S``, if the ranks' losses differ, or on any case's
    check."""
    from tpujob_torch import resolve_device
    from tpujob_torch.workloads import distributed as dist

    resolve_device(device)  # no card: raise here, never run on the CPU
    with tempfile.TemporaryDirectory(prefix="tpujob_dryrun_") as logdir:
        ranks = dist.spawn_local(_dryrun_rank, n, n, device, logdir,
                                 timeout_s=DRYRUN_TIMEOUT_S)
    if any(r != ranks[0] for r in ranks[1:]):
        raise RuntimeError(f"dryrun_multichip({n}): the ranks' losses "
                           f"differ: {ranks}")
    return ranks[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", nargs="?", type=int, default=8,
                   help="ranks (default 8)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
