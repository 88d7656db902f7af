"""Send/recv smoke workload: the port of ``tpujob/workloads/smoke_dist.py``.

The reference's master sends a random 2x2 tensor to each worker, the
worker squares it elementwise and sends it back, and the master logs each
result, validating the injected rendezvous env end to end.  Here as
collectives on the process group: rank 0 draws the tensor from the seed
and broadcasts it (the send), every rank squares its copy, and an
``all_gather`` returns every rank's result to every rank (the recv).  Each
rank checks every result against input²; rank 0 logs them.

Unlike the trainers, the smoke brings a group up even for one process
(on an in-memory store when there is no coordinator): the collectives are
its purpose.  Tensors live on the process's device: NCCL on the card,
gloo on the CPU.

Usage (as the TPUJob container entrypoint):
    python -m tpujob_torch.workloads.smoke_dist            # on the card
    python -m tpujob_torch.workloads.smoke_dist --device cpu
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Optional

import torch
import torch.distributed as tdist

from tpujob_torch.workloads import distributed as dist

log = logging.getLogger("tpujob_torch.smoke_dist")

# the injected env, logged as the reference logs it (dist_sendrecv.py:44-54)
ENV_VARS = (
    "TPUJOB_COORDINATOR_ADDRESS", "TPUJOB_NUM_PROCESSES", "TPUJOB_PROCESS_ID",
    "TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES", "TPU_TOPOLOGY",
    "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
)


def work(x: torch.Tensor) -> torch.Tensor:
    """What each worker computes on the tensor it received: its square."""
    return x * x


def run(device, seed: int = 0) -> bool:
    """One broadcast, one square a rank, one all_gather, on the live group.
    True when every rank's result equals input²."""
    device = torch.device(device)
    inp = torch.zeros(2, 2, device=device)
    if tdist.get_rank() == 0:
        gen = torch.Generator().manual_seed(seed)
        inp.copy_(torch.randn(2, 2, generator=gen))
    tdist.broadcast(inp, src=0)
    result = work(inp)
    results = [torch.empty_like(result) for _ in range(tdist.get_world_size())]
    tdist.all_gather(results, result)
    expected = inp * inp
    if tdist.get_rank() == 0:
        for i, r in enumerate(results):
            log.info("Result from participant %d : %s", i, r.tolist())
    return all(bool((r - expected).abs().max() < 1e-6) for r in results)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="send/recv smoke (PyTorch port)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s:%(name)s:%(message)s")
    for var in ENV_VARS:
        log.info("%s: %s", var, os.environ.get(var, "{}"))
    device = dist.local_device(args.device)
    pe = dist.process_env()
    own = not tdist.is_initialized()
    if own:
        dist.init_group(pe, device)
    else:
        dist.initialize(pe)  # the caller's group must be the env's
    try:
        log.info("torch %s, backend %s, device %s, process %d/%d",
                 torch.__version__, tdist.get_backend(), device,
                 tdist.get_rank(), tdist.get_world_size())
        ok = run(device, args.seed)
    finally:
        if own:
            dist.shutdown()
    log.info("smoke send/recv %s", "PASSED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
