"""The optimizer's update on the card: ``AdamW``, torch's AdamW whose
``step`` runs the whole update of each parameter group in one pass over
each tensor (``csrc/adamw.cu``), where torch's capturable foreach route ran
some ten passes a tensor and made a full-size temporary.

``train_lib.adamw`` builds it where the parameters are on the card, FSDP's
DTensors included: AdamW works element by element, so the kernel updates
each DTensor's local shard.  The CPU keeps torch's AdamW.  The state is
torch's, key for key (``step``, ``exp_avg``, ``exp_avg_sq``), made at the
first update by torch's own ``_init_group``, so state dicts load into
either class.

``UPDATES`` counts the parameter tensors each route updated: ``"kernel"``
here, ``"torch"`` by ``count_torch``, the hook ``train_lib.adamw`` puts on
torch's AdamW; a captured step's replays add what its capture recorded
(``train_lib._Graphs``).  The kernel's launches count in
``build.LAUNCHES`` as ``adamw``."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.distributed.tensor import DTensor

UPDATES: Dict[str, int] = {"kernel": 0, "torch": 0}


def count_torch(optimizer, _args, _kwargs) -> None:
    """A step-post hook of torch's own AdamW: the tensors it updated,
    counted under ``"torch"``."""
    UPDATES["torch"] += sum(p.grad is not None for g in optimizer.param_groups
                            for p in g["params"])


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _check(group, params, grads, tensors) -> None:
    """Raise on what the kernel does not take; ``tensors`` are the local
    ones it is given."""
    if group["amsgrad"] or group["maximize"]:
        raise ValueError("the AdamW kernel has no amsgrad or maximize")
    device = tensors[0][0].device
    for p, g in zip(params, grads):
        if isinstance(p, DTensor) and g.placements != p.placements:
            raise ValueError(
                f"the AdamW kernel takes a DTensor's gradient with its "
                f"parameter's placements, got {g.placements} for "
                f"{p.placements}")
    for p, g, m, v, s in zip(*tensors):
        for t in (p, g, m, v):
            if not (t.dtype == torch.float32 and t.device == device
                    and t.is_contiguous() and t.numel() == p.numel()):
                raise ValueError(
                    "the AdamW kernel takes contiguous fp32 parameters, "
                    "gradients and moments of one length on one card; got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device} for a "
                    f"parameter {tuple(p.shape)}")
        if s.dtype != torch.float32 or s.device != device:
            raise ValueError(f"step count {s.dtype} on {s.device}")


def launch(group, params, grads, exp_avgs, exp_avg_sqs, steps) -> None:
    """One AdamW update of ``params`` on the current stream, as the group's
    hyper-parameters say, with the step counts already advanced.  The lr
    is read on the card: the group's 0-d lr tensor, or one filled from its
    float lr (FSDP's groups, whose step is eager)."""
    from tpujob_torch.kernels import build

    tensors = [[_local(t) for t in ts]
               for ts in (params, grads, exp_avgs, exp_avg_sqs)] + [steps]
    _check(group, params, grads, tensors)
    device = tensors[0][0].device
    lr = group["lr"]
    if not isinstance(lr, torch.Tensor):
        lr = torch.full((), float(lr), dtype=torch.float32, device=device)
    if not (lr.device == device and lr.dtype == torch.float32
            and lr.numel() == 1):
        raise ValueError(f"the AdamW kernel reads the lr on the "
                         f"parameters' card in fp32, got {lr!r}")
    b1, b2 = (float(b) for b in group["betas"])
    ptrs = np.array([[t.data_ptr() for t in ts] for ts in zip(*tensors)],
                    dtype=np.int64)
    sizes = np.array([t.numel() for t in tensors[0]], dtype=np.int64)
    build.launch("adamw", "tpujob_adamw", ptrs.ctypes.data, sizes.ctypes.data,
                 len(sizes), lr.data_ptr(), float(group["weight_decay"]), b1,
                 b2, 1 - b1, 1 - b2, float(group["eps"]),
                 torch.cuda.current_stream(device).cuda_stream)


class AdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` whose update is one kernel launch a group
    (``launch``), on parameters on the card.  Keeps ``Optimizer``'s step
    hooks, global ones included."""

    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        with torch.no_grad():
            for group in self.param_groups:
                p, g, m, v, steps = [], [], [], [], []
                self._init_group(group, p, g, m, v, [], steps)
                if p:
                    torch._foreach_add_(steps, 1)
                    launch(group, p, g, m, v, steps)
                    UPDATES["kernel"] += len(p)
        return loss

    def load_state_dict(self, state_dict) -> None:
        """torch's, then the step counts beside the parameters, where the
        kernel reads them: the saved groups' ``capturable`` decides where
        torch puts them, and a checkpoint saved on the CPU says host."""
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            group["capturable"] = True
            for p in group["params"]:
                state = self.state.get(p)
                if state and "step" in state:
                    state["step"] = state["step"].to(p.device, torch.float32)
