"""Causal language modelling through the port's GPT trainer: the model
from ``gpt.build_parser`` / ``gpt.build_model`` (the trunk with causal
attention and ``ln_f``), the loss ``gpt.lm_loss``, a batch ``(ids,)``."""
from __future__ import annotations

from tpujob_torch.workloads import gpt as module

CAUSAL = True


def loss_of(cfg: dict):
    """``loss_of(net) -> loss_fn(batch)`` as ``bert.train`` takes it."""
    return lambda net: module.lm_loss(net)
