"""Masked language modelling through the port's BERT trainer: the model
from ``bert.build_parser`` / ``bert.build_model`` (the trunk, bidirectional
attention), the loss ``bert.mlm_loss`` with the configuration's [MASK] id,
a batch ``(ids, mask)``."""
from __future__ import annotations

from tpujob_torch.workloads import bert as module

CAUSAL = False


def loss_of(cfg: dict):
    """``loss_of(net) -> loss_fn(batch)`` as ``bert.train`` takes it."""
    mask_id = cfg["model"]["mask_token_id"]
    return lambda net: module.mlm_loss(net, mask_id=mask_id)
