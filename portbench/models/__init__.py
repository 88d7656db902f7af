"""Model architectures, one module a family, found by the configuration's
``architecture`` key (``portbench/models/<architecture>.py``).

Each module gives, from the configuration's ``model`` block alone:

- ``groups(model)``: the weights' layout, ``[[(name, shape, init), ...],
  ...]`` under the port's parameter names, one group drawn in one call
  (``portbench/weights.py``); ``init`` is ``normal``, ``zeros`` or ``ones``;
- ``port_flags(model)``: the port's command-line flags of these sizes;
- ``counts(model, batch, seq, remat, elem_bytes)``: numbers of one call of
  the train step that the per-layer readers take (``flops_per_call``, the
  model FLOPs with no recompute; any roofline bounds), by name.

Nothing here imports the port.
"""
from __future__ import annotations

import importlib


def of(cfg: dict):
    return importlib.import_module(f"portbench.models.{cfg['architecture']}")
