"""Carry weights across from the JAX package's flax models.

``params_from_flax`` takes a flax variable tree as nested dicts of numpy
arrays (``{"params": {...}}``, that and ``{"batch_stats": {...}}``, or the
inner params dict) and returns a state dict for the port's module of the
same architecture.  The port names its submodules after the flax ones, so
the map is mechanical:

- a path ``a/b/c`` becomes the key ``a.b.c``;
- ``Dense`` ``kernel`` ``[in, out]`` becomes ``weight`` ``[out, in]``;
- ``Conv`` ``kernel`` HWIO ``[kh, kw, in, out]`` becomes ``weight`` OIHW
  ``[out, in, kh, kw]``;
- ``LayerNorm``/``BatchNorm`` ``scale``/``bias`` become ``weight``/``bias``;
- ``BatchNorm`` ``batch_stats`` ``mean``/``var`` become the buffers
  ``running_mean``/``running_var``;
- ``Embed`` ``embedding`` becomes ``weight``; ``pos_embed`` stays.

With a ``mesh`` whose expert or tensor axis is longer than 1, each
parameter ``parallel.EP_RULES`` or ``parallel.TP_RULES`` splits is cut
to this rank's block of it (its experts, its block of each), so a model
under expert or tensor parallelism starts from the JAX package's
weights at any layout (FSDP then shards the module it is loaded into).
With a pipeline axis longer than 1 only this rank's stage's layers are
kept (``parallel.stage_layers``).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from tpujob_torch.workloads import parallel

_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for name, value in tree.items():
        path = f"{prefix}/{name}" if prefix else name
        if isinstance(value, dict):
            yield from _flatten(value, path)
        else:
            yield path, value


def _collections(tree: Dict[str, Any]):
    """(collection name, its tree) pairs: a bare params dict is 'params'."""
    if "params" in tree and set(tree) <= {"params", "batch_stats"}:
        return list(tree.items())
    return [("params", tree)]


def params_from_flax(tree: Dict[str, Any], mesh=None
                     ) -> Dict[str, torch.Tensor]:
    """Flax variable tree (numpy leaves) -> torch state dict: the whole
    parameters, or with ``mesh`` this rank's blocks of them
    (``parallel.mesh_local``) and of a pipeline only its stage's layers."""
    out: Dict[str, torch.Tensor] = {}
    stage = parallel.stage_layers(
        sum(k.startswith("layer_") for _, sub in _collections(tree)
            for k in sub), mesh)
    for collection, sub in _collections(tree):
        for path, value in _flatten(sub):
            parts = path.split("/")
            leaf = parts[-1]
            arr = np.array(value, dtype=np.float32)
            if collection == "batch_stats":
                if leaf not in _STATS:
                    raise ValueError(f"batch_stats/{path}: expected a "
                                     "BatchNorm mean or var")
                parts[-1] = _STATS[leaf]
            elif leaf == "kernel":
                if arr.ndim == 2:
                    arr = arr.T
                elif arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
                else:
                    raise ValueError(f"{path}: expected a 2-D Dense or 4-D "
                                     f"Conv kernel, got shape {arr.shape}")
                parts[-1] = "weight"
            elif leaf in ("scale", "embedding"):
                parts[-1] = "weight"
            if stage is not None and parts[0].startswith("layer_") \
                    and int(parts[0][len("layer_"):]) not in stage:
                continue
            name = ".".join(parts)
            out[name] = parallel.mesh_local(
                name, torch.from_numpy(np.ascontiguousarray(arr)),
                mesh).contiguous()
    return out
