"""The weights of a run, made by the benchmark from the seed and handed to
both the program and the reference.

The layout (names, shapes, groups) is the architecture's
(``portbench/models/<architecture>.py``: ``groups``).  Every ``normal``
leaf is normal(0, the configuration's ``init_std``), ``zeros`` and
``ones`` as named, in fp32 (the type the weights are held in).  They are
drawn on the device with a ``torch.Generator`` there, one call a group,
each group from its own seed.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def group_values(layout: List[list], index: int, std: float, seed: int,
                 device) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, fp32 tensor) of group ``index``, drawn in one call."""
    group = layout[index]
    count = sum(_numel(s) for _, s, kind in group if kind == "normal")
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 0x9E3779B1 + 7919 * index) % 2 ** 63)
    flat = torch.empty(count, dtype=torch.float32, device=device)
    flat.normal_(0.0, std, generator=gen)
    at = 0
    for name, shape, kind in group:
        if kind == "normal":
            n = _numel(shape)
            yield name, flat[at:at + n].view(shape)
            at += n
        elif kind == "zeros":
            yield name, torch.zeros(shape, dtype=torch.float32, device=device)
        else:
            yield name, torch.ones(shape, dtype=torch.float32, device=device)


def all_values(layout: List[list], std: float, seed: int, device
               ) -> Iterator[Tuple[str, torch.Tensor]]:
    for i in range(len(layout)):
        yield from group_values(layout, i, std, seed, device)


def load_into(params: Dict[str, torch.Tensor], layout: List[list], std: float,
              seed: int) -> None:
    """Copy the run's weights into ``params`` (name -> parameter), which
    must hold exactly the layout's leaves with its shapes."""
    names = {name for group in layout for name, _, _ in group}
    if set(params) != names:
        raise ValueError(
            "the model's parameters are not the configuration's leaves: "
            f"missing {sorted(names - set(params))[:5]}, "
            f"extra {sorted(set(params) - names)[:5]}")
    device = next(iter(params.values())).device
    with torch.no_grad():
        for name, value in all_values(layout, std, seed, device):
            if tuple(params[name].shape) != tuple(value.shape):
                raise ValueError(f"{name}: shape {tuple(params[name].shape)}, "
                                 f"the configuration's {tuple(value.shape)}")
            params[name].copy_(value)
