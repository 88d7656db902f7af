"""tpujob_torch — the PyTorch/CUDA port of ``tpujob``'s accelerator half.

The JAX package (``tpujob/workloads``) is the reference; this package
mirrors its module names one for one and runs on an NVIDIA Hopper card
(sm_90a).  It imports neither JAX nor anything of ``tpujob``.  Every
entry point runs on ``cuda`` unless the caller asks for ``cpu``; asking
for ``cuda`` where there is no card raises instead of falling back.

- ``tpujob_torch.workloads`` — the trainers and their training core,
  distributed bootstrap and data.  Entry points:
  ``python -m tpujob_torch.workloads.bert`` (BERT-large masked LM) and
  ``python -m tpujob_torch.workloads.gpt`` (GPT-2-medium causal LM, with
  ``--generate N`` to decode after training), both with ``--data-file`` /
  ``--tokenizer`` for a real corpus; ``python -m
  tpujob_torch.workloads.mnist`` and ``python -m
  tpujob_torch.workloads.resnet``; ``python -m
  tpujob_torch.workloads.tokenizer`` (train / inspect a BPE).
- ``tpujob_torch.csrc``      — the hand-written CUDA C++ kernels.
- ``tpujob_torch.kernels``   — builds them with ``nvcc`` at first use and
  binds them with ``ctypes``.
"""
from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """``"cuda"``/``"cuda:N"``/``"cpu"`` (or a ``torch.device``) as a device.

    A CUDA device without a card is an error, never a silent CPU run: the
    port exists to run on the card, and a CPU number must not pass for a
    device one."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch sees no CUDA card; "
                "pass --device cpu to run on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {name!r} requested but only "
                f"{torch.cuda.device_count()} CUDA card(s) are visible")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev
