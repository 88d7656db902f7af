"""PyTorch ports of ``tpujob/workloads`` (same module names).

Ported so far: the GPT causal-LM trainer with its decode (``gpt``), the
BERT masked-LM trainer and the transformer trunk both share (``bert``),
the training core with gradient accumulation and the profiler
(``train_lib``),
the flash-attention kernels' wrapper (``flash``), the dense attention
reference (``parallel``), the single-process bootstrap (``distributed``),
synthetic data (``data``) and the flax-to-torch weight map (``convert``).
"""
from tpujob_torch import resolve_device

__all__ = ["resolve_device"]
