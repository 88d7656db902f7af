"""PyTorch ports of ``tpujob/workloads`` (same module names).

Ported so far: the GPT causal-LM trainer with its decode (``gpt``), the
BERT masked-LM trainer and the transformer trunk both share (``bert``),
both on synthetic ids or a real corpus, the byte-level BPE tokenizer
(``tokenizer``), the MNIST example (``mnist``), ResNet (``resnet``), the
training core with gradient accumulation, the profiler and the progress
telemetry (``train_lib``), the flash-attention kernels' wrapper
(``flash``), the dense attention reference (``parallel``), the
single-process bootstrap and the progress heartbeat (``distributed``),
the data (``data``: synthetic sets, MNIST files, corpora) and the
flax-to-torch weight map (``convert``).
"""
from tpujob_torch import resolve_device

__all__ = ["resolve_device"]
