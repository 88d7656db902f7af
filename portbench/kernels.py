"""Classes of device kernels by name.

``kernel_class`` is a frozen copy of ``chip_smoke.kernel_class`` at commit
0e61eec (``chip_smoke.py:919-932``): the port's hand-written flash kernels
by their CUDA names (``tpujob_torch/csrc/flash_{fwd,dq,dkv}[_any].cu``),
convolutions, the libraries' matrix products, and the rest.
"""
from __future__ import annotations

FLASH_KERNELS = ("flash_fwd_any", "flash_dq_any", "flash_dkv_any",
                 "flash_fwd", "flash_dq", "flash_dkv")


def kernel_class(name: str) -> str:
    """The hand-written flash kernels by name, convolutions, matrix
    products, the rest."""
    low = name.lower()
    for kernel in FLASH_KERNELS:
        if kernel + "_kernel" in low:
            return kernel
    if any(m in low for m in ("conv", "fprop", "dgrad", "wgrad")):
        return "conv"
    if any(m in low for m in ("gemm", "cutlass", "nvjet", "xmma", "matmul")):
        return "matmul"
    return "other"


def layer_class(name: str) -> str:
    """``flash``, ``matmul`` or ``other`` (convolutions count as other:
    these models run none)."""
    cls = kernel_class(name)
    if cls in FLASH_KERNELS:
        return "flash"
    return "matmul" if cls == "matmul" else "other"
