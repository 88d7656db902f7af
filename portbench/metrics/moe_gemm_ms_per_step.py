"""Device ms a call of the grouped-GEMM kernels of the dropless expert
layers, the kernels whose names hold ``moe_gemm`` (forward, dX and dW);
nothing where none ran (layer: hand-written kernels)."""

NAME = "moe_gemm"


def ms_per_call(t):
    us = sum(d for n, _, d in t.kernels if NAME in n)
    return us / 1e3 / t.calls if us else None


def read(t):
    return ms_per_call(t)
