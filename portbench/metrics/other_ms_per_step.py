"""Device ms a call of kernels outside the matmul and flash classes:
casts, AdamW, LayerNorm, GELU, the cross-entropy, the gradient fold
(layer: the model step)."""


def read(t):
    if not t.kernels:
        return None
    return t.ms_per_call("other")
