"""Device ms a call of the libraries' matrix products (cuBLAS through
``F.linear``) (layer: library matmuls)."""


def read(t):
    if not t.kernels:
        return None
    return t.ms_per_call("matmul")
