"""Device kernels in the trace a call of the train step, over whole
accumulation groups (layer: the compiled step)."""


def read(t):
    if not t.kernels:
        return None
    return len(t.kernels) / t.calls
