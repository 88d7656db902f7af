"""Device ms a call of the hand-written flash kernels, by their names
(layer: hand-written kernels)."""


def read(t):
    ms = t.ms_per_call("flash") if t.kernels else 0.0
    return ms or None
