"""Device ms a call of the kernels between each call's
``tpujob_mark_forward`` and ``tpujob_mark_backward`` marks: the backward,
remat's second forward included (layer: the model step)."""
from portbench.metrics import _phases


def read(t):
    return _phases.phase_ms(t, "backward")
