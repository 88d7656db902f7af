"""Device ms a call of the kernels between each call's
``tpujob_mark_begin`` and ``tpujob_mark_forward`` marks: the forward and
the loss (layer: the model step)."""
from portbench.metrics import _phases


def read(t):
    return _phases.phase_ms(t, "forward")
