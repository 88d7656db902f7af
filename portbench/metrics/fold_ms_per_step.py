"""Device ms a call of the kernels between each call's
``tpujob_mark_backward`` and ``tpujob_mark_fold`` marks: the gradient
accumulator's fold; nothing where the step has no accumulator (layer: the
compiled step)."""
from portbench.metrics import _phases


def read(t):
    return _phases.phase_ms(t, "fold")
