"""Device ms a call, over every call, of the kernels between a call's
``tpujob_mark_fold`` (or, with no accumulator, ``tpujob_mark_backward``)
and ``tpujob_mark_update`` marks: AdamW, once a call or once a group
(layer: the model step)."""
from portbench.metrics import _phases


def read(t):
    return _phases.phase_ms(t, "optimizer")
