"""Device-idle ms a call while the innermost of the loop's spans open on
the host is ``tpujob.feed``: the batch's provider and its copy to the card
(layer: the trainer loop)."""
from portbench.metrics import _phases


def read(t):
    idle = _phases.idle_ms_by_span(t)
    return None if idle is None else idle.get(_phases.FEED, 0.0)
