"""Device-idle ms a call while the innermost of the loop's spans open on
the host is ``tpujob.step`` or one of its parts (``tpujob.step.inputs``,
``.launch``, ``.eager``): the step's copy into its static inputs and its
launch (layer: the trainer loop)."""
from portbench.metrics import _phases


def read(t):
    idle = _phases.idle_ms_by_span(t)
    if idle is None:
        return None
    return sum(ms for name, ms in idle.items() if _phases.is_step(name))
