"""The roofline-bound ms of a call's grouped products (the architecture's
``moe_gemm_bound_ms_per_call``: every assignment's rows, dropless, so from
the shapes alone) over the device ms of the grouped-GEMM kernels, in %
(layer: hand-written kernels).  Nothing where none ran or the
architecture gives no bound."""
from portbench.metrics import moe_gemm_ms_per_step


def read(t):
    bound = t.counts.get("moe_gemm_bound_ms_per_call")
    ms = moe_gemm_ms_per_step.ms_per_call(t)
    if not ms or not bound:
        return None
    return 100.0 * bound / ms
