"""The roofline-bound ms of a call's attention (the architecture's
``attention_bound_ms_per_call``, from the shapes alone) over the device
ms of the flash kernels, in % (layer: hand-written kernels).  Nothing
where no flash kernel ran or the architecture gives no bound."""


def read(t):
    bound = t.counts.get("attention_bound_ms_per_call")
    ms = t.ms_per_call("flash") if t.kernels else 0.0
    if not ms or not bound:
        return None
    return 100.0 * bound / ms
