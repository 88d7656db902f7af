"""Model FLOPs of the traced calls (the architecture's ``flops_per_call``:
no recompute) over the traced window's time and the card's dense bf16
peak, in % (layer: the model step)."""


def read(t):
    flops = t.counts.get("flops_per_call")
    if not t.kernels or not t.peak_flops or not flops:
        return None
    return 100.0 * flops * t.calls / t.window_s / t.peak_flops
