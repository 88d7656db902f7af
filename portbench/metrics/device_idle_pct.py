"""Share of the traced window in which no kernel, copy or fill ran on
the device, in % (layer: the device)."""


def read(t):
    if not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
