"""Device ms a call of the kernels inside the dropless expert layers: each
kernel whose latest preceding expert mark is ``tpujob_mark_moe_in`` (the
layer marks it where its work starts, ``tpujob_mark_moe_out`` where it
ends, in the forward, remat's recompute and the backward alike; a
recompute that stops early leaves its ``moe_in`` closed by the backward's
own).  Routing, the permutations, the grouped GEMMs, SwiGLU and the
combine; nothing where the trace holds no expert mark (layer: expert
layer)."""

MOE_IN, MOE_OUT = "tpujob_mark_moe_in", "tpujob_mark_moe_out"


def read(t):
    inside, us, seen = False, 0.0, False
    for name, _, d in sorted(t.kernels, key=lambda e: e[1]):
        if name in (MOE_IN, MOE_OUT):
            inside, seen = name == MOE_IN, True
        elif inside:
            us += d
    return us / 1e3 / t.calls if seen else None
