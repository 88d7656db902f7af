"""The card's peaks and the roofline bound of one attention call.

Frozen copies, kept here so that a change to the program cannot move the
yardstick:

- ``H100_BF16_FLOPS``, ``H100_BYTES_S``, ``visible_pairs`` and ``bound``:
  ``chip_smoke.py`` at commit 0e61eec (``bound`` and ``visible_pairs`` at
  lines 654-669).  The one bf16 peak serves the flash bound and
  ``mfu_pct`` alike; the benchmark runs on an H100 SXM (80GB HBM3) only.
- ``attention_call_bytes_flops``: the bytes and operations
  ``chip_smoke.run_kernel_case`` gives each flash call (lines 774-779).
"""
from __future__ import annotations

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM
H100_BYTES_S = 3.35e12    # HBM3 bandwidth, H100 SXM


def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the attention must compute for one head."""
    if not causal:
        return sq * sk
    total = 0
    for q in range(sq):
        lo = max(0, q - window + 1) if window else 0
        hi = min(q, sk - 1)
        total += max(0, hi - lo + 1)
    return total


def bound(nbytes: int, flops: int, peak: float = H100_BF16_FLOPS):
    t_mem = nbytes / H100_BYTES_S
    t_ops = flops / peak
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def attention_call_bytes_flops(b: int, s: int, h: int, d: int, causal: bool,
                               elem_bytes: int, window: int = 0) -> dict:
    """{kernel: (bytes, flops)} of one forward, one dQ and one dK/dV call
    on ``[b, s, h, d]`` inputs: each input read once, each output written
    once, the logsumexp and delta rows in fp32."""
    pairs = b * h * visible_pairs(s, s, causal, window)
    qkv = b * s * h * d * elem_bytes
    rows = b * h * s * 4  # one fp32 per row (lse or delta)
    return {"flash_fwd": (4 * qkv + rows, 4 * d * pairs),
            "flash_dq": (5 * qkv + 2 * rows, 6 * d * pairs),
            "flash_dkv": (6 * qkv + 2 * rows, 8 * d * pairs)}

