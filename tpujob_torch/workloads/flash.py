"""Flash attention: the port of ``tpujob/workloads/flash.py``.

Three hand-written CUDA kernels for Hopper replace the three Pallas ones:

====================  ==============================  =========================
kernel (wrapper)      source                          replaces
====================  ==============================  =========================
``flash_fwd_cuda``    ``csrc/flash_fwd.cu``           ``_flash_kernel``
``flash_dq_cuda``     ``csrc/flash_dq.cu``            ``_dq_kernel``
``flash_dkv_cuda``    ``csrc/flash_dkv.cu``           ``_dkv_kernel``
====================  ==============================  =========================

Beside each kernel sits its plain PyTorch version with the same math
(``flash_forward_ref``, ``flash_dq_ref``, ``flash_dkv_ref``).  A wrapper
takes the plain version only for tensors on the CPU; on a CUDA tensor it
launches its kernel or raises — it never falls back.  ``LAUNCHES`` counts
kernel launches, one per launch, so a run can show that it went through
the kernels.

Unlike the Pallas path, a sequence that does not tile is not sent to dense
attention: the kernels mask the ragged edge themselves, so a CUDA tensor
always takes the kernel.  Grouped-query K/V are repeated up to the query
heads before the kernels, as the JAX wrapper does.

Layouts: q, k, v, o are ``[batch, seq, heads, head_dim]``; the logsumexp is
flat ``[batch, heads, seq]`` fp32 (the reference's 128-lane replication is
a TPU layout rule, not semantics).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from tpujob_torch.workloads.parallel import _gqa_repeat

NEG_INF = -1e30  # finite, as in the reference kernels

# kernel launches since the last reset_launches(), by kernel
LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}

# the head dims the CUDA kernels are instantiated for (each source's
# template on D, launched by its C entry point's switch)
KERNEL_HEAD_DIMS = (64, 32)


def check_supported(dtype: torch.dtype, head_dim: int) -> None:
    """Raise unless the CUDA kernels take this dtype and head dim (bf16 at
    64 or 32; other variants are not ported yet).  The one owner of that
    limit: model builders call it before touching the card, and every
    kernel launch calls it again."""
    if dtype != torch.bfloat16 or head_dim not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"the flash kernels take bf16 at head dim "
            f"{' or '.join(map(str, KERNEL_HEAD_DIMS))}, got {dtype} at "
            f"head dim {head_dim}: not yet ported")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain versions (CPU path; the yardstick of correctness on the card)
# ---------------------------------------------------------------------------


def _visible(sq: int, sk: int, causal: bool, window: int, device):
    """[sq, sk] bool mask of visible (query, key) pairs, or None (all)."""
    if not causal:
        return None
    delta = (torch.arange(sq, device=device)[:, None]
             - torch.arange(sk, device=device)[None, :])
    vis = delta >= 0
    if window:
        vis = vis & (delta < window)
    return vis


def _scores(q, k, causal, scale, window):
    """Masked scaled scores in fp32, [b, h, sq, sk] (``_block_scores``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    vis = _visible(q.shape[1], k.shape[1], causal, window, q.device)
    if vis is not None:
        s = s.masked_fill(~vis, NEG_INF)
    return s


def flash_forward_ref(q, k, v, *, causal: bool, scale: float, window: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_flash_kernel``'s function: (o in q's dtype, lse [b, h, sq] fp32),
    fp32 arithmetic throughout."""
    s = _scores(q, k, causal, scale, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    o = (acc / l).permute(0, 2, 1, 3)
    lse = (m + torch.log(l)).squeeze(-1)
    return o.to(q.dtype), lse


def _probs(q, k, lse, causal, scale, window):
    """P recomputed from the saved logsumexp; masked positions are 0."""
    return torch.exp(_scores(q, k, causal, scale, window) - lse[..., None])


def flash_dq_ref(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                 window: int = 0) -> torch.Tensor:
    """``_dq_kernel``'s function: dQ = scale * (P o (dO V^T - D)) K."""
    p = _probs(q, k, lse, causal, scale, window)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def flash_dkv_ref(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                  window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_dkv_kernel``'s function: dV = P^T dO, dK = scale * dS^T Q."""
    p = _probs(q, k, lse, causal, scale, window)
    do32 = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(o, do) -> torch.Tensor:
    """D = rowsum(dO o O) as [b, h, s] fp32 — the softmax-Jacobian row
    term, one torch reduction outside the kernels (as in the reference)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_backward_ref(q, k, v, o, lse, do, *, causal: bool, scale: float,
                       window: int = 0):
    """(dq, dk, dv) by the plain versions of both backward kernels."""
    delta = attention_delta(o, do)
    dq = flash_dq_ref(q, k, v, do, lse, delta, causal=causal, scale=scale,
                      window=window)
    dk, dv = flash_dkv_ref(q, k, v, do, lse, delta, causal=causal,
                           scale=scale, window=window)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------


def _check_kernel_args(name: str, *tensors) -> None:
    for x in tensors:
        if x.device.type != "cuda":
            raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                             f"{x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
    q = tensors[0]
    check_supported(q.dtype, q.shape[-1])
    if any(x.dtype != q.dtype for x in tensors[1:4]):
        raise TypeError(f"{name}: q/k/v/dO must share one dtype, got "
                        f"{[x.dtype for x in tensors[:4]]}")
    if any(x.dtype != torch.float32 for x in tensors[4:]):
        raise TypeError(f"{name}: lse and delta must be fp32")


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_fwd_cuda(q, k, v, *, causal: bool, scale: float, window: int = 0):
    """Launch the forward kernel: (o [b, sq, h, d] bf16, lse [b, h, sq] fp32)."""
    from tpujob_torch.kernels import build

    _check_kernel_args("flash_fwd", q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = build.load("flash_fwd")
    with torch.cuda.device(q.device):
        rc = lib.tpujob_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, d, sq, sk, float(scale), int(causal),
            int(window), _stream(q))
    build.check(rc, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_dq_cuda(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                  window: int = 0):
    """Launch the dQ kernel: dq [b, sq, h, d] bf16."""
    from tpujob_torch.kernels import build

    _check_kernel_args("flash_dq", q, k, v, do, lse, delta)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dq = torch.empty_like(q)
    lib = build.load("flash_dq")
    with torch.cuda.device(q.device):
        rc = lib.tpujob_flash_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, d, sq, sk,
            float(scale), int(causal), int(window), _stream(q))
    build.check(rc, "flash_dq")
    LAUNCHES["flash_dq"] += 1
    return dq


def flash_dkv_cuda(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                   window: int = 0):
    """Launch the dK/dV kernel: (dk, dv) [b, sk, h, d] bf16."""
    from tpujob_torch.kernels import build

    _check_kernel_args("flash_dkv", q, k, v, do, lse, delta)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = build.load("flash_dkv")
    with torch.cuda.device(q.device):
        rc = lib.tpujob_flash_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, d, sq, sk, float(scale), int(causal), int(window),
            _stream(q))
    build.check(rc, "flash_dkv")
    LAUNCHES["flash_dkv"] += 1
    return dk, dv


# ---------------------------------------------------------------------------
# dispatch + autograd
# ---------------------------------------------------------------------------


def _on_cpu(*tensors) -> bool:
    devs = {x.device.type for x in tensors}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"flash attention inputs on mixed/unsupported devices "
                     f"{sorted(devs)}")


def flash_forward(q, k, v, *, causal: bool, scale: float, window: int = 0):
    """(o, lse): the plain version on CPU tensors, the kernel on CUDA ones."""
    if _on_cpu(q, k, v):
        return flash_forward_ref(q, k, v, causal=causal, scale=scale,
                                 window=window)
    return flash_fwd_cuda(q, k, v, causal=causal, scale=scale, window=window)


def flash_backward(q, k, v, o, lse, do, *, causal: bool, scale: float,
                   window: int = 0):
    """(dq, dk, dv): plain versions on CPU tensors, the kernels on CUDA."""
    if _on_cpu(q, k, v, o, lse, do):
        return flash_backward_ref(q, k, v, o, lse, do, causal=causal,
                                  scale=scale, window=window)
    delta = attention_delta(o, do)
    kw = dict(causal=causal, scale=scale, window=window)
    dq = flash_dq_cuda(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_dkv_cuda(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Saves (q, k, v, o, lse) like the reference's ``_flash_fwd``.  Under
    ``torch.utils.checkpoint`` the forward runs again inside backward and
    the recompute's saved tensors are the ones the backward reads."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        o, lse = flash_forward(q, k, v, causal=causal, scale=scale,
                               window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, scale=scale, window=window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do.contiguous(),
                                    **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None, window: int = 0):
    """Flash attention over [batch, seq, heads, head_dim] inputs,
    differentiable through the FlashAttention-2 backward kernels."""
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("window (sliding-window attention) requires "
                         "causal=True")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    # grouped-query K/V broadcast up to the query heads before the kernels
    k, v = _gqa_repeat(q, k, v)
    return _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                        bool(causal), float(scale), int(window))
