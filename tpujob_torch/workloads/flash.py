"""Flash attention: the port of ``tpujob/workloads/flash.py``.

Hand-written CUDA kernels for Hopper replace the three Pallas ones: a
forward, a dQ and a dK/dV kernel (``_flash_kernel``, ``_dq_kernel``,
``_dkv_kernel``) on each of three routes.  ``route`` picks one by dtype
and head dim before the launch; it is the only place that choice is made:

================  ======================================  ===================
route             kernels (source)                        takes
================  ======================================  ===================
``tuned``         ``flash_{fwd,dq,dkv}``                  bf16 at head dim
                  (``csrc/flash_{fwd,dq,dkv}.cu``)        64 or 32
``bf16_128``      ``flash_{fwd,dq,dkv}_bf16_128``         bf16 at head dim
                  (``csrc/flash_*_any.cu`` on             128
                  ``csrc/flash_bf16_128.cuh``)
``any``           ``flash_{fwd,dq,dkv}_any``              fp32 or bf16, the
                  (``csrc/flash_{fwd,dq,dkv}_any.cu``)    rest of 1 to 256
================  ======================================  ===================

The tuned kernels are wgmma/TMA kernels; the ``_any`` ones run on the
tensor cores too (fp32 inputs as three tf32 passes, bf16 with P and dS in
two bf16 parts), fp32 at head dims over 128 on a kernel of its own in
each.  A kernel's name is its C entry point (``tpujob_<name>``) and its
count in ``build.LAUNCHES``.  No wrapper gives way to another kernel, or
to the plain version, when a build or a launch fails: it raises.

Beside the kernels sits their plain PyTorch version with the same math
(``flash_forward_ref``, ``flash_dq_ref``, ``flash_dkv_ref``).  The
dispatch takes it only for tensors on the CPU; a kernel wrapper
(``launch_fwd``, ``launch_dq``, ``launch_dkv``) on a tensor off the card
raises.

Unlike the Pallas path, a sequence that does not tile is not sent to dense
attention: the kernels mask the ragged edge themselves, so a CUDA tensor
always takes a kernel.  Grouped-query K/V are repeated up to the query
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

# the head dims the tuned bf16 kernels are instantiated for (each source's
# template on D, launched by its C entry point's switch)
KERNEL_HEAD_DIMS = (64, 32)
# the largest head dim the _any kernels take (their shared-memory tiles)
MAX_HEAD_DIM = 256
DTYPES = (torch.float32, torch.bfloat16)
KINDS = ("fwd", "dq", "dkv")
ROUTES = ("tuned", "bf16_128", "any")


def check_supported(dtype: torch.dtype, head_dim: int) -> None:
    """Raise unless a CUDA kernel takes this dtype and head dim: fp32 or
    bf16 at head dim 1 to ``MAX_HEAD_DIM``.  The one owner of that limit:
    model constructors call it before touching the card, and every kernel
    launch calls it again (``route``)."""
    if dtype not in DTYPES or not 1 <= head_dim <= MAX_HEAD_DIM:
        raise NotImplementedError(
            f"the flash kernels take fp32 or bf16 at head dim 1 to "
            f"{MAX_HEAD_DIM}, got {dtype} at head dim {head_dim}")


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernels that take this input: ``"tuned"`` for bf16 at head dim
    64 or 32, ``"bf16_128"`` for bf16 at exactly 128, ``"any"`` for every
    other input ``check_supported`` takes (it raises for the rest)."""
    check_supported(dtype, head_dim)
    if dtype == torch.bfloat16 and head_dim in KERNEL_HEAD_DIMS:
        return "tuned"
    if dtype == torch.bfloat16 and head_dim == 128:
        return "bf16_128"
    return "any"


def kernel_name(kind: str, route_: str) -> str:
    """``kind``'s kernel (fwd, dq, dkv) on a route: ``flash_fwd``,
    ``flash_fwd_bf16_128``, ``flash_fwd_any``, ..."""
    return f"flash_{kind}" + ("" if route_ == "tuned" else f"_{route_}")


# every flash kernel, by route then kind
KERNELS = tuple(kernel_name(k, r) for r in ROUTES for k in KINDS)


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


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch(kind: str, ins: tuple, outs: tuple, causal: bool, scale: float,
            window: int) -> None:
    """Launch ``kind``'s kernel on the route of ``ins`` (q, k, v, then dO,
    lse and delta for the backward kernels), writing ``outs``.  Raises
    unless the kernel takes the inputs: on the card, contiguous, 16-byte
    aligned where the route reads by TMA (not ``any``), q/k/v/dO of one
    dtype ``route`` takes at this head dim, lse and delta fp32."""
    from tpujob_torch.kernels import build

    q = ins[0]
    for x in ins:
        if x.device.type != "cuda":
            raise ValueError(f"flash_{kind}: the kernel takes CUDA tensors, "
                             f"got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"flash_{kind}: inputs must be contiguous")
    route_ = route(q.dtype, q.shape[-1])
    name = kernel_name(kind, route_)
    if route_ != "any" and any(x.data_ptr() % 16 for x in ins):
        raise ValueError(f"{name}: inputs must be 16-byte aligned")
    if any(x.dtype != q.dtype for x in ins[1:4]):
        raise TypeError(f"{name}: q/k/v/dO must share one dtype, got "
                        f"{[x.dtype for x in ins[:4]]}")
    if any(x.dtype != torch.float32 for x in ins[4:]):
        raise TypeError(f"{name}: lse and delta must be fp32")
    b, sq, h, d = q.shape
    is_bf16 = (int(q.dtype == torch.bfloat16),) if route_ == "any" else ()
    with torch.cuda.device(q.device):
        build.launch(name, f"tpujob_{name}",
                     *(x.data_ptr() for x in ins + outs), b, h, d, sq,
                     ins[1].shape[1], float(scale), int(causal), int(window),
                     *is_bf16, _stream(q))


def launch_fwd(q, k, v, *, causal: bool, scale: float, window: int = 0):
    """The forward kernel: (o [b, sq, h, d] in q's dtype, lse [b, h, sq]
    fp32)."""
    o = torch.empty_like(q)
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                      dtype=torch.float32, device=q.device)
    _launch("fwd", (q, k, v), (o, lse), causal, scale, window)
    return o, lse


def launch_dq(q, k, v, do, lse, delta, *, causal: bool, scale: float,
              window: int = 0):
    """The dQ kernel: dq [b, sq, h, d] in q's dtype."""
    dq = torch.empty_like(q)
    _launch("dq", (q, k, v, do, lse, delta), (dq,), causal, scale, window)
    return dq


def launch_dkv(q, k, v, do, lse, delta, *, causal: bool, scale: float,
               window: int = 0):
    """The dK/dV kernel: (dk, dv) [b, sk, h, d] in k's dtype."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("dkv", (q, k, v, do, lse, delta), (dk, dv), causal, scale, window)
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
    """(o, lse): the plain version on CPU tensors, on CUDA ones the kernel
    of the input's route."""
    if _on_cpu(q, k, v):
        return flash_forward_ref(q, k, v, causal=causal, scale=scale,
                                 window=window)
    return launch_fwd(q, k, v, causal=causal, scale=scale, window=window)


def flash_backward(q, k, v, o, lse, do, *, causal: bool, scale: float,
                   window: int = 0):
    """(dq, dk, dv): plain versions on CPU tensors, on CUDA ones the
    kernels of the input's route."""
    if _on_cpu(q, k, v, o, lse, do):
        return flash_backward_ref(q, k, v, o, lse, do, causal=causal,
                                  scale=scale, window=window)
    delta = attention_delta(o, do)
    kw = dict(causal=causal, scale=scale, window=window)
    dq = launch_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = launch_dkv(q, k, v, do, lse, delta, **kw)
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
