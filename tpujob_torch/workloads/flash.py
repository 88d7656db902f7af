"""Flash attention: the port of ``tpujob/workloads/flash.py``.

Six hand-written CUDA kernels for Hopper replace the three Pallas ones,
two for each:

=========================  ===========================  =================
kernel (wrapper)           source                       replaces
=========================  ===========================  =================
``flash_fwd_cuda``         ``csrc/flash_fwd.cu``        ``_flash_kernel``
``flash_dq_cuda``          ``csrc/flash_dq.cu``         ``_dq_kernel``
``flash_dkv_cuda``         ``csrc/flash_dkv.cu``        ``_dkv_kernel``
``flash_fwd_any_cuda``     ``csrc/flash_fwd_any.cu``    ``_flash_kernel``
``flash_dq_any_cuda``      ``csrc/flash_dq_any.cu``     ``_dq_kernel``
``flash_dkv_any_cuda``     ``csrc/flash_dkv_any.cu``    ``_dkv_kernel``
=========================  ===========================  =================

The first three are the tuned wgmma/TMA kernels and take bf16 at head
dim 64 or 32 (``KERNEL_HEAD_DIMS``).  The ``_any`` three take fp32 or
bf16 at any head dim from 1 to ``MAX_HEAD_DIM`` (256), on the tensor
cores (wgmma; fp32 inputs as three tf32 passes, bf16 with P and dS in two
bf16 parts); fp32 at head dims over 128 takes a wgmma kernel of its own
in each, and bf16 at head dim exactly 128 one of its own in each
(``csrc/flash_bf16_128.cuh``, chosen by each ``_any`` C entry point;
``bf16_128`` is the predicate, ``ROUTE_LAUNCHES`` counts its launches).
``flash_forward`` and ``flash_backward`` choose by dtype and head dim
before the launch (``tuned``): bf16 at 64 or 32 takes the tuned kernels,
anything else the ``_any`` ones.  No wrapper gives way to another kernel, or to the plain
version, when a build or a launch fails: it raises.

Beside the kernels sits their plain PyTorch version with the same math
(``flash_forward_ref``, ``flash_dq_ref``, ``flash_dkv_ref``).  The
dispatch takes it only for tensors on the CPU; a kernel wrapper on a
tensor off the card raises.  ``LAUNCHES`` counts kernel launches under
each kernel's own name, one per launch, so a run can show which kernels
it went through.

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

# kernel launches since the last reset_launches(), by kernel
LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
            "flash_fwd_any": 0, "flash_dq_any": 0, "flash_dkv_any": 0}
# of those, the _any launches that took the kernels of their bf16 head-dim
# 128 route (bf16_128), by kernel
ROUTE_LAUNCHES = {"bf16_128": {"flash_fwd_any": 0, "flash_dq_any": 0,
                               "flash_dkv_any": 0}}

# the head dims the tuned bf16 kernels are instantiated for (each source's
# template on D, launched by its C entry point's switch)
KERNEL_HEAD_DIMS = (64, 32)
# the largest head dim the _any kernels take (their shared-memory tiles)
MAX_HEAD_DIM = 256
DTYPES = (torch.float32, torch.bfloat16)


def check_supported(dtype: torch.dtype, head_dim: int) -> None:
    """Raise unless a CUDA kernel takes this dtype and head dim: fp32 or
    bf16 at head dim 1 to ``MAX_HEAD_DIM``.  The one owner of that limit:
    model constructors call it before touching the card, and every kernel
    launch calls it again."""
    if dtype not in DTYPES or not 1 <= head_dim <= MAX_HEAD_DIM:
        raise NotImplementedError(
            f"the flash kernels take fp32 or bf16 at head dim 1 to "
            f"{MAX_HEAD_DIM}, got {dtype} at head dim {head_dim}")


def tuned(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether the tuned wgmma kernels take this input (bf16 at head dim 64
    or 32); every other supported input takes the ``_any`` kernels."""
    return dtype == torch.bfloat16 and head_dim in KERNEL_HEAD_DIMS


def bf16_128(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether an ``_any`` kernel's C entry point sends this input to its
    own bf16 head-dim-128 kernel (``csrc/flash_bf16_128.cuh``): bf16 at head
    dim exactly 128, as the entry points' ``is_bf16 && D == 128``.  The
    wrappers count ``ROUTE_LAUNCHES`` and check TMA's alignment by it."""
    return dtype == torch.bfloat16 and head_dim == 128


def reset_launches() -> None:
    for counts in (LAUNCHES, *ROUTE_LAUNCHES.values()):
        counts.update(dict.fromkeys(counts, 0))


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


def _check_kernel_args(name: str, *tensors, any_kernel: bool = False) -> None:
    """Raise unless ``name``'s kernel takes these tensors: on the card,
    contiguous (16-byte aligned for the TMA of the tuned kernels and of the
    ``bf16_128`` route), q/k/v/dO of one dtype the kernel takes at this head
    dim, lse and delta fp32."""
    q = tensors[0]
    aligned = not any_kernel or bf16_128(q.dtype, q.shape[-1])
    for x in tensors:
        if x.device.type != "cuda":
            raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                             f"{x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if aligned and x.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
    check_supported(q.dtype, q.shape[-1])
    if not any_kernel and not tuned(q.dtype, q.shape[-1]):
        raise NotImplementedError(
            f"{name}: the tuned kernel takes bf16 at head dim "
            f"{' or '.join(map(str, KERNEL_HEAD_DIMS))}, got {q.dtype} at "
            f"head dim {q.shape[-1]} (the _any kernels take it)")
    if any(x.dtype != q.dtype for x in tensors[1:4]):
        raise TypeError(f"{name}: q/k/v/dO must share one dtype, got "
                        f"{[x.dtype for x in tensors[:4]]}")
    if any(x.dtype != torch.float32 for x in tensors[4:]):
        raise TypeError(f"{name}: lse and delta must be fp32")


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _count_any(name: str, q) -> None:
    """One launch of the ``_any`` kernel ``name`` on inputs like ``q``."""
    LAUNCHES[name] += 1
    if bf16_128(q.dtype, q.shape[-1]):
        ROUTE_LAUNCHES["bf16_128"][name] += 1


def flash_fwd_cuda(q, k, v, *, causal: bool, scale: float, window: int = 0):
    """Launch the tuned forward kernel: (o [b, sq, h, d] bf16, lse [b, h, sq] fp32)."""
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
    """Launch the tuned dQ kernel: dq [b, sq, h, d] bf16."""
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
    """Launch the tuned dK/dV kernel: (dk, dv) [b, sk, h, d] bf16."""
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


def flash_fwd_any_cuda(q, k, v, *, causal: bool, scale: float,
                       window: int = 0):
    """Launch the general forward kernel (fp32 or bf16, head dim 1-256):
    (o [b, sq, h, d] in q's dtype, lse [b, h, sq] fp32)."""
    from tpujob_torch.kernels import build

    _check_kernel_args("flash_fwd_any", q, k, v, any_kernel=True)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = build.load("flash_fwd_any")
    with torch.cuda.device(q.device):
        rc = lib.tpujob_flash_fwd_any(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, d, sq, sk, float(scale), int(causal),
            int(window), int(q.dtype == torch.bfloat16), _stream(q))
    build.check(rc, "flash_fwd_any")
    _count_any("flash_fwd_any", q)
    return o, lse


def flash_dq_any_cuda(q, k, v, do, lse, delta, *, causal: bool,
                      scale: float, window: int = 0):
    """Launch the general dQ kernel: dq [b, sq, h, d] in q's dtype."""
    from tpujob_torch.kernels import build

    _check_kernel_args("flash_dq_any", q, k, v, do, lse, delta,
                       any_kernel=True)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dq = torch.empty_like(q)
    lib = build.load("flash_dq_any")
    with torch.cuda.device(q.device):
        rc = lib.tpujob_flash_dq_any(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, d, sq, sk,
            float(scale), int(causal), int(window),
            int(q.dtype == torch.bfloat16), _stream(q))
    build.check(rc, "flash_dq_any")
    _count_any("flash_dq_any", q)
    return dq


def flash_dkv_any_cuda(q, k, v, do, lse, delta, *, causal: bool,
                       scale: float, window: int = 0):
    """Launch the general dK/dV kernel: (dk, dv) [b, sk, h, d] in k's
    dtype."""
    from tpujob_torch.kernels import build

    _check_kernel_args("flash_dkv_any", q, k, v, do, lse, delta,
                       any_kernel=True)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = build.load("flash_dkv_any")
    with torch.cuda.device(q.device):
        rc = lib.tpujob_flash_dkv_any(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, d, sq, sk, float(scale), int(causal), int(window),
            int(q.dtype == torch.bfloat16), _stream(q))
    build.check(rc, "flash_dkv_any")
    _count_any("flash_dkv_any", q)
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
    """(o, lse): the plain version on CPU tensors; on CUDA ones the tuned
    kernel where it takes the input (``tuned``), else the ``_any`` one."""
    if _on_cpu(q, k, v):
        return flash_forward_ref(q, k, v, causal=causal, scale=scale,
                                 window=window)
    fwd = flash_fwd_cuda if tuned(q.dtype, q.shape[-1]) else flash_fwd_any_cuda
    return fwd(q, k, v, causal=causal, scale=scale, window=window)


def flash_backward(q, k, v, o, lse, do, *, causal: bool, scale: float,
                   window: int = 0):
    """(dq, dk, dv): plain versions on CPU tensors; on CUDA ones the tuned
    kernels or the ``_any`` ones, chosen as ``flash_forward`` chooses."""
    if _on_cpu(q, k, v, o, lse, do):
        return flash_backward_ref(q, k, v, o, lse, do, causal=causal,
                                  scale=scale, window=window)
    delta = attention_delta(o, do)
    kw = dict(causal=causal, scale=scale, window=window)
    if tuned(q.dtype, q.shape[-1]):
        dq_fn, dkv_fn = flash_dq_cuda, flash_dkv_cuda
    else:
        dq_fn, dkv_fn = flash_dq_any_cuda, flash_dkv_any_cuda
    dq = dq_fn(q, k, v, do, lse, delta, **kw)
    dk, dv = dkv_fn(q, k, v, do, lse, delta, **kw)
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
