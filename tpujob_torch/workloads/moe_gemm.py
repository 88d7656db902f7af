"""The grouped matrix product of a dropless expert layer, and the
permutations around it (``parallel.moe_dropless``).

The JAX package has no such kernel: its ``moe_ffn`` dispatches by dense
one-hot einsums, whose ``[b, s, E, capacity]`` tensors grow with the
experts and the capacity (ROADMAP D.8).  A dropless layer instead sorts
the ``b * s * k`` assignments by expert into a buffer of exactly that many
rows, and each expert multiplies its own rows: a grouped product over
ragged groups whose sizes live on the card only (``Groups``), so the step
that runs it has static shapes and captures into one CUDA graph.

Three hand-written CUDA kernels (``csrc/moe_gemm.cu``, wgmma fed by TMA),
built and bound by ``kernels/build.py`` like the flash and AdamW kernels:

=========================  =================================================
kernel                     computes
=========================  =================================================
``tpujob_moe_gemm_fwd``    ``out[rows of e] = a[rows of e] @ w[e]``
``tpujob_moe_gemm_dx``     ``da[rows of e] = g[rows of e] @ w[e]^T``
``tpujob_moe_gemm_dw``     ``dw[e] = a[rows of e]^T @ g[rows of e]`` in fp32
=========================  =================================================

Their bound and design are in the source's head.  Beside them sits the
plain version, a loop over the experts with the same arithmetic
(``gemm_ref``, ``gemm_t_ref``, ``gemm_dw_ref``); the wrappers take it for
CPU tensors only, and on the card launch the kernel or raise.  Each
launch counts in ``build.LAUNCHES`` as ``moe_gemm_{fwd,dx,dw}``.
"""
from typing import NamedTuple

import torch

# rows of a block of the row kernels (csrc/moe_gemm.cu's kBM): the unit of
# ``Groups.tiles``
BM = 128
DTYPES = (torch.bfloat16,)


def check_supported(dtype: torch.dtype) -> None:
    """Raise unless the kernels take this compute dtype (bf16):
    ``bert.build_model`` calls it before touching the card."""
    if dtype not in DTYPES:
        raise NotImplementedError(
            f"the grouped-GEMM kernels take bf16, got {dtype}")


class Groups(NamedTuple):
    """The experts' rows in a buffer sorted by expert: ``offsets`` [E + 1]
    (expert e holds rows ``offsets[e]:offsets[e + 1]``) and ``tiles`` [E +
    1], the first ``BM``-row tile of each expert (``tiles[E]`` the count
    of tiles), both int32 on the rows' device."""

    offsets: torch.Tensor
    tiles: torch.Tensor


def groups(counts: torch.Tensor) -> Groups:
    """``Groups`` of per-expert row counts [E], on the card: no value
    goes to the host."""
    zero = counts.new_zeros(1)
    offsets = torch.cat([zero, torch.cumsum(counts, 0)]).to(torch.int32)
    tiles = torch.cat([zero, torch.cumsum((counts + BM - 1) // BM, 0)])
    return Groups(offsets, tiles.to(torch.int32))


# ---------------------------------------------------------------------------
# plain versions (CPU path; the yardstick of correctness on the card)
# ---------------------------------------------------------------------------


def _spans(g: Groups):
    off = g.offsets.tolist()
    return [(e, off[e], off[e + 1]) for e in range(len(off) - 1)]


def gemm_ref(a: torch.Tensor, w: torch.Tensor, g: Groups) -> torch.Tensor:
    """``out[rows of e] = a[rows of e] @ w[e]`` ([R, K] x [E, K, N] ->
    [R, N]), each expert's product accumulated in fp32 and rounded to
    ``a``'s dtype."""
    out = a.new_empty(a.shape[0], w.shape[2])
    for e, lo, hi in _spans(g):
        out[lo:hi] = (a[lo:hi].float() @ w[e].float()).to(a.dtype)
    return out


def gemm_t_ref(a: torch.Tensor, w: torch.Tensor, g: Groups) -> torch.Tensor:
    """``out[rows of e] = a[rows of e] @ w[e]^T`` ([R, N] x [E, K, N] ->
    [R, K])."""
    return gemm_ref(a, w.transpose(1, 2), g)


def gemm_dw_ref(a: torch.Tensor, g_out: torch.Tensor, g: Groups,
                experts: int) -> torch.Tensor:
    """``dw[e] = a[rows of e]^T @ g_out[rows of e]`` in fp32 ([R, K], [R,
    N] -> [E, K, N]); an expert with no rows gets zeros."""
    dw = torch.zeros(experts, a.shape[1], g_out.shape[1],
                     dtype=torch.float32, device=a.device)
    for e, lo, hi in _spans(g):
        dw[e] = a[lo:hi].float().T @ g_out[lo:hi].float()
    return dw


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check(name: str, *tensors) -> None:
    """Raise unless the kernel takes these tensors: on the card and
    contiguous; the operands (the first two) bf16, 16-byte aligned for
    TMA, each width a multiple of 64."""
    for t in tensors:
        if t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous CUDA tensors, got "
                             f"{t.device}")
    for t in tensors[:2]:
        check_supported(t.dtype)
        if t.data_ptr() % 16 or any(n % 64 for n in t.shape[1:]):
            raise ValueError(f"{name}: operands 16-byte aligned, widths "
                             f"multiples of 64, got {tuple(t.shape)}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _rows_launch(kind: str, a, w, g: Groups, transposed: bool):
    """``a @ w[e]`` (``w`` [E, K, N]) or ``a @ w[e]^T`` (``w`` [E, N, K],
    ``transposed``) over each expert's rows on the card."""
    from tpujob_torch.kernels import build

    name = f"moe_gemm_{kind}"
    a, w = a.contiguous(), w.contiguous()
    _check(name, a, w, g.offsets, g.tiles)
    experts = w.shape[0]
    k_dim, n_dim = (w.shape[2], w.shape[1]) if transposed else w.shape[1:]
    if a.shape[1] != k_dim:
        raise ValueError(f"{name}: rows of {a.shape[1]}, experts take {k_dim}")
    out = a.new_empty(a.shape[0], n_dim)
    build.launch(name, "tpujob_moe_gemm_rows", a.data_ptr(), w.data_ptr(),
                 out.data_ptr(), g.offsets.data_ptr(), g.tiles.data_ptr(),
                 a.shape[0], k_dim, n_dim, experts, int(transposed),
                 _stream(a))
    return out


def gemm(a: torch.Tensor, w: torch.Tensor, g: Groups) -> torch.Tensor:
    """``a[rows of e] @ w[e]``: the plain version on CPU tensors, else
    ``tpujob_moe_gemm_fwd``."""
    if a.device.type == "cpu":
        return gemm_ref(a, w, g)
    return _rows_launch("fwd", a, w, g, transposed=False)


def gemm_t(a: torch.Tensor, w: torch.Tensor, g: Groups) -> torch.Tensor:
    """``a[rows of e] @ w[e]^T``: the plain version on CPU tensors, else
    ``tpujob_moe_gemm_dx``."""
    if a.device.type == "cpu":
        return gemm_t_ref(a, w, g)
    return _rows_launch("dx", a, w, g, transposed=True)


def gemm_dw(a: torch.Tensor, g_out: torch.Tensor, g: Groups,
            experts: int) -> torch.Tensor:
    """``a[rows of e]^T @ g_out[rows of e]`` in fp32: the plain version on
    CPU tensors, else ``tpujob_moe_gemm_dw``."""
    if a.device.type == "cpu":
        return gemm_dw_ref(a, g_out, g, experts)
    from tpujob_torch.kernels import build

    a, g_out = a.contiguous(), g_out.contiguous()
    _check("moe_gemm_dw", a, g_out, g.offsets)
    if g_out.shape[0] != a.shape[0]:
        raise ValueError(f"moe_gemm_dw: {a.shape[0]} rows against "
                         f"{g_out.shape[0]}")
    k_dim, n_dim = a.shape[1], g_out.shape[1]
    dw = torch.empty(experts, k_dim, n_dim, dtype=torch.float32,
                     device=a.device)
    build.launch("moe_gemm_dw", "tpujob_moe_gemm_weights", a.data_ptr(),
                 g_out.data_ptr(), dw.data_ptr(), g.offsets.data_ptr(),
                 a.shape[0], k_dim, n_dim, experts, _stream(a))
    return dw


class _GroupedMatmul(torch.autograd.Function):
    """``a[rows of e] @ w[e]`` with ``w`` the fp32 parameter, cast once to
    ``a``'s dtype; the backward's ``da`` by ``gemm_t`` and ``dw`` by
    ``gemm_dw``, in fp32 as the parameter holds it."""

    @staticmethod
    def forward(ctx, a, w, offsets, tiles):
        wc = w.to(a.dtype)
        ctx.save_for_backward(a, wc, offsets, tiles)
        return gemm(a, wc, Groups(offsets, tiles))

    @staticmethod
    def backward(ctx, grad):
        a, wc, offsets, tiles = ctx.saved_tensors
        g = Groups(offsets, tiles)
        grad = grad.contiguous()
        da = gemm_t(grad, wc, g) if ctx.needs_input_grad[0] else None
        dw = gemm_dw(a, grad, g, wc.shape[0]) if ctx.needs_input_grad[1] \
            else None
        return da, dw, None, None


def grouped_matmul(a: torch.Tensor, w: torch.Tensor, g: Groups
                   ) -> torch.Tensor:
    """Differentiable ``a[rows of e] @ w[e]`` over the groups ``g`` of
    ``a``'s rows: ``a`` [R, K] in the compute dtype, ``w`` [E, K, N]."""
    return _GroupedMatmul.apply(a, w, g.offsets, g.tiles)


class _Dispatch(torch.autograd.Function):
    """The sorted buffer ``x[order // k]`` ([T, h] -> [T * k, h]); its
    backward sums each token's ``k`` rows in fp32, in a fixed order (no
    atomics): ``grad[inverse].view(T, k, h).sum(1)``."""

    @staticmethod
    def forward(ctx, x, order, inverse, k):
        ctx.save_for_backward(inverse)
        ctx.k = k
        return x[order // k]

    @staticmethod
    def backward(ctx, grad):
        (inverse,) = ctx.saved_tensors
        t = inverse.shape[0] // ctx.k
        gx = grad[inverse].view(t, ctx.k, -1).sum(1, dtype=torch.float32)
        return gx.to(grad.dtype), None, None, None


class _Undispatch(torch.autograd.Function):
    """``rows[inverse]``: the buffer back in assignment order (a
    permutation, so the backward is the gather by ``order``)."""

    @staticmethod
    def forward(ctx, rows, order, inverse):
        ctx.save_for_backward(order)
        return rows[inverse]

    @staticmethod
    def backward(ctx, grad):
        (order,) = ctx.saved_tensors
        return grad[order], None, None


def dispatch(x: torch.Tensor, order: torch.Tensor, inverse: torch.Tensor,
             k: int) -> torch.Tensor:
    """Rows of ``x`` [T, h] in the sorted order of the ``T * k``
    assignments (``order``: sorted position -> assignment ``t * k + j``;
    ``inverse`` the reverse)."""
    return _Dispatch.apply(x, order, inverse, k)


def undispatch(rows: torch.Tensor, order: torch.Tensor,
               inverse: torch.Tensor) -> torch.Tensor:
    """The sorted buffer's rows in assignment order."""
    return _Undispatch.apply(rows, order, inverse)
