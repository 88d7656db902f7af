"""Dense attention, the reference every attention path is held against,
sequence and tensor parallelism, FSDP, and the sparse MoE feed-forward
with expert parallelism: the port of ``tpujob/workloads/parallel.py``.

Layout is the JAX package's ``[batch, seq, heads, head_dim]``.  Ported:
grouped-query repeat, full attention, the two sequence-parallel
attentions over a process group (``ring_attention``, with its zigzag
causal schedule, and ``ulysses_attention``) with their exchanges
(``shift``, ``all_to_all``: autograd functions whose backward is the
inverse exchange, counted in ``EXCHANGES``), and
``moe_capacity``/``moe_ffn`` on one device or over the expert, tensor
and sequence groups (``MoEGroups``).  Beside them, the port's own
``moe_dropless``: SwiGLU experts that drop no assignment, dispatched by
index through ``moe_gemm``'s grouped products, on one device.

The JAX package's ``PARTITION_RULES`` (``partition_spec_tree``,
``sanitize_spec``, ``shard_params``) are three things here.  Megatron's
tensor parallelism by hand: ``TP_RULES`` names the dim of each
parameter split over the tensor group (``tp_local``, ``tp_shard_``), and
exchanges carry the activations across it (``column_parallel``,
``reduce_from_tensor``, ``gather_from_tensor``; ``copy_to_tensor``
where no product follows).  Expert parallelism:
``EP_RULES`` splits the experts over the expert group (``ep_local``,
``ep_shard_``), and ``moe_ffn`` sums each token's partial outputs over
the expert x tensor group.  ZeRO-3 is FSDP2's ``fully_shard`` over the
fsdp group (``fully_shard_model``), which shards each parameter's dim 0
(the experts' d dim) where the JAX rules pick another dim: the same 1/n
of the parameters and moments a rank.  ``ParamShards`` gathers them
whole for a checkpoint and slices them again.

Pipeline parallelism: the stage exchanges ``to_next`` / ``to_prev`` (the
JAX schedules' ``ppermute``s, point to point where the timetable sends a
tensor), ``stage_layers`` (a stage's share of the stack), and GPipe
(``gpipe_forward`` / ``gpipe_backward``: explicit schedules both ways;
``pipeline``, the differentiable form).  1F1B is in
``pipeline_schedule``.

Where the JAX package's attentions take global arrays and cut them with
``shard_map``, these take this rank's shard: its rows of the batch and
its columns of the sequence, in the layout ``ring_layout_zigzag`` names
(the model keeps its tokens in that layout from the embedding on).
"""
from __future__ import annotations

import contextlib
import math
import re
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist
import torch.nn.functional as F

from tpujob_torch.workloads import distributed as dist


def _gqa_repeat(q, k, v):
    """Broadcast K/V heads up to the query heads (grouped-query attention);
    head ``i`` of K/V serves query heads ``i*rep .. i*rep+rep-1``."""
    rep = q.shape[2] // k.shape[2]
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"query heads {q.shape[2]} must be a multiple of KV heads "
            f"{k.shape[2]}")
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def full_attention(q, k, v, *, causal: bool = False,
                   scale: Optional[float] = None, window: int = 0):
    """Dense softmax attention in the inputs' dtype.  ``window`` > 0 masks
    keys more than window-1 positions behind the query (causal only)."""
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window and not causal:
        raise ValueError("window (sliding-window attention) requires "
                         "causal=True")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    k, v = _gqa_repeat(q, k, v)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        delta = (torch.arange(sq, device=q.device)[:, None]
                 - torch.arange(sk, device=q.device)[None, :])
        mask = delta >= 0
        if window:
            mask = mask & (delta < window)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


# ---------------------------------------------------------------------------
# sequence parallelism: the exchanges
# ---------------------------------------------------------------------------


# the exchanges since the last ``reset_exchanges()``: calls, bytes sent,
# and with ``EXCHANGE_TIMING`` set the host seconds spent in them, the
# card synced on both sides of each (a measurement, not the training path)
EXCHANGES = {"calls": 0, "bytes": 0, "seconds": 0.0}
EXCHANGE_TIMING = False


def reset_exchanges() -> None:
    EXCHANGES.update(calls=0, bytes=0, seconds=0.0)


@contextlib.contextmanager
def counted(x: torch.Tensor, sent: bool = True):
    """One exchange of ``x`` (its bytes sent; none when ``sent`` is False,
    a receive only) in ``EXCHANGES``, timed with the card synced around it
    under ``EXCHANGE_TIMING``."""
    EXCHANGES["calls"] += 1
    EXCHANGES["bytes"] += x.numel() * x.element_size() * sent
    if not EXCHANGE_TIMING:
        yield
        return
    cuda = x.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    yield
    if cuda:
        torch.cuda.synchronize(x.device)
    EXCHANGES["seconds"] += time.perf_counter() - t0


def group_size(group) -> int:
    """The ranks of ``group``; None (a mesh axis 1 long) is one rank."""
    return 1 if group is None else tdist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index in ``group`` (0 in None)."""
    return 0 if group is None else tdist.get_rank(group)


def _sendrecv(x: torch.Tensor, group, dst: Optional[int],
              src: Optional[int]) -> torch.Tensor:
    """``x`` sent to group rank ``dst`` and a tensor shaped like it
    received from group rank ``src``, in one batch of point-to-point ops
    (None: no send, or no receive and zeros back).  gloo's send and
    receive take host memory only (it reads a CUDA tensor's address as a
    host one), so a CUDA tensor in a gloo group is copied to the host,
    exchanged and copied back; NCCL exchanges the device tensors.  The
    backend decides, never a caught failure."""
    staged = (x.device.type == "cuda"
              and tdist.get_backend(group) == tdist.Backend.GLOO)
    with counted(x, sent=dst is not None):
        ops, recv = [], None
        if dst is not None:
            send = x.detach().contiguous()
            send = send.cpu() if staged else send
            ops.append(tdist.P2POp(tdist.isend, send,
                                   tdist.get_global_rank(group, dst), group))
        if src is not None:
            recv = torch.empty(x.shape, dtype=x.dtype,
                               device="cpu" if staged else x.device)
            ops.append(tdist.P2POp(tdist.irecv, recv,
                                   tdist.get_global_rank(group, src), group))
        for work in tdist.batch_isend_irecv(ops):
            work.wait()
    if recv is None:
        return torch.zeros_like(x)
    return recv.to(x.device) if staged else recv


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """``x`` of the rank ``step`` places ahead in ``group`` (this rank's
    goes to the rank ``step`` places behind): one send and one receive."""
    n, i = group_size(group), group_rank(group)
    return _sendrecv(x, group, (i - step) % n, (i + step) % n)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        return _shift(x, group, step)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.step), None, None


def shift(x: torch.Tensor, group) -> torch.Tensor:
    """The ring's neighbour exchange (``jax.lax.ppermute`` with
    ``perm = [(j, (j - 1) % n)]``): returns the ``x`` of the next rank.
    Differentiable: the backward shifts the gradient the other way."""
    if group_size(group) == 1:
        return x
    return _Shift.apply(x, group, 1)


def _all_to_all(x: torch.Tensor, group, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, split_axis, concat_axis, tiled=True)`` over
    ``group``: chunk j of ``split_axis`` goes to group rank j, and the
    chunks received are concatenated along ``concat_axis`` in the order of
    the ranks they came from.  One ``all_to_all_single`` on the tensors
    where they lie: gloo takes CUDA tensors in it (it stages them through
    the host itself), NCCL exchanges them on the card."""
    n = group_size(group)
    send = x.unflatten(split_axis, (n, x.shape[split_axis] // n))
    send = send.movedim(split_axis, 0).contiguous()
    recv = torch.empty_like(send)
    with counted(send):
        tdist.all_to_all_single(recv, send, group=group)
    return recv.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        # the transpose of a tiled all-to-all swaps its two axes
        return (_all_to_all(g, ctx.group, concat_axis, split_axis), None,
                None, None)


class _Tie(torch.autograd.Function):
    """``x`` unchanged, with ``others`` as inputs whose gradient is zero."""

    @staticmethod
    def forward(ctx, x, *others):
        ctx.others = [(o.shape, o.dtype, o.device) for o in others]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(shape, dtype=dtype, device=device)
                     for shape, dtype, device in ctx.others))


def tie(x: torch.Tensor, *others: torch.Tensor) -> torch.Tensor:
    """``x``, made to depend on ``others`` with a zero gradient: an
    exchange whose result a rank does not use (a ring hop wholly in its
    future) still runs its backward exchange, which the other ranks of its
    group wait for."""
    return _Tie.apply(x, *others) if others else x


def all_to_all(x: torch.Tensor, group, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """Differentiable tiled all-to-all (see ``_all_to_all``); its backward
    is the all-to-all with the axes swapped."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_axis, concat_axis)


# ---------------------------------------------------------------------------
# tensor parallelism (Megatron) and FSDP (ZeRO-3)
# ---------------------------------------------------------------------------

# The Megatron layout of ``PARTITION_RULES`` on torch's names and [out, in]
# weights: parameter -> the dim split into contiguous blocks over the
# tensor group.  Column-parallel (the output dim): the query/key/value and
# mlp_wi weights and biases, so a rank holds whole heads (and, under GQA,
# the KV heads its query heads read) and a block of the FFN; row-parallel
# (the input dim): the out and mlp_wo weights, whose biases stay whole and
# are added after the all-reduce; the tied embedding's vocab; and the
# experts in flax's layout, ``moe.wi`` [E, d, f] column-parallel on f and
# ``moe.wo`` [E, f, d] row-parallel on f.  Every other parameter
# (positions, LayerNorms, the row-parallel biases, the router) is whole on
# every rank.
TP_RULES = (
    (r"attn\.(query|key|value)\.(weight|bias)$", 0),
    (r"attn\.out\.weight$", 1),
    (r"mlp_wi\.(weight|bias)$", 0),
    (r"mlp_wo\.weight$", 1),
    (r"token_embed\.weight$", 0),
    (r"moe\.wi$", 2),
    (r"moe\.wo$", 1),
)
# The expert layout (``P("expert", ...)`` of the JAX package's ``moe/wi``
# and ``moe/wo``): the experts split along dim 0 over the expert group, a
# rank holding E / n whole experts (each of them cut over the tensor group
# by ``TP_RULES``).  The router stays whole.
EP_RULES = ((r"moe\.(wi|wo)$", 0),)


def _rule_dim(rules, name: str) -> Optional[int]:
    for pattern, dim in rules:
        if re.search(pattern, name):
            return dim
    return None


def tp_dim(name: str) -> Optional[int]:
    """The dim ``TP_RULES`` splits parameter ``name`` along, or None."""
    return _rule_dim(TP_RULES, name)


def ep_dim(name: str) -> Optional[int]:
    """The dim ``EP_RULES`` splits parameter ``name`` along, or None."""
    return _rule_dim(EP_RULES, name)


def _local(dim: Optional[int], what: str, name: str, t: torch.Tensor,
           n: int, i: int) -> torch.Tensor:
    if dim is None or n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"{name} {tuple(t.shape)}: dim {dim} does not "
                         f"split over {n} {what} ranks")
    return t.chunk(n, dim)[i]


def tp_local(name: str, t: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Rank ``i`` of ``n``'s block of the whole parameter ``t``."""
    return _local(tp_dim(name), "tensor", name, t, n, i)


def ep_local(name: str, t: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Expert rank ``i`` of ``n``'s experts of the parameter ``t``."""
    return _local(ep_dim(name), "expert", name, t, n, i)


def mesh_local(name: str, t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of the whole parameter ``t`` on ``mesh`` (its
    experts, then its tensor block of each): what ``tp_shard_`` and
    ``ep_shard_`` keep of the parameter this rank drew whole."""
    if mesh is None:
        return t
    t = ep_local(name, t, mesh.size("expert"), mesh.index("expert"))
    return tp_local(name, t, mesh.size("tensor"), mesh.index("tensor"))


def _shard_(local, model: torch.nn.Module, group) -> None:
    n, i = group_size(group), group_rank(group)
    if n == 1:
        return
    for name, p in list(model.named_parameters()):
        block = local(name, p.data, n, i)
        if block is not p.data:
            owner, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(owner), leaf,
                    torch.nn.Parameter(block.clone()))


def tp_shard_(model: torch.nn.Module, group) -> None:
    """Replace each whole parameter ``TP_RULES`` splits by this rank's
    block of it (a copy), in place."""
    _shard_(tp_local, model, group)


def ep_shard_(model: torch.nn.Module, group) -> None:
    """Replace each parameter ``EP_RULES`` splits by this rank's experts
    of it (a copy), in place; composes with ``tp_shard_`` in either
    order (they split different dims)."""
    _shard_(ep_local, model, group)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (no
    gradient): one ``all_gather`` on the tensors where they lie (gloo
    takes CUDA tensors in it)."""
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    with counted(x):
        tdist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    with counted(y):
        tdist.all_reduce(y, group=group)
    return y


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n, i = group_size(ctx.group), group_rank(ctx.group)
        return g.chunk(n, ctx.dim)[i].contiguous(), None, None


class _ColumnParallel(torch.autograd.Function):
    """``F.linear(x, w, b)`` for each pair, whose x-gradients, this
    rank's partials, are computed in fp32, summed over ``group`` in one
    fp32 all-reduce and rounded once each to x's dtype, then added in that
    dtype, the last product's first."""

    @staticmethod
    def forward(ctx, x, group, *pairs):
        ws, bs = pairs[0::2], pairs[1::2]
        ctx.save_for_backward(x, *ws)
        ctx.group, ctx.biased = group, [b is not None for b in bs]
        return tuple(F.linear(x, w, b) for w, b in zip(ws, bs))

    @staticmethod
    def backward(ctx, *gs):
        x, *ws = ctx.saved_tensors
        parts = torch.stack([g.float() @ w.float() for g, w in zip(gs, ws)])
        parts = _all_reduce(parts, ctx.group).to(x.dtype)
        gx = parts[-1]
        for part in reversed(parts[:-1]):
            gx = gx + part
        x2 = x.reshape(-1, x.shape[-1])
        grads = []
        for g, biased in zip(gs, ctx.biased):
            g2 = g.reshape(-1, g.shape[-1])
            grads += [g2.t().mm(x2), g2.sum(0) if biased else None]
        return (gx, None, *grads)


def column_parallel(x: torch.Tensor, pairs, group) -> list:
    """Column-parallel products of one input: ``F.linear(x, w, b)`` for
    each ``(w, b)`` of ``pairs`` (this rank's block of each output dim; b
    may be None).  Megatron's f: the backward sums x's gradient over the
    tensor ``group``, as the JAX package's CPU partitioner transposes the
    dots: each product's partial an fp32 dot, the partials all-reduced
    together in fp32, each rounded once to x's dtype, then added in it
    (q, k and v's: (v + k) + q).  One process: the plain products."""
    if group_size(group) == 1:
        return [F.linear(x, w, b) for w, b in pairs]
    return list(_ColumnParallel.apply(x, group, *(t for pair in pairs
                                                  for t in pair)))


def copy_to_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: ``x`` unchanged, at the input of column-parallel
    products; the backward all-reduces the gradient over the tensor group
    (each rank's products see the whole input, and their gradients of it
    are partial sums)."""
    if group_size(group) == 1:
        return x
    return _CopyToTensor.apply(x, group)


def reduce_from_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the ranks' partial products summed (all-reduce, in
    ``x``'s dtype), after a row-parallel product; the backward passes
    the gradient on unchanged.  The row-parallel products pass fp32
    partials and round the sum once to the compute dtype: the JAX
    package's partitioned product all-reduces its f32 dot and converts
    after (XLA's CPU partitioner; what ``tests/test_torch_tp.py``'s bf16
    case holds the port to).  The experts' outputs do the same
    (``_CombineFromExperts``)."""
    if group_size(group) == 1:
        return x
    return _ReduceFromTensor.apply(x, group)


def gather_from_tensor(x: torch.Tensor, group, dim: int = -1
                       ) -> torch.Tensor:
    """The ranks' blocks of ``x`` concatenated along ``dim`` (the vocab
    logits of the tied head); the backward keeps this rank's block of the
    gradient."""
    if group_size(group) == 1:
        return x
    return _GatherFromTensor.apply(x, group, dim % x.ndim)


def fsdp_device_mesh(mesh, device_type: str):
    """FSDP2's ``DeviceMesh`` from the port's groups: the fsdp group alone
    (shard), or with replica ranks (``distributed.REPLICA_AXES`` longer
    than 1) the 2-D (replicate, shard) mesh of the ranks that differ from
    this one along data, sequence and fsdp."""
    from torch.distributed.device_mesh import DeviceMesh

    shard, replica = mesh.group("fsdp"), mesh.group(*dist.REPLICA_AXES)
    if replica is None:
        return DeviceMesh.from_group(shard, device_type)
    ranks = mesh.grid(*dist.REPLICA_AXES, "fsdp").reshape(
        -1, mesh.size("fsdp"))
    return DeviceMesh.from_group(
        [replica, shard], device_type, mesh=ranks,
        mesh_dim_names=("replicate", "shard"))


def fsdp_placements(model: torch.nn.Module) -> Dict[int, object]:
    """FSDP2's placement of each expert weight, by the parameter's id:
    ``moe.wi`` [E, d, f] on dim 1 and ``moe.wo`` [E, f, d] on dim 2, the
    d dim, where the JAX package's ``fsdp`` entry of their rules puts it.
    FSDP2's default, dim 0, is the expert dim, which a rank holding E / ep
    experts may hold fewer of than there are fsdp ranks (padded shards).
    The numerics do not depend on the dim; the memory does."""
    from torch.distributed.tensor import Shard

    out = {}
    for name, p in model.named_parameters():
        if re.search(r"moe\.wi$", name):
            out[id(p)] = Shard(1)
        elif re.search(r"moe\.wo$", name):
            out[id(p)] = Shard(2)
    return out


def fully_shard_model(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """ZeRO-3 through FSDP2: each transformer block (``layer_<i>``), then
    the root (embeddings, LayerNorms), sharded over the fsdp group
    (``fsdp_device_mesh``).  The parameters and AdamW's moments then live
    as shards (1/n of each a rank: dim 0, the experts' d dim,
    ``fsdp_placements``); each block's forward all-gathers its parameters
    and frees them after, and its backward reduce-scatters the gradients
    (averaged over the fsdp and replica ranks).  Under tensor or expert
    parallelism each rank's local parameters are sharded.  The model
    keeps the mesh as ``fsdp_mesh``."""
    from torch.distributed.fsdp import fully_shard

    dm = fsdp_device_mesh(mesh, next(model.parameters()).device.type)
    placements = fsdp_placements(model)

    def place(p):
        return placements.get(id(p))

    for name, child in model.named_children():
        if name.startswith("layer_"):
            fully_shard(child, mesh=dm, shard_placement_fn=place)
    fully_shard(model, mesh=dm, shard_placement_fn=place)
    model.fsdp_mesh = dm
    return model


def gather_dtensor(t) -> torch.Tensor:
    """A DTensor whole, on every rank of its mesh, through ``all_gather``
    over the group of each mesh dim it is sharded along (FSDP2's dim-0
    shards, ``torch.chunk``'s sizes, padded to the largest for the
    exchange).  Not ``DTensor.full_tensor``: its functional collective
    crashes the process under gloo on CUDA tensors (torch 2.11, on the
    card), where ``all_gather`` works."""
    out = t.to_local()
    for d, placement in enumerate(t.placements):
        if not placement.is_shard():
            continue
        group, dim = t.device_mesh.get_group(d), placement.dim
        n = group_size(group)
        sizes = [c.shape[0] for c in torch.empty(t.shape[dim]).chunk(n)]
        sizes += [0] * (n - len(sizes))
        pad = [0, 0] * (out.ndim - 1 - dim) + [0, max(sizes) - out.shape[dim]]
        parts = all_gather(F.pad(out, pad), group, dim).split(max(sizes), dim)
        out = torch.cat([p.narrow(dim, 0, k) for p, k in zip(parts, sizes)],
                        dim=dim)
    return out


class ParamShards:
    """How this rank's parameters lie, for a checkpoint: ``EP_RULES``'
    experts over the expert group, ``TP_RULES``' blocks over the tensor
    group, and under FSDP each one a DTensor sharded over fsdp.  ``full``
    gathers a parameter (or a tensor shaped like it: its moments, its
    accumulated gradient) whole, on every rank of its groups, into a new
    host tensor; ``local`` cuts a whole one to this rank's shard, laid
    out as ``like``."""

    def __init__(self, tensor_group, expert_group=None):
        self.group, self.expert_group = tensor_group, expert_group
        self.n, self.i = group_size(tensor_group), group_rank(tensor_group)
        self.n_ep = group_size(expert_group)
        self.i_ep = group_rank(expert_group)

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            t = gather_dtensor(t)
        dim = tp_dim(name)
        if dim is not None and self.n > 1:
            t = all_gather(t, self.group, dim)
        dim = ep_dim(name)
        if dim is not None and self.n_ep > 1:
            t = all_gather(t, self.expert_group, dim)
        return t.detach().to("cpu", copy=True)

    def local(self, name: str, whole: torch.Tensor, like: torch.Tensor
              ) -> torch.Tensor:
        from torch.distributed.tensor import DTensor, distribute_tensor

        t = ep_local(name, whole, self.n_ep, self.i_ep)
        t = tp_local(name, t, self.n, self.i)
        if isinstance(like, DTensor):
            return distribute_tensor(t.to(like.device, like.dtype),
                                     like.device_mesh, like.placements,
                                     src_data_rank=None)
        return t


# ---------------------------------------------------------------------------
# sequence parallelism: ring attention (contiguous and zigzag) and Ulysses
# ---------------------------------------------------------------------------


def _block_attention(q, k, v, bias, m_prev, l_prev, o_prev, scale):
    """One flash-style block update: the softmax statistics (m, l) and the
    output accumulator o [b, h, sq, d] folded over an incoming K/V block,
    in fp32 whatever the inputs' dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias
    m_new = torch.maximum(m_prev, s.amax(dim=-1))
    # renormalise the previous accumulator to the new max
    alpha = torch.exp(m_prev - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l_prev * alpha + p.sum(dim=-1)
    o_new = o_prev * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                     v.float())
    return m_new, l_new, o_new


def _acc0(q, sq: int):
    """The empty running (m, l, o) of ``sq`` query rows of ``q``."""
    b, _, h, d = q.shape
    m = torch.full((b, h, sq), float("-inf"), device=q.device)
    return m, torch.zeros_like(m), torch.zeros((b, h, sq, d), device=q.device)


def _finish(o, l, dtype):
    return (o / l[..., None]).permute(0, 2, 1, 3).to(dtype)  # [b, sq, h, d]


def _causal_bias(sq: int, sk: int, device) -> torch.Tensor:
    """The within-block diagonal: 0 where key <= query, a finite -1e30
    elsewhere (a fully masked row must not poison the running max)."""
    vis = torch.arange(sq, device=device)[:, None] >= torch.arange(
        sk, device=device)[None, :]
    return torch.where(vis, 0.0, -1e30)[None, None]


def ring_layout_zigzag(seq_len: int, n: int, causal: bool) -> bool:
    """Whether the ring holds the sequence in the zigzag layout: causal
    attention whose sequence tiles into 2n chunks (``ring_attention``'s
    rule in the JAX package)."""
    return causal and n > 1 and seq_len % (2 * n) == 0


def zigzag_index(seq_len: int, n: int, rank: int) -> np.ndarray:
    """The global positions of rank ``rank``'s tokens in the zigzag layout:
    chunks ``rank`` and ``2n - 1 - rank`` of the sequence cut into 2n, one
    early and one late."""
    c = seq_len // (2 * n)
    return np.r_[np.arange(rank * c, (rank + 1) * c),
                 np.arange((2 * n - 1 - rank) * c, (2 * n - rank) * c)]


def ring_attention(q, k, v, group, *, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over a sequence split over the ranks of ``group``
    (the sequence axis): the JAX package's ``ring_attention``.

    q, k, v are this rank's shard ``[b, s/n, h, d]`` (K/V may carry fewer,
    grouped-query heads); the result is its shard of the output.  The
    layout is ``ring_layout_zigzag``'s: causal attention over a sequence
    that tiles into 2n chunks runs the zigzag schedule
    (``_zigzag_ring_attention``) on shards that hold chunks (j, 2n-1-j) of
    the sequence; otherwise a rank holds the contiguous block j.  At each
    of the n hops the rank attends its Q block to the K/V block it holds,
    then takes its neighbour's (``shift``, K and V stacked in one
    message); the softmax stays exact through running (m, l) statistics
    in fp32.  Under the causal mask a K/V block wholly in the Q block's
    future is passed on without being computed (``tie`` keeps its
    backward exchange in step with the group's).  GQA: the ring moves the
    KV-head tensors and repeats the heads only at compute.  Each hop is a
    dense einsum, as in the JAX package (no kernel runs per hop)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n, idx = group_size(group), group_rank(group)
    sq = q.shape[1]
    if ring_layout_zigzag(n * sq, n, causal) and k.shape[1] == sq:
        return _zigzag_ring_attention(q, k, v, group, scale)
    m, l, o = _acc0(q, sq)
    kv = torch.stack((k, v))
    passed = []
    for i in range(n):
        if i:
            kv = shift(kv, group)  # the block of rank idx + i now
        src = (idx + i) % n
        if causal and src > idx:
            passed.append(kv)  # wholly in this block's future: no compute
            continue
        bias = (_causal_bias(sq, kv.shape[2], q.device)
                if causal and src == idx else None)
        kr, vr = _gqa_repeat(q, kv[0], kv[1])
        m, l, o = _block_attention(q, kr, vr, bias, m, l, o, scale)
    return tie(_finish(o, l, q.dtype), *passed)


def _zigzag_ring_attention(q, k, v, group, scale):
    """Causal ring attention on the zigzag layout: this rank j holds the
    pair (chunk j, chunk 2n-1-j), one early and one late, which balances
    the causal work.  At hop 0 (its own pair) it attends early x early and
    late x late under the diagonal mask and late x early in full; at each
    later hop, with the pair of rank s:
      - late Q x early K is live and fully visible for every s != j;
      - the other live pair is early x early when s < j, late x late when
        s > j (the JAX package selects the pair with ``jnp.where``; here
        the branch is on the rank, a Python int).
    3 + 2(n-1) chunk attentions against 4n.  The shards stay in zigzag
    order from the embedding on (positions and targets permuted to match),
    so no layer permutes anything; the JAX package permutes natural-order
    inputs in and out at each call instead."""
    n, idx = group_size(group), group_rank(group)
    c = q.shape[1] // 2
    qa, qb = q[:, :c], q[:, c:]  # early chunk j, late chunk 2n-1-j
    tri = _causal_bias(c, c, q.device)

    def attend(qc, kc, vc, bias, acc):
        kr, vr = _gqa_repeat(qc, kc, vc)
        return _block_attention(qc, kr, vr, bias, *acc, scale)

    kv = torch.stack((k, v))
    acc_a = attend(qa, k[:, :c], v[:, :c], tri, _acc0(q, c))
    acc_b = attend(qb, k[:, :c], v[:, :c], None, _acc0(q, c))
    acc_b = attend(qb, k[:, c:], v[:, c:], tri, acc_b)
    for i in range(1, n):
        kv = shift(kv, group)
        s = (idx + i) % n  # owner of the pair now held
        ka, kb = kv[0][:, :c], kv[0][:, c:]
        va, vb = kv[1][:, :c], kv[1][:, c:]
        acc_b = attend(qb, ka, va, None, acc_b)
        if s < idx:
            acc_a = attend(qa, ka, va, None, acc_a)
        else:
            acc_b = attend(qb, kb, vb, None, acc_b)
    (ma, la, oa), (mb, lb, ob) = acc_a, acc_b
    return torch.cat([_finish(oa, la, q.dtype), _finish(ob, lb, q.dtype)],
                     dim=1)


def ulysses_attention(q, k, v, group, *, causal: bool = False,
                      scale: Optional[float] = None, attention_impl=None,
                      axis: str = "sequence") -> torch.Tensor:
    """All-to-all sequence parallelism (DeepSpeed-Ulysses), the JAX
    package's ``ulysses_attention``, on this rank's contiguous shard
    ``[b, s/n, h, d]``.

    One ``all_to_all`` re-shards sequence -> heads (q, k and v stacked
    into one exchange when the heads are equal; under GQA q alone and K/V
    stacked), so each rank holds the whole sequence for h/n heads;
    ``attention_impl`` (default ``full_attention``; ``flash.flash_attention``
    runs B1-B3 there) attends over ``[b, S, h/n, d]`` with the ordinary
    causal mask, and a second all-to-all brings the output back to
    ``[b, s/n, h, d]``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n = group_size(group)
    heads, hkv = q.shape[2], k.shape[2]
    if heads % n != 0:
        raise ValueError(
            f"ulysses attention needs heads ({heads}) divisible by the "
            f"{axis!r} axis size ({n}); use ring_attention otherwise")
    if hkv != heads and hkv % n != 0:
        raise ValueError(
            f"ulysses attention needs KV heads ({hkv}) divisible by the "
            f"{axis!r} axis size ({n}); use ring_attention otherwise")
    if hkv == heads:
        qkv = all_to_all(torch.stack((q, k, v)), group, split_axis=3,
                         concat_axis=2)  # [3, b, s, h/n, d]
        q_, k_, v_ = qkv[0], qkv[1], qkv[2]
    else:
        q_ = all_to_all(q, group, split_axis=2, concat_axis=1)
        kv = all_to_all(torch.stack((k, v)), group, split_axis=3,
                        concat_axis=2)
        k_, v_ = kv[0], kv[1]
    impl = attention_impl or full_attention
    out = impl(q_, k_, v_, causal=causal, scale=scale)
    # [b, s, h/n, d] -> [b, s/n, h, d]
    return all_to_all(out, group, split_axis=1, concat_axis=2)


# ---------------------------------------------------------------------------
# pipeline parallelism: the stage exchanges and the GPipe schedule
# ---------------------------------------------------------------------------


def _to_neighbour(x: torch.Tensor, group, step: int, send: bool,
                  recv: bool) -> torch.Tensor:
    n, i = group_size(group), group_rank(group)
    dst = i + step if send and 0 <= i + step < n else None
    src = i - step if recv and 0 <= i - step < n else None
    if dst is None and src is None:
        return torch.zeros_like(x)
    return _sendrecv(x, group, dst, src)


def to_next(x: torch.Tensor, group, *, send: bool = True,
            recv: bool = True) -> torch.Tensor:
    """``jax.lax.ppermute`` with ``perm = [(i, i + 1)]`` over the pipeline
    ``group``: this rank's ``x`` goes to the next stage (the last stage
    sends nothing) and the previous stage's comes back (zeros on the first
    stage).  ``send`` / ``recv`` False: this rank sends / receives nothing
    at this call (zeros back).  Both ends of a transfer must agree, which
    the schedules ensure by reading both from one timetable, so every rank
    enters the same exchanges in the same order; a call with nothing to
    send or receive exchanges nothing.  Not differentiable: the schedules
    run their backward ticks themselves (``to_prev`` carries the
    cotangents)."""
    return _to_neighbour(x, group, 1, send, recv)


def to_prev(x: torch.Tensor, group, *, send: bool = True,
            recv: bool = True) -> torch.Tensor:
    """``jax.lax.ppermute`` with ``perm = [(i, i - 1)]``: ``to_next`` the
    other way (the first stage sends nothing, the last receives zeros)."""
    return _to_neighbour(x, group, -1, send, recv)


def check_pipeline(num_layers: int, n: int, b_local: int, m: int,
                   axis: str = "pipeline") -> None:
    """The JAX package's two ValueErrors of a pipeline: a layer stack that
    does not divide over the stages, a per-rank batch that does not
    divide into the microbatches."""
    if num_layers % n != 0:
        raise ValueError(
            f"layer stack of {num_layers} does not divide over "
            f"{axis!r} axis size {n}")
    if b_local % m != 0:
        raise ValueError(
            f"per-device batch {b_local} does not divide into "
            f"{m} microbatches")


def stage_layers(layers: int, mesh) -> Optional[range]:
    """The layers of a stack of ``layers`` this rank's pipeline stage
    holds, stage s of n holding [s L / n, (s + 1) L / n); None off a
    pipeline."""
    n = mesh.size("pipeline") if mesh is not None else 1
    if n == 1:
        return None
    per, i = layers // n, mesh.index("pipeline")
    return range(i * per, (i + 1) * per)


def _live(stage: int, tick: int, m: int) -> bool:
    """Whether GPipe's stage ``stage`` holds a microbatch at forward tick
    ``tick`` (microbatch ``tick - stage``)."""
    return 0 <= tick - stage < m


def gpipe_forward(stage_fn, x_mb: List[torch.Tensor], group, *,
                  skip_idle: bool = True, grad: bool = True):
    """GPipe's forward ticks on this rank: ``m + n - 1`` of them; at tick
    t stage s applies ``stage_fn`` to microbatch t - s (stage 0 takes it
    from ``x_mb``, a later stage what the one before sent at tick t - 1)
    and sends the result on.  ``skip_idle`` False: the warm-up and drain
    ticks run the stage on what the stage holds and discard it (the JAX
    schedule's lock-step compute); the exchanges carry microbatches only.

    Returns ``(outs, stash)``: the m outputs on the last stage (detached;
    empty elsewhere) and, with ``grad``, each microbatch's ``(input leaf,
    output)`` on this stage, the graph ``gpipe_backward`` runs backward."""
    n, s = group_size(group), group_rank(group)
    m = len(x_mb)
    like = torch.empty_like(x_mb[0])
    held = like
    outs, stash = [], []
    for tick in range(m + n - 1):
        live = _live(s, tick, m)
        y = None
        if live:
            cur = x_mb[tick] if s == 0 else held
            if grad:
                xi = cur.detach().requires_grad_()
                with torch.enable_grad():
                    y = stage_fn(xi)
                stash.append((xi, y))
            else:
                with torch.no_grad():
                    y = stage_fn(cur)
            if s == n - 1:
                outs.append(y.detach())
        elif not skip_idle:
            with torch.no_grad():
                stage_fn(held)
        held = to_next(like if y is None else y, group, send=live,
                       recv=_live(s - 1, tick, m))
    return outs, stash


def gpipe_backward(stash, grads: List[torch.Tensor], group
                   ) -> List[torch.Tensor]:
    """GPipe's backward ticks: the forward ticks in reverse.  At each one
    a stage takes its microbatch's output gradient (on the last stage
    from ``grads``, elsewhere what the next stage sent at the tick
    before), runs ``torch.autograd.backward`` on the stashed output (the
    stage's parameters' gradients accumulate in ``.grad``) and sends its
    input's gradient to the previous stage.  Each stashed graph is freed
    after its backward.  Returns the m input gradients on stage 0 (empty
    elsewhere)."""
    n, s = group_size(group), group_rank(group)
    m = len(stash)
    like = torch.empty_like(stash[0][0])
    held = like
    dxs = []
    for back in range(m + n - 1):
        tick = m + n - 2 - back  # the forward tick this one reverses
        live = _live(s, tick, m)
        dx = None
        if live:
            j = tick - s
            (xi, y), stash[j] = stash[j], None
            torch.autograd.backward(y, grads[j] if s == n - 1 else held)
            dx = xi.grad
            if s == 0:
                dxs.insert(0, dx)
        held = to_prev(like if dx is None else dx, group, send=live,
                       recv=_live(s + 1, tick, m))
    return dxs


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, stage_fn, group, m, skip_idle):
        outs, ctx.stash = gpipe_forward(stage_fn, list(x.chunk(m)), group,
                                        skip_idle=skip_idle)
        ctx.group = group
        return _from_last(outs, x, group)

    @staticmethod
    def backward(ctx, g):
        dxs = gpipe_backward(ctx.stash, list(g.chunk(len(ctx.stash))),
                             ctx.group)
        dx = torch.cat(dxs) if dxs else torch.zeros_like(g)
        return dx, None, None, None, None


def _from_last(outs: List[torch.Tensor], like: torch.Tensor, group
               ) -> torch.Tensor:
    """The last stage's outputs, concatenated, on every stage (a masked
    all-reduce, the JAX schedule's broadcast: zeros elsewhere)."""
    last = group_rank(group) == group_size(group) - 1
    y = torch.cat(outs) if last else torch.zeros_like(like)
    return _all_reduce(y, group) if group_size(group) > 1 else y


def pipeline(stage_fn, x: torch.Tensor, group, *, num_layers: int,
             num_microbatches: Optional[int] = None,
             skip_idle: bool = True) -> torch.Tensor:
    """A layer stack split over the pipeline ``group`` run as a GPipe
    pipeline: the JAX package's ``parallel.pipeline``, differentiable.

    ``stage_fn(x_mb)`` applies this rank's layers (the stage's share of
    ``num_layers``, group rank s holding layers [s L / n, (s + 1) L / n))
    to one microbatch.  ``x``: this rank's rows ``[b, ...]`` of the
    pipeline input, the same on every stage (only stage 0 reads it); the
    batch is cut into ``num_microbatches`` (default the stage count) and
    streamed through the stages (``gpipe_forward``); the last stage's
    output is returned on every stage, as the JAX schedule's masked psum
    replicates it.  The (n - 1) / (m + n - 1) bubble is GPipe's cost.

    The backward is an explicit schedule too (``gpipe_backward``): the
    last stage's output gradient starts it (every stage's loss of the
    replicated output is one copy of the same function, so the others'
    are not summed in), and every stage runs the same exchanges in the
    same order, which autograd across ranks would not promise.  The
    stage's parameters' gradients accumulate in ``.grad``; ``x``'s is
    stage 0's (zeros on the others, which do not read it).

    Training runs the fused schedules instead
    (``pipeline_schedule.pipeline_gpipe`` / ``pipeline_1f1b``), which
    compute the head once, on the last stage."""
    n = group_size(group)
    m = num_microbatches or n
    check_pipeline(num_layers, n, x.shape[0], m)
    if torch.is_grad_enabled():
        return _Pipeline.apply(x, stage_fn, group, m, skip_idle)
    outs, _ = gpipe_forward(stage_fn, list(x.chunk(m)), group,
                            skip_idle=skip_idle, grad=False)
    return _from_last(outs, x, group)


# ---------------------------------------------------------------------------
# sparse Mixture-of-Experts FFN, and expert parallelism
# ---------------------------------------------------------------------------


def moe_capacity(tokens_per_group: int, num_experts: int, k: int,
                 capacity_factor: float) -> int:
    """Static per-expert buffer length for one routing group (a batch
    row).  Assignments past it are dropped: their combine weight is 0 and
    the residual stream carries the token through."""
    return max(1, math.ceil(tokens_per_group * k * capacity_factor / num_experts))


class Routing(NamedTuple):
    """Top-k routing of one ``moe_ffn`` call: ``logits``/``probs`` [b, s, E]
    in fp32, ``gate`` [b, s, k] renormalised, ``expert_idx`` [b, s, k],
    ``oh`` [b, s, k, E] the choices' one-hot (zero at invalid positions),
    ``oh_prio`` [b, k*s, E] the same in k-major priority order, and for
    each assignment in that order its slot ``pos`` and ``keep`` (1.0 when
    the slot is below the capacity) [b, k*s]."""

    logits: torch.Tensor
    probs: torch.Tensor
    gate: torch.Tensor
    expert_idx: torch.Tensor
    oh: torch.Tensor
    oh_prio: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor


def route_gates(x: torch.Tensor, router_kernel: torch.Tensor, k: int):
    """(logits, probs [b, s, E], gate, expert_idx [b, s, k]): the router in
    fp32, its softmax, the top k and their gates renormalised by
    max(sum, 1e-9), as both MoE layers route."""
    # fp32 router: exp/softmax on bf16 logits is where MoE training
    # classically diverges
    logits = torch.einsum("bsd,de->bse", x.float(), router_kernel.float())
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gate, expert_idx


def moe_route(x: torch.Tensor, router_kernel: torch.Tensor, k: int, cap: int,
              valid: Optional[torch.Tensor] = None) -> Routing:
    """The routing half of ``moe_ffn``: an fp32 router, softmax, top-k with
    the gates renormalised by max(sum, 1e-9), and each assignment's slot in
    its expert's buffer, first choices before second choices, per batch
    row.  Positions where ``valid`` is 0 are zeroed before the slot cumsum,
    so they never occupy (or steal) a slot.  Every shape is static and no
    value goes to the host: the step that runs it can be captured."""
    b, s, _ = x.shape
    num_experts = router_kernel.shape[1]
    logits, probs, gate, expert_idx = route_gates(x, router_kernel, k)
    experts = torch.arange(num_experts, device=x.device)
    oh = (expert_idx[..., None] == experts).float()  # [b, s, k, E]
    if valid is not None:
        oh = oh * valid.float()[..., None, None]
    oh_prio = oh.transpose(1, 2).reshape(b, k * s, num_experts)
    pos = torch.cumsum(oh_prio, dim=1) - 1.0
    pos = torch.sum(pos * oh_prio, dim=-1)  # [b, k*s]
    keep = (pos < cap).float()
    return Routing(logits, probs, gate, expert_idx, oh, oh_prio, pos, keep)


def seq_route(r: Routing, group, positions: torch.Tensor, cap: int
              ) -> Routing:
    """``r``, the routing of this rank's shard of each sequence, with the
    slots and keep flags the whole sequences give its assignments: the
    reference's k-major order over the whole sequence (every first choice
    in sequence order before every second choice), whatever layout the
    shards hold (contiguous, or the zigzag chunks).  The integer choices
    (-1 where ``valid`` masked the position) and the positions are
    all-gathered over the sequence ``group`` (no gradient), put in
    sequence order, and the reference's cumsum taken over them; this
    rank keeps its positions' slots.  Exact, and every rank computes the
    same whole-sequence slots."""
    b, s, k = r.expert_idx.shape
    num_experts = r.oh.shape[-1]
    valid = r.oh.sum(-1) > 0  # [b, s, k]: zero rows were masked
    choice = torch.where(valid, r.expert_idx, -1)
    where = all_gather(positions.to(r.expert_idx.device, torch.long),
                       group, 0)
    every = all_gather(choice, group, 1)  # [b, S, k], in gather order
    whole = torch.empty_like(every).index_copy_(1, where, every)
    experts = torch.arange(num_experts, device=whole.device)
    oh = (whole[..., None] == experts).float()  # [b, S, k, E]
    oh_prio = oh.transpose(1, 2).reshape(b, -1, num_experts)
    pos = torch.cumsum(oh_prio, dim=1) - 1.0
    pos = torch.sum(pos * oh_prio, dim=-1)  # [b, k*S]
    pos = pos.reshape(b, k, -1)[:, :, positions.to(pos.device)].reshape(
        b, k * s)
    return r._replace(pos=pos, keep=(pos < cap).float())


def dispatch_combine(r: Routing, cap: int, dtype: torch.dtype,
                     experts: Optional[slice] = None,
                     gate: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense dispatch and combine tensors [b, s, E, cap] of a routing,
    in ``dtype``: dispatch is 1 where a kept assignment puts the token in
    an expert's slot, combine the same weighted by its gate.  The slot
    one-hot compares with ``arange(cap)``: a slot past the capacity
    matches none, where a one-hot of it would raise.  ``experts``: only
    those columns (an expert rank's, [b, s, E / n, cap]); ``gate``: the
    gates to weigh by (``r.gate`` by default)."""
    b, ks, _ = r.oh_prio.shape
    k = r.gate.shape[-1]
    gate = r.gate if gate is None else gate
    oh_prio = r.oh_prio if experts is None else r.oh_prio[..., experts]
    num_experts = oh_prio.shape[-1]
    slots = torch.arange(cap, device=r.pos.device, dtype=torch.float32)
    slot = (r.pos[..., None] == slots).float() * r.keep[..., None]
    # [b, k*s, E, cap] -> [b, s, k, E, cap]
    dispatch = (oh_prio[..., None] * slot[..., None, :]).reshape(
        b, k, ks // k, num_experts, cap).permute(0, 2, 1, 3, 4)
    combine = (dispatch * gate[..., None, None]).sum(2).to(dtype)
    return dispatch.sum(2).to(dtype), combine


def load_balance(density_count: torch.Tensor, prob_sum: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """The aux loss E * sum_e(density_e * mean_prob_e) over the last dim
    (1.0 when balanced): density from a per-expert count (the Switch
    layer's top-1 choices; the dropless layer's top-k assignments over k),
    mean probability from the sum of the router's probabilities, both over
    ``tokens`` routed positions (shape ``density_count.shape[:-1]``)."""
    n = tokens[..., None]
    return density_count.shape[-1] * torch.sum(
        (density_count / n) * (prob_sum / n), dim=-1)


class _DispatchToExperts(torch.autograd.Function):
    """``einsum("bsec,bsd->becd", dispatch, x)``, whose gradient of x,
    this rank's experts' (and f block's) share of it, is summed over
    ``group`` in fp32 and rounded once: Megatron's f with fp32 partials,
    so each token's gradient is the one process's (the sum of its kept
    slots' gradients, rounded once)."""

    @staticmethod
    def forward(ctx, dispatch, x, group):
        ctx.save_for_backward(dispatch)
        ctx.group, ctx.dtype = group, x.dtype
        return torch.einsum("bsec,bsd->becd", dispatch, x)

    @staticmethod
    def backward(ctx, g):
        (dispatch,) = ctx.saved_tensors
        gx = torch.einsum("bsec,becd->bsd", dispatch.float(), g.float())
        return None, _all_reduce(gx, ctx.group).to(ctx.dtype), None


class _CombineFromExperts(torch.autograd.Function):
    """``einsum("bsec,becd->bsd", combine, out)`` summed over ``group``:
    the ranks' fp32 partial products all-reduced and rounded once to the
    compute dtype, which is the one process's product (each token's kept
    products summed in fp32, rounded once): Megatron's g with fp32
    partials.  The backward is the plain product's own, in the compute
    dtype, on this rank's experts."""

    @staticmethod
    def forward(ctx, combine, out, group):
        ctx.save_for_backward(combine, out)
        y = torch.einsum("bsec,becd->bsd", combine.float(), out.float())
        return _all_reduce(y, group).to(combine.dtype)

    @staticmethod
    def backward(ctx, g):
        combine, out = ctx.saved_tensors
        with torch.enable_grad():
            c = combine.detach().requires_grad_()
            o = out.detach().requires_grad_()
            y = torch.einsum("bsec,becd->bsd", c, o)
        gc, go = torch.autograd.grad(y, (c, o), g)
        return gc, go, None


class MoEGroups(NamedTuple):
    """The process groups a sharded ``moe_ffn`` exchanges over:
    ``expert`` splits the experts (``EP_RULES``), ``ffn`` is the expert x
    tensor group whose ranks hold the partial outputs of one token's FFN
    (each its experts, each its block of f), ``sequence`` holds the other
    shards of each sequence.  None: an axis 1 long."""

    expert: Any = None
    ffn: Any = None
    sequence: Any = None


def moe_groups(mesh) -> Optional[MoEGroups]:
    """``mesh``'s ``MoEGroups`` (None when every one is 1 long)."""
    if mesh is None:
        return None
    g = MoEGroups(mesh.group("expert"), mesh.group("expert", "tensor"),
                  mesh.group("sequence"))
    return None if g == MoEGroups() else g


def moe_ffn(x: torch.Tensor, router_kernel: torch.Tensor, wi: torch.Tensor,
            wo: torch.Tensor, *, k: int = 2, capacity_factor: float = 1.25,
            valid: Optional[torch.Tensor] = None,
            groups: Optional[MoEGroups] = None,
            positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sparse MoE feed-forward with top-k routing: the JAX package's
    ``moe_ffn``, on one device or on ``groups``.

    ``x``: [batch, seq, d_model]; ``router_kernel``: [d_model, E], whole;
    ``wi``: [E, d_model, d_ff]; ``wo``: [E, d_ff, d_model], or this
    rank's experts and block of d_ff of them.  Returns ``(y, metrics)``,
    y shaped like x.  ``valid``: optional [batch, seq] 0/1 mask;
    positions with 0 are not routed (no slot, output 0) and the load
    balance counts valid positions only, which keeps decode over a fixed
    buffer causal.

    Dispatch is dense, as in the reference: one-hot dispatch and combine
    tensors [b, s, E, cap] (``dispatch_combine``, in x's dtype) and three
    einsums around a tanh GELU, so every expert takes part and the shapes
    never depend on the data.

    On ``groups`` (``moe_groups``; the JAX package pins the dispatched
    buffer's expert dim to its ``expert`` axis and GSPMD derives the
    exchanges) each rank routes all its rows with the whole router, runs
    its experts (``groups.expert``'s share, each on its block of d_ff
    under tensor parallelism) on its columns of the dispatch, and the
    partial outputs, summed over ``groups.ffn`` in fp32 and rounded once
    to x's dtype, are y (``_CombineFromExperts``).  Two gradients are
    summed over ``groups.ffn`` in the backward (Megatron's f): x's
    through the dispatch, in fp32 (``_DispatchToExperts``), and the
    gates' (``copy_to_tensor``); x's through the router, whole on every
    rank, is not, so every replicated parameter (the router first) ends
    the backward with one gradient on every rank of the group.  Under
    expert parallelism alone this is one process's arithmetic, sum for
    sum.  With
    ``positions`` (this rank's global positions along a sequence split
    over ``groups.sequence``) the capacity is the whole sequence's and
    the slots are the whole sequence's (``seq_route``); the experts have
    no bias and gelu(0) = 0, so a rank runs them on a buffer holding its
    own tokens' slots and combines its own positions, exchanging no
    activation.  Without ``positions`` x is whole sequences.

    ``metrics``: ``load_balance`` (the Switch aux loss, density from the
    top-1 choice only) and ``router_z`` (mean squared logsumexp of the
    logits), the reference's two; and the parts the load balance is made
    of, which the loss sums over ranks (``density_count`` [E], the top-1
    choices, and ``tokens``, without grad, ``prob_sum`` [E]), and
    ``dropped``, the count of this rank's valid assignments past their
    expert's capacity (not in the reference; a diagnostic)."""
    b, s, _ = x.shape
    num_experts = router_kernel.shape[1]
    if not 1 <= k <= num_experts:
        raise ValueError(
            f"top-k k={k} must be in [1, num_experts={num_experts}]")
    g = groups or MoEGroups()
    seq = g.sequence if positions is not None else None
    cap = moe_capacity(s * group_size(seq), num_experts, k, capacity_factor)
    r = moe_route(x, router_kernel, k, cap, valid)
    if group_size(seq) > 1:
        r = seq_route(r, seq, positions, cap)
    if g.ffn is None:
        dispatch, combine = dispatch_combine(r, cap, x.dtype)
        expert_in = torch.einsum("bsec,bsd->becd", dispatch, x)
    else:
        e0 = group_rank(g.expert) * wi.shape[0]
        dispatch, combine = dispatch_combine(
            r, cap, x.dtype, slice(e0, e0 + wi.shape[0]),
            copy_to_tensor(r.gate, g.ffn))
        expert_in = _DispatchToExperts.apply(dispatch, x, g.ffn)
    h = F.gelu(torch.einsum("becd,edf->becf", expert_in, wi),
               approximate="tanh")
    out = torch.einsum("becf,efd->becd", h, wo)
    if g.ffn is None:
        y = torch.einsum("bsec,becd->bsd", combine, out)
    else:
        y = _CombineFromExperts.apply(combine, out, g.ffn)

    top1_count = r.oh[:, :, 0, :].sum(dim=(0, 1))
    metrics = _balance_metrics(r.logits, r.probs, top1_count, valid)
    metrics["dropped"] = torch.sum(r.oh_prio.sum(-1) * (1.0 - r.keep))
    return y, metrics


def _balance_metrics(logits: torch.Tensor, probs: torch.Tensor,
                     density_count: torch.Tensor,
                     valid: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The router's metrics both MoE layers give: ``load_balance`` of the
    per-expert ``density_count`` [E] (counted over valid positions) and
    the probabilities' sum over the valid positions, ``router_z``, and the
    parts the loss sums over ranks (``density_count``, ``prob_sum``,
    ``tokens``)."""
    b, s, _ = logits.shape
    if valid is not None:
        vmask = valid.float()
        tokens = torch.clamp(vmask.sum(), min=1.0)
        prob_sum = (probs * vmask[..., None]).sum(dim=(0, 1))
    else:
        tokens = torch.full((), float(b * s), device=logits.device)
        prob_sum = probs.sum(dim=(0, 1))
    return {
        "load_balance": load_balance(density_count, prob_sum, tokens),
        "router_z": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "density_count": density_count, "prob_sum": prob_sum,
        "tokens": tokens,
    }


def moe_dropless(x: torch.Tensor, router_kernel: torch.Tensor,
                 wi: torch.Tensor, wo: torch.Tensor, *, k: int,
                 valid: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Dropless sparse MoE feed-forward with SwiGLU experts, on one device:
    every one of the ``b * s * k`` assignments is computed, none dropped.

    ``x``: [batch, seq, d_model]; ``router_kernel``: [d_model, E];
    ``wi``: [E, d_model, 2 d_ff], each expert's gate (first d_ff columns)
    and up projections side by side; ``wo``: [E, d_ff, d_model]; the
    experts' weights in fp32, cast to x's dtype inside the grouped
    product.  Routing is ``route_gates``' (an fp32 softmax over the
    experts, top-k, the gates renormalised), without ``moe_route``'s
    capacity slots.  The assignments are sorted by expert (a stable sort,
    so within an expert in token order) into a buffer of exactly ``b * s
    * k`` rows, the per-expert row counts and offsets kept on the card
    (``moe_gemm.Groups``); then ``moe_gemm``'s
    grouped products, ``silu(gate) * up``, the second grouped product, and
    each token's ``k`` outputs weighed by their gates and summed in fp32.
    Every shape is static and nothing goes to the host, so the step that
    runs it captures.

    ``valid`` (0/1 [batch, seq]) leaves positions out of the metrics only:
    with no capacity, an invalid position cannot take another's slot.
    ``metrics``: ``_balance_metrics`` with the density of every top-k
    assignment (its count over k, so a balanced router reads 1)."""
    from tpujob_torch.workloads import moe_gemm

    b, s, d = x.shape
    num_experts = router_kernel.shape[1]
    if not 1 <= k <= num_experts:
        raise ValueError(
            f"top-k k={k} must be in [1, num_experts={num_experts}]")
    logits, probs, gate, expert_idx = route_gates(x, router_kernel, k)
    flat = expert_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    inverse = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    counts = torch.zeros(num_experts, dtype=torch.long, device=x.device)
    counts.index_add_(0, flat, torch.ones_like(flat))
    groups = moe_gemm.groups(counts)
    rows = moe_gemm.dispatch(x.reshape(b * s, d), order, inverse, k)
    h = moe_gemm.grouped_matmul(rows, wi, groups)
    f = wo.shape[1]
    h = F.silu(h[:, :f]) * h[:, f:]
    out = moe_gemm.undispatch(moe_gemm.grouped_matmul(h, wo, groups), order,
                              inverse).view(b * s, k, d)
    y = (out.float() * gate.reshape(b * s, k, 1)).sum(1)
    y = y.to(x.dtype).view(b, s, d)
    density = counts.float() if valid is None else torch.zeros(
        num_experts, device=x.device).index_add_(
        0, flat, valid.float().reshape(-1).repeat_interleave(k))
    return y, _balance_metrics(logits, probs, density / k, valid)
