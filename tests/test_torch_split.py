"""The numerics plan of the general kernels on the tensor cores, B2a/B3a
(``tpujob_torch/csrc/flash_tc.cuh``) and B1a (``flash_fwd_tc.cuh``), on
the CPU: their products emulated
on the plain backward at a small shape, held to the card tests' ``ANY_TOL``
against ``flash_dq_ref`` / ``flash_dkv_ref``.

- fp32 (3xTF32): every product as big.big + big.small + small.big, big =
  the operand rounded to tf32 (low 13 mantissa bits cleared, to nearest),
  small = the rest rounded to tf32; one pass reads each raw fp32 operand as
  the tensor core does, its low 13 bits cleared.
- bf16: S and dP are exact products of bf16 inputs; P and dS enter the
  last products as a bf16 high part plus a bf16 low part; one pass takes
  the high part alone.

Each term is summed exactly (float64) and rounded to fp32 once, as the
kernels' per-batch fp32 adds keep their sums near that; at head dim 256
(129-256 pads to it) the sums follow the fp32 kernels' batches instead:
each batch's terms summed exactly, rounded to fp32 and added in fp32
(``CHUNKS``).  As in the
kernels, query 0's one dP under the causal mask (the row whose dS is the
rounding noise of dP - D) is the plain version's.  The split lands within
ANY_TOL everywhere.  One pass misses it in fp32 by two orders of
magnitude; in bf16 it stays under 2x of it at these sizes (one rounding of
P and dS to bf16 against the output's own), so there the test holds the
split to no worse than one pass and prints both (``-s``).

B1a's plan on ``flash_forward_ref``'s math: S = Q K^T in 3xTF32 (fp32) or
exact (bf16), the softmax in fp32, P V in 3xTF32 (fp32) or with P as a
bf16 high + low part (bf16); o held to ANY_TOL and lse to ANY_LSE_TOL.
One pass (the raw fp32 words read as tf32; P's high part alone in bf16)
misses in fp32 by more than 2x.  At fp32 head dim 256 B1a takes Q's tf32
parts in registers as each k-step is loaded and adds S in batches of four
k-steps (32 head-dim columns), P V a 32-key tile at a time; B2a and B3a
sum S and dP in batches of eight k-steps (64 columns), B2a dQ a 64-key tile
at a time and B3a dK, dV a 64-query tile at a time.
"""
import pytest
import torch

from test_torch_kernels import ANY_TOL
from tpujob_torch.workloads import flash


def tf32_round(x):
    """x rounded to tf32 (11 significant bits), to nearest."""
    u = x.float().contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_read(x):
    """What the tensor core reads of an fp32 word: the low 13 bits cleared."""
    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(
        torch.float32)


def parts(x, split: bool):
    """x as the parts the kernels feed the tensor cores: fp32 as tf32 big
    and small (one pass: the raw word as read), bf16-rounded P or dS as a
    high and a low part (one pass: the high part)."""
    if x.dtype == torch.float32 and not split:
        return [tf32_read(x)]
    if not split:
        return [x.to(torch.bfloat16).float()]
    hi = x.to(torch.bfloat16).float()
    return [hi, (x - hi).to(torch.bfloat16).float()]


def tf32_parts(x, split: bool):
    if not split:
        return [tf32_read(x)]
    big = tf32_round(x)
    return [big, tf32_round(x.float() - big)]


def tc_product(eq, a, b, *, split: bool, first: bool, chunk: int = 0):
    """einsum(eq, a, b) as B2a/B3a's wgmmas compute it: a is an input
    tensor (q, k, v or dO), b an input (first products) or P / dS.  fp32:
    the tf32 passes of both (3xTF32, or one); bf16: a exact, b exact in
    the first products, else its high + low parts (or the high one).  Each
    term exact, the sum rounded to fp32 once; with ``chunk``, once for each
    ``chunk`` entries of the summed axis, those sums added in fp32."""
    if a.dtype == torch.float32:
        pa, pb = tf32_parts(a, split), tf32_parts(b, split)
        pairs = [(0, 0), (0, 1), (1, 0)] if split else [(0, 0)]
    else:
        pa = [a.float()]
        pb = [b.float()] if first else parts(b, split)
        pairs = [(0, j) for j in range(len(pb))]
    ins, out = eq.split("->")
    sa, sb = ins.split(",")
    axis = next(c for c in sa if c in sb and c not in out)
    n = a.shape[sa.index(axis)]
    total = None
    for c0 in range(0, n, chunk or n):
        def cut(x, spec):
            return x.narrow(spec.index(axis), c0, min(chunk or n, n - c0))
        part = sum(torch.einsum(eq, cut(pa[i], sa).double(),
                                cut(pb[j], sb).double())
                   for i, j in pairs).float()
        total = part if total is None else total + part
    return total


# fp32 head dim 256: the summed axis's batches of B1a's S and P V, of B2a's
# and B3a's S and dP, of B2a's dQ and of B3a's dK and dV
CHUNKS = {"fwd_s": 32, "fwd_pv": 32, "bwd_first": 64, "dq_second": 64,
          "dkv_second": 64}


def chunks(dtype, d) -> dict:
    """The kernels' batches at this dtype and head dim (none: exact)."""
    return CHUNKS if dtype == torch.float32 and d > 128 else {}


def emulated_backward(q, k, v, do, lse, delta, *, causal, scale, split):
    """(dq, dk, dv) with B2a/B3a's products on the plain backward."""
    ch = chunks(q.dtype, q.shape[-1])
    first = ch.get("bwd_first", 0)
    s = tc_product("bqhd,bkhd->bhqk", q, k, split=split, first=True,
                   chunk=first) * scale
    dp = tc_product("bqhd,bkhd->bhqk", do, v, split=split, first=True,
                    chunk=first)
    if causal:  # query 0's one dP in the plain version's arithmetic
        dp[:, :, 0, 0] = torch.einsum(
            "bqhd,bkhd->bhqk", do.float(), v.float())[:, :, 0, 0]
    p = torch.exp(s - lse[..., None])
    vis = flash._visible(q.shape[1], k.shape[1], causal, 0, q.device)
    if vis is not None:
        p = p.masked_fill(~vis, 0.0)
    ds = p * (dp - delta[..., None]) * scale
    second = ch.get("dkv_second", 0)
    out = (tc_product("bkhd,bhqk->bqhd", k, ds, split=split, first=False,
                      chunk=ch.get("dq_second", 0)),
           tc_product("bqhd,bhqk->bkhd", q, ds, split=split, first=False,
                      chunk=second),
           tc_product("bqhd,bhqk->bkhd", do, p, split=split, first=False,
                      chunk=second))
    return tuple(x.to(q.dtype) for x in out)


def worst_ratio(got, ref, tol) -> float:
    """The card tests' element-wise ratio to rtol*|ref| + atol*rms_row(ref)
    + floor*rms(ref), its worst (<= 1 passes)."""
    got, ref = got.float(), ref.float()
    bound = (tol["rtol"] * ref.abs()
             + tol["atol_of_row_rms"] * ref.square().mean(-1, keepdim=True)
             .sqrt() + tol["floor_of_rms"] * ref.square().mean().sqrt())
    return ((got - ref).abs() / bound).max().item()


CASES = [(torch.float32, 64, 128, True), (torch.float32, 16, 64, False),
         (torch.bfloat16, 128, 128, True), (torch.bfloat16, 80, 96, False),
         (torch.bfloat16, 36, 200, True), (torch.float32, 256, 128, True),
         # a ragged head dim in the 256 bucket (its batches over a padded
         # head dim) at a ragged length
         (torch.float32, 200, 96, True)]


def ratios(dtype, d, seq, causal):
    """Worst ratios (dq, dk, dv) of the split and of one pass."""
    gen = torch.Generator().manual_seed(seq + d)
    q, k, v, do = (torch.randn(1, seq, 2, d, generator=gen).to(dtype)
                   for _ in range(4))
    kw = dict(causal=causal, scale=d ** -0.5)
    o, lse = flash.flash_forward_ref(q, k, v, **kw)
    delta = flash.attention_delta(o, do)
    ref = (flash.flash_dq_ref(q, k, v, do, lse, delta, **kw),
           *flash.flash_dkv_ref(q, k, v, do, lse, delta, **kw))
    return [[worst_ratio(g, r, ANY_TOL[dtype]) for g, r in zip(
        emulated_backward(q, k, v, do, lse, delta, split=split, **kw), ref)]
        for split in (True, False)]


@pytest.mark.parametrize("dtype,d,seq,causal", CASES)
def test_split_meets_any_tol_and_one_pass_does_not(dtype, d, seq, causal):
    split, one_pass = ratios(dtype, d, seq, causal)
    print(f"{dtype} d={d} s={seq} causal={causal}: worst ratio to ANY_TOL "
          f"(dq, dk, dv) split {split}, one pass {one_pass}")
    assert max(split) <= 1, split
    assert max(split) <= max(one_pass), (split, one_pass)
    if dtype == torch.float32:  # a clear margin: one pass misses ANY_TOL
        assert min(one_pass) > 2, one_pass


ANY_LSE_TOL = 1e-5  # the card tests' lse bound (absolute, fp32)


def emulated_forward(q, k, v, *, causal, scale, split):
    """(o, lse) with B1a's products on the plain forward: S in the split
    (or one pass), the masked softmax in fp32, P V with P's parts."""
    ch = chunks(q.dtype, q.shape[-1])
    s = tc_product("bqhd,bkhd->bhqk", q, k, split=split, first=True,
                   chunk=ch.get("fwd_s", 0)) * scale
    vis = flash._visible(q.shape[1], k.shape[1], causal, 0, q.device)
    if vis is not None:
        s = s.masked_fill(~vis, flash.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if vis is not None:
        p = p.masked_fill(~vis, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = tc_product("bkhd,bhqk->bqhd", v, p, split=split, first=False,
                     chunk=ch.get("fwd_pv", 0))
    o = acc / l.squeeze(-1).transpose(1, 2)[..., None]
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def forward_ratios(dtype, d, seq, causal):
    """Worst ratios (o to ANY_TOL, lse to ANY_LSE_TOL) of the split and of
    one pass."""
    gen = torch.Generator().manual_seed(seq + d)
    q, k, v = (torch.randn(1, seq, 2, d, generator=gen).to(dtype)
               for _ in range(3))
    kw = dict(causal=causal, scale=d ** -0.5)
    o_ref, lse_ref = flash.flash_forward_ref(q, k, v, **kw)
    out = []
    for split in (True, False):
        o, lse = emulated_forward(q, k, v, split=split, **kw)
        out.append([worst_ratio(o, o_ref, ANY_TOL[dtype]),
                    (lse - lse_ref).abs().max().item() / ANY_LSE_TOL])
    return out


@pytest.mark.parametrize("dtype,d,seq,causal", CASES)
def test_forward_split_meets_any_tol_and_one_pass_does_not(dtype, d, seq,
                                                           causal):
    split, one_pass = forward_ratios(dtype, d, seq, causal)
    print(f"{dtype} d={d} s={seq} causal={causal}: forward worst ratio "
          f"(o to ANY_TOL, lse to ANY_LSE_TOL) split {split}, one pass "
          f"{one_pass}")
    assert max(split) <= 1, split
    assert split[0] <= one_pass[0], (split, one_pass)
    if dtype == torch.float32:  # a clear margin: one pass misses ANY_TOL
        assert one_pass[0] > 2, one_pass
