"""The port's flash attention (``tpujob_torch.workloads.flash``) against the
JAX package's Pallas kernels, run in interpret mode on the CPU.

The same numpy inputs go to both sides.  On the CPU the port's wrappers
take the kernels' plain versions, so these tests pin the math of B1-B3 and
the autograd plumbing around them; the CUDA kernels themselves are held
against the same plain versions on the card (``tests/test_torch_kernels.py``
and ``chip_smoke.py``).

Tolerances: fp32 2e-5 for o and lse, 2e-4 for grads (two fp32 summation
orders: blockwise in Pallas, dense in the plain version); bf16 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from tpujob.workloads import flash as jflash
from tpujob_torch.workloads import flash, parallel

CASES = {
    # id: (seq, heads, kv_heads, causal, window, dtype)
    "noncausal": (256, 2, 2, False, 0, "float32"),
    "causal": (256, 2, 2, True, 0, "float32"),
    "window": (256, 2, 2, True, 100, "float32"),
    "gqa": (256, 4, 2, True, 0, "float32"),
    "ragged": (200, 2, 2, True, 0, "float32"),
    "bf16": (256, 2, 2, True, 0, "bfloat16"),
}
TOL = {"float32": (2e-5, 2e-4), "bfloat16": (2e-2, 2e-2)}
B, D = 2, 32


def _inputs(seq, heads, kv_heads, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, seq, heads, D).astype(np.float32)
    k = rng.randn(B, seq, kv_heads, D).astype(np.float32)
    v = rng.randn(B, seq, kv_heads, D).astype(np.float32)
    ct = rng.randn(B, seq, heads, D).astype(np.float32)
    return q, k, v, ct


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """Both sides' forward and grads for one case (JAX computed once)."""
    seq, heads, kvh, causal, window, dtype = CASES[request.param]
    q, k, v, ct = _inputs(seq, heads, kvh)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))

    def jloss(q, k, v):
        o = jflash.flash_attention(q, k, v, causal=causal, window=window)
        return jnp.sum(o.astype(jnp.float32) * ct)

    jo = jflash.flash_attention(jq, jk, jv, causal=causal, window=window)
    jgrads = jax.grad(jloss, (0, 1, 2))(jq, jk, jv)

    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tq, tk, tv = (torch.tensor(x, dtype=tdt, requires_grad=True)
                  for x in (q, k, v))
    to = flash.flash_attention(tq, tk, tv, causal=causal, window=window)
    (to.float() * torch.from_numpy(ct)).sum().backward()
    return dict(name=request.param, causal=causal, window=window,
                dtype=dtype, inputs=(q, k, v), jo=_f32(jo),
                jgrads=[_f32(g) for g in jgrads], to=to.detach().float().numpy(),
                tgrads=[t.grad.float().numpy() for t in (tq, tk, tv)])


def test_forward_matches_pallas(case):
    tol = TOL[case["dtype"]][0]
    np.testing.assert_allclose(case["to"], case["jo"], rtol=tol, atol=tol)


def test_grads_match_pallas(case):
    tol = TOL[case["dtype"]][1]
    for got, want, name in zip(case["tgrads"], case["jgrads"], "qkv"):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=f"d{name} ({case['name']})")


@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0), (True, 100)])
def test_lse_matches_pallas(causal, window):
    """The saved logsumexp (flat [b, h, s] here, lane-replicated
    [b*h, s, 128] in the reference) agrees at 2e-5."""
    q, k, v, _ = _inputs(256, 2, 2, seed=3)
    _, jlse = jflash._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, D ** -0.5,
        128, 128, True, window)
    jlse = np.asarray(jlse)[..., 0].reshape(B, 2, 256)
    _, lse = flash.flash_forward_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, scale=D ** -0.5, window=window)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=2e-5, atol=2e-5)


def test_backward_ref_matches_dense_autograd():
    """flash_backward_ref is the exact gradient of dense attention."""
    q, k, v, ct = (torch.from_numpy(x).requires_grad_()
                   for x in _inputs(64, 2, 2, seed=5))
    ct = ct.detach()
    (parallel.full_attention(q, k, v, causal=True, window=20) * ct).sum().backward()
    o, lse = flash.flash_forward_ref(q.detach(), k.detach(), v.detach(),
                                     causal=True, scale=D ** -0.5, window=20)
    grads = flash.flash_backward_ref(q.detach(), k.detach(), v.detach(), o,
                                     lse, ct, causal=True, scale=D ** -0.5,
                                     window=20)
    for got, want in zip(grads, (q.grad, k.grad, v.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                                   atol=2e-5)


def test_remat_replays_forward_and_matches():
    """Under torch.utils.checkpoint the forward runs again inside backward
    (its lse is what the backward reads); grads equal the plain run's."""
    q, k, v, ct = (torch.from_numpy(x) for x in _inputs(128, 2, 2, seed=7))
    calls = []
    orig = flash.flash_forward_ref

    def counting(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    def run(remat):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]

        def f(q, k, v):
            return flash.flash_attention(q, k, v, causal=True)

        o = checkpoint(f, *xs, use_reentrant=False) if remat else f(*xs)
        (o * ct).sum().backward()
        return [x.grad for x in xs]

    plain = run(False)
    flash.flash_forward_ref = counting
    try:
        remat = run(True)
    finally:
        flash.flash_forward_ref = orig
    assert len(calls) == 2
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)


def test_validation_matches_reference():
    q = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError, match="window must be >= 0"):
        flash.flash_attention(q, q, q, causal=True, window=-1)
    with pytest.raises(ValueError, match="requires causal"):
        flash.flash_attention(q, q, q, window=4)
    with pytest.raises(ValueError, match="multiple of KV heads"):
        flash.flash_attention(q, torch.zeros(1, 8, 3, 4), torch.zeros(1, 8, 3, 4))


def test_cpu_path_launches_no_kernel():
    flash.reset_launches()
    q = torch.randn(1, 64, 2, 64, requires_grad=True)
    flash.flash_attention(q, q, q, causal=True).sum().backward()
    assert flash.LAUNCHES == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


@pytest.mark.parametrize("wrapper", ["flash_fwd_cuda", "flash_dq_cuda",
                                     "flash_dkv_cuda"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    """A wrapper never runs the plain version for a tensor it was handed
    directly: CPU tensors are refused before any build or launch."""
    x = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    r = torch.zeros(1, 2, 64)
    args = (x, x, x) if wrapper == "flash_fwd_cuda" else (x, x, x, x, r, r)
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(flash, wrapper)(*args, causal=True, scale=0.125)


@pytest.mark.parametrize("dtype,head_dim,supported", [
    (torch.bfloat16, 64, True), (torch.float32, 64, False),
    (torch.float16, 64, False), (torch.bfloat16, 128, False),
    (torch.bfloat16, 32, True)])
def test_check_supported_owns_the_kernel_limits(dtype, head_dim, supported):
    """The kernels take bf16 at head dim 32 or 64; anything else raises
    "not yet ported" from the one check that model builders and launches
    share."""
    if supported:
        flash.check_supported(dtype, head_dim)
    else:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            flash.check_supported(dtype, head_dim)
