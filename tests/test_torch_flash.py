"""The port's flash attention (``tpujob_torch.workloads.flash``) against the
JAX package's Pallas kernels, run in interpret mode on the CPU.

The same numpy inputs go to both sides.  On the CPU the port's wrappers
take the kernels' plain versions, so these tests pin the math of B1-B3 and
the autograd plumbing around them; the CUDA kernels themselves are held
against the same plain versions on the card (``tests/test_torch_kernels.py``
and ``chip_smoke.py``).

Tolerances: fp32 2e-5 for o and lse, 2e-4 for grads (two fp32 summation
orders: blockwise in Pallas, dense in the plain version); bf16 2e-2.  The
head dims the ``_any`` kernels add on the card (16, 80, 128, 256, fp32)
are held the same way (``test_any_head_dim_matches_pallas``): the
wrappers take the same plain versions here, at every head dim.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from tpujob.workloads import flash as jflash
from tpujob_torch.kernels import build
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
    """Every kernel is counted under its own name, and the CPU path (the
    plain versions) launches none of them, in bf16 or fp32, on any
    route's head dim."""
    build.reset_launches()
    for dtype, d in ((torch.bfloat16, 64), (torch.float32, 64),
                     (torch.bfloat16, 128)):
        q = torch.randn(1, 64, 2, d, dtype=dtype, requires_grad=True)
        flash.flash_attention(q, q, q, causal=True).sum().backward()
    assert build.LAUNCHES == {}
    assert flash.KERNELS == (
        "flash_fwd", "flash_dq", "flash_dkv", "flash_fwd_bf16_128",
        "flash_dq_bf16_128", "flash_dkv_bf16_128", "flash_fwd_any",
        "flash_dq_any", "flash_dkv_any")


# an input of each route: (dtype, head dim)
ROUTE_INPUTS = {"tuned": (torch.bfloat16, 64),
                "bf16_128": (torch.bfloat16, 128),
                "any": (torch.float32, 64)}


@pytest.mark.parametrize("kind", flash.KINDS)
@pytest.mark.parametrize("route", flash.ROUTES)
def test_kernel_wrappers_refuse_cpu_tensors(kind, route):
    """A wrapper never runs the plain version for a tensor it was handed
    directly: CPU tensors are refused before any build or launch, on every
    route."""
    dtype, d = ROUTE_INPUTS[route]
    assert flash.route(dtype, d) == route
    x = torch.zeros(1, 64, 2, d, dtype=dtype)
    r = torch.zeros(1, 2, 64)
    args = (x, x, x) if kind == "fwd" else (x, x, x, x, r, r)
    build.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(flash, f"launch_{kind}")(*args, causal=True, scale=0.125)
    assert build.LAUNCHES == {}


@pytest.mark.parametrize("dtype,head_dim,route", [
    (torch.bfloat16, 64, "tuned"), (torch.bfloat16, 32, "tuned"),
    (torch.float32, 64, "any"), (torch.float32, 32, "any"),
    (torch.bfloat16, 128, "bf16_128"), (torch.bfloat16, 80, "any"),
    (torch.float32, 1, "any"), (torch.float32, 256, "any"),
    (torch.bfloat16, 16, "any"), (torch.float32, 257, None),
    (torch.bfloat16, 257, None), (torch.float32, 0, None),
    (torch.float16, 64, None), (torch.float64, 64, None),
    (torch.float32, 128, "any"), (torch.bfloat16, 127, "any"),
    (torch.bfloat16, 129, "any"), (torch.bfloat16, 256, "any"),
    (torch.float16, 128, None)])
def test_check_supported_owns_the_kernel_limits(dtype, head_dim, route):
    """The kernels take fp32 or bf16 at head dim 1 to 256: the tuned ones
    bf16 at 64 or 32, the bf16_128 ones bf16 at exactly 128, the ``_any``
    ones the rest; anything else raises from the one check that model
    constructors and launches share, and ``route`` raises with it."""
    if route is None:
        with pytest.raises(NotImplementedError, match="head dim 1 to 256"):
            flash.check_supported(dtype, head_dim)
        with pytest.raises(NotImplementedError, match="head dim 1 to 256"):
            flash.route(dtype, head_dim)
    else:
        flash.check_supported(dtype, head_dim)
        assert flash.route(dtype, head_dim) == route


def test_reset_launches_clears_the_route_counter():
    """``build.reset_launches`` sets every kernel's launches to 0, every
    route's and the grouped GEMMs' alike."""
    build.LAUNCHES["flash_fwd_any"] += 4
    build.LAUNCHES["flash_dkv_bf16_128"] += 2
    build.LAUNCHES["moe_gemm_dw"] += 1
    build.reset_launches()
    assert build.LAUNCHES == {}
    assert all(build.LAUNCHES[k] == 0 for k in flash.KERNELS)


# the head dims the _any kernels add: the dryrun's width (16), two that
# are not powers of two or not the tuned ones (80, 128) and the largest
# (256); fp32 causal, and one non-causal
ANY_CASES = {"d16": (16, True), "d80": (80, True), "d128": (128, False),
             "d256": (256, True)}


@pytest.fixture(scope="module", params=sorted(ANY_CASES))
def any_case(request):
    """The JAX package's flash attention (Pallas, interpret mode) and the
    port's at one head dim in fp32: forward and grads of sum(o * ct)."""
    d, causal = ANY_CASES[request.param]
    rng = np.random.RandomState(d)
    q, k, v, ct = (rng.randn(1, 256, 2, d).astype(np.float32)
                   for _ in range(4))

    def jloss(q, k, v):
        return jnp.sum(jflash.flash_attention(q, k, v, causal=causal) * ct)

    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jo = jflash.flash_attention(jq, jk, jv, causal=causal)
    jgrads = jax.grad(jloss, (0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    to = flash.flash_attention(tq, tk, tv, causal=causal)
    (to * torch.from_numpy(ct)).sum().backward()
    return (np.asarray(jo), [np.asarray(g) for g in jgrads],
            to.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)])


def test_any_head_dim_matches_pallas(any_case):
    """fp32 at the ``_any`` kernels' head dims: o within 2e-5, grads
    within 2e-4, as the fp32 cases above."""
    jo, jgrads, to, tgrads = any_case
    fwd_tol, grad_tol = TOL["float32"]
    np.testing.assert_allclose(to, jo, rtol=fwd_tol, atol=fwd_tol)
    for got, want, name in zip(tgrads, jgrads, "qkv"):
        np.testing.assert_allclose(got, want, rtol=grad_tol, atol=grad_tol,
                                   err_msg=f"d{name}")
