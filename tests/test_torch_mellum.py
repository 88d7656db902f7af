"""Mellum2's block family on the port (``bert.Bert`` with ``--block
pre_rms``) against the benchmark's plain reference
(``portbench/references/mellum.py``) on the CPU, at a tiny size: hidden
64, four layers (sliding, sliding, sliding, full), 8 experts top-2, window
8, seq 32, in fp32.  Also: the dropless dispatch against a per-expert
loop, with an expert that gets no token and one that gets every token;
YaRN's range and scale at the published dims; each layer's window; and the
default flags' model unchanged.  This file imports no JAX, so its card
test runs beside the card: ``python -m pytest -m gpu
tests/test_torch_mellum.py -q``."""
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import weights
from portbench.models import mellum as arch
from portbench.models import trunk
from portbench.references import mellum as ref
from tpujob_torch.kernels import build
from tpujob_torch.workloads import bert, gpt, moe_gemm, parallel

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "portbench" / "configs"
                     / "mellum2-12b-a2.5b.json").read_text())
TINY = dict(hidden=64, layers=4, heads=4, kv_heads=2, head_dim=16,
            expert_width=24, experts=8, top_k=2, vocab=300, window=8,
            max_positions=32, intermediate=128)
SEED = 2 ** 31 + 12345


def tiny_model_cfg():
    model = copy.deepcopy(CONFIG["model"])
    model.update(TINY)
    model["yarn"] = dict(model["yarn"], original_max_position_embeddings=16)
    return model


def port_and_params(model):
    args = gpt.build_parser().parse_args(
        arch.port_flags(model) + ["--no-bf16", "--attention", "flash",
                                  "--device", "cpu"])
    net = gpt.build_model(args, torch.device("cpu"))
    params = dict(net.named_parameters())
    weights.load_into(params, arch.groups(model), model["init_std"], SEED)
    ref_params = {n: t.clone().requires_grad_() for n, t in weights.all_values(
        arch.groups(model), model["init_std"], SEED, "cpu")}
    return net, ref_params


def batch(model, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, model["vocab"], (2, 32)))


def test_logits_loss_and_every_gradient_match_the_reference():
    model = tiny_model_cfg()
    net, p = port_and_params(model)
    ids = batch(model)
    logits, _ = net(ids, with_metrics=True)
    z, _ = ref.logits(p, ids, model)
    torch.testing.assert_close(logits, z, rtol=1e-4, atol=1e-5)
    loss = gpt.lm_loss(net)((ids,))
    want = ref.lm_loss(p, (ids,), model)
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=1e-6)
    loss.backward()
    grads = torch.autograd.grad(want, list(p.values()))
    assert set(p) == {n for n, _ in net.named_parameters()}
    for (name, g_ref) in zip(p, grads):
        g = dict(net.named_parameters())[name].grad
        torch.testing.assert_close(g, g_ref, rtol=1e-3, atol=1e-6,
                                   msg=lambda m, n=name: f"{n}: {m}")


def test_the_loss_carries_the_aux_term_at_its_coefficient():
    model = tiny_model_cfg()
    net, p = port_and_params(model)
    ids = batch(model, 1)
    loss = gpt.lm_loss(net)((ids,))
    z, balance = ref.logits(p, ids, model)
    ce = -torch.gather(torch.log_softmax(z[:, :-1], -1), -1,
                       ids[:, 1:, None]).mean()
    assert float(balance.detach()) > 1.0  # a random router is not balanced
    torch.testing.assert_close(loss, ce + 1e-3 * balance, rtol=1e-5,
                               atol=1e-6)


def _plain_moe(x, router, wi, wo, k):
    """The dropless layer written as a loop over the experts."""
    t = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(t @ router, -1)
    gate, idx = torch.topk(probs, k, -1)
    gate = gate / gate.sum(-1, keepdim=True)
    f = wo.shape[1]
    y = torch.zeros_like(t)
    for e in range(router.shape[1]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        h = t[tok] @ wi[e]
        out = (F.silu(h[:, :f]) * h[:, f:]) @ wo[e]
        y = y.index_add(0, tok, out * gate[tok, slot, None])
    return y.view_as(x), idx


def test_the_dropless_dispatch_is_a_per_expert_loop_with_empty_and_full_experts():
    gen = torch.Generator().manual_seed(3)
    d, e, f, k = 16, 8, 12, 2
    x = torch.rand(2, 10, d, generator=gen) + 0.1  # every entry positive
    router = 0.1 * torch.randn(d, e, generator=gen)
    router[:, 0] = 5.0   # every token's first choice
    router[:, 3] = -5.0  # no token's choice
    wi = torch.randn(e, d, 2 * f, generator=gen) / d ** 0.5
    wo = torch.randn(e, f, d, generator=gen) / f ** 0.5
    leaves = [t.clone().requires_grad_() for t in (x, router, wi, wo)]
    plain = [t.clone().requires_grad_() for t in (x, router, wi, wo)]
    y, metrics = parallel.moe_dropless(*leaves, k=k)
    want, idx = _plain_moe(*plain, k=k)
    counts = torch.bincount(idx.reshape(-1), minlength=e)
    assert counts[0] == 20 and counts[3] == 0
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)
    g = torch.randn(y.shape, generator=gen)
    got = torch.autograd.grad((y * g).sum() + metrics["load_balance"], leaves)
    share = counts.float() / idx.numel()
    probs = torch.softmax(plain[0].reshape(-1, d) @ plain[1], -1)
    lb = e * torch.sum(share * probs.mean(0))
    torch.testing.assert_close(metrics["load_balance"], lb)
    wanted = torch.autograd.grad((want * g).sum() + lb, plain)
    for a, b in zip(got, wanted):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert float(got[2][3].abs().sum()) == 0.0  # the empty expert


def test_the_plain_grouped_products_are_per_expert_matmuls():
    gen = torch.Generator().manual_seed(5)
    counts = torch.tensor([3, 0, 7, 1])
    g = moe_gemm.groups(counts)
    assert g.offsets.tolist() == [0, 3, 3, 10, 11]
    assert g.tiles.tolist() == [0, 1, 1, 2, 3]
    a = torch.randn(11, 5, generator=gen)
    w = torch.randn(4, 5, 6, generator=gen)
    out = moe_gemm.gemm(a, w, g)
    grad = torch.randn(11, 6, generator=gen)
    dw = moe_gemm.gemm_dw(a, grad, g, 4)
    for e, (lo, hi) in enumerate([(0, 3), (3, 3), (3, 10), (10, 11)]):
        torch.testing.assert_close(out[lo:hi], a[lo:hi] @ w[e])
        torch.testing.assert_close(moe_gemm.gemm_t(grad, w, g)[lo:hi],
                                   grad[lo:hi] @ w[e].T)
        torch.testing.assert_close(dw[e], a[lo:hi].T @ grad[lo:hi])
    assert float(dw[1].abs().sum()) == 0.0


def test_yarn_range_and_scale_at_the_published_dims():
    yarn = CONFIG["rope_parameters"]["full_attention"]
    port = bert.YaRN(yarn["factor"], yarn["original_max_position_embeddings"])
    # the published betas and attention factor are HF's defaults, the port's
    assert (port.beta_fast, port.beta_slow) == (yarn["beta_fast"],
                                                yarn["beta_slow"])
    assert port.scale() == pytest.approx(yarn["attention_factor"], rel=1e-15)
    assert port.correction_range(128, 500000) == (18, 35)
    assert port.scale() == pytest.approx(1.27726, abs=1e-5)
    inv, scale = bert.rope_frequencies(128, 500000.0, port, "cpu")
    inv_ref, scale_ref = ref.rope_frequencies(128, 500000.0, yarn)
    torch.testing.assert_close(inv, inv_ref)
    assert scale == scale_ref
    plain, _ = bert.rope_frequencies(128, 500000.0, None, "cpu")
    # below the range the frequencies are the plain ones, above it 1/16 of them
    torch.testing.assert_close(inv[:18], plain[:18])
    torch.testing.assert_close(inv[35:], plain[35:] / 16)


def test_each_layer_takes_its_window_and_only_the_full_layer_yarn():
    model = tiny_model_cfg()
    net, _ = port_and_params(model)
    got = [(getattr(net, f"layer_{i}").attn.window,
            getattr(net, f"layer_{i}").attn.yarn is not None)
           for i in range(4)]
    assert got == [(8, False), (8, False), (8, False), (0, True)]
    assert arch.windows(model) == [8, 8, 8, 0]
    args = gpt.build_parser().parse_args(
        ["--layers", "6", "--attention-pattern", "SF", "--attention-window",
         "5"])
    assert bert.layer_windows(args) == [5, 0, 5, 0, 5, 0]


@pytest.mark.parametrize("flags,message", [
    (["--moe-expert-width", "24"], "--moe-experts"),
    (["--block", "pre_rms", "--moe-experts", "4", "--expert-parallel", "2"],
     "pre_rms"),
    (["--untied-head", "--pipeline-parallel", "2"], "pre_rms"),
    (["--attention-pattern", "SSX", "--attention-window", "4"], "letters"),
    (["--attention-pattern", "SF"], "--attention-window"),
    (["--yarn-factor", "4", "--yarn-original-positions", "8"], "rope"),
    (["--block", "pre_rms", "--fsdp", "2"], "data parallelism"),
])
def test_the_flag_checks(flags, message):
    args = gpt.build_parser().parse_args(flags + ["--device", "cpu"])
    with pytest.raises(ValueError, match=message):
        bert.validate_parallel_flags(args, causal=True)


def test_default_flags_build_the_trunk_as_before():
    args = gpt.build_parser().parse_args(
        ["--hidden", "64", "--layers", "2", "--heads", "4", "--intermediate",
         "128", "--vocab", "211", "--seq-len", "32", "--device", "cpu"])
    net = gpt.build_model(args, torch.device("cpu"))
    layout = trunk.groups(dict(hidden=64, layers=2, intermediate=128,
                               vocab=211, max_positions=32,
                               final_layer_norm=True))
    want = [(n, s) for group in layout for n, s, _ in group]
    assert sorted((n, tuple(p.shape)) for n, p in net.named_parameters()) \
        == sorted(want)
    assert [type(m).__name__ for m in net.children()] == [
        "Embedding", "LayerNorm", "LayerNorm", "Block", "Block"]
    assert net.lm_head is None and isinstance(net.ln_embed, bert.LayerNorm)


@pytest.mark.gpu
@pytest.mark.parametrize("k_dim,n_dim", [(192, 320), (128, 512)])
def test_grouped_gemm_kernels_match_fp32_per_expert_matmuls(k_dim, n_dim):
    """On the card: the three kernels against fp32 per-expert products of
    the same bf16 inputs, with ragged groups (one of a single row, one of
    several tiles and an edge) and empty ones, in both passes; at widths
    whose output tiles are 128 columns (320) and 256 (512), one of them
    ragged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the grouped-GEMM kernels)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    counts = torch.tensor([1, 0, 300, 0, 129, 640, 0, 17], device=dev)
    rows = int(counts.sum())
    g = moe_gemm.groups(counts)
    a = torch.randn(rows, k_dim, device=dev, generator=gen).bfloat16()
    w = torch.randn(8, k_dim, n_dim, device=dev, generator=gen).bfloat16()
    grad = torch.randn(rows, n_dim, device=dev, generator=gen).bfloat16()
    build.reset_launches()
    out = moe_gemm.gemm(a, w, g)
    da = moe_gemm.gemm_t(grad, w, g)
    dw = moe_gemm.gemm_dw(a, grad, g, 8)
    torch.cuda.synchronize()
    assert build.LAUNCHES == {
        "moe_gemm_fwd": 1, "moe_gemm_dx": 1, "moe_gemm_dw": 1}
    lo = 0
    for e, n in enumerate(counts.tolist()):
        hi = lo + n
        # bf16 outputs: within a bf16 rounding of the largest element
        for got, want in ((out, a[lo:hi].float() @ w[e].float()),
                          (da, grad[lo:hi].float() @ w[e].float().T)):
            scale = float(want.abs().max()) if n else 1.0
            torch.testing.assert_close(got[lo:hi].float(), want, rtol=1e-2,
                                       atol=1e-2 * scale)
        want = a[lo:hi].float().T @ grad[lo:hi].float()
        torch.testing.assert_close(dw[e], want, rtol=1e-4, atol=1e-3)
        lo = hi
    assert dw.dtype == torch.float32
