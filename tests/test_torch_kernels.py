"""The hand-written CUDA kernels of ``tpujob_torch`` against their plain
PyTorch versions, on the card (``gpu`` marker; skipped without one).

This file imports torch only, so it runs on a machine without JAX:

    python -m pytest -m gpu tests/test_torch_kernels.py -q

Tolerance, element by element: |kernel - plain| <= 2e-2 x |plain| +
2e-2 x rms_row(plain) + 1e-3 x rms(plain), with rms_row the rms over the
element's row of head_dim values and the last term a floor for rows that
are exactly 0 (bf16 outputs, P and dS rounded to bf16 for the tensor
cores); lse 1e-3 (fp32 in both).  The ``_any`` kernels (fp32 or bf16 at
any head dim, fp32 arithmetic like the plain versions, their products on
the tensor cores in split precision) are held tighter:
in fp32 1e-5 x |plain| + 1e-5 x rms_row + 1e-6 x rms (the two differ in
summation order, the exp/log approximations and the split's 22 of 24
bits), in bf16 1e-2 x |plain| + 1e-3 x rms_row + 1e-4 x rms (one bf16 ulp
of the rounded output, at most 2^-7 relative); lse 1e-5.
"""
import pytest
import torch

from tpujob_torch.kernels import build
from tpujob_torch.workloads import flash


def assert_close(got, ref, rtol=2e-2, atol_of_row_rms=2e-2,
                 floor_of_rms=1e-3, name=""):
    got, ref = got.cpu().float(), ref.cpu().float()
    rms_row = ref.square().mean(-1, keepdim=True).sqrt()
    bound = (rtol * ref.abs() + atol_of_row_rms * rms_row
             + floor_of_rms * ref.square().mean().sqrt())
    ratio = ((got - ref).abs() / bound).flatten()
    worst = int(ratio.argmax())
    assert ratio[worst] <= 1, (
        f"{name}: worst ratio {ratio[worst].item()} at flat index {worst} "
        f"of {tuple(got.shape)}, got {got.flatten()[worst].item()}, "
        f"ref {ref.flatten()[worst].item()}")


def launched(**want) -> dict:
    """Each flash kernel's launches: ``want``'s, 0 for the others."""
    return {**dict.fromkeys(flash.KERNELS, 0), **want}


def flash_launches() -> dict:
    """Each flash kernel's launches since ``build.reset_launches()``."""
    return {k: build.LAUNCHES[k] for k in flash.KERNELS}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand-written kernels)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("seq,causal,window", [
    (256, False, 0), (256, True, 0), (200, True, 0), (320, True, 96),
    # the 128-row tiles' edges: under one tile, one row past a tile, a
    # window under one tile, a ragged length without the causal mask
    (40, True, 0), (130, True, 0), (320, True, 48), (200, False, 0),
    # B2's 64-row warpgroups and 64-key tiles: the second warpgroup of the
    # only q-tile with 32 rows in S and 32 past it; a window wider than one
    # k-tile and not a multiple of it
    (96, True, 0), (512, True, 200),
    # BERT-large's length without the mask (every q-tile sees all 8 key
    # tiles of 64); decode's fixed buffer, one 128-row q-tile whose second
    # warpgroup lies wholly past S
    (512, False, 0), (64, True, 0)])
def test_kernels_match_plain_versions(cuda, seq, causal, window):
    """B1-B3 on the card against flash_forward_ref / flash_dq_ref /
    flash_dkv_ref on the same bf16 inputs, element by element."""
    check_kernels(cuda, seq, causal, window, head_dim=64)


@pytest.mark.gpu
@pytest.mark.parametrize("seq,causal,window", [
    # bench_models --quick's GPT row (b 4, s 128, h 8), the GPT length with
    # and without the mask, the tiles' edges and a window, at head dim 32
    (128, True, 0), (1024, True, 0), (1024, False, 0), (200, True, 0),
    (40, True, 0), (96, True, 0), (320, True, 96), (64, True, 0)])
def test_kernels_match_plain_versions_head_dim_32(cuda, seq, causal, window):
    """The head-dim-32 instantiation of B1-B3 (64-byte rows, the 64-byte
    swizzle, m64n32 accumulators) against the plain versions."""
    check_kernels(cuda, seq, causal, window, head_dim=32)


def check_kernels(cuda, seq, causal, window, head_dim):
    gen = torch.Generator(device=cuda).manual_seed(seq + window + head_dim)
    q, k, v, do = (torch.randn(2, seq, 4, head_dim, device=cuda,
                               generator=gen, dtype=torch.bfloat16)
                   for _ in range(4))
    kw = dict(causal=causal, scale=head_dim ** -0.5, window=window)

    o, lse = flash.launch_fwd(q, k, v, **kw)
    o_r, lse_r = flash.flash_forward_ref(q, k, v, **kw)
    assert_close(o, o_r, name="o")
    assert (lse - lse_r).abs().max().item() <= 1e-3
    delta = flash.attention_delta(o_r, do)
    assert_close(flash.launch_dq(q, k, v, do, lse_r, delta, **kw),
                 flash.flash_dq_ref(q, k, v, do, lse_r, delta, **kw),
                 name="dq")
    for name, got, ref in zip(
            ("dk", "dv"),
            flash.launch_dkv(q, k, v, do, lse_r, delta, **kw),
            flash.flash_dkv_ref(q, k, v, do, lse_r, delta, **kw)):
        assert_close(got, ref, name=name)


@pytest.mark.gpu
def test_flash_attention_autograd_on_card_matches_cpu(cuda):
    """The autograd path (B1 forward, B2 + B3 backward) on the card against
    the same function on the CPU (plain versions), GQA included.  Each
    route computes D = rowsum(dO o O) from its own bf16 O, and in the first
    causal rows, where dQ = sum_j dS_ij (k_j - mean k) cancels, one ulp of O
    moves dQ by scale x dD x (P K), more than 2e-2 of that row's rms: the
    grads' floor is 2e-2 x the tensor's rms instead of 1e-3."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 192, 4, 64, generator=gen).bfloat16()
    k, v = (torch.randn(2, 192, 2, 64, generator=gen).bfloat16()
            for _ in range(2))
    ct = torch.randn(2, 192, 4, 64, generator=gen)
    out = {}
    for dev in ("cpu", cuda):
        xs = [x.detach().to(dev).requires_grad_() for x in (q, k, v)]
        o = flash.flash_attention(*xs, causal=True)
        (o.float() * ct.to(dev)).sum().backward()
        out[str(dev)] = [o] + [x.grad for x in xs]
    for name, got, ref in zip(("o", "dq", "dk", "dv"), out["cuda"],
                              out["cpu"]):
        assert_close(got, ref, name=name,
                     floor_of_rms=1e-3 if name == "o" else 2e-2)


@pytest.mark.gpu
def test_train_step_launches_each_kernel(cuda, tmp_path):
    """One remat training step of a 2-layer GPT on the card launches B1
    twice per layer (forward and the remat replay), B2 and B3 once."""
    from tpujob_torch.workloads import gpt

    args = gpt.build_parser().parse_args([
        "--hidden", "128", "--heads", "2", "--layers", "2",
        "--intermediate", "256", "--vocab", "211", "--seq-len", "128",
        "--batch-size", "2", "--steps", "1", "--attention", "flash",
        "--dir", str(tmp_path)])
    build.reset_launches()
    res = gpt.run(args)
    assert flash_launches() == launched(flash_fwd=4, flash_dq=2, flash_dkv=2)
    assert all(torch.isfinite(torch.tensor(res["losses"])))


@pytest.mark.gpu
def test_generate_launches_the_forward_kernel_only(cuda):
    """``gpt.generate`` with flash attention on the card runs B1 once a
    layer a new token, under no_grad (no B2, no B3); the cached route
    launches none."""
    from tpujob_torch.workloads import gpt

    args = gpt.build_parser().parse_args([
        "--hidden", "128", "--heads", "2", "--layers", "2",
        "--intermediate", "256", "--vocab", "211", "--seq-len", "64",
        "--batch-size", "2", "--attention", "flash"])
    model = gpt.build_model(args, cuda)
    prompt = torch.randint(0, 211, (2, 8), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(0))
    build.reset_launches()
    out = gpt.generate(model, prompt, 6)
    assert flash_launches() == launched(flash_fwd=12)
    build.reset_launches()
    cached = gpt.generate_cached(model, prompt, 6)
    assert flash_launches() == launched()
    assert out.shape == cached.shape == (2, 14)
    assert torch.equal(out[:, :8], prompt)


ANY_TOL = {torch.float32: dict(rtol=1e-5, atol_of_row_rms=1e-5,
                               floor_of_rms=1e-6),
           torch.bfloat16: dict(rtol=1e-2, atol_of_row_rms=1e-3,
                                floor_of_rms=1e-4)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,seq,causal,window", [
    # chip_smoke's cases at a smaller batch: GPT's fp32 shape, the
    # dryrun's width, the d=128 and d=80 bf16 GPTs (the window at 128),
    # the largest head dim at a ragged length
    (torch.float32, 64, 1024, True, 0), (torch.float32, 16, 64, False, 0),
    (torch.bfloat16, 128, 1024, True, 256), (torch.bfloat16, 80, 1024, True, 0),
    (torch.float32, 256, 1000, True, 0),
    # the tiles' edges: one head-dim column, a head dim past a bucket by
    # one, one row past a 64-row tile, a window narrower than a tile
    (torch.float32, 1, 130, True, 0), (torch.float32, 33, 65, False, 0),
    (torch.bfloat16, 48, 200, True, 17), (torch.float32, 32, 96, True, 0),
    (torch.bfloat16, 256, 40, False, 0),
    # bf16 at a head dim whose rows (72 bytes) TMA cannot take: the
    # producer's plain copies
    (torch.bfloat16, 36, 200, True, 0),
    # fp32 in the 256 bucket (its own kernels): the d=256 GPT's length
    # with a window, a ragged head dim, the bucket's edge, and rows (808
    # bytes) TMA cannot take; one k-tile of keys, where every 16-query
    # tile of dQ takes dP on the CUDA cores on the diagonal tile
    (torch.float32, 256, 1024, True, 256), (torch.float32, 200, 300, True, 0),
    (torch.float32, 129, 257, False, 0), (torch.float32, 202, 130, True, 0),
    (torch.float32, 256, 64, True, 0),
    # bf16 at head dim 128 (its own kernels): Mellum2's sliding window at
    # two windows' length, full causal at a ragged length, non-causal, a
    # window narrower than one tile
    (torch.bfloat16, 128, 2048, True, 1024), (torch.bfloat16, 128, 1100, True, 0),
    (torch.bfloat16, 128, 512, False, 0), (torch.bfloat16, 128, 300, True, 17)])
def test_any_kernels_match_plain_versions(cuda, dtype, d, seq, causal,
                                          window):
    """The _any forward, dQ and dK/dV kernels (bf16 at head dim 128: the
    bf16_128 route's) against flash_forward_ref / flash_dq_ref /
    flash_dkv_ref on the same inputs, element by element.
    In fp32 they can agree bit for bit, so each kernel's outputs are
    allocated where blocks of their sizes filled with NaN were just freed
    (the caching allocator hands them back): an element a kernel skipped
    stays NaN and fails."""
    gen = torch.Generator(device=cuda).manual_seed(seq + d + window)
    q, k, v, do = (torch.randn(2, seq, 2, d, device=cuda, generator=gen,
                               dtype=dtype) for _ in range(4))
    kw = dict(causal=causal, scale=d ** -0.5, window=window)
    tol = ANY_TOL[dtype]
    o_r, lse_r = flash.flash_forward_ref(q, k, v, **kw)
    delta = flash.attention_delta(o_r, do)
    runs = {
        ("o", "lse"): (lambda: flash.launch_fwd(q, k, v, **kw),
                       (o_r, lse_r)),
        ("dq",): (lambda: (flash.launch_dq(q, k, v, do, lse_r,
                                                   delta, **kw),),
                  (flash.flash_dq_ref(q, k, v, do, lse_r, delta, **kw),)),
        ("dk", "dv"): (lambda: flash.launch_dkv(
            q, k, v, do, lse_r, delta, **kw),
            flash.flash_dkv_ref(q, k, v, do, lse_r, delta, **kw)),
    }
    for names, (run, refs) in runs.items():
        junk = [torch.full_like(r, float("nan")) for r in refs]
        del junk
        for name, got, ref in zip(names, run(), refs):
            assert got.dtype == ref.dtype, name
            if name == "lse":
                assert (got - ref).abs().max().item() <= 1e-5
            else:
                assert_close(got, ref, name=name, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,seq", [
    (torch.float32, 64, 1024), (torch.bfloat16, 128, 300),
    (torch.float32, 33, 200), (torch.bfloat16, 36, 130),
    (torch.float32, 256, 1024), (torch.bfloat16, 128, 1100)])
def test_any_backward_launches_give_equal_bits(cuda, dtype, d, seq):
    """Two launches of the _any (and bf16_128) dQ and dK/dV kernels on the
    same inputs give the same bits (no atomics: the captured step's
    bit-equality with the eager one rests on it), by TMA and by the
    producer's copies."""
    gen = torch.Generator(device=cuda).manual_seed(seq + d)
    q, k, v, do = (torch.randn(2, seq, 2, d, device=cuda, generator=gen,
                               dtype=dtype) for _ in range(4))
    kw = dict(causal=True, scale=d ** -0.5)
    o, lse = flash.flash_forward_ref(q, k, v, **kw)
    delta = flash.attention_delta(o, do)
    runs = [(flash.launch_dq(q, k, v, do, lse, delta, **kw),
             *flash.launch_dkv(q, k, v, do, lse, delta, **kw))
            for _ in range(2)]
    for name, a, b in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,seq", [
    (torch.float32, 64, 1024), (torch.bfloat16, 128, 300),
    (torch.float32, 33, 200), (torch.bfloat16, 36, 130),
    (torch.float32, 256, 1024), (torch.bfloat16, 128, 1100)])
def test_any_forward_launches_give_equal_bits(cuda, dtype, d, seq):
    """Two launches of the _any (and bf16_128) forward on the same inputs
    give the same o and lse bits (each consumer owns its rows of O: no
    atomics), by TMA
    (fp32 at 64 and 256, bf16 at 128) and by the producer's plain copies
    (33, 36)."""
    gen = torch.Generator(device=cuda).manual_seed(seq + d)
    q, k, v = (torch.randn(2, seq, 2, d, device=cuda, generator=gen,
                           dtype=dtype) for _ in range(3))
    kw = dict(causal=True, scale=d ** -0.5)
    runs = [flash.launch_fwd(q, k, v, **kw) for _ in range(2)]
    for name, a, b in zip(("o", "lse"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,heads", [(torch.float32, 2),
                                         (torch.bfloat16, 1)])
def test_train_step_takes_the_any_kernels(cuda, tmp_path, dtype, heads):
    """One remat step of a 2-layer GPT in fp32 (head dim 64) or in bf16 at
    head dim 128 launches the _any kernels only, 4 / 2 / 2: in bf16 at 128
    those of their own route, bf16_128."""
    from tpujob_torch.workloads import gpt

    args = gpt.build_parser().parse_args([
        "--hidden", "128", "--heads", str(heads), "--layers", "2",
        "--intermediate", "256", "--vocab", "211", "--seq-len", "128",
        "--batch-size", "2", "--steps", "1", "--attention", "flash",
        "--dir", str(tmp_path)] + (["--no-bf16"] if dtype == torch.float32
                                   else []))
    build.reset_launches()
    res = gpt.run(args)
    route = "any" if dtype == torch.float32 else "bf16_128"
    assert flash_launches() == launched(**{
        flash.kernel_name(kind, route): n
        for kind, n in (("fwd", 4), ("dq", 2), ("dkv", 2))})
    assert all(torch.isfinite(torch.tensor(res["losses"])))
