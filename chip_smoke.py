#!/usr/bin/env python3
"""Drive the PyTorch port (``tpujob_torch``) on one NVIDIA card and hold
every hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py            # from the repo root, one CUDA card

Phases, one JSON line each on stdout:

1. ``device``: the card, its power limit, torch and CUDA versions.
2. ``build``: every kernel of ``tpujob_torch/csrc`` compiled with ``nvcc``
   for sm_90a (all sources at once), with ptxas' register/spill report and
   each warpgroup role's ``setmaxnreg`` budget; a spill fails the phase, and
   so does ptxas' C7518 ("wgmma serialized") or C7517 ("warpgroup.wait
   injected"): all three kernels are wgmma kernels, and either note means
   the products of one no longer overlap.
3. ``kernel``: each flash kernel (B1 forward, B2 dQ, B3 dK/dV) at the
   GPT-2-medium shapes (b=8, s=1024, h=16, d=64, bf16, causal), at a ragged
   length (s=1000) and with a sliding window (256): every element within
   RTOL x |plain| + ATOL x rms_row(plain) + FLOOR x rms(plain) of the
   plain version, and at the main shape the kernel's, the plain version's and the PyTorch library call's
   times (CUDA events) beside the bound computed from the inputs, the
   rate over the visible pairs' FLOPs (``tflops``) and ``bound_share``
   (bound / time); ``backward``: B2 and B3 launched back to back, timed
   together, beside SDPA's backward (one call for dQ, dK and dV).
4. ``model``: a 2-layer full-width GPT on the card with flash attention
   against the same weights with dense attention (logits, loss, and each
   parameter's gradient, by normwise relative error).
5. ``train``: the main path — ``gpt.run`` trains GPT-2-medium (24 layers,
   hidden 1024, 16 heads, vocab 50257, seq 1024, batch 8, bf16, remat,
   flash attention) for 16 steps from a seed; losses must be finite and
   fall.  Kernel launch counts are zeroed just before and read just after.
   The rate is all tokens over all the time of steps 3-12; ``profile``:
   steps 13-16 under torch.profiler, device time by kernel class and the
   device's busy share of those steps (the profiler's own host cost
   included: compare ``host_step_ms`` with the unprofiled steps).

Then the ``kernels`` summary line, the card's ``name, power.limit`` as
nvidia-smi prints them, and last ``{"ok": true, "device": {...}}``.  Any
failure (no card, no package, a build error, a mismatch, a kernel the main
path never launched) exits non-zero before the last line.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import traceback

import torch

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM
H100_BYTES_S = 3.35e12    # HBM3 bandwidth, H100 SXM

DEVICE = "cuda"
MAIN = dict(b=8, s=1024, h=16, d=64)
# Kernel vs plain version, element by element:
#   |kernel - plain| <= RTOL * |plain| + ATOL * rms_row(plain)
#                       + FLOOR * rms(plain)
# where rms_row is the rms over the element's own row of head_dim values.
# The two compute one function on the same inputs; they differ by bf16
# rounding of the output (<= 2^-8 relative) and of P / dS for the tensor
# cores, an error that scales with the row's own terms.  The row rms covers
# values near 0 by cancellation without letting the large early causal rows
# set the limit for the small late ones.  A floor of FLOOR x rms(plain)
# over the whole tensor covers rows that are exactly 0 (dQ's first causal
# row sees one key, so dS = P (dP - D) = 0); it lies below one bf16 ulp at
# the tensor's rms.
RTOL = ATOL = 2e-2
FLOOR = 1e-3
LSE_TOL = 1e-3  # lse is fp32 in both; only exp/log approximations differ
# Flash GPT vs dense GPT (two attention algorithms in bf16): the
# normwise relative error ||flash - dense|| / ||dense|| of the logits and
# of each parameter's gradient.
MODEL_TOL = 5e-2
WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS = 2, 10, 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the attention must compute for one head."""
    if not causal:
        return sq * sk
    total = 0
    for q in range(sq):
        lo = max(0, q - window + 1) if window else 0
        hi = min(q, sk - 1)
        total += max(0, hi - lo + 1)
    return total


def bound(nbytes: int, flops: int):
    t_mem = nbytes / H100_BYTES_S
    t_ops = flops / H100_BF16_FLOPS
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else "operations")


def compare(got, ref) -> dict:
    """max |got - ref| and its worst ratio to RTOL*|ref| + ATOL*rms_row(ref)
    + FLOOR*rms(ref) (ok when <= 1), with where it is and max|ref| for the
    record."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    rms_row = ref.square().mean(-1, keepdim=True).sqrt()
    rms = ref.square().mean().sqrt()
    ratio = diff / (RTOL * ref.abs() + ATOL * rms_row + FLOOR * rms)
    worst = ratio.argmax().item()
    at = list(torch.unravel_index(torch.tensor(worst), ratio.shape))
    r = ratio.flatten()[worst].item()
    return {"max_abs_err": diff.max().item(), "worst_ratio": r,
            "worst_at": [int(i) for i in at],
            "worst_ref": ref.flatten()[worst].item(),
            "worst_got": got.flatten()[worst].item(),
            "ref_absmax": ref.abs().max().item(),
            "ok": math.isfinite(r) and r <= 1.0}


def rel_err(got, ref) -> float:
    """||got - ref|| / ||ref|| over the whole tensor."""
    got, ref = got.float(), ref.float()
    return ((got - ref).norm() / ref.norm()).item()


def ptxas_report(build) -> list:
    """ptxas' register and spill lines for each source (and its C75xx notes
    of wgmma serialized or waits injected), beside the register budget
    that ``setmaxnreg`` gives each warpgroup role where the source sets one
    (ptxas reports the count at the kernel's entry only)."""
    out = []
    for log in sorted(build.build_dir().glob("*.log")):
        text = log.read_text()
        src = (build.CSRC / f"{log.stem}.cu").read_text()
        roles = {role.lower(): {"setmaxnreg": int(n)} for role, n in
                 re.findall(r"constexpr int k(Producer|Consumer)Regs = (\d+);",
                            src)}
        out.append({
            "source": f"{log.stem}.cu",
            "lines": [ln.strip() for ln in text.splitlines()
                      if "registers" in ln or "spill" in ln
                      or "setmaxnreg" in ln or "(C75" in ln],
            "roles": roles or None,
            "spill_bytes": sum(int(a) + int(b) for a, b in re.findall(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)),
            "wgmma_notes": sorted(set(re.findall(r"\(C751[78]\)", text)))})
    return out


def check_kernels(*, s: int, window: int, timed: bool) -> dict:
    """B1-B3 against their plain versions on one shape (causal)."""
    from tpujob_torch.workloads import flash

    b, h, d = MAIN["b"], MAIN["h"], MAIN["d"]
    gen = torch.Generator(device=DEVICE).manual_seed(1234 + s + window)

    def rnd():
        return torch.randn(b, s, h, d, device=DEVICE, dtype=torch.bfloat16,
                           generator=gen)

    q, k, v, do = rnd(), rnd(), rnd(), rnd()
    kw = dict(causal=True, scale=d ** -0.5, window=window)
    case = f"s{s}" + (f"_w{window}" if window else "")

    o_k, lse_k = flash.flash_fwd_cuda(q, k, v, **kw)
    o_r, lse_r = flash.flash_forward_ref(q, k, v, **kw)
    delta = flash.attention_delta(o_r, do)
    dq_k = flash.flash_dq_cuda(q, k, v, do, lse_r, delta, **kw)
    dq_r = flash.flash_dq_ref(q, k, v, do, lse_r, delta, **kw)
    dk_k, dv_k = flash.flash_dkv_cuda(q, k, v, do, lse_r, delta, **kw)
    dk_r, dv_r = flash.flash_dkv_ref(q, k, v, do, lse_r, delta, **kw)
    torch.cuda.synchronize()
    e_l = (lse_k - lse_r).abs().max().item()
    c_o, c_dq = compare(o_k, o_r), compare(dq_k, dq_r)
    c_dk, c_dv = compare(dk_k, dk_r), compare(dv_k, dv_r)
    out = {
        "flash_fwd": dict(c_o, lse_err=e_l, lse_tol=LSE_TOL,
                          ok=c_o["ok"] and e_l <= LSE_TOL),
        "flash_dq": c_dq,
        "flash_dkv": {"max_abs_err": max(c_dk["max_abs_err"],
                                         c_dv["max_abs_err"]),
                      "dk": c_dk, "dv": c_dv,
                      "ok": c_dk["ok"] and c_dv["ok"]},
    }
    ok = all(r["ok"] for r in out.values())
    if timed:
        pairs = b * h * visible_pairs(s, s, True, window)
        qkv = q.numel() * 2
        rows = b * h * s * 4  # one fp32 per row (lse or delta)
        shapes = {
            "flash_fwd": (4 * qkv + rows, 4 * d * pairs),
            "flash_dq": (5 * qkv + 2 * rows, 6 * d * pairs),
            "flash_dkv": (6 * qkv + 2 * rows, 8 * d * pairs),
        }
        ms = {
            "flash_fwd": time_ms(lambda: flash.flash_fwd_cuda(q, k, v, **kw)),
            "flash_dq": time_ms(lambda: flash.flash_dq_cuda(
                q, k, v, do, lse_r, delta, **kw)),
            "flash_dkv": time_ms(lambda: flash.flash_dkv_cuda(
                q, k, v, do, lse_r, delta, **kw)),
        }
        plain_ms = {
            "flash_fwd": time_ms(lambda: flash.flash_forward_ref(
                q, k, v, **kw), iters=5),
            "flash_dq": time_ms(lambda: flash.flash_dq_ref(
                q, k, v, do, lse_r, delta, **kw), iters=5),
            "flash_dkv": time_ms(lambda: flash.flash_dkv_ref(
                q, k, v, do, lse_r, delta, **kw), iters=5),
        }
        bwd_ms = time_ms(lambda: (
            flash.flash_dq_cuda(q, k, v, do, lse_r, delta, **kw),
            flash.flash_dkv_cuda(q, k, v, do, lse_r, delta, **kw)))
        lib = library_ms(q, k, v, do) if not window else {}
        backward = {"kernels": ["flash_dq", "flash_dkv"], "ms": bwd_ms,
                    "library_ms": lib.get("flash_dq"),
                    "library_fn": lib.get("fn_flash_dq")}
        for name, (nbytes, flops) in shapes.items():
            bms, by = bound(nbytes, flops)
            out[name].update(ms=ms[name], plain_ms=plain_ms[name],
                             bound_ms=bms, bound_by=by, bytes=nbytes,
                             flops=flops, tflops=flops / ms[name] / 1e9,
                             bound_share=bms / ms[name],
                             library_ms=lib.get(name),
                             library_fn=lib.get("fn_" + name))
    emit({"phase": "kernel", "case": case, "shape": [b, s, h, d],
          "window": window, "rtol": RTOL, "atol_of_row_rms": ATOL,
          "floor_of_rms": FLOOR, "ok": ok,
          "kernels": out, **({"backward": backward} if timed else {})})
    if not ok:
        raise AssertionError(f"kernel mismatch in case {case}: {out}")
    return out


def library_ms(q, k, v, do) -> dict:
    """One PyTorch call computing the same function, as a yardstick only:
    scaled_dot_product_attention (causal) and its autograd backward, which
    computes dQ, dK and dV in one call."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    fwd = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    bwd = time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    return {"flash_fwd": fwd, "flash_dq": bwd, "flash_dkv": bwd,
            "fn_flash_fwd": "F.scaled_dot_product_attention(is_causal=True)",
            "fn_flash_dq": "its backward (dq, dk, dv in one call)",
            "fn_flash_dkv": "its backward (dq, dk, dv in one call)"}


def check_model() -> None:
    """A 2-layer full-width GPT on the card: flash attention (kernels)
    against dense attention (torch) on the same weights."""
    from tpujob_torch.workloads import bert as bertlib
    from tpujob_torch.workloads import distributed, gpt

    argv = ["--layers", "2", "--seq-len", "256", "--batch-size", "2",
            "--device", DEVICE]
    out = {}
    for attn in ("dense", "flash"):
        args = gpt.build_parser().parse_args(argv + ["--attention", attn])
        model = gpt.build_model(args, torch.device(DEVICE))
        ids, _, _ = bertlib.token_batches(args, distributed.process_env({}))
        batch = (bertlib.batch_to_device(ids, DEVICE),)
        loss = gpt.lm_loss(model)(batch)
        loss.backward()
        with torch.no_grad():
            logits = model(batch[0])
        out[attn] = (logits.float(), loss.item(),
                     {n: p.grad.float() for n, p in model.named_parameters()})
    (ld, lossd, gd), (lf, lossf, gf) = out["dense"], out["flash"]
    e_logits = rel_err(lf, ld)
    # The key bias's exact gradient is 0 (adding q.b to every score of a
    # row leaves its softmax unchanged), so both sides hold rounding noise
    # only: hold its norm to MODEL_TOL x the query bias's instead.
    zero = [n for n in gd if n.endswith("attn.key.bias")]
    grad_errs = {n: rel_err(gf[n], gd[n]) for n in gd if n not in zero}
    worst = max(grad_errs, key=grad_errs.get)
    key_bias = max(max(gf[n].norm().item(), gd[n].norm().item())
                   / gd[n.replace(".key.", ".query.")].norm().item()
                   for n in zero)
    finite = bool(torch.isfinite(lf).all()) and math.isfinite(lossf)
    ok = (finite and e_logits <= MODEL_TOL and abs(lossf - lossd) <= 2e-2
          and grad_errs[worst] <= MODEL_TOL and key_bias <= MODEL_TOL
          and tuple(lf.shape) == (2, 256, 50257))
    emit({"phase": "model", "ok": ok, "logits_shape": list(lf.shape),
          "logits_rel_err": e_logits, "rel_tol": MODEL_TOL,
          "loss_flash": lossf, "loss_dense": lossd, "loss_tol": 2e-2,
          "grad_rel_err_worst": grad_errs[worst], "grad_worst_param": worst,
          "grad_rel_err_median": sorted(grad_errs.values())[
              len(grad_errs) // 2],
          "key_bias_grad_norm_over_query_bias": key_bias})
    if not ok:
        raise AssertionError("flash GPT disagrees with dense GPT on the card")


def kernel_class(name: str) -> str:
    """The hand-written flash kernels by name, matrix products, the rest."""
    low = name.lower()
    for kernel in ("flash_fwd", "flash_dq", "flash_dkv"):
        if kernel + "_kernel" in low:
            return kernel
    if any(m in low for m in ("gemm", "cutlass", "nvjet", "xmma", "matmul")):
        return "matmul"
    return "other"


def device_ms_by_class(prof, steps: int) -> tuple:
    """Kernel time per step from a profile, by class, and the twelve
    kernels with the most time (ms per step, launches per step)."""
    by_class, by_name = {}, {}
    for evt in prof.key_averages():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue  # kernels only: an annotation range spans kernels
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        cls = kernel_class(evt.key)
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3 / steps
        by_name[evt.key[:90]] = (us / 1e3 / steps, evt.count / steps)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return by_class, top


def run_train() -> dict:
    """The main path: GPT-2-medium through gpt.run, launches counted.

    One run of WARMUP + TIMED + PROFILED steps; a hook after each step
    waits for the card and stamps the host clock.  Steps after the warm-up
    form two windows: TIMED steps unprofiled give the end-to-end rate (all
    tokens over all the window's time), then PROFILED steps under
    torch.profiler give device time by kernel class and the device's busy
    share of those same steps."""
    from tpujob_torch.workloads import flash, gpt

    steps = WARMUP_STEPS + TIMED_STEPS + PROFILED_STEPS
    logdir = os.path.join("build", "chip_smoke", "train")
    shutil.rmtree(logdir, ignore_errors=True)
    argv = ["--attention", "flash", "--batch-size", "8", "--steps",
            str(steps), "--log-interval", "1", "--seed", "0", "--dir", logdir,
            "--device", DEVICE]
    args = gpt.build_parser().parse_args(argv)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    stamps, prof_t0 = [], []

    def on_step(i: int) -> None:
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if i == WARMUP_STEPS + TIMED_STEPS - 1:
            prof.start()
            prof_t0.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    flash.reset_launches()
    t0 = time.perf_counter()
    try:
        res = gpt.run(args, on_step=on_step)  # ends with the card synced
    finally:
        if prof_t0:
            prof.stop()
    wall = time.perf_counter() - t0
    launches = dict(flash.LAUNCHES)
    losses = res["losses"]

    tokens = args.batch_size * args.seq_len
    a0, a1 = stamps[WARMUP_STEPS - 1], stamps[WARMUP_STEPS + TIMED_STEPS - 1]
    step_ms = [(y - x) * 1e3 for x, y in zip(stamps[WARMUP_STEPS - 1:],
                                             stamps[WARMUP_STEPS:])]
    timed_ms = step_ms[:TIMED_STEPS]
    quart = statistics.quantiles(timed_ms, n=4)
    by_class, top = device_ms_by_class(prof, PROFILED_STEPS)
    busy_ms = sum(by_class.values())
    prof_step_ms = (stamps[-1] - prof_t0[0]) * 1e3 / PROFILED_STEPS
    ok = (len(losses) == steps and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0] and all(n > 0 for n in launches.values())
          and busy_ms > 0)
    n_params = sum(p.numel() for p in res["state"]["model"].parameters())
    emit({"phase": "train", "ok": ok, "argv": argv, "params": n_params,
          "losses": losses,
          "window_steps": TIMED_STEPS,
          "window_tokens_per_sec": TIMED_STEPS * tokens / (a1 - a0),
          "window_step_ms_mean": (a1 - a0) * 1e3 / TIMED_STEPS,
          "window_step_ms_median": statistics.median(timed_ms),
          "window_step_ms_q1_q3": [quart[0], quart[2]],
          "step_ms_all": step_ms,
          "trainer_tokens_per_sec_all_steps": res["tokens_per_sec"],
          "wall_s": wall,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
          "launches": launches,
          "launches_per_step": {k: n / steps for k, n in launches.items()}})
    emit({"phase": "profile", "steps": PROFILED_STEPS,
          "host_step_ms": prof_step_ms,
          "device_ms_per_step": by_class,
          "device_busy_ms_per_step": busy_ms,
          "device_busy_share": busy_ms / prof_step_ms,
          "top_kernels_ms_launches_per_step": top})
    if not ok:
        raise AssertionError(f"main path failed: losses {losses}, "
                             f"launches {launches}, busy {busy_ms} ms")
    return launches


KERNELS = {
    "flash_fwd": ("tpujob_torch/csrc/flash_fwd.cu",
                  "tpujob/workloads/flash.py:74"),
    "flash_dq": ("tpujob_torch/csrc/flash_dq.cu",
                 "tpujob/workloads/flash.py:163"),
    "flash_dkv": ("tpujob_torch/csrc/flash_dkv.cu",
                  "tpujob/workloads/flash.py:197"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 1
    try:
        from tpujob_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the tpujob_torch package is not importable: {e}",
              file=sys.stderr)
        return 1
    try:
        smi = smi_line()
        emit({"phase": "device", "nvidia_smi": smi,
              "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda})
        t0 = time.perf_counter()
        build.load_all()
        ptxas = ptxas_report(build)
        spilled = [r["source"] for r in ptxas if r["spill_bytes"]]
        serialized = [r["source"] for r in ptxas if r["wgmma_notes"]]
        emit({"phase": "build", "ok": not spilled and not serialized,
              "seconds": time.perf_counter() - t0,
              "dir": str(build.build_dir()), "ptxas": ptxas})
        if spilled:
            raise AssertionError(f"ptxas spills registers in {spilled}")
        if serialized:
            raise AssertionError("ptxas serializes wgmma (C7518) or injects "
                                 f"warpgroup waits (C7517) in {serialized}")

        main_case = check_kernels(s=MAIN["s"], window=0, timed=True)
        check_kernels(s=1000, window=0, timed=False)
        check_kernels(s=MAIN["s"], window=256, timed=False)
        check_model()
        launches = run_train()

        rows = []
        for name, (source, replaces) in KERNELS.items():
            m = main_case[name]
            rows.append({"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "launches": launches[name],
                         "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                         "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                         "bound_by": m["bound_by"], "tflops": m["tflops"],
                         "bound_share": m["bound_share"],
                         "library_ms": m["library_ms"]})
        emit({"kernels": rows})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    except Exception:  # any failed phase: report, no result line
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
