"""Flagship model benchmarks of the port: ResNet-50, BERT-large and
GPT-2-medium training throughput and MFU on one card.

The port's counterpart of the JAX package's root ``bench_models.py``
(its rows ``resnet50``, ``bert-large`` and ``gpt``, at their shapes): each
row builds its state with ``train_lib.init_state``, runs
``STEPS_PER_DISPATCH`` optimizer updates a call through
``train_lib.make_multi_step`` (one CUDA graph of the four on the card)
and times the calls with ``benchlib.measure_windows``.

    python -m tpujob_torch.bench_models --models resnet50,bert-large,gpt
    python -m tpujob_torch.bench_models --quick          # smaller shapes
    python -m tpujob_torch.bench_models --models scaling --device cpu

Prints one JSON line per row:
    {"metric": "...", "value": N, "unit": "...", ...}

FLOPs are analytic, as the JAX rows' fallbacks: 3 x 4.09 GFLOP a 224px
image for ResNet-50, 8 x params x tokens for the transformers (remat runs
the forward twice).  ``mfu_vs_spec`` is their rate over the card's dense
bf16 peak, reported only where it is at most 1.  The ``--quick`` GPT row
has head dim 32 (the kernels' second instantiation).

The DP-scaling row (``scaling``, the JAX package's ``_scaling_child`` /
``bench_scaling``): one BERT step (vocab 1024, hidden 256, 4 layers, 8
heads, fp32) on a global batch of 32, timed in one process and in 8 gloo
ranks of 4 rows each (``distributed.spawn_local``), both eager, so that
``t8/t1`` measures the batch split and the gradient all-reduce and not a
CUDA graph against eager; the captured one-process step is recorded
beside them.  The reference's 8 devices are virtual CPU devices sharing
one CPU's cores; the port's 8 ranks share the device named by
``--device``: on the card, all 8 on the one card over gloo, a record of
that layout, not a speed of data parallelism across cards.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Tuple

# Peak dense bf16 FLOP/s of one card, by name (NVIDIA's data sheets):
# the H100 SXM (HBM3) and the H100 PCIe.  Any other card: no peak.
PEAK_BF16 = [
    (("h100", "pcie"), 756e12),
    (("h100", "hbm3"), 989.4e12),
    (("h100", "sxm"), 989.4e12),
]

# optimizer steps a call: the JAX rows' value
STEPS_PER_DISPATCH = 4


def peak_flops(name: str) -> Optional[float]:
    low = name.lower()
    for keys, val in PEAK_BF16:
        if all(key in low for key in keys):
            return val
    return None


def perf_fields(flops: Optional[float], sec_per_step: float, n_chips: int,
                name: str) -> dict:
    """FLOP-derived fields: ``flops_per_step`` and
    ``achieved_tflops_per_chip`` always; the ratio to the card's peak as
    ``mfu_vs_spec`` only where it is at most 1, else as
    ``spec_peak_exceeded_x`` (a misidentified card, not a utilization)."""
    out = {}
    if not flops:
        return out
    out["flops_per_step"] = round(flops)
    ach = flops / sec_per_step / n_chips
    out["achieved_tflops_per_chip"] = round(ach / 1e12, 1)
    peak = peak_flops(name)
    if peak:
        ratio = ach / peak
        if ratio <= 1.0:
            out["mfu_vs_spec"] = round(ratio, 3)
        else:
            out["spec_peak_exceeded_x"] = round(ratio, 1)
    return out


def time_steps(step, state, batch, seconds: float, min_steps: int = 5,
               steps_per_call: int = 1):
    """Steady-state seconds a step: two untimed calls (the eager one that
    makes the optimizer's state, then the capture), then windows of about
    1 s (two shorter ones under 2 s) with the stddev across them.
    Returns (mean_sec_per_step, total_steps, std_sec_per_step, step mode)."""
    from tpujob_torch.workloads.benchlib import drain, measure_windows

    for _ in range(2):
        state, losses = step(state, batch)
    drain(losses)

    def run_one():
        nonlocal state
        state, out = step(state, batch)
        return out

    n_windows = max(2, int(seconds))
    stats = measure_windows(
        run_one,
        window_s=seconds / n_windows,
        min_windows=n_windows,
        min_total_s=seconds,
        min_steps_per_window=max(1, -(-min_steps // n_windows)),
        steps_per_call=steps_per_call,
    )
    return stats.mean_s, stats.steps, stats.std_s, step.mode


def bench_resnet50(quick: bool, device: str = "cuda",
                   overrides: tuple = ()) -> dict:
    """ResNet-50 at batch 256 (64 with ``--quick``), bf16, SGD, one
    synthetic batch.  ``overrides``: flags appended to the row's argv
    (a smaller model for a smoke)."""
    import torch

    from tpujob_torch.workloads import data as datalib
    from tpujob_torch.workloads import distributed as dist
    from tpujob_torch.workloads import resnet, train_lib
    from tpujob_torch.workloads.benchlib import platform_name

    dev = dist.local_device(device)
    n_chips = 1
    batch = 64 if quick else 256
    args = resnet.build_parser().parse_args(
        ["--batch-size", str(batch)] + list(overrides))
    batch = args.batch_size
    model = resnet.make_model(args).to(dev)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    model.train()
    optimizer = train_lib.sgd(model.parameters(), args.lr, args.momentum)
    state = train_lib.init_state(model, optimizer)
    step = train_lib.make_multi_step(resnet.build_loss(model), optimizer,
                                     STEPS_PER_DISPATCH)
    x, y = datalib.synthetic_imagenet_batch(batch, args.image_size)
    b = train_lib.put_batch((x, y), dev)
    sec_per_step, steps, std, mode = time_steps(
        step, state, b, 1.0 if quick else 4.0,
        steps_per_call=STEPS_PER_DISPATCH)
    sps = batch / sec_per_step
    # forward ~4.09 GFLOP a 224px image (a MAC is 2), training ~3x that
    flops = 3 * 4.09e9 * batch * (args.image_size / 224) ** 2
    out = {
        "metric": "resnet50_train_samples_per_sec_per_chip",
        "value": round(sps / n_chips, 1),
        "unit": "samples/s/chip",
        "global_batch": batch,
        "chips": n_chips,
        "steps": steps,
        "step_ms": round(sec_per_step * 1e3, 2),
        "step_ms_std": round(std * 1e3, 3),
        "platform": platform_name(dev),
        "step_mode": mode,
    }
    out.update(perf_fields(flops, sec_per_step, n_chips, out["platform"]))
    return out


def _bench_transformer(args, dev, model, loss_fn, batch, seconds, *, metric,
                       extra_fields=None) -> dict:
    """The transformer rows' shared body: AdamW at the flags' lr, k steps
    a call, windowed timing, tokens/s and MFU."""
    from tpujob_torch.kernels import build
    from tpujob_torch.workloads import flash, optim, train_lib
    from tpujob_torch.workloads.benchlib import platform_name

    n_chips = 1
    n_tokens = args.batch_size * args.seq_len
    optimizer = train_lib.adamw(model.parameters(), args.lr)
    state = train_lib.init_state(model, optimizer)
    step = train_lib.make_multi_step(loss_fn, optimizer, STEPS_PER_DISPATCH)
    n_params = sum(p.numel() for p in model.parameters())
    build.reset_launches()
    optim.UPDATES.update(kernel=0, torch=0)
    sec_per_step, steps, std, mode = time_steps(
        step, state, batch, seconds, steps_per_call=STEPS_PER_DISPATCH)
    # each flash kernel's launches: every step the row ran, untimed ones too
    launches = {k: build.LAUNCHES[k] for k in flash.KERNELS}
    updates = dict(optim.UPDATES)  # parameter tensors each AdamW route updated
    sps = args.batch_size / sec_per_step
    tps = sps * args.seq_len
    # 6 x params x tokens (forward and backward of a dense transformer);
    # remat runs the forward again: 8 x params x tokens executed
    flops = 8 * n_params * n_tokens
    out = {
        "metric": metric,
        "value": round(tps / n_chips, 0),
        "unit": "tokens/s/chip",
        "samples_per_sec_per_chip": round(sps / n_chips, 2),
        "global_batch": args.batch_size,
        "seq_len": args.seq_len,
        "params_m": round(n_params / 1e6, 1),
        **(extra_fields or {}),
        "chips": n_chips,
        "steps": steps,
        "step_ms": round(sec_per_step * 1e3, 2),
        "step_ms_std": round(std * 1e3, 3),
        "platform": platform_name(dev),
        "step_mode": mode,
        "kernel_launches": launches,
        "adamw_updates": updates,
    }
    out.update(perf_fields(flops, sec_per_step, n_chips, out["platform"]))
    return out


def bench_bert_large(quick: bool, device: str = "cuda",
                     overrides: tuple = ()) -> dict:
    """BERT-large masked LM at batch 16, seq 512 (8 x 128 with
    ``--quick``), dense attention as in the JAX row."""
    from tpujob_torch.workloads import bert as bertlib
    from tpujob_torch.workloads import data as datalib
    from tpujob_torch.workloads import distributed as dist
    from tpujob_torch.workloads import train_lib

    dev = dist.local_device(device)
    batch, seq = (8, 128) if quick else (16, 512)
    args = bertlib.build_parser().parse_args(
        ["--batch-size", str(batch), "--seq-len", str(seq)]
        + list(overrides))
    model = bertlib.build_model(args, dev)
    ids = datalib.synthetic_token_batch(args.batch_size, args.seq_len,
                                        args.vocab)
    ids, mask = bertlib.mask_batch(ids, 0)
    return _bench_transformer(
        args, dev, model, bertlib.mlm_loss(model),
        train_lib.put_batch((ids, mask), dev), 1.0 if quick else 4.0,
        metric="bert_large_train_tokens_per_sec_per_chip")


def bench_gpt_medium(quick: bool, device: str = "cuda",
                     overrides: tuple = ()) -> dict:
    """GPT-2-medium causal LM at batch 8, seq 1024, through the flash
    kernels.  ``--quick`` shrinks it to a small decoder (hidden 256, 8
    heads: head dim 32) and keeps ``--attention flash``: the kernels'
    head-dim-32 instantiation."""
    from tpujob_torch.workloads import bert as bertlib
    from tpujob_torch.workloads import data as datalib
    from tpujob_torch.workloads import distributed as dist
    from tpujob_torch.workloads import gpt as gptlib

    dev = dist.local_device(device)
    batch, seq = (4, 128) if quick else (8, 1024)
    argv = ["--batch-size", str(batch), "--seq-len", str(seq),
            "--attention", "flash"]
    if quick:
        argv += ["--hidden", "256", "--layers", "4", "--heads", "8",
                 "--intermediate", "1024", "--vocab", "2048"]
    args = gptlib.build_parser().parse_args(argv + list(overrides))
    model = gptlib.build_model(args, dev)
    ids = datalib.synthetic_token_batch(args.batch_size, args.seq_len,
                                        args.vocab)
    return _bench_transformer(
        args, dev, model, gptlib.lm_loss(model),
        (bertlib.batch_to_device(ids, dev),), 1.0 if quick else 4.0,
        metric="gpt_medium_train_tokens_per_sec_per_chip",
        extra_fields={"attention": args.attention})


# ---------------------------------------------------------------------------
# DP scaling: the same global batch in one process and in 8 gloo ranks
# ---------------------------------------------------------------------------

SCALING_RANKS = 8
SCALING_BATCH = 32
SCALING_ARGV = ["--vocab", "1024", "--hidden", "256", "--layers", "4",
                "--heads", "8", "--intermediate", "1024", "--no-bf16",
                "--batch-size", str(SCALING_BATCH)]
SCALING_TIMEOUT_S = 900.0


def _scaling_step(quick: bool, device: str, pe, capture: bool):
    """The scaling row's BERT MLM step on this process's rows of the
    global batch (all of it at world 1; DDP over the world otherwise):
    (step, state, batch)."""
    from tpujob_torch.workloads import bert as bertlib
    from tpujob_torch.workloads import data as datalib
    from tpujob_torch.workloads import distributed as dist
    from tpujob_torch.workloads import train_lib

    dev = dist.local_device(device)
    seq = 64 if quick else 128
    args = bertlib.build_parser().parse_args(
        SCALING_ARGV + ["--seq-len", str(seq)])
    mesh = dist.make_mesh({"data": -1}, env=pe)
    model = bertlib.build_model(args, dev, mesh=mesh)
    ids = datalib.synthetic_token_batch(SCALING_BATCH, seq, args.vocab)
    ids, mask = bertlib.mask_batch(ids, 0)
    lo, sz = dist.local_batch_slice(SCALING_BATCH, pe, mesh)
    batch = train_lib.put_batch((ids[lo : lo + sz], mask[lo : lo + sz]),
                                dev)
    optimizer = train_lib.adamw(model.parameters(), args.lr)
    state = train_lib.init_state(model, optimizer)
    step = train_lib.make_train_step(
        bertlib.mlm_loss(train_lib.data_parallel(model, mesh), mesh=mesh),
        optimizer, lambda count: args.lr, capture=capture, mesh=mesh)
    return step, state, batch


def _time_ranks(step, state, batch, seconds: float) -> float:
    """``time_steps`` for the ranks of a group: every rank must run the
    same steps (a wall-clock-bounded loop queues unequal collective counts
    per rank, and the group hangs), so each window runs a fixed count of
    steps, rank 0's estimate of a window's worth from a 3-step probe,
    broadcast to all.  Returns the mean s a step."""
    import math

    import torch
    import torch.distributed as tdist

    from tpujob_torch.workloads.benchlib import drain, measure_windows

    for _ in range(2):
        state, out = step(state, batch)
    drain(out)
    t0 = time.perf_counter()
    for _ in range(3):
        state, out = step(state, batch)
    drain(out)
    per_step = (time.perf_counter() - t0) / 3
    n_windows = max(2, int(seconds))
    count = torch.tensor([max(-(-5 // n_windows),
                              math.ceil(seconds / n_windows / per_step))])
    tdist.broadcast(count, src=0)

    def run_one():
        nonlocal state
        state, out = step(state, batch)
        return out

    return measure_windows(run_one, min_windows=n_windows,
                           fixed_steps=int(count)).mean_s


def _time_scaling_step(quick: bool, device: str, pe, capture: bool
                       ) -> Tuple[float, float, str]:
    """(first step's loss, mean s a step, step mode): the first
    step from the seed's weights, then the reference's windows (1 s under
    ``--quick``, else 3 s); in a group, windows of a count of steps all
    ranks share (``_time_ranks``)."""
    step, state, batch = _scaling_step(quick, device, pe, capture)
    state, loss = step(state, batch)
    first = float(loss)
    seconds = 1.0 if quick else 3.0
    if pe.num_processes > 1:
        return first, _time_ranks(step, state, batch, seconds), step.mode
    sec, _, _, mode = time_steps(step, state, batch, seconds)
    return first, sec, mode


def _scaling_rank(rank: int, quick: bool, device: str) -> dict:
    """One of the 8 spawned ranks: the group over gloo (on the card too:
    NCCL refuses two ranks on one card), then its timed step."""
    import torch.distributed as tdist

    from tpujob_torch.workloads import distributed as dist

    pe = dist.initialize(device=dist.local_device(device), backend="gloo")
    first, sec, _ = _time_scaling_step(quick, device, pe, False)
    tdist.barrier()
    dist.shutdown()
    return {"loss": first, "sec": sec}


def bench_scaling(quick: bool, device: str = "cuda") -> dict:
    """DP sharding overhead: t8 / t1 of one step of the same global batch,
    eager in both, on ``device`` (8 gloo ranks sharing it)."""
    from tpujob_torch.workloads import distributed as dist
    from tpujob_torch.workloads.benchlib import platform_name

    dev = dist.local_device(device)
    one = dist.process_env({})
    loss1, t1, mode1 = _time_scaling_step(quick, device, one, False)
    ranks = dist.spawn_local(_scaling_rank, SCALING_RANKS, quick, device,
                             timeout_s=SCALING_TIMEOUT_S)
    t8 = ranks[0]["sec"]
    out = {
        "metric": "dp_sharding_overhead_8dev_vs_1dev",
        "value": round(t8 / t1, 3),
        "unit": "t8/t1 (1.0 = free sharding)",
        "step_ms_1dev": round(t1 * 1e3, 2),
        "step_ms_8dev": round(t8 * 1e3, 2),
        "global_batch": SCALING_BATCH,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device_name": platform_name(dev),
        "backend": "gloo",
        "step_mode": mode1,
        "step_ms_8dev_by_rank": [round(r["sec"] * 1e3, 2) for r in ranks],
        "loss_1dev": loss1,
        "loss_8dev": ranks[0]["loss"],
    }
    if dev.type == "cuda":
        _, tg, mode_g = _time_scaling_step(quick, device, one, True)
        out.update(ranks_per_card=SCALING_RANKS,
                   step_ms_1dev_captured=round(tg * 1e3, 2),
                   step_mode_captured=mode_g)
    return out


BENCHES = {
    "resnet50": bench_resnet50,
    "bert-large": bench_bert_large,
    "gpt": bench_gpt_medium,
    "scaling": bench_scaling,
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="flagship model benchmarks "
                                            "of the port")
    p.add_argument("--models", default="resnet50,bert-large,gpt,scaling",
                   help=f"comma list from {sorted(BENCHES)}")
    p.add_argument("--quick", action="store_true",
                   help="small shapes and short timing (a smoke)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    names = [name.strip() for name in args.models.split(",")]
    for name in names:
        if name not in BENCHES:
            print(f"unknown benchmark {name!r} (the port has "
                  f"{sorted(BENCHES)})", file=sys.stderr)
            return 2
    for name in names:
        print(json.dumps(BENCHES[name](args.quick, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
