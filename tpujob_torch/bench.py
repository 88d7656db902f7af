"""Headline benchmark of the port: MNIST training throughput per card.

The port's counterpart of the JAX package's root ``bench.py``, with its
accuracy gate, batch, steps per call and one-line contract.  The
reference's only quantitative claim is the MNIST example at ~10 epochs of
60k samples in 5-10 minutes on a CPU cluster (~1,333 samples/s at the
450 s midpoint); ``vs_baseline`` is measured samples/s per card over that.

    python -m tpujob_torch.bench                 # on the card
    python -m tpujob_torch.bench --device cpu    # a small smoke on the CPU

Prints exactly ONE JSON line on stdout:
    {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ..., ...}

Steps: k = 10 optimizer updates per call through
``train_lib.make_multi_step`` (one CUDA graph of the ten on the card), at
batch 1,024 per card, timed by ``benchlib.measure_windows``.  Under
``--device cpu`` the batch is 32, k = 2 and the windows two short ones:
the CPU run proves the contract, not a rate.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import tempfile

# ~1,333 samples/s: 10 epochs x 60k samples / 450 s (the reference's
# README midpoint)
BASELINE_SAMPLES_PER_SEC = 10 * 60000 / 450.0


def gate_argv(data_dir: str) -> list:
    """The accuracy gate's dataset, as the JAX bench prefers it: MNIST IDX
    files when present, else the UCI digits when scikit-learn imports,
    else the synthetic set (8,192 / 2,048)."""
    from tpujob_torch.workloads import data as datalib

    if datalib.resolve_dataset(data_dir, "auto") == "idx":
        return ["--data-dir", data_dir, "--dataset", "idx", "--epochs", "1"]
    try:
        import sklearn  # noqa: F401 - digits needs scikit-learn

        # digits is tiny (~1.7k samples): 10 epochs, the reference's run
        return ["--dataset", "digits", "--epochs", "10"]
    except ImportError:
        return ["--dataset", "synthetic", "--train-size", "8192",
                "--test-size", "2048", "--epochs", "1"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="MNIST throughput of the port")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    import torch

    from tpujob_torch.workloads import data as datalib
    from tpujob_torch.workloads import distributed as dist
    from tpujob_torch.workloads import mnist, train_lib
    from tpujob_torch.workloads.benchlib import (measure_windows,
                                                 platform_name)

    device = dist.local_device(args.device)
    pe = dist.initialize(device=device)
    n_chips = pe.num_processes  # one card a process

    # -- accuracy gate: the trained example must learn ----------------------
    data_dir = os.environ.get("TPUJOB_MNIST_DIR") or "data"
    logdir = tempfile.mkdtemp(prefix="tpujob_torch_bench_")
    try:
        acc_args = mnist.build_parser().parse_args(
            gate_argv(data_dir) + ["--dir", logdir, "--device", args.device])
        with contextlib.redirect_stdout(io.StringIO()):  # stdout: 1 line
            gate = mnist.run(acc_args)
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    acc = gate["accuracy"]
    if acc <= 0.8:
        print(f"FAIL: accuracy {acc:.4f} <= 0.8 on {gate['dataset']} "
              "— training is broken", file=sys.stderr)
        return 1

    # -- throughput: big-batch steady-state train steps ---------------------
    on_cpu = device.type == "cpu"
    batch = (32 if on_cpu else 1024) * n_chips
    k = 2 if on_cpu else 10
    model = mnist.Net(seed=0).to(device)
    if not on_cpu:
        model = model.to(memory_format=torch.channels_last)
    optimizer = train_lib.sgd(model.parameters(), 0.01, 0.5)
    net = train_lib.data_parallel(model)
    state = train_lib.init_state(model, optimizer)
    step = train_lib.make_multi_step(lambda b: mnist.nll_loss(net, b),
                                     optimizer, k)
    # every process feeds its own rows: `batch` is the GLOBAL batch below
    lo, sz = dist.local_batch_slice(batch, pe)
    x, y = datalib.synthetic_split(batch, seed=0)
    b = train_lib.put_batch(((x[lo : lo + sz] - datalib.MEAN) / datalib.STD,
                             y[lo : lo + sz]), device)

    # the first call runs its k steps eagerly (the optimizer's state), the
    # second captures them (on the card): neither is timed
    for _ in range(2):
        state, losses = step(state, b)
    train_lib.sync(device)

    def run_one():
        nonlocal state
        state, out = step(state, b)
        return out

    if pe.num_processes > 1:
        # several processes: fixed call counts keep their collectives paired
        stats = measure_windows(
            run_one, window_s=1.0, min_windows=5, min_total_s=5.0,
            fixed_steps=10 if on_cpu else 50, steps_per_call=k)
    elif on_cpu:
        # a smoke: two minimal windows prove the contract, not the rate
        stats = measure_windows(
            run_one, window_s=0.5, min_windows=2, min_total_s=1.0,
            min_steps_per_window=2, steps_per_call=k)
    else:
        stats = measure_windows(run_one, window_s=1.0, min_windows=5,
                                min_total_s=5.0, steps_per_call=k)
    steps, wall = stats.steps, stats.wall_s
    mean_ms, std_ms = stats.mean_s * 1e3, stats.std_s * 1e3
    sps_per_chip = steps * batch / wall / n_chips
    print(json.dumps({
        "metric": "mnist_train_samples_per_sec_per_chip",
        "value": round(sps_per_chip, 1),
        "unit": "samples/s/chip",
        "vs_baseline": round(sps_per_chip / BASELINE_SAMPLES_PER_SEC, 2),
        "accuracy": round(float(acc), 4),
        "gate_dataset": gate["dataset"],
        "chips": n_chips,
        "platform": platform_name(device),
        "steps": steps,
        "wall_s": round(wall, 3),
        "step_ms_mean": round(mean_ms, 4),
        "step_ms_std": round(std_ms, 4),
        "step_ms_cv_pct": round(100.0 * std_ms / mean_ms, 1),
        "step_mode": step.mode,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
