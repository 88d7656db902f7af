"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (``tpujob_torch``), on a
machine with the CUDA cards the cell asks for.  With ``--trace 0`` the
result's metrics are the cell's end-to-end metrics; with ``--trace 1`` a
shorter window of whole steps runs under ``torch.profiler`` and the
metrics are the per-layer ones, read by ``portbench/metrics/<name>.py``.
Either way, once the window has closed and the program's state is freed,
the plain reference follows the check's first updates and ``correct``
compares the two (``portbench/check.py``; limits in
``portbench/limits/<workload>.json``).  Exits non-zero, printing no
result, without the cards, or if ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``tpujob`` were loaded.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpujob")


def process_start() -> float:
    """The epoch time this process started (``/proc``), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


PROC_START = process_start()


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def load_cell(workload: str, bench_path: Path = ROOT / "BENCHMARK.json"):
    """(the workloads entry, the configuration, the traffic mix, the limits)
    of ``workload``, each from the file its name gives."""
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {bench_path}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    here = bench_path.parent
    cfg = json.loads((here / entry["file"]).read_text())
    spec = json.loads((here / "portbench" / "traffic"
                       / f"{cell['traffic']}.json").read_text())
    limits = json.loads((here / "portbench" / "limits"
                         / f"{workload}.json").read_text())
    if spec["objective"] != cfg["objective"]:
        raise SystemExit(f"traffic {cell['traffic']} is {spec['objective']}, "
                         f"configuration {cell['config']} {cfg['objective']}")
    return bench, cell, cfg, spec, limits


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(bench: dict, cell: dict, cfg: dict, spec: dict, limits: dict,
             seed: int, seconds: float, traced: bool, device: str = "cuda",
             log_dir: str = None) -> dict:
    """One run: the program's window, then the reference's check.  The
    result line as a dict, with ``check`` (each number beside its limit)
    last."""
    import numpy as np
    import torch

    from portbench import check, program

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "portbench", cell["name"])
    run = program.run(cfg, spec, seed, seconds, traced, device, log_dir,
                      PROC_START)
    gc.collect()
    on_card = device.startswith("cuda")
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    ref = check.follow_reference(cfg, spec, seed, device)
    correct, shown = check.judge(check.numbers(run.readings, ref),
                                 limits["numbers"])
    tokens = spec["batch_size"] * spec["seq_len"]
    if traced:
        metrics = {}
        for m in bench["per_layer"]:
            if "workloads" in m and cell["name"] not in m["workloads"]:
                continue
            reader = importlib.import_module(f"portbench.metrics.{m['name']}")
            value = reader.read(run.summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        p95 = float(np.percentile(run.step_ms, 95))
        e2e = {"train_tokens_per_s": run.calls * tokens / run.window_s,
               "step_ms_p95": p95,
               "peak_mem_gib": run.peak_bytes / 2 ** 30,
               "setup_s": run.setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"]
                   if "workloads" not in m or cell["name"] in m["workloads"]}
    failed = sum(1 for x in run.window_losses if not math.isfinite(x))
    out = {"correct": bool(correct), "attempted": run.calls, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": (torch.cuda.get_device_name(0) if on_card
                               else "cpu"),
                      "count": cell["chips"],
                      "memory_peak_bytes": run.peak_bytes}}
    if traced:
        from portbench import trace

        out["device"]["busy_s"] = run.summary.busy_s
        out["device"]["window_s"] = run.summary.window_s
        out["breakdown"] = trace.breakdown(run.summary)
    out["setup_phases_s"] = run.phases
    out["check"] = shown
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = p.parse_args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    bench, cell, cfg, spec, limits = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(bench, cell, cfg, spec, limits, args.seed, args.seconds,
                   bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {found}", file=sys.stderr)
        return 3
    print("set-up, seconds from process start: " + ", ".join(
        f"{k} {v:.2f}" for k, v in out["setup_phases_s"].items()),
        file=sys.stderr)
    for name, c in out["check"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
