"""Readings that set a cell's limits: the program against the reference
over many seeds (the lower readings), and the control and the planted
faults against the reference on a few (the upper readings).

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] --out calib_<name>.json

One process on the card: for each seed the program's set-up and check
calls (``program.run`` with a one-call window), then the reference; on the
control seeds also the control (the reference with every matrix product in
fp8, ``references/<reference>.py``) and the reference with half of each batch
left out.  A step that leaves its state unchanged reads 1 on both
gradient and change numbers by their definition; a loss reported 5% high
reads 5% of the loss on ``loss_gap``.  Not run by the benchmark itself.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", required=True, help="JSON file of the readings")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run as runmod

    runmod._caches()
    import torch

    from portbench import check, program

    _, cell, cfg, spec, limits = runmod.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    log_dir = os.path.join(tempfile.gettempdir(), "portbench", "calibrate")
    rows = []
    out_path = args.out

    def free():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    for seed in seeds:
        t0 = time.time()
        run = program.run(cfg, spec, seed, 0.0, False, "cuda", log_dir,
                          time.time())
        prog = run.readings
        peak = run.peak_bytes
        del run
        free()
        ref = check.follow_reference(cfg, spec, seed, "cuda")
        row = {"seed": seed, "program": check.numbers(prog, ref),
               "peak_bytes": peak, "losses_program": prog.losses,
               "losses_reference": ref.losses}
        del prog
        free()
        if seed in control:
            for name, kw in (("control_fp8", {"precision": "fp8"}),
                             ("fault_half", {"fault": "half"})):
                other = check.follow_reference(cfg, spec, seed, "cuda", **kw)
                row[name] = check.numbers(other, ref)
                del other
                free()
            row["fault_loss"] = {"loss_gap": 0.05 * max(ref.losses)}
            row["fault_frozen"] = {"grad_norm_gap": 1.0, "change_norm_gap": 1.0}
        del ref
        free()
        row["seconds"] = time.time() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
        with open(out_path, "w") as f:
            json.dump({"workload": args.workload,
                       "device": torch.cuda.get_device_name(0), "rows": rows},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
