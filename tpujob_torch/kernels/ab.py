"""Time versions of one flash kernel's source against each other on the card.

    python -m tpujob_torch.kernels.ab old=path/to/flash_fwd.cu \\
        new=tpujob_torch/csrc/flash_fwd.cu          # from the repo root

Each ``name=path`` is one version of a source with one of the C entry
points ``tpujob_flash_fwd`` (B1), ``tpujob_flash_dq`` (B2) or
``tpujob_flash_dkv`` (B3); all versions must have the same one.  Each is
compiled by ``nvcc`` with ``build.py``'s flags and ``csrc/`` on the include
path, into its own library, checked element by element against the plain
version with ``chip_smoke.py``'s tolerance at the GPT-2-medium shape (b=8,
s=1024, h=16, d=64, bf16, causal), then timed in turns: every version in
order, then in reverse, twice (four readings of 50 launches each, CUDA
events).  Prints one JSON line per version (its readings, their median,
the worst ratio to the tolerance) and the card's name and power limit.
Compare versions only within one run: two runs may land on two cards.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from tpujob_torch.kernels import build
from tpujob_torch.workloads import flash

B, S, H, D = 8, 1024, 16, 64


def _build(name: str, src: Path, out: Path) -> ctypes.CDLL:
    lib = out / f"lib{name}.so"
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
           "-o", str(lib), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(lib))


def _launcher(lib, stem: str, args: dict):
    """A no-argument launch of the version's kernel on `args`, and the
    outputs it writes."""
    fn = getattr(lib, f"tpujob_{stem}")
    fn.argtypes = build.SIGNATURES[stem][f"tpujob_{stem}"]
    q, k, v, do, lse, delta = (args[n] for n in
                               ("q", "k", "v", "do", "lse", "delta"))
    stream = torch.cuda.current_stream().cuda_stream
    tail = (B, H, D, S, S, D ** -0.5, 1, 0, stream)
    if stem == "flash_fwd":
        outs = (torch.empty_like(q), torch.empty_like(lse))
        ptrs = (q, k, v, *outs)
    elif stem == "flash_dq":
        outs = (torch.empty_like(q),)
        ptrs = (q, k, v, do, lse, delta, *outs)
    else:
        outs = (torch.empty_like(k), torch.empty_like(v))
        ptrs = (q, k, v, do, lse, delta, *outs)

    def launch():
        build.check(fn(*(x.data_ptr() for x in ptrs), *tail), stem)
    return launch, outs


def main(argv) -> int:
    import chip_smoke as cs  # the tolerance and the timer of the chip smoke

    versions = dict(a.split("=", 1) for a in argv)
    stems = {next(s for s in ("flash_fwd", "flash_dq", "flash_dkv")
                  if f"tpujob_{s}(" in Path(p).read_text())
             for p in versions.values()}
    if len(stems) != 1:
        raise SystemExit(f"versions of different kernels: {sorted(stems)}")
    stem = stems.pop()
    out = build.BUILD_ROOT / "ab"
    out.mkdir(parents=True, exist_ok=True)
    libs = {n: _build(n, Path(p), out) for n, p in versions.items()}

    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=gen,
                               dtype=torch.bfloat16) for _ in range(4))
    kw = dict(causal=True, scale=D ** -0.5)
    o, lse = flash.flash_forward_ref(q, k, v, **kw)
    delta = flash.attention_delta(o, do)
    args = dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    refs = {"flash_fwd": (o, lse),
            "flash_dq": (flash.flash_dq_ref(q, k, v, do, lse, delta, **kw),),
            "flash_dkv": flash.flash_dkv_ref(q, k, v, do, lse, delta, **kw)}
    runs = {n: _launcher(lib, stem, args) for n, lib in libs.items()}
    worst = {}
    for n, (launch, outs) in runs.items():
        launch()
        torch.cuda.synchronize()
        worst[n] = max(cs.compare(got, ref)["worst_ratio"] if got.dtype ==
                       torch.bfloat16 else (got - ref).abs().max().item()
                       / cs.LSE_TOL for got, ref in zip(outs, refs[stem]))
    ms = {n: [] for n in runs}
    order = list(runs) + list(runs)[::-1]
    for n in order + order:
        ms[n].append(cs.time_ms(runs[n][0], iters=50, warmup=5))
    for n in runs:
        cs.emit({"version": n, "source": versions[n], "kernel": stem,
                 "ms": ms[n], "median_ms": statistics.median(ms[n]),
                 "worst_ratio_to_tolerance": worst[n]})
    print(cs.smi_line(), flush=True)
    return 0 if all(r <= 1 for r in worst.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
