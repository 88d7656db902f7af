"""Time versions of one flash kernel's source against each other on the card.

    python -m tpujob_torch.kernels.ab old=path/to/flash_fwd.cu \\
        new=tpujob_torch/csrc/flash_fwd.cu          # from the repo root
    python -m tpujob_torch.kernels.ab --case float32:8,1024,16,64 \\
        --case bfloat16:8,1024,8,128 old=path/to/flash_dq_any.cu \\
        new=tpujob_torch/csrc/flash_dq_any.cu

Each ``name=path`` is one version of a source with one of the C entry
points ``tpujob_flash_fwd`` (B1), ``tpujob_flash_dq`` (B2),
``tpujob_flash_dkv`` (B3) or the general kernels' ``tpujob_flash_fwd_any``,
``tpujob_flash_dq_any``, ``tpujob_flash_dkv_any`` (B1a-B3a); all versions
must have the same one.  A general source's case that ``flash.route``
sends to the bf16 head-dim-128 kernels launches the source's
``tpujob_flash_*_bf16_128`` entry point instead (``entry``).  Each is
compiled by ``nvcc`` with ``build.py``'s
flags and ``csrc/`` on the include path, into its own library.  Then, for
each ``--case dtype:b,s,h,d`` (default: the GPT-2-medium shape in bf16,
8,1024,16,64; causal unless ``--noncausal``), every version is checked
element by element against the plain version with ``chip_smoke.py``'s
tolerance (``ANY_TOL`` for the general kernels) and timed in turns: every
version in order, then in reverse, twice (four readings of 50 launches
each, CUDA events).  ``--window w`` (repeatable) runs each case causal
under a sliding window of w keys as well (0: none).  The plain versions
run a few heads at a time where a case's scores would not fit the card
(``chip_smoke.head_chunk_for``).  Prints one JSON line per case and
version (its readings, their median, the worst ratio to the tolerance)
and the card's name and power limit.  ``--sdpa`` adds, for each case, one line with
PyTorch's ``scaled_dot_product_attention`` forward and backward times on
the same inputs and the backend that served them (a yardstick only: no
kernel of the port calls it).  Compare versions only within one run: two
runs may land on two cards.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from tpujob_torch.kernels import build
from tpujob_torch.workloads import flash

STEMS = ("flash_fwd", "flash_dq", "flash_dkv", "flash_fwd_any",
         "flash_dq_any", "flash_dkv_any")
GPT_CASE = "bfloat16:8,1024,16,64"


def _build(name: str, src: Path, out: Path) -> ctypes.CDLL:
    lib = out / f"lib{name}.so"
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
           "-o", str(lib), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(lib))


def parse_case(text: str) -> tuple:
    """'dtype:b,s,h,d' -> (torch dtype, (b, s, h, d))."""
    dtype, dims = text.split(":")
    b, s, h, d = (int(x) for x in dims.split(","))
    return getattr(torch, dtype), (b, s, h, d)


def entry(stem: str, dtype, d: int) -> str:
    """The kernel of ``stem``'s source that takes a case, by its entry
    point's name after ``tpujob_``: a general source's bf16_128 route has
    one of its own."""
    if stem.endswith("_any") and flash.route(dtype, d) == "bf16_128":
        return stem.replace("_any", "_bf16_128")
    return stem


def _launcher(lib, stem: str, args: dict, shape: tuple, causal: bool,
              window: int):
    """A no-argument launch of the version's kernel on `args`, and the
    outputs it writes."""
    q, k, v, do, lse, delta = (args[n] for n in
                               ("q", "k", "v", "do", "lse", "delta"))
    b, s, h, d = shape
    name = entry(stem, q.dtype, d)
    fn = getattr(lib, f"tpujob_{name}")
    fn.argtypes = build.SIGNATURES[stem][f"tpujob_{name}"]
    stream = torch.cuda.current_stream().cuda_stream
    dtype_arg = ((int(q.dtype == torch.bfloat16),) if name.endswith("_any")
                 else ())
    tail = (b, h, d, s, s, d ** -0.5, int(causal), window, *dtype_arg,
            stream)
    if stem.startswith("flash_fwd"):
        outs = (torch.empty_like(q), torch.empty_like(lse))
        ptrs = (q, k, v, *outs)
    elif stem.startswith("flash_dq"):
        outs = (torch.empty_like(q),)
        ptrs = (q, k, v, do, lse, delta, *outs)
    else:
        outs = (torch.empty_like(k), torch.empty_like(v))
        ptrs = (q, k, v, do, lse, delta, *outs)

    def launch():
        build.check(fn(*(x.data_ptr() for x in ptrs), *tail), name)
    return launch, outs


def run_case(cs, stem: str, libs: dict, versions: dict, dtype, shape: tuple,
             causal: bool, window: int = 0) -> bool:
    """Check and time every version on one case; True if all agree."""
    b, s, h, d = shape
    general = stem.endswith("_any")
    tol = cs.ANY_TOL[dtype] if general else (cs.RTOL, cs.ATOL, cs.FLOOR)
    lse_tol = cs.ANY_LSE_TOL if general else cs.LSE_TOL
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen,
                               dtype=dtype) for _ in range(4))
    kw = dict(causal=causal, scale=d ** -0.5, window=window)
    chunk = cs.head_chunk_for(b, s, h)
    o, lse = cs.by_heads(flash.flash_forward_ref, (q, k, v), kw, chunk)
    delta = flash.attention_delta(o, do)
    args = dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta)
    base = stem.replace("_any", "")
    xs = (q, k, v, do, lse, delta)
    ref_of = {"flash_fwd": lambda: (o, lse),
              "flash_dq": lambda: (cs.by_heads(flash.flash_dq_ref, xs, kw,
                                               chunk),),
              "flash_dkv": lambda: cs.by_heads(flash.flash_dkv_ref, xs, kw,
                                               chunk)}
    refs = {base: ref_of[base]()}
    runs = {n: _launcher(lib, stem, args, shape, causal, window)
            for n, lib in libs.items()}
    worst = {}
    for n, (launch, outs) in runs.items():
        launch()
        torch.cuda.synchronize()
        worst[n] = max(cs.compare(got, ref, tol)["worst_ratio"]
                       if got.dtype == dtype else
                       (got - ref).abs().max().item() / lse_tol
                       for got, ref in zip(outs, refs[base]))
    ms = {n: [] for n in runs}
    order = list(runs) + list(runs)[::-1]
    for n in order + order:
        ms[n].append(cs.time_ms(runs[n][0], iters=50, warmup=5))
    for n in runs:
        cs.emit({"version": n, "source": versions[n],
                 "kernel": entry(stem, dtype, d),
                 "dtype": str(dtype).replace("torch.", ""),
                 "shape": list(shape), "causal": causal, "window": window,
                 "ms": ms[n],
                 "median_ms": statistics.median(ms[n]),
                 "worst_ratio_to_tolerance": worst[n]})
    return all(r <= 1 for r in worst.values())


def sdpa_backend(q, causal: bool) -> str:
    """The backend PyTorch's dispatch picks for SDPA on [b, h, s, d]
    inputs like ``q``'s."""
    from torch.nn.attention import SDPBackend

    code = torch._fused_sdp_choice(q, q, q, is_causal=causal)
    return next((n for n in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                             "CUDNN_ATTENTION", "MATH")
                 if int(getattr(SDPBackend, n)) == code), str(code))


def run_sdpa(cs, dtype, shape: tuple, causal: bool, window: int = 0) -> None:
    """SDPA's forward and backward (dQ, dK, dV in one call) on one case,
    with the same seed as ``run_case`` (a window as a boolean mask, as
    ``chip_smoke.library_ms`` gives it)."""
    b, s, h, d = shape
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen,
                               dtype=dtype) for _ in range(4))
    lib = cs.library_ms(q, k, v, do, causal, window)
    cs.emit({"version": "sdpa", "dtype": str(dtype).replace("torch.", ""),
             "shape": list(shape), "causal": causal, "window": window,
             "fn": lib["fn_flash_fwd"],
             "backend": (sdpa_backend(q.transpose(1, 2), causal)
                         if not window else None),
             "forward_ms": lib["flash_fwd"], "backward_ms": lib["flash_dq"]})


def main(argv) -> int:
    import chip_smoke as cs  # the tolerances and the timer of the chip smoke

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--case", action="append", type=parse_case,
                   help="dtype:b,s,h,d (repeatable; default "
                        f"{GPT_CASE})")
    p.add_argument("--noncausal", action="store_true")
    p.add_argument("--window", action="append", type=int,
                   help="causal sliding window in keys, per case "
                        "(repeatable; default 0: none)")
    p.add_argument("--sdpa", action="store_true",
                   help="also time SDPA's forward and backward per case")
    p.add_argument("versions", nargs="+", help="name=path of each version")
    args = p.parse_args(argv)
    versions = dict(a.split("=", 1) for a in args.versions)
    stems = {next(s for s in STEMS[::-1]
                  if f"tpujob_{s}(" in Path(path).read_text())
             for path in versions.values()}
    if len(stems) != 1:
        raise SystemExit(f"versions of different kernels: {sorted(stems)}")
    stem = stems.pop()
    out = build.BUILD_ROOT / "ab"
    out.mkdir(parents=True, exist_ok=True)
    libs = {n: _build(f"{stem}_{n}", Path(path), out)
            for n, path in versions.items()}
    ok = all([run_case(cs, stem, libs, versions, dtype, shape,
                       not args.noncausal or bool(w), w)
              for dtype, shape in args.case or [parse_case(GPT_CASE)]
              for w in args.window or [0]])
    if args.sdpa:
        for dtype, shape in args.case or [parse_case(GPT_CASE)]:
            for w in args.window or [0]:
                run_sdpa(cs, dtype, shape, not args.noncausal or bool(w), w)
    print(cs.smi_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
