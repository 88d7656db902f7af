"""Compile ``tpujob_torch/csrc/*.cu`` with ``nvcc`` and bind them with ctypes.

Each source is one shared library with a plain C interface (no PyTorch
headers, so a build takes seconds, not minutes).  Libraries land in
``<repo>/build/tpujob_torch_kernels/<hash>/``, where the hash covers every
source and header and the compiler flags, so an edited kernel is rebuilt
and an unchanged one is reused.  Nine sources, one library each:

- ``flash_fwd``, ``flash_dq``, ``flash_dkv``: the tuned wgmma/TMA kernels
  (B1-B3), templates on the head dim instantiated for 32 and 64 in bf16
  (the C entry point's ``switch`` on ``D``);
- ``flash_fwd_any``, ``flash_dq_any``, ``flash_dkv_any``: the general
  kernels (B1-B3 in fp32 or bf16 at head dim 1-256; wgmma with split
  precision; fp32 at padded head dim 256 on a kernel of its own in each),
  templates on the dtype and on the padded head dim 32/64/128/256, the
  entry point taking ``D`` and ``is_bf16``;
- ``mark``: the train step's phase marks (``train_lib.PhaseMarks``), one
  one-thread kernel a boundary, built with the rest by ``load_all`` or
  alone at the first mark of a run without the flash kernels;
- ``adamw``: AdamW's whole update in one pass over each tensor
  (``workloads/optim.py``), built the same way;
- ``moe_gemm``: the dropless expert layer's grouped products (wgmma fed
  by TMA; ``workloads/moe_gemm.py``), the row kernels' entry point taking
  ``transposed`` for dX.

Each ``_any`` source also exports the bf16 head-dim-128 kernels' own
entry point (``tpujob_flash_*_bf16_128``); ``workloads/flash.py``'s
``route`` chooses among the three sets by dtype and head dim before the
launch.  The hash of the sources covers the instantiations too.  All
sources compile at once, one ``nvcc`` process each.

Every wrapper launches through ``launch``, which counts each launch in
``LAUNCHES`` under the wrapper's name for its kernel; a captured step's
replays add what its capture recorded (``train_lib._Graphs``).

    from tpujob_torch.kernels import build
    build.launch("mark_begin", "tpujob_mark", 0, word, stream)
    build.load_all()                   # every library, built in parallel
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "tpujob_torch_kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = [ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo"]

_p = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float

# C signature of every entry point: source stem -> {symbol: argtypes}
SIGNATURES: Dict[str, Dict[str, list]] = {
    "flash_fwd": {
        # q, k, v, o, lse, B, H, D, Sq, Sk, scale, causal, window, stream
        "tpujob_flash_fwd": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _f, _i,
                             _i, _p],
    },
    "flash_dq": {
        # q, k, v, dO, lse, delta, dq, B, H, D, Sq, Sk, scale, causal,
        # window, stream
        "tpujob_flash_dq": [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i,
                            _f, _i, _i, _p],
    },
    "flash_dkv": {
        # q, k, v, dO, lse, delta, dk, dv, B, H, D, Sq, Sk, scale, causal,
        # window, stream
        "tpujob_flash_dkv": [_p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i,
                             _i, _f, _i, _i, _p],
    },
    "flash_fwd_any": {
        # q, k, v, o, lse, B, H, D, Sq, Sk, scale, causal, window, is_bf16,
        # stream
        "tpujob_flash_fwd_any": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _f,
                                 _i, _i, _i, _p],
        # as tpujob_flash_fwd
        "tpujob_flash_fwd_bf16_128": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i,
                                      _f, _i, _i, _p],
    },
    "flash_dq_any": {
        # q, k, v, dO, lse, delta, dq, B, H, D, Sq, Sk, scale, causal,
        # window, is_bf16, stream
        "tpujob_flash_dq_any": [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i,
                                _i, _f, _i, _i, _i, _p],
        # as tpujob_flash_dq
        "tpujob_flash_dq_bf16_128": [_p, _p, _p, _p, _p, _p, _p, _i, _i, _i,
                                     _i, _i, _f, _i, _i, _p],
    },
    "flash_dkv_any": {
        # q, k, v, dO, lse, delta, dk, dv, B, H, D, Sq, Sk, scale, causal,
        # window, is_bf16, stream
        "tpujob_flash_dkv_any": [_p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i,
                                 _i, _i, _f, _i, _i, _i, _p],
        # as tpujob_flash_dkv
        "tpujob_flash_dkv_bf16_128": [_p, _p, _p, _p, _p, _p, _p, _p, _i, _i,
                                      _i, _i, _i, _f, _i, _i, _p],
    },
    "mark": {
        # which, word, stream
        "tpujob_mark": [_i, _p, _p],
    },
    "adamw": {
        # ptrs, sizes, count, lr, wd, b1, b2, w1, w2, eps, stream
        "tpujob_adamw": [_p, _p, _i, _p, _f, _f, _f, _f, _f, _f, _p],
    },
    "moe_gemm": {
        # a, w, out, offsets, tiles, R, K, N, E, transposed, stream
        "tpujob_moe_gemm_rows": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _p],
        # a, g, dw, offsets, R, M, N, E, stream
        "tpujob_moe_gemm_weights": [_p, _p, _p, _p, _i, _i, _i, _i, _p],
    },
}

# the source stem of each entry point
_STEM = {sym: stem for stem, syms in SIGNATURES.items() for sym in syms}

# kernel launches since the last reset_launches(), by the name each
# wrapper gives its kernel
LAUNCHES: collections.Counter[str] = collections.Counter()

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "tpujob_torch CUDA kernels are built from source at first use")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def _lib_path(stem: str) -> Path:
    return build_dir() / f"lib{stem}.so"


def build_all(stems: Optional[List[str]] = None) -> Dict[str, Path]:
    """Compile every missing library, all ``nvcc`` processes in parallel
    (ptxas' register/spill report goes to ``<stem>.log`` beside it).
    Raises with the compiler's output if any build fails."""
    stems = list(stems or SIGNATURES)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [s for s in stems if not _lib_path(s).exists()]
    procs = []
    nvcc = nvcc_path() if todo else ""
    for stem in todo:
        # unique temp name, renamed into place: concurrent builds never
        # load a half-written library
        tmp = out_dir / f".lib{stem}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / f"{stem}.cu")]
        procs.append((stem, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for stem, tmp, proc in procs:
        log, _ = proc.communicate()
        (out_dir / f"{stem}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {stem}.cu (rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(stem))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {s: _lib_path(s) for s in stems}


def load(stem: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<stem>.cu``, building it on first use."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            path = build_all([stem])[stem]
            lib = ctypes.CDLL(str(path))
            for sym, argtypes in SIGNATURES[stem].items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[stem] = lib
        return lib


def load_all() -> Dict[str, ctypes.CDLL]:
    """Every library of ``SIGNATURES``, all missing ones built at once."""
    build_all()
    return {stem: load(stem) for stem in SIGNATURES}


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def launch(name: str, symbol: str, *args) -> None:
    """Call the entry point ``symbol`` with ``args`` (its library built at
    first use), raise if it fails, and count one launch of ``name``."""
    check(getattr(load(_STEM[symbol]), symbol)(*args), name)
    LAUNCHES[name] += 1


def reset_launches() -> None:
    LAUNCHES.clear()
