"""The ctypes bindings of ``tpujob_torch/kernels/build.py`` against the C
sources in ``tpujob_torch/csrc`` (CPU only: the sources are parsed, not
compiled).

ctypes passes a Python int given for a ``c_int`` argument as 32 bits, so a
pointer bound as an int is silently cut.  So every ``extern "C" int
tpujob_*(...)`` must be in ``build.SIGNATURES`` under its source's stem,
with as many arguments and ``c_void_p`` / ``c_int`` / ``c_float`` for each
pointer / int / float; and every binding must name an entry point that
exists.  The three tuned kernels (B1 ``flash_fwd.cu``, B2 ``flash_dq.cu``,
B3 ``flash_dkv.cu``) must keep their wgmma + TMA + mbarrier design, and no
source or header may hold the mma.sync pieces of the first port.  Of the
three general kernels, each with a C entry point that takes the dtype
(``is_bf16``), the forward (``flash_fwd_any.cu`` on ``flash_fwd_tc.cuh``),
dQ and dK/dV (``flash_dq_any.cu``, ``flash_dkv_any.cu`` on
``flash_tc.cuh``) run their products on wgmma with split precision (tf32 in
three passes, bf16 with P or dS as a high and a low part) and copy tiles by
TMA or a producer warpgroup's plain copies.  fp32 at padded head dim 256
(129-256) runs a wgmma kernel of its own in each (``*_kernel_f32_256``),
and so does bf16 at head dim 128 (``*_kernel_bf16``, in
``flash_bf16_128.cuh``, each behind an entry point of its own,
``tpujob_flash_*_bf16_128``, which ``flash.route`` picks), each chosen
before the launch; no FFMA body is left.  Every launch in the port goes
through ``build.launch``, the one place that calls an entry point and
counts it.
"""
import ast
import ctypes
import re
from pathlib import Path

import pytest

from tpujob_torch.kernels import build

CSRC = Path(build.CSRC)
ENTRY = re.compile(r'extern\s+"C"\s+int\s+(tpujob_\w+)\s*\(([^)]*)\)')
CTYPES = {"pointer": ctypes.c_void_p, "int": ctypes.c_int,
          "float": ctypes.c_float}


def c_kind(param: str) -> str:
    """'pointer', 'int' or 'float' for one C parameter declaration."""
    decl = " ".join(param.split())
    if "*" in decl:
        return "pointer"
    ctype = decl.rsplit(" ", 1)[0].replace("const ", "")
    assert ctype in ("int", "float"), f"unbound C type in {param!r}"
    return ctype


def entry_points():
    """(stem, symbol, [kind of each parameter]) of every C entry point."""
    out = []
    for cu in sorted(CSRC.glob("*.cu")):
        for sym, params in ENTRY.findall(cu.read_text()):
            out.append((cu.stem, sym, [c_kind(p) for p in params.split(",")]))
    return out


ENTRIES = entry_points()
BINDINGS = [(stem, sym) for stem, syms in build.SIGNATURES.items()
            for sym in syms]


def test_sources_have_entry_points():
    assert {stem for stem, _, _ in ENTRIES} == {
        cu.stem for cu in CSRC.glob("*.cu")}


@pytest.mark.parametrize("stem,symbol,kinds", ENTRIES,
                         ids=[f"{s}:{f}" for s, f, _ in ENTRIES])
def test_entry_point_bound_with_matching_ctypes(stem, symbol, kinds):
    assert symbol in build.SIGNATURES.get(stem, {}), \
        f"{symbol} of csrc/{stem}.cu is not in build.SIGNATURES[{stem!r}]"
    bound = build.SIGNATURES[stem][symbol]
    assert len(bound) == len(kinds), (symbol, len(bound), len(kinds))
    for i, (got, kind) in enumerate(zip(bound, kinds)):
        assert got is CTYPES[kind], \
            f"{symbol} argument {i}: C {kind}, bound as {got.__name__}"


@pytest.mark.parametrize("stem,symbol", BINDINGS,
                         ids=[f"{s}:{f}" for s, f in BINDINGS])
def test_binding_names_an_entry_point_of_its_source(stem, symbol):
    assert (stem, symbol) in {(s, f) for s, f, _ in ENTRIES}, \
        f"build.SIGNATURES[{stem!r}] binds {symbol}, which csrc/{stem}.cu lacks"


def test_c_kind_parses_declarations():
    assert c_kind(" const void* q") == "pointer"
    assert c_kind("void *stream") == "pointer"
    assert c_kind("\n int B") == "int"
    assert c_kind("float scale") == "float"
    with pytest.raises(AssertionError):
        c_kind("double x")


# the identifiers of the mma.sync pieces of the first port (flash_common.cuh
# before the Hopper redesign)
MMA_SYNC_PIECES = {"mma16816", "ld_pair", "ld_col_pair", "load_a_frags",
                   "c_to_a", "mma_abt", "mma_pt", "load_tile", "store_acc",
                   "Tile", "kPitch", "kThreads", "kTile", "visible"}


def mma_sync_pieces(src: str) -> set:
    """The mma.sync pieces that a C source names outside its comments."""
    code = re.sub(r"//[^\n]*", "", src)
    found = MMA_SYNC_PIECES & set(re.findall(r"\w+", code))
    return found | ({"mma.sync"} if "mma.sync" in code else set())


@pytest.mark.parametrize("stem", ["flash_fwd", "flash_dq", "flash_dkv"])
def test_hopper_kernels_use_wgmma_tma_and_mbarriers(stem):
    src = (CSRC / f"{stem}.cu").read_text()
    for piece in ("hopper.cuh", "wgmma_m64", "tma_load_bshd", "mbar_wait",
                  "mbar_arrive", "setmaxnreg_dec", "setmaxnreg_inc",
                  "encode_bshd", "__grid_constant__"):
        assert piece in src, f"{stem}.cu lacks {piece}"
    assert not mma_sync_pieces(src), f"{stem}.cu uses {mma_sync_pieces(src)}"


ANY_STEMS = ["flash_fwd_any", "flash_dq_any", "flash_dkv_any"]


def squeeze(code: str) -> str:
    """C code with each run of whitespace as one space."""
    return " ".join(code.split())


# B1a's passes, whitespace squeezed: S (flash_fwd_tc.cuh's scores_of) in
# 3xTF32 (big x small, small x big, big x big) or one bf16 wgmma, over a
# compile-time count of k-steps; P V (flash_fwd_any.cu) in 3xTF32 into a
# per-tile accumulator, or P's low and high bf16 parts against V read
# transposed
FWD_S_PASSES = (
    "mma_tf32_ss(sc, dq0 + kstep<BM>(ks), dk1 + kstep<KT>(ks), ks > 0)",
    "mma_tf32_ss(sc, dq1 + kstep<BM>(ks), dk0 + kstep<KT>(ks), 1)",
    "mma_tf32_ss(sc, dq0 + kstep<BM>(ks), dk0 + kstep<KT>(ks), 1)",
    "wgmma_m64n64_ss(sc, dq0 + kstep<BM>(ks), dk0 + kstep<KT>(ks), ks > 0)",
    "for (int ks = 0; ks < NKS; ++ks)")
FWD_PV_PASSES = (
    "scores<T, BM, KT, G::kNksLo, G::kNksHi>(nks, sc,",
    "p_tf32(sc, j, pb[j], ps[j])", "mma_tf32(ot[nb], pb[j], dv1 +",
    "mma_tf32(ot[nb], ps[j], dv0 +", "mma_tf32(ot[nb], pb[j], dv0 +",
    "p_bf16(sc, kk, hi[kk], lo[kk])", "wgmma_m64nN_rs_t(o[nb], lo[kk], dv)",
    "wgmma_m64nN_rs_t(o[nb], hi[kk], dv)")


@pytest.mark.parametrize("stem", ANY_STEMS)
def test_general_kernels_run_on_wgmma_with_the_split(stem):
    """B1a-B3a issue wgmma (tf32 and bf16) with the split, from TMA or the
    producer's copies; fp32 at padded head dim 256 goes, before the
    launch, to a wgmma kernel of its own in each; no FFMA body, no mma.sync
    and no atomics."""
    src = (CSRC / f"{stem}.cu").read_text()
    code = re.sub(r"//[^\n]*", "", src)
    assert "is_bf16" in code
    assert not mma_sync_pieces(src), f"{stem}.cu uses {mma_sync_pieces(src)}"
    assert [sym for s, sym, _ in ENTRIES if s == stem] == [
        f"tpujob_{stem}", f"tpujob_{stem.replace('_any', '_bf16_128')}"]
    header = re.sub(r"//[^\n]*", "", (CSRC / "flash_tc.cuh").read_text())
    hopper = re.sub(r"//[^\n]*", "", (CSRC / "hopper.cuh").read_text())
    for piece in ("wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32",
                  "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32",
                  "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32",
                  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16",
                  "cp.async.bulk.tensor.4d", "fence.proxy.async"):
        assert piece in header, f"flash_tc.cuh lacks {piece}"
    kind = stem.split("_")[1]
    if stem == "flash_fwd_any":
        fwd = re.sub(r"//[^\n]*", "",
                     (CSRC / "flash_fwd_tc.cuh").read_text())
        assert '#include "flash_fwd_tc.cuh"' in src
        assert '#include "flash_tc.cuh"' in fwd
        flat = squeeze(code)
        for piece in FWD_PV_PASSES + ("encode_panels<T>(", "tma_takes<T>(",
                                      "__grid_constant__ CUtensorMap",
                                      "produce_fwd<T, DP>("):
            assert piece in flat, f"{stem}.cu lacks {piece}"
        for piece in FWD_S_PASSES:
            assert piece in squeeze(fwd), f"flash_fwd_tc.cuh lacks {piece}"
        # tf32 with both operands in shared memory (S); bf16 S with both
        # K-major, P V with B transposed (the last immediate)
        assert ("wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
                in fwd and "%16, %17, p, 1, 1;" in fwd)
        assert "%32, %33, p, 1, 1, 0, 0;" in hopper
        assert "%36, p, 1, 1, 1;" in hopper
        # TMA (one box a panel, K landed then split) and the plain copies
        for piece in ("tma_load_panel(", "mbar_arrive_expect_tx(&sm.q_land",
                      "mbar_wait(&sm.land[s], ph)", "split_tile<KT * C>(",
                      "copy_split<KT, C>(", "copy_split<BM, C>(",
                      "put_vt<DP, KT>(", "copy_tile<T, BM, C>(",
                      "produce<T, KT, C>(", "fence_async_shared();"):
            assert piece in fwd, f"flash_fwd_tc.cuh lacks {piece}"
        # fp32 at 256: S with Q split in registers (first_product), K and
        # V^T released one at a time, setmaxnreg's budgets
        for piece in ("first_product<float, KT, KT, C>(",
                      "produce_fwd_wide(", "mbar_arrive(&sm.k_empty)",
                      "mbar_arrive(&sm.v_empty)",
                      "setmaxnreg_dec<G::kProducerRegs>()",
                      "setmaxnreg_inc<G::kConsumerRegs>()"):
            assert piece in flat, f"{stem}.cu lacks {piece}"
        for piece in ("put_vt<G::DP, KT>(", "mbar_wait(&sm.k_land, ph)",
                      "produce_tile<float, G::BM, C>("):
            assert piece in fwd, f"flash_fwd_tc.cuh lacks {piece}"
        assert "fmaf(" not in code + fwd
        assert "atomicAdd" not in code + fwd
    else:
        assert '#include "flash_tc.cuh"' in src
        for piece in ("first_product<T, ", "second_product<T, ", "put_w<T, ",
                      "produce<T, kRows, C>(", "encode_panels<T>(",
                      "tma_takes<T>(", "__grid_constant__ CUtensorMap"):
            assert piece in code, f"{stem}.cu lacks {piece}"
        for piece in ("wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16",
                      "mma_tf32(part, big[u], dxs +",   # big x small
                      "mma_tf32(part, small[u], dx +",  # small x big
                      "mma_tf32(part, big[u], dx +",    # big x big
                      "mma_bf16(z, a[u], dw1 +",        # P / dS low part
                      "mma_bf16(z, a[u], dw0 +"):       # P / dS high part
            assert piece in header, f"flash_tc.cuh lacks {piece}"
    # fp32 at 256, chosen before the launch: each kernel's own tensor-core
    # kernel; no FFMA body, and fmaf only in dQ's diagonal-tile dP (the
    # plain version's order: fmaf(o, vv[e >> 1], ...) over the head dim)
    assert "_ffma" not in code
    assert (f"if constexpr (sizeof(T) == 4) return "
            f"launch_{kind}_f32_256(a, B, stream);" in code)
    assert f"flash_{kind}_any_kernel_f32_256<<<" in code
    fmas = re.findall(r"fmaf\(([^,]*), ([^,]*),", code + header)
    if stem == "flash_dq_any":
        assert fmas == [("o", "vv[e >> 1]")] * 2, fmas
    else:
        assert not fmas, fmas
    if stem == "flash_dkv_any":
        for piece in ("produce_tile<float, kRows, C>(",
                      "first_product<float, N, F, C, kB>(",
                      "second_product<float, N, C, kB>(",
                      "mbar_arrive(&sm.empty_q)", "mbar_arrive(&sm.empty_do)"):
            assert piece in code, f"{stem}.cu lacks {piece}"
    if stem == "flash_dq_any":
        # S^T on consumer 0 and dP^T on consumer 1 from the raw K and V
        # tiles, V released after dP, K after both halves of dQ^T += K^T dS
        for piece in ("produce_tile<float, kRows, C>(",
                      "first_product<float, N, F, C, kB>(sc, sm.yk,",
                      "first_product<float, N, F, C, kB>(dp, sm.yv,",
                      "second_product<float, N, C, kB>(dqt[mb], sm.yk,",
                      "mbar_arrive(&sm.empty_v)", "mbar_arrive(&sm.empty_k)"):
            assert piece in squeeze(code), f"{stem}.cu lacks {piece}"
    assert "atomicAdd" not in code + header


# the second products of the bf16 head-dim-128 kernels (whitespace
# squeezed): P or dS as a low then a high bf16 part, against an operand
# read MN-major (transposed) from shared memory
BF16_128_SECOND = {
    "fwd": ("wgmma_m64n128_rs_t(o, lo[kk], desc_v + mn_step(kk))",
            "wgmma_m64n128_rs_t(o, hi[kk], desc_v + mn_step(kk))"),
    "dq": ("wgmma_m64n128_rs_t(dq, lo[kk], mn_k + mn_step(kk))",
           "wgmma_m64n128_rs_t(dq, hi[kk], mn_k + mn_step(kk))"),
    "dkv": ("wgmma_m64n128_rs_t(dv, plo[kk], mn_do + mn_step(kk))",
            "wgmma_m64n128_rs_t(dv, phi[kk], mn_do + mn_step(kk))",
            "wgmma_m64n128_rs_t(dk, dlo[kk], mn_q + mn_step(kk))",
            "wgmma_m64n128_rs_t(dk, dhi[kk], mn_q + mn_step(kk))")}


def entry_body(code: str, symbol: str) -> str:
    """The body of the C entry point ``symbol`` (comments stripped,
    whitespace squeezed), up to the closing brace of the function."""
    rest = code.split(f"int {symbol}(", 1)[1].split(") {", 1)[1]
    return (rest + " ").split(" } ", 1)[0]


@pytest.mark.parametrize("stem", ANY_STEMS)
def test_bf16_128_route_has_a_kernel_of_its_own(stem):
    """bf16 at head dim 128 takes a kernel of its own in each _any source
    (``flash_bf16_128.cuh``), behind an entry point of its own that takes
    D 128 alone, while the ``_any`` entry point refuses bf16 at D 128: S
    and dP as one bf16 wgmma pass, P and dS in two parts, tiles by TMA on
    mbarriers, the warpgroups' registers set by setmaxnreg; no atomics and
    no mma.sync pieces."""
    kind = stem.split("_")[1]
    code = squeeze(re.sub(r"//[^\n]*", "", (CSRC / f"{stem}.cu").read_text()))
    text = (CSRC / "flash_bf16_128.cuh").read_text()
    header = squeeze(re.sub(r"//[^\n]*", "", text))
    kernel = f"flash_{kind}_any_kernel_bf16"
    assert '#include "flash_bf16_128.cuh"' in code
    own = entry_body(code, f"tpujob_flash_{kind}_bf16_128")
    assert "|| D != 128) return (int)cudaErrorInvalidValue;" in own
    assert own.endswith(f"return launch_{kind}_bf16_128(a, B, stream);")
    general = entry_body(code, f"tpujob_{stem}")
    assert ("|| (D == 128 && is_bf16)) return (int)cudaErrorInvalidValue;"
            in general)
    assert "bf16_128" not in general
    assert f"{kernel}<kD><<<grid, kBlockThreads, smem," in code
    assert ("__global__ void __launch_bounds__(kBlockThreads, 1) "
            f"{kernel}(const __grid_constant__ CUtensorMap tmQ," in header)
    body = header.split(f"{kernel}(", 1)[1].split("__global__", 1)[0]
    for piece in ("tma_rows<", "mbar_arrive_expect_tx(", "mbar_wait(",
                  "mbar_arrive(", "setmaxnreg_dec<kProducerRegs>()",
                  "setmaxnreg_inc<kConsumerRegs>()", "split_frag(",
                  "wgmma_wait<0>()") + BF16_128_SECOND[kind]:
        assert piece in body, f"{kernel} lacks {piece}"
    first = "wgmma_m64n128_ss(sc," if kind == "fwd" else "wgmma_m64n64_ss("
    assert first in body, f"{kernel}: S is not one bf16 pass"
    # the wgmma of the second products: bf16, B transposed (the last
    # immediate); a panel tile read MN-major takes its panels' stride as LBO
    assert ("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in header
            and "%68, p, 1, 1, 1;" in header)
    assert "((uint64_t)(R * kPanel / 16) << 16)" in header
    assert "atomic" not in header
    assert not mma_sync_pieces(text), mma_sync_pieces(text)


def test_no_ffma_body_is_left():
    """The general kernels' FFMA body (fp32 arithmetic on the CUDA cores)
    and the pieces only it used are gone from every source and header."""
    for path in sorted(CSRC.glob("*.cu*")):
        code = re.sub(r"//[^\n]*", "", path.read_text())
        names = set(re.findall(r"\w+", code))
        assert not [n for n in names if n.endswith("_ffma")], path.name
        assert not names & {"kAnyThreads", "Geom", "load_rows", "row_max",
                            "row_sum"}, path.name


@pytest.mark.parametrize("name", ["flash_common.cuh", "hopper.cuh",
                                  "flash_any.cuh", "flash_tc.cuh",
                                  "flash_fwd_tc.cuh", "flash_bf16_128.cuh"])
def test_headers_hold_no_mma_sync_pieces(name):
    src = (CSRC / name).read_text()
    assert not mma_sync_pieces(src), f"{name} holds {mma_sync_pieces(src)}"


def test_mma_sync_pieces_are_found():
    old = ("__device__ void mma16816(float c[4]);  // mma.sync m16n8k16\n"
           "typedef bf16 Tile[kTile][kPitch];\n")
    assert mma_sync_pieces(old) == {"mma16816", "Tile", "kTile", "kPitch"}
    assert mma_sync_pieces('asm("mma.sync.aligned.m16n8k16 ...");') == {
        "mma.sync"}
    assert not mma_sync_pieces("// visible pairs; EncodeTiledFn fn;")


PORT = CSRC.parent


def test_no_module_but_build_calls_an_entry_point():
    """Every launch goes through ``build.launch``, which counts it in
    ``build.LAUNCHES``: no module of the port but ``kernels/build.py`` (and
    ``kernels/ab.py``, which times copies of a source outside the package)
    calls a ``tpujob_*`` entry point itself."""
    callers = {}
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr.startswith("tpujob_")):
                callers.setdefault(path.relative_to(PORT).as_posix(),
                                   []).append(node.func.attr)
    assert set(callers) <= {"kernels/build.py", "kernels/ab.py"}, callers


def test_train_lib_imports_no_kernel_module():
    """The compiled step (``train_lib._Graphs``) re-adds what a capture
    counted from ``build.LAUNCHES`` and ``optim.UPDATES`` alone: it
    imports no kernel module (``flash``, ``moe_gemm``), at module level or
    in a function."""
    tree = ast.parse((PORT / "workloads" / "train_lib.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {alias.name for alias in node.names}
        elif isinstance(node, ast.ImportFrom):
            names |= {node.module or ""} | {f"{node.module}.{alias.name}"
                                            for alias in node.names}
    assert not names & {"tpujob_torch.workloads.flash",
                        "tpujob_torch.workloads.moe_gemm"}, names
    assert "tpujob_torch.kernels.build" in names


def test_launch_calls_the_entry_point_and_counts_it(monkeypatch):
    """``build.launch`` calls the entry point from its source's library,
    counts one launch of its name, and raises on a failed launch without
    counting it."""
    calls = []

    class Lib:
        def tpujob_moe_gemm_rows(self, *args):
            calls.append(args)
            return args[0]

    loaded = []
    monkeypatch.setattr(build, "load", lambda stem: loaded.append(stem)
                        or Lib())
    build.reset_launches()
    build.launch("moe_gemm_dx", "tpujob_moe_gemm_rows", 0, 7)
    assert calls == [(0, 7)] and loaded == ["moe_gemm"]
    assert build.LAUNCHES == {"moe_gemm_dx": 1}
    with pytest.raises(RuntimeError, match="moe_gemm_fwd: CUDA launch failed "
                       "with cudaError 1"):
        build.launch("moe_gemm_fwd", "tpujob_moe_gemm_rows", 1)
    assert build.LAUNCHES == {"moe_gemm_dx": 1}
    build.reset_launches()
    assert build.LAUNCHES == {}
