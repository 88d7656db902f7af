"""The port's benches (``python -m tpujob_torch.bench`` and
``tpujob_torch.bench_models``) on the CPU: their one-line contracts
against the JAX package's (``bench.py``, ``bench_models.py``),
whose printed keys are read from their source, the CPU shrink, and the
peak FLOP/s by card name.  Numbers from these runs are CPU numbers and
are checked for shape only.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpujob_torch import bench_models

ROOT = Path(__file__).resolve().parent.parent


def _printed_keys(path: Path, function: str) -> set:
    """The keys of the row ``function`` of ``path`` builds: those of its
    dict literal that holds ``"metric"``, and those it assigns as
    ``out["..."] = ...``."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == function)
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            lits = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if "metric" in lits:
                keys |= lits
        elif isinstance(node, ast.Assign):
            keys |= {t.slice.value for t in node.targets
                     if isinstance(t, ast.Subscript)
                     and isinstance(t.slice, ast.Constant)}
    return keys


def test_bench_prints_one_line_with_the_jax_keys_on_the_cpu():
    jax_keys = _printed_keys(ROOT / "bench.py", "main")
    assert {"metric", "vs_baseline", "step_ms_cv_pct"} <= jax_keys
    # two threads: the test workers share the host's cores, and a child
    # at every core's worth of spinning threads slows them all
    out = subprocess.run(
        [sys.executable, "-m", "tpujob_torch.bench", "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 1, out.stdout
    line = json.loads(lines[0])
    assert jax_keys <= set(line)
    assert line["metric"] == "mnist_train_samples_per_sec_per_chip"
    assert line["accuracy"] > 0.8
    assert line["platform"] == "cpu" and line["chips"] == 1
    assert line["step_mode"] == "eager"
    # the CPU shrink: k = 2 steps a call, two short windows
    assert line["steps"] % 2 == 0 and line["steps"] >= 8
    assert line["value"] > 0 and line["step_ms_std"] >= 0


TINY = {
    "resnet50": ("--width", "4", "--image-size", "16", "--batch-size", "2"),
    "bert-large": ("--hidden", "64", "--layers", "2", "--heads", "4",
                   "--intermediate", "128", "--vocab", "211", "--seq-len",
                   "64", "--batch-size", "2", "--no-bf16"),
    "gpt": ("--hidden", "64", "--layers", "2", "--heads", "4",
            "--intermediate", "128", "--vocab", "211", "--seq-len", "64",
            "--batch-size", "2", "--no-bf16"),
}


@pytest.fixture
def two_threads():
    """Tiny models gain nothing from more threads, and the test workers
    share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_bench_models_rows_at_a_tiny_size_carry_the_jax_keys(two_threads):
    """The three rows through their functions at a tiny size (about 7 s
    on an idle 8-core host)."""
    row_keys = {
        "resnet50": _printed_keys(ROOT / "bench_models.py", "bench_resnet50"),
        "bert-large": _printed_keys(ROOT / "bench_models.py",
                                    "_bench_transformer"),
    }
    row_keys["gpt"] = row_keys["bert-large"] | {"attention"}
    perf = _printed_keys(ROOT / "bench_models.py", "perf_fields")
    for name in TINY:  # the scaling row: test_scaling_row_*
        row = bench_models.BENCHES[name](True, "cpu", TINY[name])
        assert row_keys[name] - {"attention"} <= set(row), name
        assert {"flops_per_step", "achieved_tflops_per_chip"} <= set(row)
        # no card, no peak: no utilization is claimed for a CPU number
        assert not (perf - {"flops_per_step", "achieved_tflops_per_chip"}) \
            & set(row), row
        assert row["platform"] == "cpu" and row["step_mode"] == "eager"
        assert row["steps"] % bench_models.STEPS_PER_DISPATCH == 0
        assert row["value"] > 0 and row["step_ms_std"] >= 0
        json.dumps(row)
    assert row["attention"] == "flash"
    assert row["kernel_launches"] == {  # plain versions
        "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0, "flash_fwd_bf16_128": 0,
        "flash_dq_bf16_128": 0, "flash_dkv_bf16_128": 0, "flash_fwd_any": 0,
        "flash_dq_any": 0, "flash_dkv_any": 0}
    # torch's AdamW on the CPU, the port's kernel on the card
    assert row["adamw_updates"]["kernel"] == 0
    assert row["adamw_updates"]["torch"] > 0


@pytest.mark.parametrize("card,peak", [
    ("NVIDIA H100 80GB HBM3", 989.4e12), ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H100 SXM5", 989.4e12), ("NVIDIA A100-SXM4-80GB", None),
    ("cpu", None)])
def test_peak_by_card_name(card, peak):
    assert bench_models.peak_flops(card) == peak
    out = bench_models.perf_fields(1e12, 0.01, 1, card)
    assert out["flops_per_step"] == 10**12
    assert out["achieved_tflops_per_chip"] == 100.0
    if peak:
        assert out["mfu_vs_spec"] == round(100e12 / peak, 3)
    else:
        assert set(out) == {"flops_per_step", "achieved_tflops_per_chip"}


def test_a_rate_above_the_peak_is_not_called_mfu():
    out = bench_models.perf_fields(2e13, 0.01, 1, "NVIDIA H100 80GB HBM3")
    assert "mfu_vs_spec" not in out
    assert out["spec_peak_exceeded_x"] == round(2e15 / 989.4e12, 1)
    assert bench_models.perf_fields(None, 0.01, 1, "NVIDIA H100 PCIe") == {}


def test_bench_models_refuses_a_row_it_does_not_have(capsys):
    """Every row of the JAX package's ``bench_models.py`` is ported (its
    ``scaling`` too);
    a name it does not know is refused before any row runs."""
    assert set(bench_models.BENCHES) == {"resnet50", "bert-large", "gpt",
                                         "scaling"}
    assert bench_models.main(["--models", "resnet50,nope",
                              "--device", "cpu"]) == 2
    assert "unknown benchmark 'nope'" in capsys.readouterr().err


# The 8 ranks' first step against one process's: the same global batch
# and weights, the masked sums taken per rank and summed by gloo (another
# order of fp32 additions; 1.2e-7 relative read)
SCALING_LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def scaling_row():
    out = subprocess.run(
        [sys.executable, "-m", "tpujob_torch.bench_models", "--models",
         "scaling", "--quick", "--device", "cpu"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert len(lines) == 1, out.stdout
    return json.loads(lines[0])


def test_scaling_row_prints_the_reference_keys(scaling_row):
    """``--models scaling --quick --device cpu``: one JSON line with the
    JAX row's keys (read from ``bench_models.py``'s ``_scaling_child``),
    t8 / t1 from two eager steps, 8 ranks over gloo."""
    jax_keys = _printed_keys(ROOT / "bench_models.py", "_scaling_child")
    assert {"metric", "step_ms_1dev", "step_ms_8dev", "platform"} <= jax_keys
    row = scaling_row
    assert jax_keys <= set(row)
    assert row["metric"] == "dp_sharding_overhead_8dev_vs_1dev"
    assert row["platform"] == "cpu" and row["backend"] == "gloo"
    assert row["global_batch"] == 32 and row["step_mode"] == "eager"
    assert "ranks_per_card" not in row  # a card's field
    assert len(row["step_ms_8dev_by_rank"]) == 8
    # value is t8 / t1 before the step ms were rounded
    assert abs(row["value"] - row["step_ms_8dev"] / row["step_ms_1dev"]) \
        < 2e-3


def test_scaling_row_8_ranks_give_one_process_loss(scaling_row):
    """The 8-rank step computes the one-process step's loss (the global
    batch's), within SCALING_LOSS_RTOL."""
    rel = abs(scaling_row["loss_8dev"] - scaling_row["loss_1dev"]) / abs(
        scaling_row["loss_1dev"])
    assert rel <= SCALING_LOSS_RTOL, scaling_row


@pytest.mark.parametrize("module", ["tpujob_torch.bench",
                                    "tpujob_torch.bench_models"])
def test_benches_without_a_card_raise(module):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", module], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr
    assert out.stdout == ""
