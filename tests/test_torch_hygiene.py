"""Hygiene of the PyTorch port (``tpujob_torch/``) and its chip smoke.

- No module of the port imports JAX, flax, optax, orbax or anything of the
  JAX package ``tpujob``; ``triton`` may only be imported inside a
  function (it exists only beside the card).
- tpulint's per-file rules hold over the port (``tpujob/analysis`` scans
  only its own directories; ``Project(root, files=...)`` points it here).
- ``cuda`` without a card raises; ``chip_smoke.py`` fails with no card,
  and fails alone in a directory without the package.
- The MNIST and ResNet entry points run on the CPU with ``--device cpu``
  and raise without a card by default.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpujob.analysis.engine import Project, Rule, load_rules, run_rules
from tpujob_torch import resolve_device

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "tpujob_torch"
FORBIDDEN = ("jax", "flax", "optax", "orbax", "tpujob")
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(tree):
    """(module root, top-level?) for every import in the file."""
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0], id(node) in top


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_nothing_of_jax_or_tpujob(path):
    tree = ast.parse(path.read_text())
    for mod, top in _imports(tree):
        assert mod not in FORBIDDEN, f"{path.name} imports {mod}"
        assert not (mod == "triton" and top), \
            f"{path.name} imports triton at module level"


def test_scan_covers_every_port_module():
    """The scan above reads every module of the port, the multi-process
    ones and the benches included, and the chip smoke."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for module in ("smoke_dist", "distributed", "train_lib", "bert", "gpt",
                   "mnist", "resnet", "benchlib"):
        assert f"tpujob_torch/workloads/{module}.py" in names
    for bench in ("bench", "bench_models", "graft_entry"):
        assert f"tpujob_torch/{bench}.py" in names
    assert "chip_smoke.py" in names
    assert set(FORBIDDEN) == {"jax", "flax", "optax", "orbax", "tpujob"}


def test_port_is_tpulint_clean():
    """Every per-file tpulint rule over the port (the project-wide rules
    read the control plane's wire registry and do not apply here)."""
    rules = [r for r in load_rules()
             if type(r).check_project is Rule.check_project]
    assert {"TPL100", "TPL101"} <= {r.id for r in rules}
    project = Project(ROOT, files=PORT_FILES)
    findings = run_rules(project, rules)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_every_kernel_source_names_what_it_replaces():
    """A flash kernel names the Pallas kernel of ``flash.py`` it replaces;
    another kernel (the step's phase marks, ``mark.cu``) names the JAX
    package's code it stands for."""
    for cu in sorted((PORT / "csrc").glob("*.cu")):
        head = cu.read_text()[:3000]
        counterpart = ("tpujob/workloads/flash.py:" if cu.stem.startswith("flash")
                       else "tpujob/workloads/")
        assert counterpart in head, cu.name
        assert "Bound on an H100" in head or "Bounds on an H100" in head, cu.name


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("mps")


def _smoke(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    out = _smoke(ROOT, ROOT / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory with nothing else of the repo, the script
    must fail (no package to drive), whatever the machine has."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = _smoke(tmp_path, alone)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


ENTRY_ARGS = {
    "mnist": ["--train-size", "128", "--test-size", "64", "--batch-size",
              "32", "--test-batch-size", "32", "--log-interval", "1"],
    "resnet": ["--width", "8", "--image-size", "32", "--batch-size", "2",
               "--steps", "2", "--warmup-steps", "1", "--depth", "50"],
}


@pytest.mark.parametrize("module", sorted(ENTRY_ARGS))
def test_entry_point_runs_on_cpu(module, tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", f"tpujob_torch.workloads.{module}",
         "--device", "cpu", "--dir", str(tmp_path)] + ENTRY_ARGS[module],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert ("accuracy=" if module == "mnist" else "resnet50:") in out.stdout


@pytest.mark.parametrize("module", sorted(ENTRY_ARGS))
def test_entry_point_without_a_card_raises(module, tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", f"tpujob_torch.workloads.{module}",
         "--dir", str(tmp_path)] + ENTRY_ARGS[module],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr
