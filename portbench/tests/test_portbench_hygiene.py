"""No module of the benchmark imports JAX or the JAX package, and the
yardstick (the reference, the check, the arithmetic, the readers) imports
nothing of the port.  Top-level names are compared whole: ``tpujob_torch``
begins with ``tpujob``."""
import ast

import pytest

from portbench.tests.support import BENCH

FILES = sorted(BENCH.rglob("*.py"))
JAX = {"jax", "jaxlib", "flax", "tpujob"}
PORT_FACING = {"program.py", "run.py", "calibrate.py"}


def top_names(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.add(node.args[0].value.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax(path):
    assert not top_names(path) & JAX


@pytest.mark.parametrize("path", [p for p in FILES if p.parent.name != "objectives"
                                  and p.name not in PORT_FACING
                                  and p.parent.name != "tests"],
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_the_yardstick_imports_nothing_of_the_port(path):
    assert "tpujob_torch" not in top_names(path)


def test_the_scan_sees_the_port_where_it_is():
    assert "tpujob_torch" in top_names(BENCH / "objectives" / "lm.py")
    assert "tpujob_torch" in top_names(BENCH / "program.py")


SIZES = ("trunk", '["hidden"]', '["heads"]', '["layers"]', '["intermediate"]')


@pytest.mark.parametrize("name", ["run.py", "program.py", "check.py", "trace.py",
                                  "weights.py", "traffic.py"])
def test_the_harness_reads_no_architecture_of_its_own(name):
    """What belongs to an architecture (its layout, sizes, counts, flags)
    lives in ``portbench/models/<architecture>.py``, found by name."""
    text = (BENCH / name).read_text()
    assert not [s for s in SIZES if s in text]
