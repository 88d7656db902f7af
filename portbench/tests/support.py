"""Helpers shared by the benchmark's tests."""
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"


def config_of(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def traffic_of(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def benchmark():
    return json.loads((ROOT / "BENCHMARK.json").read_text())
