"""``correct`` catches what it must, on the CPU at a tiny size.

A run here skips the harness's look for a card and drives the rest of a
run (the port's trainer through ``bert.train``, the window, the reference
and the comparison) with each cell's own limits.  The program runs in
fp32 at these sizes, where it agrees with the reference to round-off, so
a sound run passes any limit; then the timed path is broken underneath,
once for each fault a training step can have on one card, and ``correct``
must come out false.  The control, the reference computed in fp8, must
fail the cell's limits too."""
import copy

import pytest
import torch

from portbench import check, run as runmod
from portbench.tests.support import BENCH, benchmark
from tpujob_torch.workloads import bert, gpt

CELLS = [c["name"] for c in benchmark()["workloads"]]
TINY = dict(hidden=64, layers=2, heads=4, intermediate=128, vocab=300)


def tiny_cell(name, precision="float32"):
    bench, cell, cfg, spec, limits = runmod.load_cell(
        name, BENCH.parent / "BENCHMARK.json")
    cfg, spec = copy.deepcopy(cfg), copy.deepcopy(spec)
    cfg["model"].update(TINY, max_positions=32)
    cfg["precision"]["compute"] = precision
    spec.update(batch_size=4, seq_len=32 if cfg["model"]["causal"] else 16)
    return bench, cell, cfg, spec, limits


def drive(name, tmp_path, seconds=0.2):
    bench, cell, cfg, spec, limits = tiny_cell(name)
    return runmod.run_cell(bench, cell, cfg, spec, limits, 2 ** 31 + 7,
                           seconds, False, device="cpu",
                           log_dir=str(tmp_path / "log"))


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name, tmp_path):
    out = drive(name, tmp_path)
    assert out["correct"], out["check"]
    assert list(out)[-1] == "check" and out["attempted"] >= 1
    assert set(out["metrics"]) == {"train_tokens_per_s", "step_ms_p95",
                                   "peak_mem_gib", "setup_s"}


def _halved(orig):
    def loss_of(model, **kw):
        fn = orig(model, **kw)
        return lambda batch: fn(tuple(t[: t.shape[0] // 2] for t in batch))
    return loss_of


def _misreported(orig):
    def loss_of(model, **kw):
        fn = orig(model, **kw)

        def loss_fn(batch):
            loss = fn(batch)
            return loss + 0.05 * loss.detach()
        return loss_fn
    return loss_of


@pytest.mark.parametrize("fault", ["frozen", "half", "loss"])
@pytest.mark.parametrize("name", CELLS)
def test_each_fault_makes_the_run_incorrect(name, fault, tmp_path, monkeypatch):
    if fault == "frozen":  # the step returns its state unchanged
        monkeypatch.setattr(torch.optim.AdamW, "step",
                            lambda self, closure=None: None)
    else:
        wrap = _halved if fault == "half" else _misreported
        monkeypatch.setattr(gpt, "lm_loss", wrap(gpt.lm_loss))
        monkeypatch.setattr(bert, "mlm_loss", wrap(bert.mlm_loss))
    out = drive(name, tmp_path)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits(name):
    _, _, cfg, spec, limits = tiny_cell(name)
    ref = check.follow_reference(cfg, spec, 11, "cpu")
    control = check.follow_reference(cfg, spec, 11, "cpu", precision="fp8")
    correct, shown = check.judge(check.numbers(control, ref), limits["numbers"])
    assert not correct, shown
