"""The compiled step's rules (``train_lib.step_mode``, ``make_train_step``,
``make_multi_step``): eager on the CPU, the float lr a graph bakes in, the
``step_mode`` every trainer reports; and on the card (``gpu`` marker,
skipped without one) the captured step against the eager one, bit for
bit.  This file imports no JAX, so it runs beside the card too:
``python -m pytest -m gpu tests/test_torch_graph.py -q``.
"""
import contextlib

import pytest
import torch

from tpujob_torch.kernels import build
from tpujob_torch.workloads import bert as tbert
from tpujob_torch.workloads import gpt as tgpt
from tpujob_torch.workloads import mnist as tmnist
from tpujob_torch.workloads import optim
from tpujob_torch.workloads import resnet as tresnet
from tpujob_torch.workloads import train_lib


def _mnist():
    model = tmnist.Net()
    return model, train_lib.sgd(model.parameters(), 0.01, 0.5)


def test_step_mode_rule_on_the_cpu():
    model, opt = _mnist()
    assert train_lib.step_mode(opt) == "eager"
    assert train_lib.step_mode(opt, capture=False) == "eager"
    loss = lambda b: tmnist.nll_loss(model, b)  # noqa: E731
    assert train_lib.make_train_step(loss, opt, lambda c: 0.01).mode == \
        "eager"
    assert train_lib.make_multi_step(loss, opt, 2).mode == "eager"


def test_baked_lr_and_tensor_lr():
    """A float lr (SGD) is baked into a captured step: a schedule that
    moves it raises; a tensor lr (AdamW on the card) is filled in place
    by ``set_lr`` and never raises."""
    model, opt = _mnist()
    train_lib.check_baked_lr(opt, [0.01, 0.01])
    with pytest.raises(ValueError, match="bakes in"):
        train_lib.check_baked_lr(opt, [0.01, 0.02])
    lr = torch.tensor(0.5)
    adam = torch.optim.AdamW(model.parameters(), lr=lr, foreach=False)
    train_lib.set_lr(adam, 0.25)
    assert adam.param_groups[0]["lr"] is lr and lr.item() == 0.25
    train_lib.check_baked_lr(adam, [0.1, 0.2])


TRAINERS = {
    "gpt": (tgpt, ["--hidden", "32", "--layers", "1", "--heads", "2",
                   "--intermediate", "64", "--vocab", "97", "--seq-len",
                   "16", "--batch-size", "2", "--steps", "2"]),
    "bert": (tbert, ["--hidden", "32", "--layers", "1", "--heads", "2",
                     "--intermediate", "64", "--vocab", "211", "--seq-len",
                     "16", "--batch-size", "2", "--steps", "2"]),
    "mnist": (tmnist, ["--train-size", "128", "--test-size", "64",
                       "--batch-size", "32", "--test-batch-size", "32"]),
    "resnet": (tresnet, ["--width", "8", "--image-size", "32",
                         "--batch-size", "2", "--steps", "1",
                         "--warmup-steps", "1"]),
}


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainers_report_eager_step_mode_on_the_cpu(name, tmp_path, capsys):
    module, argv = TRAINERS[name]
    res = module.run(module.build_parser().parse_args(
        argv + ["--device", "cpu", "--dir", str(tmp_path)]))
    assert res["step_mode"] == "eager"
    first = capsys.readouterr().out.splitlines()[0]
    assert first.endswith("step_mode=eager"), first


def test_no_capture_before_the_first_update_and_one_batch_shape():
    """A capture before an eager update would record the optimizer's
    state creation (a zero fill every replay repeats): refused.  The
    static inputs take one shape and dtype."""
    model, opt = _mnist()
    graphs = train_lib._Graphs(opt)
    assert not graphs.warm()
    with pytest.raises(RuntimeError, match="before the first update"):
        graphs.replay("step", lambda: None)
    x, y = torch.randn(4, 28, 28, 1), torch.arange(4)
    inputs = graphs.feed((x, y))
    assert all(torch.equal(a, b) for a, b in zip(inputs, (x, y)))
    assert graphs.feed((x + 1, y))[0] is inputs[0]
    assert torch.equal(inputs[0], x + 1)
    with pytest.raises(ValueError, match="one batch shape"):
        graphs.feed((x[:2], y[:2]))
    with pytest.raises(ValueError, match="one batch shape"):
        graphs.feed((x.double(), y))


class _Graph:
    """A stand-in for ``torch.cuda.CUDAGraph`` on the CPU: records
    nothing, counts its replays."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1

    def pool(self):
        return "pool"


def test_replays_add_what_a_capture_counted(monkeypatch):
    """What a capture counts in ``build.LAUNCHES`` and ``optim.UPDATES``
    is taken back out (the card ran none of it) and added again at each
    replay, a kernel first counted inside the capture included."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **kw: contextlib.nullcontext())
    _, opt = _mnist()
    graphs = train_lib._Graphs(opt)
    graphs.feed((torch.zeros(2),))
    graphs.updated = True
    build.reset_launches()
    build.LAUNCHES["flash_fwd"] += 1  # an eager call's
    kernel = optim.UPDATES["kernel"]

    def capture():
        build.LAUNCHES["flash_fwd"] += 2
        build.LAUNCHES["mark_update"] += 1
        optim.UPDATES["kernel"] += 3
        return torch.ones(1)

    for replays in (1, 2, 3):
        assert torch.equal(graphs.replay("step", capture), torch.ones(1))
        assert build.LAUNCHES == {"flash_fwd": 1 + 2 * replays,
                                  "mark_update": replays}
        assert optim.UPDATES["kernel"] == kernel + 3 * replays
    assert graphs.graphs["step"][0].replays == 3
    build.reset_launches()


def test_grad_accum_fold_then_advance_is_add():
    """The captured mini-step holds ``fold`` (the device's work) and the
    host counts with ``advance``: together they are ``add``, bit for bit,
    at every position of a group of 3."""
    gen = torch.Generator().manual_seed(0)
    grads = [torch.randn(5, generator=gen) for _ in range(6)]
    a, b = torch.nn.Parameter(torch.zeros(5)), torch.nn.Parameter(
        torch.zeros(5))
    one, two = (train_lib.with_grad_accum([a], 3),
                train_lib.with_grad_accum([b], 3))
    for i, g in enumerate(grads):
        a.grad, b.grad = g.clone(), g.clone()
        got = one.add()
        handed = two.fold(two.mini_step)
        assert handed == (i % 3 == 2)
        assert two.advance() == got == (i // 3 if i % 3 == 2 else None)
        assert torch.equal(one.acc[0], two.acc[0])
        assert (one.mini_step, one.gradient_step) == \
            (two.mini_step, two.gradient_step)


@pytest.mark.gpu
@pytest.mark.parametrize("accum", [1, 2])
def test_captured_step_is_the_eager_step_on_the_card(accum, tmp_path):
    """gpt.run and bert.run (flash, bf16) eager and captured from one
    seed: the same losses and parameters, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs)")
    argv = ["--hidden", "256", "--layers", "2", "--heads", "4",
            "--intermediate", "512", "--vocab", "1000", "--seq-len", "256",
            "--batch-size", "2", "--steps", "6", "--attention", "flash",
            "--grad-accum", str(accum), "--lr-schedule", "cosine"]
    module = tgpt if accum == 1 else tbert
    runs = [module.run(module.build_parser().parse_args(
        argv + ["--dir", str(tmp_path / str(c))]), capture=c)
        for c in (False, True)]
    assert [r["step_mode"] for r in runs] == ["eager", "graph"]
    assert runs[0]["losses"] == runs[1]["losses"]
    for p, q in zip(runs[0]["state"]["model"].parameters(),
                    runs[1]["state"]["model"].parameters()):
        assert torch.equal(p, q)
