"""Distributed MNIST example: the port of ``tpujob/workloads/mnist.py``.

The reference CNN (conv 20@5x5 -> pool -> conv 50@5x5 -> pool -> fc 500 ->
fc 10 -> log_softmax), its flags, its train and test log lines and its
``SummaryWriter`` scalars (``loss`` every log interval, ``accuracy`` every
epoch), SGD with momentum, and the progress heartbeat (``TrainTelemetry``)
as the JAX package has them.  The convolutions and products are cuDNN and
cuBLAS through torch: the JAX package runs no Pallas kernel here either.

Parity with flax, made explicit: images arrive NHWC (``data.IMAGE_SHAPE``)
and are viewed as NCHW for the convolutions (on the card that view is the
channels-last layout); the flatten before ``fc1`` is in flax's NHWC order,
so ``fc1``'s weight is flax's kernel transposed; every kernel starts from
flax's lecun-normal, every bias from 0.  Submodules carry the flax names
(``conv1``, ``conv2``, ``fc1``, ``fc2``) for ``convert.params_from_flax``.

Across processes (a process group from the injected env) ``Net`` trains
in ``DistributedDataParallel`` on each rank's rows of the global batch,
both batch sizes round down to a multiple of the world, and the test
epoch's loss and correct count are summed over the ranks, so the accuracy
is the whole test set's, as in the JAX package.

Entry point (on the card; ``--device cpu`` for the CPU):
    python -m tpujob_torch.workloads.mnist --epochs 1
    torchrun --nproc-per-node 2 -m tpujob_torch.workloads.mnist --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpujob_torch.workloads import data as datalib
from tpujob_torch.workloads import distributed as dist
from tpujob_torch.workloads import train_lib


class Net(nn.Module):
    """The reference CNN on NHWC input [b, 28, 28, 1]; log-probabilities
    out."""

    def __init__(self, seed: int = 0):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 20, 5)
        self.conv2 = nn.Conv2d(20, 50, 5)
        self.fc1 = nn.Linear(4 * 4 * 50, 500)
        self.fc2 = nn.Linear(500, 10)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in (self.conv1, self.conv2, self.fc1, self.fc2):
                train_lib.lecun_normal_(m.weight, m.weight[0].numel(), gen)
                m.bias.zero_()

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view
        x = F.max_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's order
        x = self.fc2(F.relu(self.fc1(x)))
        return F.log_softmax(x, dim=-1)


def nll_loss(model: nn.Module, batch) -> torch.Tensor:
    """F.nll_loss on the log-probabilities: the mean over the batch."""
    x, y = batch
    return F.nll_loss(model(x), y)


def eval_metrics(model: nn.Module, batch):
    """(summed nll, count of correct predictions) of one batch."""
    x, y = batch
    logp = model(x)
    return (F.nll_loss(logp, y, reduction="sum"),
            (logp.argmax(dim=1) == y).sum())


def train_epoch(args, state, train_step, device, train_x, train_y, epoch,
                writer, pe, profiler=None, telemetry=None):
    n = len(train_x) - len(train_x) % args.batch_size
    steps_per_epoch = n // args.batch_size
    # every process walks the same global batch order (one seed) and feeds
    # only its own rows
    lo, sz = dist.local_batch_slice(args.batch_size, pe)
    last_loss, prev_loss = None, None
    for batch_idx, (bx, by) in enumerate(
            datalib.batches(train_x, train_y, args.batch_size,
                            seed=args.seed + epoch)):
        if profiler is not None:
            profiler.step((epoch - 1) * steps_per_epoch + batch_idx,
                          block_on=prev_loss)
        state, loss = train_step(
            state, train_lib.put_batch((bx[lo : lo + sz], by[lo : lo + sz]),
                                       device))
        prev_loss = loss
        if telemetry is not None:
            # throughput EMA and the operator's heartbeat (rate-limited in
            # the reporter; nothing is published outside a cluster)
            telemetry.step((epoch - 1) * steps_per_epoch + batch_idx + 1,
                           samples=args.batch_size)
        if batch_idx % args.log_interval == 0:
            loss_v = float(loss)
            print(
                "Train Epoch: {} [{}/{} ({:.0f}%)]\tloss={:.4f}".format(
                    epoch, batch_idx * args.batch_size, n,
                    100.0 * batch_idx / steps_per_epoch, loss_v))
            writer.add_scalar("loss", loss_v,
                              (epoch - 1) * steps_per_epoch + batch_idx)
            last_loss = loss_v
    return state, last_loss


def test_epoch(args, state, eval_step, device, test_x, test_y, epoch,
               writer, pe) -> float:
    total = len(test_x) - len(test_x) % args.test_batch_size
    lo, sz = dist.local_batch_slice(args.test_batch_size, pe)
    loss_sum, correct = 0.0, 0
    for bx, by in datalib.batches(test_x, test_y, args.test_batch_size,
                                  shuffle=False):
        # the global batch's sums: every rank holds them
        ls, c = eval_step(train_lib.put_batch(
            (bx[lo : lo + sz], by[lo : lo + sz]), device))
        loss_sum += float(ls)
        correct += int(c)
    accuracy = correct / max(1, total)
    print("\naccuracy={:.4f}\n".format(accuracy))
    writer.add_scalar("accuracy", accuracy, epoch)
    return accuracy


def build_parser() -> argparse.ArgumentParser:
    # flag for flag with the reference example
    p = argparse.ArgumentParser(description="MNIST Example (PyTorch port)")
    p.add_argument("--batch-size", type=int, default=64, metavar="N",
                   help="input batch size for training (default: 64)")
    p.add_argument("--test-batch-size", type=int, default=1000, metavar="N",
                   help="input batch size for testing (default: 1000)")
    p.add_argument("--epochs", type=int, default=1, metavar="N",
                   help="number of epochs to train (default: 1)")
    p.add_argument("--lr", type=float, default=0.01, metavar="LR",
                   help="learning rate (default: 0.01)")
    p.add_argument("--momentum", type=float, default=0.5, metavar="M",
                   help="SGD momentum (default: 0.5)")
    p.add_argument("--seed", type=int, default=1, metavar="S",
                   help="random seed (default: 1)")
    p.add_argument("--log-interval", type=int, default=10, metavar="N",
                   help="how many batches to wait before logging training status")
    p.add_argument("--save-model", action="store_true", default=False,
                   help="For Saving the current Model")
    p.add_argument("--dir", default="logs", metavar="L",
                   help="directory where summary logs are stored")
    p.add_argument("--data-dir", default=None,
                   help="IDX dataset dir (torchvision layout); synthetic if absent")
    p.add_argument("--dataset", choices=["auto", "synthetic", "digits", "idx"],
                   default="auto",
                   help="auto = IDX files when present, else synthetic; "
                        "digits = real offline UCI handwritten digits "
                        "(needs scikit-learn)")
    p.add_argument("--train-size", type=int, default=60000)
    p.add_argument("--test-size", type=int, default=10000)
    train_lib.add_profile_flags(p)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def run(args, capture: bool = True) -> Dict[str, Any]:
    """Train and test from the flags.  On one card each training step
    after the first replays a CUDA graph (``train_lib.make_train_step``;
    ``capture=False`` keeps it eager); the test epoch is eager.
    ``step_mode`` in the result says which ran."""
    device = dist.local_device(getattr(args, "device", "cuda"))
    pe = dist.initialize(device=device)
    writer = train_lib.SummaryWriter(args.dir, enabled=pe.process_id == 0)

    dataset = datalib.resolve_dataset(args.data_dir,
                                      getattr(args, "dataset", "auto"))
    train_x, train_y, test_x, test_y = datalib.mnist_datasets(
        args.data_dir, args.train_size, args.test_size, dataset=dataset)
    # clamp so a small set still yields one full batch (dropping the
    # remainder would otherwise report accuracy 0), rounded down to a
    # multiple of the world so each process feeds as many rows
    div = pe.num_processes
    args.test_batch_size = max(div, min(args.test_batch_size,
                                        len(test_x)) // div * div)
    args.batch_size = max(div, min(args.batch_size, len(train_x)) // div * div)

    model = Net(seed=args.seed).to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    optimizer = train_lib.sgd(model.parameters(), args.lr, args.momentum)
    net = train_lib.data_parallel(model)
    train_step = train_lib.make_train_step(
        lambda batch: nll_loss(net, batch), optimizer, lambda count: args.lr,
        capture=capture)
    if pe.process_id == 0:
        print(f"mnist: step_mode={train_step.mode}")
    eval_step = train_lib.make_eval_step(
        lambda batch: eval_metrics(model, batch))
    state = train_lib.init_state(model, optimizer)

    accuracy, last_loss = 0.0, None
    profiler = train_lib.profiler_from_args(args, pe, device)
    telemetry = train_lib.TrainTelemetry.from_env()
    t0 = time.perf_counter()
    try:
        for epoch in range(1, args.epochs + 1):
            state, last_loss = train_epoch(
                args, state, train_step, device, train_x, train_y, epoch,
                writer, pe, profiler=profiler, telemetry=telemetry)
            accuracy = test_epoch(args, state, eval_step, device, test_x,
                                  test_y, epoch, writer, pe)
        # test_epoch ends on a host read, so the card has finished; a trace
        # written mid-loop is not training time
        wall = time.perf_counter() - t0 - profiler.overhead_s
    finally:
        profiler.close()
        telemetry.close()

    if args.save_model:
        ckpt = train_lib.Checkpointer(args.dir + "/ckpt")
        ckpt.save(state["step"], state)
        telemetry.checkpointed(state["step"])
    writer.close()
    return {
        "accuracy": accuracy,
        "final_loss": last_loss,
        "wall_s": wall,
        "samples": (len(train_x) - len(train_x) % args.batch_size) * args.epochs,
        "dataset": dataset,
        "state": state,
        "step_mode": train_step.mode,
    }


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    result = run(args)
    return 0 if result["accuracy"] > 0.0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
