"""ResNet-50 training: the port of ``tpujob/workloads/resnet.py``.

ResNet v1.5 (stride 2 on the bottleneck's 3x3), trained with SGD and
momentum on a synthetic ImageNet-shaped batch, as the JAX package does.
The convolutions and products are cuDNN and cuBLAS through torch (the JAX
package runs no Pallas kernel here either); on the card they run
channels-last.

Parity with flax, made explicit:

- params are fp32; under ``--bf16`` every convolution casts its input and
  kernel to bf16 (flax ``dtype``), so activations are bf16, while the batch
  statistics, the normalisation and the running averages are fp32 and the
  ``head`` is fp32;
- ``Conv`` pads as flax's ``'SAME'``: at stride 2 a 3x3 pads 0 before and
  1 after on an even size (torch's ``padding=1`` pads both sides);
- ``BatchNorm`` keeps flax's running averages: ``momentum`` 0.9 weighs the
  old value (torch's 0.1 weighs the new one), and the variance folded in
  is the biased batch variance (torch folds in the unbiased one);
- the last BatchNorm scale of each bottleneck starts at 0;
- the max-pool pads (1, 1) with -inf, as flax's does;
- submodules carry the flax names (``conv_init``, ``bn_init``,
  ``Bottleneck_{i}/Conv_{j}``, ``BatchNorm_{j}``, ``downsample_conv``,
  ``downsample_bn``, ``head``) for ``convert.params_from_flax``.

Across processes the model trains in ``DistributedDataParallel`` on each
rank's rows of the global batch, and ``BatchNorm`` takes its statistics
over the global batch (the JAX package's jit over the sharded batch does
so), through an all-reduce that autograd differentiates.

Entry point (on the card; ``--device cpu`` for the CPU):
    python -m tpujob_torch.workloads.resnet --steps 100 --batch-size 256
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

import torch.distributed as tdist

from tpujob_torch.workloads import data as datalib
from tpujob_torch.workloads import distributed as dist
from tpujob_torch.workloads import train_lib

STAGE_SIZES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of flax's ``'SAME'`` on one spatial dim:
    the output is ceil(size / stride) and the odd pixel of the padding goes
    after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias: input and kernel cast to ``dtype``
    before the product, ``'SAME'`` padding unless ``padding`` is given.
    The weight is torch's OIHW (flax's kernel is HWIO)."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int,
                 dtype: torch.dtype, gen: torch.Generator,
                 padding: Optional[int] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, kernel, kernel))
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.dtype = dtype
        with torch.no_grad():
            train_lib.lecun_normal_(self.weight, c_in * kernel * kernel, gen)

    def forward(self, x):
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        if self.padding is not None:
            return F.conv2d(x, w, stride=self.stride, padding=self.padding)
        ph = same_padding(x.shape[2], self.kernel, self.stride)
        pw = same_padding(x.shape[3], self.kernel, self.stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, w, stride=self.stride, padding=(ph[0], pw[0]))
        return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w,
                        stride=self.stride)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose gradient is the sum of the ranks'
    gradients: every rank's loss depends on every rank's input through
    the summed statistics."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        tdist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` (momentum 0.9, eps 1e-5) over NCHW channels.

    Training normalises with the batch statistics (fp32, biased variance)
    and updates the running averages as flax does: ``ra = m * ra + (1 - m)
    * stat`` with the BIASED variance.  ``F.batch_norm`` computes the
    statistics in fp32 whatever the input dtype and folds them into the
    running buffers, but with the unbiased variance; the explicit update
    after it takes that variance's share back out (a [C]-vector
    correction, no second pass over the activations).  The output is in
    ``dtype``.

    With a process group of more than one rank the statistics are the
    global batch's (``_global_forward``); alone, ``F.batch_norm`` (cuDNN
    on the card) as above."""

    momentum, eps = 0.9, 1e-5  # flax's, as the JAX package sets them

    def __init__(self, channels: int, dtype: torch.dtype,
                 zero_scale: bool = False):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(channels) if zero_scale else torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.dtype = dtype

    def forward(self, x):
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
            return y.to(self.dtype)
        if tdist.is_initialized() and tdist.get_world_size() > 1:
            return self._global_forward(x)
        n = x.numel() // x.shape[1]
        m = self.momentum
        # torch folds its variance into a copy (the op keeps the copy for
        # its backward, so the buffer itself is free to be rewritten)
        folded = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, folded, self.weight,
                         self.bias, True, 1.0 - m, self.eps)
        with torch.no_grad():
            # torch added (1 - m) * var * n / (n - 1); flax adds (1 - m) * var
            kept = self.running_var * m
            self.running_var.copy_((folded - kept) * ((n - 1) / n) + kept)
        return y.to(self.dtype)

    def _global_forward(self, x):
        """Statistics over every rank's rows: the per-channel fp32 sum, sum
        of squares and count, summed over the ranks in one all-reduce; the
        mean and the biased variance as flax takes them, max(E[x^2] -
        E[x]^2, 0); the running averages from those (the same on every
        rank)."""
        c = x.shape[1]
        xf = x.float()
        stats = torch.cat([xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3)),
                           xf.new_full((1,), x.numel() // c)])
        stats = _AllReduceSum.apply(stats)
        n = stats[2 * c]
        mean = stats[:c] / n
        var = torch.clamp(stats[c : 2 * c] / n - mean.square(), min=0.0)
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = (xf - mean[:, None, None]) * scale[:, None, None] \
            + self.bias[:, None, None]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_((1 - m) * mean)
            self.running_var.mul_(m).add_((1 - m) * var)
        return y.to(self.dtype)


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, filters: int, stride: int,
                 dtype: torch.dtype, gen: torch.Generator):
        super().__init__()
        self.Conv_0 = Conv(c_in, filters, 1, 1, dtype, gen)
        self.BatchNorm_0 = BatchNorm(filters, dtype)
        self.Conv_1 = Conv(filters, filters, 3, stride, dtype, gen)
        self.BatchNorm_1 = BatchNorm(filters, dtype)
        self.Conv_2 = Conv(filters, filters * 4, 1, 1, dtype, gen)
        self.BatchNorm_2 = BatchNorm(filters * 4, dtype, zero_scale=True)
        self.project = c_in != filters * 4 or stride != 1
        if self.project:
            self.downsample_conv = Conv(c_in, filters * 4, 1, stride, dtype,
                                        gen)
            self.downsample_bn = BatchNorm(filters * 4, dtype)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = x
        if self.project:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """ResNet v1.5 on NHWC input [b, h, w, 3]; fp32 logits [b, classes]."""

    def __init__(self, depth: int = 50, num_classes: int = 1000,
                 width: int = 64, dtype: torch.dtype = torch.float32,
                 seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.conv_init = Conv(3, width, 7, 2, dtype, gen, padding=3)
        self.bn_init = BatchNorm(width, dtype)
        c_in, i = width, 0
        for stage, blocks in enumerate(STAGE_SIZES[depth]):
            filters = width * 2 ** stage
            for block in range(blocks):
                stride = 2 if block == 0 and stage > 0 else 1
                setattr(self, f"Bottleneck_{i}",
                        Bottleneck(c_in, filters, stride, dtype, gen))
                c_in, i = filters * 4, i + 1
        self.blocks = i
        self.head = nn.Linear(c_in, num_classes)
        with torch.no_grad():
            train_lib.lecun_normal_(self.head.weight, c_in, gen)
            self.head.bias.zero_()

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view (channels-last)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)  # pads with -inf
        for i in range(self.blocks):
            x = getattr(self, f"Bottleneck_{i}")(x)
        x = x.mean(dim=(2, 3))  # global average pool
        return self.head(x.float())  # the head is fp32


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the batch (one-hot labels)."""
    return F.cross_entropy(logits, labels)


def make_model(args) -> ResNet:
    return ResNet(depth=args.depth, width=args.width,
                  dtype=torch.bfloat16 if args.bf16 else torch.float32,
                  seed=args.seed)


def build_loss(model: nn.Module):
    """``loss_fn(batch)``: the train-mode forward (batch statistics; the
    running averages update in place, flax's mutable ``batch_stats``) and
    the cross-entropy."""

    def loss_fn(batch):
        x, y = batch
        return cross_entropy(model(x), y)

    return loss_fn


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ResNet-50 (PyTorch port)")
    p.add_argument("--depth", type=int, default=50, choices=sorted(STAGE_SIZES))
    p.add_argument("--width", type=int, default=64,
                   help="base filter count (64 = standard ResNet)")
    p.add_argument("--batch-size", type=int, default=256,
                   help="global batch size")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--warmup-steps", type=int, default=2,
                   help="warm-up steps excluded from throughput")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--log-interval", type=int, default=20)
    p.add_argument("--dir", default="logs")
    train_lib.add_profile_flags(p)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def run(args, capture: bool = True) -> Dict[str, Any]:
    """Warm-up steps, then ``--steps`` timed steps on one synthetic batch
    (each process its rows of it).  ``losses`` holds every step's loss,
    warm-up first.  On one card every step after the first replays a CUDA
    graph (``train_lib.make_train_step``; ``capture=False`` keeps it
    eager); ``step_mode`` in the result says which ran."""
    device = dist.local_device(getattr(args, "device", "cuda"))
    pe = dist.initialize(device=device)
    writer = train_lib.SummaryWriter(args.dir, enabled=pe.process_id == 0)

    model = make_model(args).to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    model.train()
    optimizer = train_lib.sgd(model.parameters(), args.lr, args.momentum)
    train_step = train_lib.make_train_step(
        build_loss(train_lib.data_parallel(model)), optimizer,
        lambda count: args.lr, capture=capture)
    if pe.process_id == 0:
        print(f"resnet{args.depth}: step_mode={train_step.mode}")
    state = train_lib.init_state(model, optimizer)

    lo, sz = dist.local_batch_slice(args.batch_size, pe)
    x, y = datalib.synthetic_imagenet_batch(args.batch_size, args.image_size)
    batch = train_lib.put_batch((x[lo : lo + sz], y[lo : lo + sz]), device)

    losses = []
    for _ in range(args.warmup_steps):
        state, loss = train_step(state, batch)
        losses.append(loss)
    train_lib.sync(device)
    profiler = train_lib.profiler_from_args(args, pe, device)
    loss = None
    t0 = time.perf_counter()
    try:
        for i in range(args.steps):
            profiler.step(i, block_on=loss)
            state, loss = train_step(state, batch)
            losses.append(loss)
            if i % args.log_interval == 0:
                writer.add_scalar("loss", loss, i)
        train_lib.sync(device)
        # a trace written mid-loop is not training time
        wall = time.perf_counter() - t0 - profiler.overhead_s
    finally:
        profiler.close(block_on=loss)
    sps = args.steps * args.batch_size / wall
    losses = [float(v) for v in losses]
    writer.close()
    if pe.process_id == 0:
        print(f"resnet{args.depth}: {sps:.1f} samples/sec "
              f"({sps:.1f}/device), loss={losses[-1]:.3f}")
    return {"samples_per_sec": sps, "wall_s": wall, "final_loss": losses[-1],
            "losses": losses, "state": state, "step_mode": train_step.mode}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    run(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
