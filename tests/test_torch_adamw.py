"""The port's AdamW (``optim.AdamW``, which ``train_lib.adamw`` builds on
the card).  On the CPU: the route rule (torch's AdamW there, its updates
counted), and the port's class driven through a host stand-in for the C
entry point (``HostKernel``: the same table of pointers, the kernel's
formula in numpy fp32), which holds the Python side to torch's AdamW, a
float or tensor lr, torch's state dict both ways through ``Checkpointer``,
the global step hooks, and FSDP's DTensors updated through their local
shards (two gloo ranks).  On the card (``gpu`` marker, skipped without
one): the one-pass kernel (``csrc/adamw.cu``) against torch's capturable
foreach AdamW and against ``fused=True``, eager and captured, and over
more tensors than one launch's table holds.  This file imports no JAX, so
it runs beside the card: ``python -m pytest -m gpu tests/test_torch_adamw.py
-q``.
"""
import ctypes
import types

import numpy as np
import pytest
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from test_torch_spawn import join, leave, spawn
from tpujob_torch.kernels import build
from tpujob_torch.workloads import optim, train_lib

# parameters of 1, 3, 4, 4,097 and 1,048,577 elements (the 1-D ones in
# the no-decay group), and one at an offset not 16-byte aligned
SHAPES = [(1,), (3,), (4,), (17, 241), (17, 61681)]
UNALIGNED = (17, 241)
LRS = [1e-3, 3e-4, 2e-3, 5e-4, 1e-3]  # one each update
# the kernel's parameters against torch's foreach route (the same fp32
# formula): within ULPS units in the last place of max(|torch's|,
# PARAM_FLOOR).  Each of 5 updates may round p + update to the neighbouring
# float (one ulp of p), and the update itself, ~lr, differs by a few of its
# own ulps: the floor, about lr, covers that where p is near 0.
ULPS = 8
PARAM_FLOOR = 2.0 ** -9
MOMENT_FLOOR = 2.0 ** -4  # exp_avg ~ 0.1-0.3 |g|, may cross 0
# against fused=True, FUSED_RTOL x the sum of the lrs more: the fused
# kernel takes b1, b2 and 1 - b1, 1 - b2 in double, torch's foreach route
# (and so the kernel) in fp32, whose 0.999 makes 1 - b2^t 1.3e-5 smaller
# at t = 1; each update is at most ~3.2 lr (|m^| / sqrt(v^) at b1 .9, b2
# .999), so the updates part by ~2e-5 of that.  A dropped term (a bias
# correction, the decay) parts them by a whole update, ~lr.
FUSED_RTOL = 1e-4


def _params(device, seed=0):
    """The test's parameters, drawn from ``seed``; the last lies one float
    into a buffer, so no route can take 16-byte accesses on it."""
    gen = torch.Generator().manual_seed(seed)
    out = [torch.nn.Parameter(torch.randn(s, generator=gen).to(device))
           for s in SHAPES]
    n = UNALIGNED[0] * UNALIGNED[1]
    buf = torch.randn(n + 1, generator=gen).to(device)
    out.append(torch.nn.Parameter(buf[1:].view(UNALIGNED)))
    return out


def _grads(device, update, seed=1):
    gen = torch.Generator().manual_seed(seed * 1000 + update)
    return [torch.randn(p.shape, generator=gen).to(device)
            for p in _params("cpu")]


def _torch_adamw(params, **kw):
    """torch's AdamW in ``train_lib.adamw``'s groups, lrs as 0-d tensors
    on the card."""
    decay, no_decay = train_lib._decay_mask(params)
    groups = [{"params": decay, "weight_decay": 0.01},
              {"params": no_decay, "weight_decay": 0.0}]
    if params[0].is_cuda:
        for g in groups:
            g["lr"] = torch.tensor(LRS[0], device=params[0].device)
    return torch.optim.AdamW(groups, lr=LRS[0], betas=(0.9, 0.999),
                             eps=1e-8, **kw)


def _run(opt, params, updates, accum=None):
    """``updates`` updates from the drawn grads, each at its own lr; with
    ``accum`` (``GradAccum`` every 2) each update from the mean of two
    mini-steps' grads."""
    for u in range(updates):
        if accum is None:
            for p, g in zip(params, _grads(params[0].device, u)):
                p.grad = g
        else:
            for k in range(accum.every):
                for p, g in zip(params, _grads(params[0].device,
                                               2 * u + k, seed=2)):
                    p.grad = g
                accum.add()
        train_lib.set_lr(opt, LRS[u])
        opt.step()


def _ulps(got, want, floor=0.0, slack=0.0):
    """(|got - want| - slack) in units in the last place of max(|want|,
    floor), the largest."""
    got, want = got.detach(), want.detach()
    if not want.numel():  # an empty shard
        return 0.0
    scale = torch.clamp(want.abs(), min=floor)
    ulp = torch.nextafter(scale, torch.full_like(scale, float("inf"))) - scale
    return float((((got - want).abs() - slack) / ulp).max())


class HostKernel:
    """``tpujob_adamw``'s stand-in on the host: it reads the same table
    (int64 pointers and lengths, the lr and step counts by address) and
    applies the kernel's formula, in its order, in numpy fp32 to the
    arrays the pointers address (its fused multiply-adds through fp64,
    whose product of two floats is exact)."""

    @staticmethod
    def _array(addr, n, ctype=ctypes.c_float):
        return np.ctypeslib.as_array((ctype * n).from_address(addr))

    def tpujob_adamw(self, ptrs, sizes, count, lr, wd, b1, b2, w1, w2, eps,
                     stream):
        f = np.float32
        table = self._array(ptrs, 5 * count, ctypes.c_int64).reshape(count, 5)
        lengths = self._array(sizes, count, ctypes.c_int64)
        lr = self._array(lr, 1)[0]
        wd, b1, b2, w1, w2, eps = (f(x) for x in (wd, b1, b2, w1, w2, eps))
        for (pa, ga, ma, va, sa), n in zip(table, lengths):
            if n == 0:
                continue
            p, g, m, v = (self._array(int(a), int(n)) for a in (pa, ga, ma, va))
            step = self._array(int(sa), 1)[0]
            decay = f(1) - lr * wd
            bc2_sqrt = np.sqrt(-(b2 ** step - f(1)))
            step_size = f(1) / ((b1 ** step - f(1)) / lr)
            p *= decay
            d = np.float64
            m[:] = (d(w1) * (g - m) + m).astype(f)
            v[:] = (d(w2) * (g * g) + v * b2).astype(f)
            p += m / ((np.sqrt(v) / bc2_sqrt + eps) / step_size)
        return 0


def _host_kernel(setattr_):
    """``launch`` on the host: ``build.load("adamw")`` gives a
    ``HostKernel`` and the card's stream is a null one."""
    load = build.load
    setattr_(build, "load",
             lambda name: HostKernel() if name == "adamw" else load(name))
    setattr_(torch.cuda, "current_stream",
             lambda device=None: types.SimpleNamespace(cuda_stream=0))


@pytest.fixture
def host_kernel(monkeypatch):
    _host_kernel(monkeypatch.setattr)


def _port_adamw(params, lr_tensor=True):
    """``optim.AdamW`` in ``train_lib.adamw``'s groups, on any device
    (capturable on the card only: torch's AdamW, restored from its state
    dict, refuses it on the CPU)."""
    opt = _torch_adamw(params)
    groups = [{k: g[k] for k in ("params", "weight_decay")}
              for g in opt.param_groups]
    if lr_tensor:
        for g in groups:
            g["lr"] = torch.tensor(LRS[0], device=params[0].device)
    return optim.AdamW(groups, lr=LRS[0], betas=(0.9, 0.999), eps=1e-8,
                       capturable=params[0].is_cuda)


def _close(params, ref, slack=FUSED_RTOL * sum(LRS)):
    """The port's parameters within ``ULPS`` of torch's, and ``slack``
    more: torch's single-tensor route takes the betas' powers in double,
    the kernel in fp32 (see ``FUSED_RTOL``)."""
    for p, q in zip(params, ref):
        assert _ulps(p, q, PARAM_FLOOR, slack) <= ULPS, tuple(p.shape)


def test_cpu_takes_torchs_route_and_counts_it():
    params = _params("cpu")
    opt = train_lib.adamw(params, LRS[0])
    assert type(opt) is torch.optim.AdamW
    assert [len(g["params"]) for g in opt.param_groups] == [3, 3]
    before = dict(optim.UPDATES)
    ref_params = _params("cpu")
    ref = _torch_adamw(ref_params)
    _run(opt, params, 3)
    _run(ref, ref_params, 3)
    assert optim.UPDATES["torch"] - before["torch"] == 3 * len(params)
    assert optim.UPDATES["kernel"] == before["kernel"]
    for p, q in zip(params, ref_params):
        assert torch.equal(p, q)


@pytest.mark.parametrize("lr_tensor", [True, False], ids=["tensor", "float"])
def test_port_adamw_hands_the_kernel_its_table(host_kernel, lr_tensor):
    """Five updates at five lrs through the host stand-in: torch's AdamW
    within ``_close``, its moments within ``ULPS``, the step counts
    advanced once an update, the kernel route counted for every tensor;
    a float lr (FSDP's) is read like a tensor one."""
    params, ref_params = _params("cpu"), _params("cpu")
    opt, ref = _port_adamw(params, lr_tensor), _torch_adamw(ref_params)
    before = dict(optim.UPDATES)
    _run(opt, params, len(LRS))
    _run(ref, ref_params, len(LRS))
    assert optim.UPDATES["kernel"] - before["kernel"] == \
        len(LRS) * len(params)
    assert optim.UPDATES["torch"] == before["torch"]
    _close(params, ref_params)
    for p, q in zip(params, ref_params):
        s, t = opt.state[p], ref.state[q]
        assert float(s["step"]) == float(t["step"]) == len(LRS)
        assert _ulps(s["exp_avg"], t["exp_avg"], MOMENT_FLOOR) <= ULPS
        assert _ulps(s["exp_avg_sq"], t["exp_avg_sq"]) <= ULPS


@pytest.mark.parametrize("save_ours", [True, False],
                         ids=["port_to_torch", "torch_to_port"])
def test_state_dict_loads_into_torchs_adamw_and_back(tmp_path, host_kernel,
                                                     save_ours):
    """Saved from the port's AdamW through ``Checkpointer`` and restored
    into torch's, or the other way: the same state, key for key, and next
    updates that agree (``_close``).  Restored into the port's class, the
    groups are capturable and the step counts lie beside the parameters,
    where the kernel reads them, whatever the saved groups said."""
    def model_of(params):
        m = torch.nn.Module()
        for i, p in enumerate(params):
            m.register_parameter(f"p{i}", p)
        return m

    params = _params("cpu")
    model = model_of(params)
    opt = _port_adamw(params) if save_ours else _torch_adamw(params)
    _run(opt, params, 2)
    ck = train_lib.Checkpointer(str(tmp_path))
    ck.save(2, {"model": model, "opt": opt, "step": 2})
    fresh = _params("cpu", seed=5)
    other = _torch_adamw(fresh) if save_ours else _port_adamw(fresh)
    state = ck.restore(2, {"model": model_of(fresh), "opt": other,
                           "step": 0})
    assert state["step"] == 2 and type(other) is not type(opt)
    a, b = opt.state_dict(), other.state_dict()
    if not save_ours:
        assert all(g["capturable"] for g in b["param_groups"])
        for g in a["param_groups"] + b["param_groups"]:
            g["capturable"] = True
    assert a["param_groups"] == b["param_groups"]
    assert a["state"].keys() == b["state"].keys()
    for i, entry in a["state"].items():
        assert list(entry) == list(b["state"][i]) == [
            "step", "exp_avg", "exp_avg_sq"]
        for k, t in entry.items():
            assert torch.equal(t, b["state"][i][k]), (i, k)
    _run(opt, params, 2)
    _run(other, fresh, 2)
    _close(params, fresh)


def test_global_step_post_hook_fires_once_and_sees_the_moments(host_kernel):
    params = _params("cpu")
    opt = _port_adamw(params)
    _torch_adamw(_params("cpu"))  # torch's own step is wrapped too
    seen = []

    def hook(o, _args, _kwargs):
        seen.append([o.state[p]["exp_avg"].clone() for p in params])

    handle = register_optimizer_step_post_hook(hook)
    try:
        _run(opt, params, 2)
    finally:
        handle.remove()
    assert len(seen) == 2
    for p, m in zip(params, seen[-1]):
        assert torch.equal(m, opt.state[p]["exp_avg"])


def _dtensor_rank(rank):
    """One of two gloo ranks: ``SHAPES`` as DTensors sharded on dim 0 (the
    1-element one leaves rank 1 an empty shard), updated by the port's
    AdamW through the host stand-in and by torch's on the same start; the
    local shards compared (``_close``), and what the kernel route counted
    and held as DTensors."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    join()
    _host_kernel(setattr)
    mesh = init_device_mesh("cpu", (2,))
    runs = []
    for make in (lambda ps: _port_adamw(ps, lr_tensor=False), _torch_adamw):
        params = [torch.nn.Parameter(distribute_tensor(
            p.detach(), mesh, [Shard(0)])) for p in _params("cpu")[:-1]]
        opt = make(params)
        for u in range(len(LRS)):
            for p, g in zip(params, _grads("cpu", u)):
                p.grad = distribute_tensor(g, mesh, [Shard(0)])
            train_lib.set_lr(opt, LRS[u])
            opt.step()
        runs.append((params, opt))
    (params, opt), (ref, _) = runs
    _close([p.to_local() for p in params], [q.to_local() for q in ref])
    leave()
    return {"kernel": optim.UPDATES["kernel"],
            "local_sizes": [p.to_local().numel() for p in params],
            "moments_sharded": all(
                isinstance(opt.state[p][k], DTensor)
                and opt.state[p][k].placements == p.placements
                for p in params for k in ("exp_avg", "exp_avg_sq"))}


def test_fsdp_dtensors_take_the_kernel_through_their_shards(tmp_path):
    outs = spawn(_dtensor_rank, 2, tmp_path)
    n = len(SHAPES)
    for out in outs:
        assert out["kernel"] == len(LRS) * n
        assert out["moments_sharded"]
    assert [o["local_sizes"][0] for o in outs] == [1, 0]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the AdamW kernel)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("accum", [False, True], ids=["grads", "grad_accum"])
def test_kernel_matches_torchs_foreach_and_fused(accum):
    """Five updates at five lrs, both groups, every length and the
    unaligned view: the kernel's parameters within ``ULPS`` of torch's
    foreach route's and within ``ULPS`` and ``FUSED_RTOL`` of the lrs of
    fused=True's, its moments within ``ULPS`` of foreach's, the step
    counts equal; with ``accum``, from ``GradAccum``'s fp32 mean."""
    dev = _card()
    runs = {}
    for route in ("kernel", "foreach", "fused"):
        params = _params(dev)
        opt = (train_lib.adamw(params, LRS[0]) if route == "kernel"
               else _torch_adamw(params, capturable=True,
                                 **{"foreach": True} if route == "foreach"
                                 else {"fused": True}))
        counted = dict(optim.UPDATES)
        _run(opt, params, len(LRS),
             train_lib.with_grad_accum(params, 2) if accum else None)
        if route == "kernel":
            assert optim.UPDATES["kernel"] - counted["kernel"] == \
                len(LRS) * len(params)
        runs[route] = (params, opt)
    torch.cuda.synchronize()
    params, opt = runs["kernel"]
    for route, slack in (("foreach", 0.0), ("fused", FUSED_RTOL * sum(LRS))):
        ref, ref_opt = runs[route]
        for p, q in zip(params, ref):
            assert _ulps(p, q, PARAM_FLOOR, slack) <= ULPS, \
                (route, tuple(p.shape))
    ref, ref_opt = runs["foreach"]
    for p, q in zip(params, ref):
        s, t = opt.state[p], ref_opt.state[q]
        assert float(s["step"]) == float(t["step"]) == len(LRS)
        assert _ulps(s["exp_avg"], t["exp_avg"], MOMENT_FLOOR) <= ULPS
        assert _ulps(s["exp_avg_sq"], t["exp_avg_sq"]) <= ULPS


@pytest.mark.gpu
def test_captured_update_equals_the_eager_one_bit_for_bit():
    """Update 1 eager (it makes the state), updates 2-5 replayed from one
    ``step`` captured by the compiled step's ``_Graphs``, reading each
    update's lr and grads from static tensors: the parameters and moments
    of five eager updates, bit for bit; each replay counts the kernel's
    updates as its capture recorded them."""
    dev = _card()
    eager = _params(dev)
    eager_opt = train_lib.adamw(eager, LRS[0])
    _run(eager_opt, eager, len(LRS))

    params = _params(dev)
    opt = train_lib.adamw(params, LRS[0])
    _run(opt, params, 1)
    graphs = train_lib._Graphs(opt)
    graphs.inputs, graphs.updated = (), True  # update 1 made the state
    static = [torch.empty_like(p) for p in params]

    def capture():
        for p, g in zip(params, static):
            p.grad = g
        opt.step()
        return params[0].detach()

    counted = dict(optim.UPDATES)
    for u in range(1, len(LRS)):
        for s, g in zip(static, _grads(dev, u)):
            s.copy_(g)
        train_lib.set_lr(opt, LRS[u])
        graphs.replay("update", capture)
    assert optim.UPDATES["kernel"] - counted["kernel"] == \
        (len(LRS) - 1) * len(params)
    assert optim.UPDATES["torch"] == counted["torch"]
    torch.cuda.synchronize()
    for p, q in zip(params, eager):
        assert torch.equal(p, q)
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][k], eager_opt.state[q][k]), k


@pytest.mark.gpu
def test_kernel_splits_a_long_list_of_tensors_into_launches():
    """Lengths about the kernel's chunk of 8,192 elements, empty tensors
    among them, and more no-decay tensors than one launch's table holds
    (512): three updates within ``ULPS`` of torch's foreach route, the
    moments too, every tensor counted once an update."""
    dev = _card()
    lengths = [0, 1, 3, 4, 4097, 8192, 8193, 70_000] * 3
    shapes = [(n,) for n in lengths] + [(1, n) for n in lengths] + [(5,)] * 600
    gen = torch.Generator().manual_seed(3)
    init = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[torch.randn(s, generator=gen).to(dev) for s in shapes]
             for _ in range(3)]
    runs = []
    for route in ("kernel", "foreach"):
        params = [torch.nn.Parameter(t.to(dev)) for t in init]
        opt = (train_lib.adamw(params, LRS[0]) if route == "kernel"
               else _torch_adamw(params, capturable=True, foreach=True))
        assert len(opt.param_groups[1]["params"]) > 512
        counted = dict(optim.UPDATES)
        for u, gs in enumerate(grads):
            for p, g in zip(params, gs):
                p.grad = g
            train_lib.set_lr(opt, LRS[u])
            opt.step()
        if route == "kernel":
            assert optim.UPDATES["kernel"] - counted["kernel"] == \
                len(grads) * len(shapes)
        runs.append((params, opt))
    torch.cuda.synchronize()
    (params, opt), (ref, ref_opt) = runs
    for p, q in zip(params, ref):
        assert _ulps(p, q, PARAM_FLOOR) <= ULPS, tuple(p.shape)
        s, t = opt.state[p], ref_opt.state[q]
        assert _ulps(s["exp_avg"], t["exp_avg"], MOMENT_FLOOR) <= ULPS
        assert _ulps(s["exp_avg_sq"], t["exp_avg_sq"]) <= ULPS
