"""Deep-layer MoE routing of the port's GPT against the JAX package's.

A 24-layer post-LN trunk from random weights routes a deep layer's tokens
to a few experts, so many assignments drop at capacity 1.25.  This holds
that share to the reference: both packages' GPTs, from one flax init
carried across (``convert.params_from_flax``), run the same token ids in
fp32, and each layer's routing is read from each package's own trunk
(the input of its MoE FFN, captured there, routed by that package's
code).  The chosen experts, each assignment's slot and the dropped count
of every layer are compared as integers; the port's model reports the
same dropped counts as its routing.

Run as a script for the table of dropped shares a layer:
    JAX_PLATFORMS=cpu python -m tests.test_torch_moe_depth \\
        --hidden 256 --layers 24 --seq-len 1024 --batch-size 2
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh

from tpujob.workloads import gpt as jgpt
from tpujob.workloads import parallel as jpar
from tpujob_torch.workloads import convert
from tpujob_torch.workloads import gpt as tgpt
from tpujob_torch.workloads import parallel as tpar


def _argv(hidden, layers, seq, batch, experts):
    return ["--hidden", str(hidden), "--layers", str(layers),
            "--heads", str(hidden // 64), "--intermediate", str(4 * hidden),
            "--vocab", "512", "--seq-len", str(seq),
            "--batch-size", str(batch), "--no-bf16", "--no-remat",
            "--moe-experts", str(experts)]


def _jax_routes(x, moe, k, cf):
    """The reference's ``moe_ffn`` on ``x`` run eagerly, its two one-hots
    recorded: the chosen experts [b, s, k] and each assignment's slot
    [b, k*s] (k-major)."""
    seen = []
    one_hot = jax.nn.one_hot

    def recording(idx, n, **kw):
        seen.append(np.asarray(idx))
        return one_hot(idx, n, **kw)

    jax.nn.one_hot = recording
    try:
        jpar.moe_ffn(x, moe["router"], moe["wi"], moe["wo"], k=k,
                     capacity_factor=cf)
    finally:
        jax.nn.one_hot = one_hot
    return seen[0], seen[1]


def routing_by_layer(hidden=256, layers=24, seq=128, batch=2, experts=8,
                     seed=0):
    """Each layer's routing in both packages: a list of dicts with the
    capacity, both packages' chosen experts and slots, both dropped counts
    and the port's model-reported count."""
    argv = _argv(hidden, layers, seq, batch, experts)
    ja = jgpt.build_parser().parse_args(argv)
    jm = jgpt.build_model(ja, Mesh(np.array(jax.devices()[:1]), ("data",)))
    ids = np.random.RandomState(seed + 1).randint(0, 512, (batch, seq))
    params = {"params": jm.init(jax.random.PRNGKey(seed),
                                jnp.zeros((1, seq), jnp.int32))["params"]}
    _, inter = jm.apply(params, jnp.asarray(ids, jnp.int32),
                        capture_intermediates=lambda m, _: m.name == "ln_attn")
    inter = inter["intermediates"]

    ta = tgpt.build_parser().parse_args(argv + ["--device", "cpu"])
    model = tgpt.build_model(ta, torch.device("cpu"))
    model.load_state_dict(convert.params_from_flax(
        jax.tree.map(np.asarray, params)), strict=True)
    seen = {}
    for i in range(layers):
        getattr(model, f"layer_{i}").ln_attn.register_forward_hook(
            lambda mod, inp, out, i=i: seen.__setitem__(i, out.detach()))
    with torch.no_grad():
        _, metrics = model(torch.from_numpy(ids), with_metrics=True)

    k, cf = ja.moe_k, ja.moe_capacity_factor
    cap = tpar.moe_capacity(seq, experts, k, cf)
    rows = []
    for i in range(layers):
        moe = params["params"][f"layer_{i}"]["moe"]
        j_idx, j_pos = _jax_routes(
            inter[f"layer_{i}"]["ln_attn"]["__call__"][0], moe, k, cf)
        mlp = getattr(model, f"layer_{i}").moe
        r = tpar.moe_route(seen[i], mlp.router, k, cap, None)
        rows.append({
            "layer": i, "cap": cap, "assignments": batch * seq * k,
            "jax_idx": j_idx, "jax_pos": j_pos,
            "port_idx": r.expert_idx.numpy(), "port_pos": r.pos.long().numpy(),
            "jax_dropped": int((j_pos >= cap).sum()),
            "port_dropped": int((1 - r.keep).sum()),
            "port_reported": int(metrics[i]["dropped"]),
        })
    return rows


def test_deep_routing_and_drops_match_jax():
    """GPT-2-medium's depth and MoE (24 layers, 8 experts, top-2, capacity
    1.25) at width 256: every layer's experts and slots equal as integers,
    so the share dropped is the reference's at every depth."""
    rows = routing_by_layer()
    for r in rows:
        np.testing.assert_array_equal(r["port_idx"], r["jax_idx"],
                                      err_msg=f"layer {r['layer']}")
        np.testing.assert_array_equal(r["port_pos"], r["jax_pos"],
                                      err_msg=f"layer {r['layer']}")
        assert r["port_dropped"] == r["jax_dropped"] == r["port_reported"]
    # the trap this guards: deep layers drop, shallow ones barely do
    assert rows[-1]["jax_dropped"] > 4 * max(rows[0]["jax_dropped"], 1)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=24)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--experts", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args()
    jax.config.update("jax_platforms", "cpu")
    rows = routing_by_layer(a.hidden, a.layers, a.seq_len, a.batch_size,
                            a.experts, a.seed)
    for r in rows:
        n = r["assignments"]
        print(json.dumps({
            "layer": r["layer"], "cap": r["cap"], "assignments": n,
            "jax_dropped": r["jax_dropped"], "port_dropped": r["port_dropped"],
            "port_reported": r["port_reported"],
            "jax_share": r["jax_dropped"] / n,
            "port_share": r["port_dropped"] / n,
            "experts_equal": bool((r["port_idx"] == r["jax_idx"]).all()),
            "slots_equal": bool((r["port_pos"] == r["jax_pos"]).all())}))
    tot = sum(r["assignments"] for r in rows)
    print(json.dumps({
        "jax_share": sum(r["jax_dropped"] for r in rows) / tot,
        "port_share": sum(r["port_dropped"] for r in rows) / tot}))


if __name__ == "__main__":
    main()
