"""The Mellum2 configuration and cell: the file holds the published
configuration but for the keys ``reduced`` names, the architecture's
counts match figures worked out by hand, the three readers of the expert
layer and ``flash_roofline_pct`` (on the window-aware attention bound)
read a hand-built trace, and the reference imports nothing of the port."""
import json

import pytest

from portbench import models, roofline, trace
from portbench.metrics import (flash_roofline_pct, mfu_pct,
                               moe_gemm_ms_per_step, moe_gemm_roofline_pct,
                               moe_ms_per_step)
from portbench.models import mellum
from portbench.tests.support import BENCH, benchmark, config_of, traffic_of
from portbench.tests.test_portbench_hygiene import top_names

NAME, CELL = "mellum2-12b-a2.5b", "mellum2.pretrain.s8192"
SOURCE = ("https://huggingface.co/JetBrains/Mellum2-12B-A2.5B-Instruct/"
          "blob/main/config.json")
SLIDING, FULL = "sliding_attention", "full_attention"
# the published config.json, as the model's card gives it
PUBLISHED = {
    "attention_bias": False, "head_dim": 128, "hidden_act": "silu",
    "hidden_size": 2304, "intermediate_size": 7168,
    "layer_types": [SLIDING, SLIDING, SLIDING, FULL] * 7,
    "mlp_layer_types": ["sparse"] * 28, "max_position_embeddings": 131072,
    "max_window_layers": 0, "model_type": "mellum",
    "moe_intermediate_size": 896, "norm_topk_prob": True,
    "num_attention_heads": 32, "num_experts": 64, "num_experts_per_tok": 8,
    "num_hidden_layers": 28, "num_key_value_heads": 4, "rms_norm_eps": 1e-06,
    "rope_parameters": {
        "full_attention": {"rope_type": "yarn", "rope_theta": 500000,
                           "factor": 16,
                           "original_max_position_embeddings": 8192,
                           "beta_fast": 32, "beta_slow": 1,
                           "attention_factor": 1.2772588722239782},
        "sliding_attention": {"rope_type": "default", "rope_theta": 500000}},
    "sliding_window": 1024, "tie_word_embeddings": False,
    "vocab_size": 98304, "use_sliding_window": True,
}


def entry():
    return {c["name"]: c for c in benchmark()["configs"]}[NAME]


def test_the_file_is_the_published_config_but_for_the_reduced_keys():
    cfg = config_of(NAME)
    changed = sorted(k for k, v in PUBLISHED.items() if cfg[k] != v)
    assert changed == sorted(entry()["reduced"]) == ["num_hidden_layers",
                                                     "vocab_size"]
    assert (cfg["num_hidden_layers"], cfg["vocab_size"]) == (4, 98304 // 8)
    assert {k: cfg["published"][k] for k in changed} == \
        {k: PUBLISHED[k] for k in changed}
    assert entry()["source"] == cfg["source"] == SOURCE
    assert set(cfg["reduced_why"]) == set(changed)
    assert {"initializer_range", "router_aux_loss", "router_z_loss"} <= \
        set(cfg["assumed"])
    assert "7 pipeline stages" in cfg["deployment"]
    assert any("MTP" in d for d in cfg["departures"])


def test_the_model_block_is_the_published_widths():
    cfg = config_of(NAME)
    m, yarn = cfg["model"], cfg["rope_parameters"]["full_attention"]
    assert (m["hidden"], m["heads"], m["kv_heads"], m["head_dim"],
            m["expert_width"], m["experts"], m["top_k"], m["window"],
            m["rms_norm_eps"], m["rope_theta"], m["init_std"]) == (
        cfg["hidden_size"], cfg["num_attention_heads"],
        cfg["num_key_value_heads"], cfg["head_dim"],
        cfg["moe_intermediate_size"], cfg["num_experts"],
        cfg["num_experts_per_tok"], cfg["sliding_window"],
        cfg["rms_norm_eps"], yarn["rope_theta"], 0.02)
    assert (m["layers"], m["vocab"]) == (cfg["num_hidden_layers"],
                                         cfg["vocab_size"])
    assert m["layer_types"] == cfg["layer_types"][: m["layers"]]
    assert {k: yarn[k] for k in m["yarn"]} == m["yarn"]
    assert mellum.windows(m) == [1024, 1024, 1024, 0]
    assert cfg["architecture"] == cfg["reference"] == "mellum"
    assert cfg["objective"] == traffic_of("lm.b2s8192")["objective"] == "lm"


def test_parameters_and_counts_by_hand():
    m = config_of(NAME)["model"]
    layout = mellum.groups(m)
    sizes = {n: s for group in layout for n, s, _ in group}
    per_layer = sum(_numel(s) for n, s in sizes.items()
                    if n.startswith("layer_0."))
    assert per_layer == 417_747_456
    assert sum(_numel(s) for s in sizes.values()) == 1_727_615_232
    assert _numel(sizes["layer_0.moe.wi"]) + _numel(
        sizes["layer_0.moe.wo"]) == 396_361_728
    counts = models.of(config_of(NAME)).counts(m, 2, 8192, True, 2)
    # 6 x (4 x (21,233,664 + 147,456 + 8 x 3 x 2304 x 896) + 12288 x 2304)
    # a token, plus 12 x 4096 x the visible pairs of three windowed layers
    # and one causal one
    pairs = 3 * (1024 * 1025 // 2 + (8192 - 1024) * 1024) + 8192 * 8193 // 2
    tokens = 16_384
    assert counts["flops_per_call"] == 6 * 312_016_896 * tokens \
        + 12 * 4096 * pairs * 2
    assert counts["flops_per_call"] / 1e12 == pytest.approx(36.29, abs=5e-3)
    # 4 passes x 6 R h f x 4 layers, R = 131,072 rows, at 989 TFLOP/s
    assert counts["moe_gemm_bound_ms_per_call"] == pytest.approx(
        4 * 6 * 131072 * 2304 * 896 * 4 / 989e12 * 1e3, rel=1e-9)
    assert counts["moe_gemm_bound_ms_per_call"] == pytest.approx(26.3,
                                                                 abs=0.05)
    calls = roofline.attention_call_bytes_flops(2, 8192, 32, 128, True, 2,
                                                1024)
    one = {k: roofline.bound(*bf)[0] for k, bf in calls.items()}
    full = {k: roofline.bound(*bf)[0] for k, bf in
            roofline.attention_call_bytes_flops(2, 8192, 32, 128, True,
                                                2).items()}
    # remat: two forwards a layer
    assert counts["attention_bound_ms_per_call"] == pytest.approx(
        3 * (2 * one["flash_fwd"] + one["flash_dq"] + one["flash_dkv"])
        + 2 * full["flash_fwd"] + full["flash_dq"] + full["flash_dkv"])


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def _call(t0):
    """One call: a forward expert layer and a backward one between their
    marks, a recompute whose moe_in the backward's closes, flash and a
    matmul outside them."""
    return [("void flash_fwd_any_kernel<__nv_bfloat16, 128>", t0, 300.0),
            ("tpujob_mark_moe_in", t0 + 400, 2.0),
            ("tpujob_moe_gemm_fwd", t0 + 410, 500.0),
            ("gather_kernel", t0 + 920, 80.0),
            ("tpujob_mark_moe_out", t0 + 1010, 2.0),
            ("nvjet_tst_192x192", t0 + 1020, 100.0),
            ("tpujob_mark_moe_in", t0 + 1200, 2.0),    # the recompute
            ("tpujob_moe_gemm_fwd", t0 + 1210, 500.0),
            ("tpujob_mark_moe_in", t0 + 1800, 2.0),    # the backward
            ("tpujob_moe_gemm_dx", t0 + 1810, 400.0),
            ("tpujob_moe_gemm_dw", t0 + 2220, 300.0),
            ("tpujob_mark_moe_out", t0 + 2600, 2.0),
            ("void flash_dq_any_kernel<__nv_bfloat16, 128>", t0 + 2610,
             200.0)]


def test_the_expert_layer_readers_on_a_hand_built_trace():
    counts = {"moe_gemm_bound_ms_per_call": 0.85,
              "attention_bound_ms_per_call": 0.25,
              "flops_per_call": 1e9}
    kernels = _call(0.0) + _call(3000.0)
    t = trace.Summary(kernels, kernels, [], (0.0, 6000.0), 2, counts,
                      roofline.H100_BF16_FLOPS)
    assert moe_ms_per_step.read(t) == pytest.approx(1.78)
    assert moe_gemm_ms_per_step.read(t) == pytest.approx(1.7)
    assert moe_gemm_roofline_pct.read(t) == pytest.approx(50.0)
    assert flash_roofline_pct.read(t) == pytest.approx(50.0)
    assert mfu_pct.read(t) is not None
    plain = [k for k in kernels if "moe" not in k[0]]
    t = trace.Summary(plain, plain, [], (0.0, 6000.0), 2, {}, None)
    assert [r.read(t) for r in (moe_ms_per_step, moe_gemm_ms_per_step,
                                moe_gemm_roofline_pct,
                                flash_roofline_pct)] == [None] * 4


def test_the_cell_and_its_metrics_in_the_benchmark():
    bench = benchmark()
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        NAME, "lm.b2s8192", 1)
    spec = traffic_of("lm.b2s8192")
    assert (spec["batch_size"], spec["seq_len"], spec["grad_accum"]) == (
        2, 8192, 1)
    assert spec["tokens"] == {"law": "zipf", "exponent": 1.0}
    assert spec["optimizer"] == traffic_of("gpt.b8s1024")["optimizer"]
    new = {"moe_ms_per_step", "moe_gemm_ms_per_step", "moe_gemm_roofline_pct"}
    for m in bench["per_layer"]:
        if m["name"] in new:
            assert m["workloads"] == [CELL]
    assert new <= {m["name"] for m in bench["per_layer"]}
    for item in bench["configs"] + bench["workloads"]:
        assert len(item["why"]) <= 200
    limits = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
    assert set(limits["numbers"]) == {"loss_gap", "grad_norm_gap",
                                      "change_norm_gap"}


@pytest.mark.parametrize("path", ["references/mellum.py", "references/trunk.py",
                                  "models/mellum.py"])
def test_the_reference_imports_nothing_of_the_port(path):
    names = top_names(BENCH / path)
    assert not names & {"tpujob_torch", "tpujob", "jax", "jaxlib", "flax"}
