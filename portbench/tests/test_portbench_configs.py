"""Each configuration file carries its published widths and departures,
and BENCHMARK.json names them by the rules of the benchmark."""
import json

import pytest

from portbench import models
from portbench.tests.support import BENCH, benchmark, config_of, traffic_of

PUBLISHED = {
    "gpt2-medium": {"n_embd": 1024, "n_layer": 24, "n_head": 16, "n_ctx": 1024,
                    "n_positions": 1024, "vocab_size": 50257,
                    "activation_function": "gelu_new",
                    "layer_norm_epsilon": 1e-5, "resid_pdrop": 0.1,
                    "embd_pdrop": 0.1, "attn_pdrop": 0.1},
    "bert-large": {"hidden_size": 1024, "num_hidden_layers": 24,
                   "num_attention_heads": 16, "intermediate_size": 4096,
                   "max_position_embeddings": 512, "vocab_size": 30522,
                   "hidden_act": "gelu", "layer_norm_eps": 1e-12,
                   "hidden_dropout_prob": 0.1,
                   "attention_probs_dropout_prob": 0.1, "type_vocab_size": 2},
}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_published_values_and_departures(name):
    cfg = config_of(name)
    run = cfg["as_run"]
    published = {**run, **cfg["published"]}
    for key, value in PUBLISHED[name].items():
        assert published[key] == value, key
    changed = sorted(k for k in cfg["published"] if cfg["published"][k] != run[k])
    entry = {c["name"]: c for c in benchmark()["configs"]}[name]
    assert sorted(entry["reduced"]) == changed
    # no width or depth is cut: every changed key is one the port forces
    assert sorted(cfg["forced_by_the_program"]) == changed
    assert cfg["departures"] and cfg["source"].startswith(entry["source"])
    assert cfg["deployment"]


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_the_model_block_is_the_published_widths(name):
    cfg = config_of(name)
    run, m = cfg["as_run"], cfg["model"]
    if name == "gpt2-medium":
        widths = (run["n_embd"], run["n_layer"], run["n_head"],
                  4 * run["n_embd"], run["vocab_size"], run["n_positions"],
                  run["layer_norm_epsilon"])
    else:
        widths = (run["hidden_size"], run["num_hidden_layers"],
                  run["num_attention_heads"], run["intermediate_size"],
                  run["vocab_size"], run["max_position_embeddings"],
                  run["layer_norm_eps"])
    assert widths == (m["hidden"], m["layers"], m["heads"], m["intermediate"],
                      m["vocab"], m["max_positions"], m["layer_norm_eps"])
    assert m["init_std"] == run["initializer_range"]


def test_every_name_resolves_to_files():
    bench = benchmark()
    configs = {c["name"]: c for c in bench["configs"]}
    for cell in bench["workloads"]:
        cfg = json.loads((BENCH.parent / configs[cell["config"]]["file"]).read_text())
        spec = traffic_of(cell["traffic"])
        assert spec["objective"] == cfg["objective"]
        assert (BENCH / "limits" / f"{cell['name']}.json").exists()
        assert (BENCH / "references" / f"{cfg['reference']}.py").exists()
        assert (BENCH / "objectives" / f"{cfg['objective']}.py").exists()
        arch = models.of(cfg)
        assert all(callable(getattr(arch, f)) for f in
                   ("groups", "port_flags", "counts"))
        assert cell["chips"] == 1
    for m in bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    assert [m["name"] for m in bench["end_to_end"]] == [
        "train_tokens_per_s", "step_ms_p95", "peak_mem_gib", "setup_s"]
