"""The yardstick's arithmetic against figures worked out by hand."""
import pytest

from portbench import models, roofline, trace
from portbench.metrics import flash_roofline_pct, mfu_pct
from portbench.models import trunk
from portbench.tests.support import config_of


def test_model_flops_by_hand():
    gpt = config_of("gpt2-medium")["model"]
    # 24 x (4 x 1024^2 + 2 x 1024 x 4096) + 50257 x 1024, the head once
    assert trunk.matmul_params(gpt) == 24 * (4 * 1024 ** 2 + 2 * 1024 * 4096) + 50257 * 1024
    per_token = 6 * 353_453_056 + 12 * 24 * 1024 * 1024 // 2
    assert trunk.flops_per_call(gpt, 8, 1024) == 8192 * per_token


@pytest.mark.parametrize("config,batch,seq,tflop", [
    ("gpt2-medium", 8, 1024, 18.63),
    ("bert-large", 16, 512, 17.6),
    ("bert-large", 64, 128, 16.7),
])
def test_model_flops_match_the_issue(config, batch, seq, tflop):
    cfg = config_of(config)
    counts = models.of(cfg).counts(cfg["model"], batch, seq, True, 2)
    assert counts["flops_per_call"] / 1e12 == pytest.approx(tflop, rel=2e-3)


def test_attention_bound_of_the_main_shape():
    calls = roofline.attention_call_bytes_flops(8, 1024, 16, 64, True, 2)
    got = {k: round(roofline.bound(*bf)[0], 5) for k, bf in calls.items()}
    assert got == {"flash_fwd": 0.02019, "flash_dq": 0.02608,
                   "flash_dkv": 0.03478}
    assert [roofline.bound(*calls[k])[1] for k in got] == [
        "bytes", "operations", "operations"]


def test_attention_bound_a_call_counts_remat():
    gpt = config_of("gpt2-medium")["model"]
    ms = trunk.attention_bound_ms_per_call(gpt, 8, 1024, True, 2)
    calls = roofline.attention_call_bytes_flops(8, 1024, 16, 64, True, 2)
    one = {k: roofline.bound(*bf)[0] for k, bf in calls.items()}
    assert ms == pytest.approx(24 * (2 * one["flash_fwd"] + one["flash_dq"]
                                     + one["flash_dkv"]))
    assert trunk.attention_bound_ms_per_call(gpt, 8, 1024, False, 2) == \
        pytest.approx(ms - 24 * one["flash_fwd"])


def _summary(counts, peak=roofline.H100_BF16_FLOPS):
    # two calls in a 0.2 s window: 30 ms of flash and 50 of matmul
    kernels = [("void flash_fwd_kernel<64>(...)", 0.0, 30e3),
               ("nvjet_tst_256x128", 40e3, 50e3)]
    return trace.Summary(kernels, kernels, [], (0.0, 2e5), 2, counts, peak)


def test_the_readers_take_the_architectures_counts_and_the_one_peak():
    cfg = config_of("gpt2-medium")
    counts = models.of(cfg).counts(cfg["model"], 8, 1024, True, 2)
    t = _summary(counts)
    assert mfu_pct.read(t) == pytest.approx(
        100 * counts["flops_per_call"] * 2 / 0.2 / 989e12)
    assert flash_roofline_pct.read(t) == pytest.approx(
        100 * counts["attention_bound_ms_per_call"] / 15.0)


def test_a_reader_without_its_count_reads_nothing():
    t = _summary({})
    assert mfu_pct.read(t) is None and flash_roofline_pct.read(t) is None
    assert mfu_pct.read(_summary({"flops_per_call": 1.0}, peak=None)) is None
