"""The phase and idle readers on hand-built traces: the marks split each
call's kernels into forward, backward, fold and optimizer, which with the
kernels outside them add up to the window's kernel time; the device's idle
time goes to the innermost of the program's spans open at each instant."""
import pytest

from portbench import trace
from portbench.metrics import (_phases, backward_ms_per_step,
                               flash_ms_per_step, fold_ms_per_step,
                               forward_ms_per_step, idle_feed_ms_per_step,
                               idle_step_ms_per_step, matmul_ms_per_step,
                               optimizer_ms_per_step, other_ms_per_step)

PHASE_READERS = {"forward": forward_ms_per_step,
                 "backward": backward_ms_per_step,
                 "fold": fold_ms_per_step,
                 "optimizer": optimizer_ms_per_step}


def _call(t0, fold, update):
    """One call's kernels from ``t0`` (us): a fill before the begin mark,
    then per phase one kernel of each class, marks of 2 us between."""
    k = [("fill_kernel", t0, 5.0), ("tpujob_mark_begin", t0 + 10, 2.0),
         ("void flash_fwd_kernel<64>", t0 + 20, 300.0),
         ("nvjet_tst_256x128", t0 + 400, 200.0),
         ("tpujob_mark_forward", t0 + 700, 2.0),
         ("void flash_dq_kernel<64>", t0 + 710, 400.0),
         ("layer_norm_backward", t0 + 1200, 100.0),
         ("tpujob_mark_backward", t0 + 1400, 2.0)]
    t = t0 + 1410
    if fold:
        k += [("add_kernel", t, 50.0), ("tpujob_mark_fold", t + 60, 2.0)]
        t += 70
    if update:
        k += [("multi_tensor_apply_kernel", t, 80.0),
              ("tpujob_mark_update", t + 90, 2.0)]
        t += 100
    k.append(("copy_kernel", t, 4.0))  # the output's clone
    return k


def _summary(kernels, spans=(), window=(0.0, 1e4), calls=2):
    return trace.Summary(kernels, kernels, list(spans), window, calls, {},
                         None)


@pytest.mark.parametrize("fold,update,phases", [
    (False, (True, True), {"forward": 500.0, "backward": 500.0,
                           "optimizer": 80.0}),
    (True, (False, True), {"forward": 500.0, "backward": 500.0,
                           "fold": 50.0, "optimizer": 40.0}),
])
def test_phases_and_the_kernels_outside_add_up_to_the_window(fold, update,
                                                             phases):
    t = _summary(_call(0.0, fold, update[0]) + _call(3000.0, fold, update[1]))
    got = {p: r.read(t) for p, r in PHASE_READERS.items()}
    assert got == {p: pytest.approx(phases[p] / 1e3) if p in phases else None
                   for p in PHASE_READERS}
    by_phase = _phases.kernel_ms_by_phase(t)
    whole = (other_ms_per_step.read(t) + matmul_ms_per_step.read(t)
             + flash_ms_per_step.read(t))
    assert sum(by_phase.values()) == pytest.approx(whole)
    marks = sum(3 + fold + u for u in update)  # 2 us each
    # the fill and the clone, 9 us a call, and the marks
    assert by_phase[_phases.OUTSIDE] == pytest.approx((9.0 + marks) / 1e3)


def test_a_trace_without_marks_or_spans_reads_nothing():
    kernels = [("nvjet_tst_256x128", 0.0, 100.0), ("fill_kernel", 200.0, 5.0)]
    t = _summary(kernels, spans=[("portbench.traffic", 100.0, 50.0)])
    for reader in list(PHASE_READERS.values()) + [idle_feed_ms_per_step,
                                                  idle_step_ms_per_step]:
        assert reader.read(t) is None
    assert idle_feed_ms_per_step.read(_summary([], spans=[
        ("tpujob.feed", 0.0, 10.0)])) is None  # no device operation


def test_idle_goes_to_the_innermost_span_open_at_each_instant():
    # busy 0-100 and 400-1000 in a window of 0-1000 us, one call: idle
    # 100-400.  On the host: feed 50-250 holding the benchmark's traffic
    # span 60-120; step 250-1000 holding inputs 250-280 and launch
    # 290-410; nothing of the loop's 280-290.
    kernels = [("k0", 0.0, 100.0), ("k1", 400.0, 600.0)]
    spans = [("tpujob.feed", 50.0, 200.0), ("portbench.traffic", 60.0, 60.0),
             ("tpujob.step", 250.0, 750.0),
             ("tpujob.step.inputs", 250.0, 30.0),
             ("tpujob.step.launch", 290.0, 120.0),
             ("portbench.on_step", 1000.0, 10.0)]
    t = _summary(kernels, spans, window=(0.0, 1000.0), calls=1)
    assert idle_feed_ms_per_step.read(t) == pytest.approx(0.150)
    # inputs 30, the step itself 10 (280-290), launch 110 (290-400)
    assert idle_step_ms_per_step.read(t) == pytest.approx(0.150)
    idle = _phases.idle_ms_by_span(t)
    assert idle == pytest.approx({"tpujob.feed": 0.150,
                                  "tpujob.step.inputs": 0.030,
                                  "tpujob.step": 0.010,
                                  "tpujob.step.launch": 0.110})
    window_idle = (t.window_s - t.busy_s) * 1e3
    assert sum(idle.values()) == pytest.approx(window_idle)


def test_idle_outside_every_span_is_kept_apart():
    kernels = [("k0", 0.0, 100.0), ("k1", 500.0, 500.0)]
    spans = [("tpujob.log", 150.0, 100.0)]
    t = _summary(kernels, spans, window=(0.0, 1000.0), calls=2)
    idle = _phases.idle_ms_by_span(t)
    assert idle == pytest.approx({"tpujob.log": 0.050, None: 0.150})
    assert idle_feed_ms_per_step.read(t) == 0.0
    assert idle_step_ms_per_step.read(t) == 0.0
