"""The port's progress heartbeat (``tpujob_torch.workloads.distributed``
``format_progress``, ``ProgressReporter``, ``pod_progress_patch``,
``pod_patch_publisher``, ``progress_publisher_from_env``) and
``train_lib.TrainTelemetry`` against the JAX package's and the
controller's parser (``tpujob.api.progress``).

Everything here is held exactly: the same heartbeat strings, the same
publish decisions on a fake clock, the same smoothed rate.  One publish
goes over HTTP to the REST shim of ``tests/k8sshim.py`` on localhost.
"""
import urllib.error

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.k8sshim import K8sRestShim
from tpujob.api import constants as c
from tpujob.api.progress import format_progress as jformat
from tpujob.api.progress import parse_progress
from tpujob.workloads import distributed as jdist
from tpujob.workloads import train_lib as jtl
from tpujob_torch.workloads import distributed as tdist
from tpujob_torch.workloads import train_lib


@settings(max_examples=200, deadline=None)
@given(st.integers(0, 10**12),
       st.one_of(st.none(), st.floats(0, 1e9, allow_nan=False)),
       st.one_of(st.none(), st.integers(0, 10**12)),
       st.integers(0, 10**6),
       st.one_of(st.none(), st.floats(0, 2e9, allow_nan=False)))
def test_format_progress_matches_the_wire_format(step, sps, ckpt, gen, t):
    got = tdist.format_progress(step, samples_per_sec=sps,
                                checkpoint_step=ckpt, resize_generation=gen,
                                published_at=t)
    assert got == jformat(step, samples_per_sec=sps, checkpoint_step=ckpt,
                          resize_generation=gen, published_at=t)
    parsed = parse_progress(got)
    assert parsed.step == step and parsed.checkpoint_step == ckpt
    assert parsed.resize_generation == gen
    assert (parsed.samples_per_sec is None) == (sps is None)


def test_annotation_key_and_patch_body_match():
    assert tdist.ANNOTATION_PROGRESS == c.ANNOTATION_PROGRESS
    assert tdist.POD_NAME_ENV == jdist.POD_NAME_ENV
    assert tdist.POD_NAMESPACE_ENV == jdist.POD_NAMESPACE_ENV
    assert tdist.pod_progress_patch("step=3") == \
        jdist.pod_progress_patch("step=3")


def _fields(value):
    p = parse_progress(value)
    return (p.step, p.samples_per_sec, p.checkpoint_step, p.resize_generation)


# (clock, step, force) of each report
SCHEDULE = [(0.0, 1, False), (3.0, 2, False), (9.9, 3, False),
            (10.0, 4, False), (10.5, 5, True), (15.0, 6, False),
            (20.4, 7, False), (20.5, 8, False), (50.0, 9, False)]


def test_reporter_decisions_match_jax_on_a_fake_clock():
    """The rate limit (10 s from the last attempt) and the forced publishes
    give the same shipped/skipped answers and the same values."""
    out = {}
    for name, cls in (("port", tdist.ProgressReporter),
                      ("jax", jdist.ProgressReporter)):
        clock = {"t": 0.0}
        shipped = []
        r = cls(shipped.append, interval_s=10.0, clock=lambda: clock["t"])
        answers = []
        for t, step, force in SCHEDULE:
            clock["t"] = t
            answers.append(r.report(step, samples_per_sec=step * 2.5,
                                    checkpoint_step=step - 1 or None,
                                    resize_generation=1, force=force))
        out[name] = (answers, [_fields(v) for v in shipped], r.published)
    assert out["port"] == out["jax"]
    # a forced publish restarts the interval too (10.5 -> 20.5)
    assert out["port"][0] == [True, False, False, True, True, False, False,
                              True, True]


def test_failed_publish_is_swallowed_and_rate_limited_alike():
    out = {}
    for name, cls in (("port", tdist.ProgressReporter),
                      ("jax", jdist.ProgressReporter)):
        clock = {"t": 0.0}
        calls = []

        def dead(value):
            calls.append(value)
            raise OSError("apiserver down")

        r = cls(dead, interval_s=5.0, clock=lambda: clock["t"])
        answers = [r.report(1), r.report(2)]
        clock["t"] = 6.0
        answers.append(r.report(3))
        out[name] = (answers, len(calls), r.published)
    assert out["port"] == out["jax"] == ([False, False, False], 2, 0)


def test_disabled_reporter_publishes_nothing():
    r = tdist.ProgressReporter(None)
    assert not r.enabled and r.report(1, force=True) is False


@pytest.mark.parametrize("env", [
    {},
    {"TPUJOB_POD_NAME": "job-worker-0"},
    {"TPUJOB_POD_NAME": "job-worker-0", "KUBERNETES_SERVICE_HOST": "10.0.0.1",
     "KUBERNETES_SERVICE_PORT": "443"},
])
def test_publisher_is_none_without_identity_or_cluster(env, tmp_path):
    """No pod identity, or no in-cluster config (here: no service-account
    token under ``sa_dir``): telemetry off, as in the JAX package."""
    assert tdist.progress_publisher_from_env(env, sa_dir=str(tmp_path)) is None
    if "KUBERNETES_SERVICE_HOST" not in env:
        assert jdist.progress_publisher_from_env(env) is None


def test_publisher_built_from_the_service_account(tmp_path):
    """With the identity, the API server's address and a token, the
    publisher is a callable (built, not called: the address is not
    reachable from a test)."""
    (tmp_path / "token").write_text("abc\n")
    env = {"TPUJOB_POD_NAME": "p", "TPUJOB_POD_NAMESPACE": "team",
           "KUBERNETES_SERVICE_HOST": "fd00::1",
           "KUBERNETES_SERVICE_PORT": "6443"}
    assert callable(tdist.progress_publisher_from_env(env,
                                                      sa_dir=str(tmp_path)))
    (tmp_path / "ca.crt").write_text("not a certificate")
    assert tdist.progress_publisher_from_env(env, sa_dir=str(tmp_path)) \
        is None


def test_one_patch_through_the_rest_shim(tmp_path):
    """A heartbeat published by the port lands on the pod's annotation as a
    merge patch that keeps the other annotations, and the controller's
    parser reads it; a wrong token is refused and the reporter swallows
    the refusal."""
    shim = K8sRestShim(token="s3cret").start()
    try:
        shim.backend.create("pods", {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "job-worker-0", "namespace": "team",
                         "annotations": {"other": "kept"}},
            "spec": {"containers": [{"name": "c", "image": "i"}]}})
        token = tmp_path / "token"
        token.write_text("s3cret\n")
        publish = tdist.pod_patch_publisher(shim.url, "team", "job-worker-0",
                                            token_file=str(token))
        reporter = tdist.ProgressReporter(publish)
        assert reporter.report(120, samples_per_sec=512.0, checkpoint_step=100)
        pod = shim.backend.get("pods", "team", "job-worker-0")
        notes = pod["metadata"]["annotations"]
        assert notes["other"] == "kept"
        parsed = parse_progress(notes[c.ANNOTATION_PROGRESS])
        assert (parsed.step, parsed.samples_per_sec,
                parsed.checkpoint_step) == (120, 512.0, 100)

        token.write_text("wrong")
        with pytest.raises(urllib.error.HTTPError) as err:
            publish("step=121")
        assert err.value.code == 401
        assert reporter.report(121, force=True) is False
        missing = tdist.pod_patch_publisher(shim.url, "team", "gone",
                                            token_file=str(tmp_path / "t2"))
        (tmp_path / "t2").write_text("s3cret")
        with pytest.raises(urllib.error.HTTPError) as err:
            missing("step=1")
        assert err.value.code == 404
    finally:
        shim.stop()


def test_train_telemetry_matches_jax_on_a_fake_clock():
    """The smoothed samples/s, the heartbeats and the forced ones at a
    checkpoint and at close are the JAX package's."""
    out = {}
    for name, tl, dist in (("port", train_lib, tdist), ("jax", jtl, jdist)):
        clock = {"t": 100.0}
        shipped = []
        rep = dist.ProgressReporter(shipped.append, interval_s=1.0,
                                    clock=lambda: clock["t"])
        tel = tl.TrainTelemetry(rep, enabled=True, clock=lambda: clock["t"])
        rates = []
        for i, dt in enumerate([0.0, 0.5, 0.25, 1.0, 0.1, 2.0]):
            clock["t"] += dt
            tel.step(i + 1, samples=64, resize_generation=2 if i > 3 else None)
            rates.append(tel.samples_per_sec)
        tel.checkpointed(6)
        tel.close()
        out[name] = (rates, [_fields(v) for v in shipped], tel.step_count,
                     tel.checkpoint_step, tel.resize_generation)
    assert out["port"] == out["jax"]
    assert out["port"][0][0] is None and out["port"][0][1] == 128.0


def test_train_telemetry_off_the_coordinator_and_from_env(monkeypatch):
    shipped = []
    tel = train_lib.TrainTelemetry(tdist.ProgressReporter(shipped.append),
                                   enabled=False)
    tel.step(1, samples=8)
    tel.close()
    assert tel.reporter is None and shipped == []
    monkeypatch.delenv("TPUJOB_POD_NAME", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("TPUJOB_PROCESS_ID", raising=False)
    tel = train_lib.TrainTelemetry.from_env()
    assert tel.reporter is not None and not tel.reporter.enabled
    tel.step(1, samples=8)
    tel.close()  # nothing to publish to, nothing raised
