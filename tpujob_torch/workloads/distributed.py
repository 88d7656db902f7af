"""Workload-side bootstrap: the consumer of the injected env.

The operator injects either the ``TPUJOB_*`` variables or the
torch.distributed spelling (``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
``RANK``); ``process_env`` reads both, exactly as the JAX package's
``tpujob/workloads/distributed.py`` does (this is a copy of its
JAX-free part, so the port imports nothing of ``tpujob``).

Only single-process jobs run in this port so far: a multi-process env
raises from ``initialize`` instead of training one replica alone.

The other direction, workload to controller, is the progress heartbeat:
``ProgressReporter`` publishes a ``tpujob.dev/progress`` record (the
port's copy of ``format_progress``, the wire format the controller parses)
on the pod's own annotation, rate-limited, through a small in-cluster
client (``progress_publisher_from_env``: the service account's token and
CA, one merge-patch ``PATCH`` through ``urllib``).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import ssl
import time
import urllib.request
from typing import Callable, Dict, Optional, Tuple

log = logging.getLogger("tpujob_torch.workloads")


@dataclasses.dataclass(frozen=True)
class ProcessEnv:
    """The injected cluster spec, parsed."""

    coordinator_address: Optional[str]
    num_processes: int
    process_id: int
    num_slices: int
    slice_id: int
    devices_per_host: Optional[int]
    global_devices: Optional[int]
    accelerator: Optional[str]
    topology: Optional[str]

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


def _geti(env: Dict[str, str], key: str, default: Optional[int] = None) -> Optional[int]:
    v = env.get(key)
    if v is None or v == "":
        return default
    return int(v)


def process_env(env: Optional[Dict[str, str]] = None) -> ProcessEnv:
    """Parse TPUJOB_* (preferred) or MASTER_ADDR-compat env into a ProcessEnv."""
    e = dict(os.environ) if env is None else env
    coord = e.get("TPUJOB_COORDINATOR_ADDRESS")
    if coord is None and e.get("MASTER_ADDR"):
        coord = f"{e['MASTER_ADDR']}:{e.get('MASTER_PORT', '23456')}"
    num = _geti(e, "TPUJOB_NUM_PROCESSES") or _geti(e, "WORLD_SIZE", 1) or 1
    pid = _geti(e, "TPUJOB_PROCESS_ID")
    if pid is None:
        pid = _geti(e, "RANK", 0) or 0
    return ProcessEnv(
        coordinator_address=coord,
        num_processes=num,
        process_id=pid,
        num_slices=_geti(e, "TPUJOB_NUM_SLICES", 1) or 1,
        slice_id=_geti(e, "TPUJOB_SLICE_ID", 0) or 0,
        devices_per_host=_geti(e, "TPUJOB_DEVICES_PER_HOST"),
        global_devices=_geti(e, "TPUJOB_GLOBAL_DEVICES"),
        accelerator=e.get("TPU_ACCELERATOR_TYPE"),
        topology=e.get("TPU_TOPOLOGY"),
    )


def initialize(env: Optional[ProcessEnv] = None) -> ProcessEnv:
    """The single-process half of ``init_process_group``.

    A single-process job needs no rendezvous.  A multi-process env raises:
    the process group and DDP are not ported yet, and training one replica
    alone while the others do the same would silently waste the job."""
    pe = env or process_env()
    if pe.is_distributed:
        raise NotImplementedError(
            f"multi-process training is not yet ported to tpujob_torch "
            f"(env asks for {pe.num_processes} processes); run one process")
    log.info("single-process job; no process group")
    return pe


def local_batch_slice(global_batch: int, env: Optional[ProcessEnv] = None) -> Tuple[int, int]:
    """(start, size) of this process's rows of the global batch."""
    pe = env or process_env()
    if global_batch % pe.num_processes != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by {pe.num_processes} processes"
        )
    per = global_batch // pe.num_processes
    return pe.process_id * per, per


# ---------------------------------------------------------------------------
# progress heartbeats: the workload -> controller telemetry channel
# ---------------------------------------------------------------------------

# the annotation the controller reads (``tpujob.api.constants``)
ANNOTATION_PROGRESS = "tpujob.dev/progress"
# the pod's own identity, injected by the operator; absent = not running
# under it, and the reporter stays disabled
POD_NAME_ENV = "TPUJOB_POD_NAME"
POD_NAMESPACE_ENV = "TPUJOB_POD_NAMESPACE"
# where the kubelet mounts the pod's service account
SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def format_progress(step: int, samples_per_sec: Optional[float] = None,
                    checkpoint_step: Optional[int] = None,
                    resize_generation: int = 0,
                    published_at: Optional[float] = None) -> str:
    """One heartbeat value, ``step=1200 sps=3411.5 ckpt=1100 gen=2
    t=1722772000.123`` (every field but ``step`` optional): the wire format
    of ``tpujob/api/progress.py``, which the controller parses."""
    parts = [f"step={int(step)}"]
    if samples_per_sec is not None:
        parts.append(f"sps={float(samples_per_sec):.6g}")
    if checkpoint_step is not None:
        parts.append(f"ckpt={int(checkpoint_step)}")
    if resize_generation:
        parts.append(f"gen={int(resize_generation)}")
    if published_at is not None:
        parts.append(f"t={float(published_at):.3f}")
    return " ".join(parts)


class ProgressReporter:
    """Rate-limited publisher of the progress heartbeat.

    ``publish(value)`` ships one annotation value and may raise; a failure
    is logged (at most once a minute) and dropped, because telemetry must
    never stop training.  ``interval_s`` bounds the publish rate: a 10 ms
    step loop heartbeats every few seconds, not every step."""

    def __init__(self, publish: Optional[Callable[[str], None]],
                 interval_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.publish = publish
        self.interval_s = interval_s
        self._clock = clock
        self._last_pub: Optional[float] = None
        self._last_warn: Optional[float] = None
        self.published = 0  # successful publishes

    @property
    def enabled(self) -> bool:
        return self.publish is not None

    def report(self, step: int, samples_per_sec: Optional[float] = None,
               checkpoint_step: Optional[int] = None,
               resize_generation: int = 0, force: bool = False) -> bool:
        """Publish one heartbeat unless rate-limited; True when it shipped.
        ``force`` bypasses the interval (checkpoint saves, loop exit)."""
        if self.publish is None:
            return False
        now = self._clock()
        if (not force and self._last_pub is not None
                and now - self._last_pub < self.interval_s):
            return False
        value = format_progress(
            step, samples_per_sec=samples_per_sec,
            checkpoint_step=checkpoint_step,
            resize_generation=resize_generation, published_at=time.time())
        # stamped before the attempt: a failing transport must not turn
        # every step into a publish attempt
        self._last_pub = now
        try:
            self.publish(value)
        except Exception as e:  # noqa: TPL005 - telemetry is best-effort;
            # a dead transport must not kill training (warned, rate-limited)
            if self._last_warn is None or now - self._last_warn >= 60.0:
                self._last_warn = now
                log.warning("progress heartbeat publish failed: %s", e)
            return False
        self.published += 1
        return True


def pod_progress_patch(value: str) -> Dict[str, Dict[str, Dict[str, str]]]:
    """The merge-patch body of one heartbeat: only this annotation key, so
    it composes with every other writer of the pod's metadata."""
    return {"metadata": {"annotations": {ANNOTATION_PROGRESS: value}}}


PUBLISH_TIMEOUT_S = 5.0  # the longest one heartbeat may hold up the step loop


def pod_patch_publisher(base_url: str, namespace: str, pod: str, *,
                        token_file: Optional[str] = None,
                        context: Optional[ssl.SSLContext] = None
                        ) -> Callable[[str], None]:
    """``publish(value)``: one ``PATCH`` of the pod with
    ``application/merge-patch+json`` at ``base_url`` (the API server).  The
    bearer token is read from ``token_file`` at every publish (the kubelet
    rotates it); a non-2xx answer raises ``urllib.error.HTTPError``.  The
    API server is reached directly, never through a proxy from the env."""
    url = f"{base_url}/api/v1/namespaces/{namespace}/pods/{pod}"
    opener = urllib.request.build_opener(
        urllib.request.ProxyHandler({}),
        urllib.request.HTTPSHandler(context=context))

    def publish(value: str) -> None:
        req = urllib.request.Request(
            url, method="PATCH",
            data=json.dumps(pod_progress_patch(value)).encode(),
            headers={"Content-Type": "application/merge-patch+json",
                     "Accept": "application/json"})
        if token_file:
            with open(token_file) as f:
                req.add_header("Authorization", f"Bearer {f.read().strip()}")
        with opener.open(req, timeout=PUBLISH_TIMEOUT_S) as resp:
            resp.read()

    return publish


def progress_publisher_from_env(env: Optional[Dict[str, str]] = None,
                                sa_dir: str = SERVICE_ACCOUNT_DIR
                                ) -> Optional[Callable[[str], None]]:
    """The in-cluster publisher: the pod patches its own annotation through
    the API server at ``KUBERNETES_SERVICE_HOST``/``_PORT``, with the
    service account's token and CA under ``sa_dir``.  None (telemetry off)
    without the pod identity (``TPUJOB_POD_NAME``, ``_NAMESPACE``) or
    without that cluster config: a local run, a dryrun, a test."""
    e = dict(os.environ) if env is None else env
    pod = e.get(POD_NAME_ENV)
    if not pod:
        return None
    namespace = e.get(POD_NAMESPACE_ENV) or "default"
    host = e.get("KUBERNETES_SERVICE_HOST")
    port = e.get("KUBERNETES_SERVICE_PORT") or "443"
    token_file = os.path.join(sa_dir, "token")
    ca_file = os.path.join(sa_dir, "ca.crt")
    if not host or not os.path.exists(token_file):
        log.info("progress heartbeats disabled (no in-cluster config)")
        return None
    try:
        context = ssl.create_default_context(
            cafile=ca_file if os.path.exists(ca_file) else None)
    except (OSError, ssl.SSLError) as e_ca:
        log.info("progress heartbeats disabled (unreadable CA %s): %s",
                 ca_file, e_ca)
        return None
    if ":" in host:  # an IPv6 address
        host = f"[{host}]"
    return pod_patch_publisher(f"https://{host}:{port}", namespace, pod,
                               token_file=token_file, context=context)
