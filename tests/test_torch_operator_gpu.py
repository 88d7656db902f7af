"""The port's GPU job spec (``tpujob_torch/examples/tpujob_gpt_h100x2.yaml``)
under the unchanged operator, on the CPU: it loads and validates as the
operator's admission does, and through the in-memory controller
(``tests.jobtestutil.Harness``) its two pods keep their ``nvidia.com/gpu``
limit and gain no TPU resource or node selector
(``reconciler._apply_tpu_scheduling``), carry the flat env of
``cluster_env``'s no-topology branch, and run the port's GPT trainer at
GPT-2-medium with the flash kernels, which reads that env as ranks 0 and
1 of world 2.
"""
from pathlib import Path

import pytest
import yaml

from jobtestutil import Harness
from tpujob.api import TPUJob
from tpujob.api import constants as c
from tpujob.api.defaults import set_defaults_tpujob
from tpujob.api.validation import validate_tpujob_spec
from tpujob.controller.tpu_env import cluster_env
from tpujob.kube.control import gen_general_name
from tpujob_torch.workloads import distributed, gpt

SPEC = (Path(__file__).resolve().parent.parent / "tpujob_torch" / "examples"
        / "tpujob_gpt_h100x2.yaml")
GPU = "nvidia.com/gpu"


def load_job() -> TPUJob:
    job = TPUJob.from_dict(yaml.safe_load(SPEC.read_text()))
    set_defaults_tpujob(job)
    return job


def test_spec_validates_with_no_tpu_field():
    job = load_job()
    assert validate_tpujob_spec(job.spec, strict_topology=True) == []
    specs = job.spec.tpu_replica_specs
    assert set(specs) == {c.REPLICA_TYPE_MASTER, c.REPLICA_TYPE_WORKER}
    for rspec in specs.values():
        assert rspec.replicas == 1 and rspec.tpu is None
    # a YAML round trip is stable
    assert TPUJob.from_dict(job.to_dict()).to_dict() == job.to_dict()


@pytest.fixture(scope="module")
def pods():
    """The controller's pods for the spec: {replica type: pod}."""
    h = Harness()
    job = h.submit(load_job())
    h.sync()
    assert len(h.pod_names()) == 2, h.pod_names()
    return job, {rtype: h.clients.pods.get(
        "default", gen_general_name(job.metadata.name, rtype, 0))
        for rtype in (c.REPLICA_TYPE_MASTER, c.REPLICA_TYPE_WORKER)}


def test_pods_ask_for_one_card_and_no_tpu(pods):
    _, by_type = pods
    for pod in by_type.values():
        [ct] = pod.spec.containers
        assert ct.name == c.DEFAULT_CONTAINER_NAME == "tpu"
        assert ct.resources.limits == {GPU: 1}
        assert c.TPU_RESOURCE not in ct.resources.limits
        assert c.TPU_RESOURCE not in (ct.resources.requests or {})
        for key in (c.TPU_ACCELERATOR_NODE_SELECTOR,
                    c.TPU_TOPOLOGY_NODE_SELECTOR):
            assert key not in (pod.spec.node_selector or {})


def test_pods_carry_the_flat_env_the_port_reads(pods):
    """Each pod's env is ``cluster_env``'s no-topology branch (no
    ``PJRT_DEVICE``, no TPU variables), and the port's ``process_env``
    reads it as its rank of world 2 at the Master's coordinator."""
    job, by_type = pods
    for rank, rtype in enumerate((c.REPLICA_TYPE_MASTER,
                                  c.REPLICA_TYPE_WORKER)):
        [ct] = by_type[rtype].spec.containers
        env = {e.name: e.value for e in ct.env}
        port = int(env["MASTER_PORT"])
        assert env == cluster_env(job, rtype, 0, None, port)
        assert "PJRT_DEVICE" not in env
        assert not any(k.startswith("TPU_") for k in env)
        pe = distributed.process_env(env)
        assert (pe.process_id, pe.num_processes, pe.local_rank) == (rank, 2,
                                                                    0)
        assert pe.coordinator_address == f"{env['MASTER_ADDR']}:{port}"
        assert env["WORLD_SIZE"] == "2" and env["RANK"] == str(rank)


def test_pods_run_the_ports_gpt_at_gpt2_medium(pods):
    """Both pods run ``python -m tpujob_torch.workloads.gpt`` with the same
    flags: GPT-2-medium (the ``bench_models`` GPT row's widths), global
    batch 8, flash, bf16, on the card (the default device), with
    checkpoints on the mounted volume."""
    _, by_type = pods
    argvs = []
    for pod in by_type.values():
        [ct] = pod.spec.containers
        assert ct.command == ["python", "-m", "tpujob_torch.workloads.gpt"]
        argvs.append(ct.args)
        mounts = {m["mountPath"] for m in ct.volume_mounts}
        assert "/ckpt" in mounts
    assert argvs[0] == argvs[1]
    args = gpt.build_parser().parse_args(argvs[0])
    assert (args.hidden, args.layers, args.heads, args.intermediate,
            args.seq_len, args.vocab) == (1024, 24, 16, 4096, 1024, 50257)
    assert args.batch_size == 8 and args.attention == "flash" and args.bf16
    assert args.device == "cuda" and args.dir == "/ckpt"
    assert args.checkpoint_interval > 0 and args.steps > 0
