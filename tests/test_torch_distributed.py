"""The port's multi-process bootstrap (``tpujob_torch.workloads.distributed``)
against the JAX package's, on the CPU.

- ``process_env``: every field of the JAX package's ``ProcessEnv`` equal
  on a generated table of envs without launcher variables (``TPUJOB_*``,
  the torch.distributed spelling, both, neither, empty strings) and on
  hypothesis-drawn ones; ``local_rank`` (the port's own field) 0 there.
  Under a launcher (``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` set, as
  torchrun sets them) the launcher's world, rank and coordinator win over
  the pod's ``TPUJOB_*`` counts: a deliberate difference from JAX.
- ``local_batch_slice``: equal to the JAX package's on a table.
- ``initialize``: no group for one process; at world 2 (two gloo ranks
  spawned, rendezvous through ``TPUJOB_COORDINATOR_ADDRESS`` on a port
  picked by binding to port 0) one group, idempotent, a conflicting env
  refused, and a re-rendezvous on the same port after a teardown.
- ``local_device``: a bare ``cuda`` is ``cuda:<local rank>`` in a
  multi-process job, an explicit ``cuda:N`` is kept, and the package
  root's ``resolve_device`` leaves a bare ``cuda`` alone (card count and
  availability stubbed, so no card is needed).
"""
import dataclasses
import itertools
import socket

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_spawn import group_ranks, spawn
from tpujob.workloads import distributed as jdist
from tpujob_torch import resolve_device
from tpujob_torch.workloads import distributed as dist

JAX_FIELDS = [f.name for f in dataclasses.fields(jdist.ProcessEnv)]
ENV_KEYS = ("TPUJOB_COORDINATOR_ADDRESS", "TPUJOB_NUM_PROCESSES",
            "TPUJOB_PROCESS_ID", "TPUJOB_NUM_SLICES", "TPUJOB_SLICE_ID",
            "TPUJOB_DEVICES_PER_HOST", "TPUJOB_GLOBAL_DEVICES",
            "TPU_ACCELERATOR_TYPE", "TPU_TOPOLOGY", "MASTER_ADDR",
            "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
            "LOCAL_WORLD_SIZE")

# the operator's two spellings, each absent, complete, partial or blank
TPUJOB = [{}, {"TPUJOB_COORDINATOR_ADDRESS": "job-master-0:8476",
               "TPUJOB_NUM_PROCESSES": "4", "TPUJOB_PROCESS_ID": "3",
               "TPUJOB_NUM_SLICES": "2", "TPUJOB_SLICE_ID": "1",
               "TPUJOB_DEVICES_PER_HOST": "4", "TPUJOB_GLOBAL_DEVICES": "16",
               "TPU_ACCELERATOR_TYPE": "v4-32", "TPU_TOPOLOGY": "2x2x4"},
          {"TPUJOB_NUM_PROCESSES": "2"},
          {"TPUJOB_NUM_PROCESSES": "", "TPUJOB_PROCESS_ID": "",
           "TPUJOB_COORDINATOR_ADDRESS": ""}]
TORCH = [{}, {"MASTER_ADDR": "job-master-0", "MASTER_PORT": "23456",
              "WORLD_SIZE": "4", "RANK": "2"},
         {"MASTER_ADDR": "m", "WORLD_SIZE": "3"},
         {"MASTER_ADDR": "", "MASTER_PORT": "", "WORLD_SIZE": "",
          "RANK": ""}]
TABLE = [dict(a, **b) for a, b in itertools.product(TPUJOB, TORCH)]


def _jax_fields(pe):
    return {k: getattr(pe, k) for k in JAX_FIELDS}


@pytest.mark.parametrize("env", TABLE, ids=[f"tpujob{i}-torch{j}" for i, j in
                                            itertools.product(range(4),
                                                              range(4))])
def test_process_env_matches_jax_on_the_table(env):
    pe = dist.process_env(env)
    assert _jax_fields(pe) == _jax_fields(jdist.process_env(env))
    assert pe.local_rank == 0
    assert pe.is_distributed == (pe.num_processes > 1)


_ints = st.sampled_from(["", "0", "1", "2", "3", "7", "16"])
_words = st.sampled_from(["", "h", "job-master-0.ns.svc", "10.0.0.1:99"])
_ENV = st.fixed_dictionaries({}, optional={
    **{k: _ints for k in ("TPUJOB_NUM_PROCESSES", "TPUJOB_PROCESS_ID",
                          "TPUJOB_NUM_SLICES", "TPUJOB_SLICE_ID",
                          "TPUJOB_DEVICES_PER_HOST", "TPUJOB_GLOBAL_DEVICES",
                          "WORLD_SIZE", "RANK", "MASTER_PORT")},
    **{k: _words for k in ("TPUJOB_COORDINATOR_ADDRESS", "MASTER_ADDR",
                           "TPU_ACCELERATOR_TYPE", "TPU_TOPOLOGY")},
    # one launcher variable alone is not a launcher
    "LOCAL_RANK": _ints})


@settings(max_examples=300, deadline=None)
@given(_ENV)
def test_process_env_matches_jax_on_generated_envs(env):
    pe = dist.process_env(env)
    assert _jax_fields(pe) == _jax_fields(jdist.process_env(env))
    assert pe.local_rank == 0


@pytest.mark.parametrize("pod", TPUJOB[:3])
def test_launcher_world_and_rank_win(pod):
    """A torchrun child inherits its pod's ``TPUJOB_*`` (pods, not
    processes): the launcher's world, rank, local rank and store win."""
    env = dict(pod, MASTER_ADDR="127.0.0.1", MASTER_PORT="29500",
               WORLD_SIZE="8", RANK="6", LOCAL_RANK="2",
               LOCAL_WORLD_SIZE="4")
    pe = dist.process_env(env)
    assert (pe.num_processes, pe.process_id, pe.local_rank) == (8, 6, 2)
    assert pe.coordinator_address == "127.0.0.1:29500"
    assert dist.under_launcher(env)
    # the rest of the pod's spec is read as the JAX package reads it
    want = jdist.process_env(env)
    for k in ("num_slices", "slice_id", "devices_per_host", "global_devices",
              "accelerator", "topology"):
        assert getattr(pe, k) == getattr(want, k)
    assert dist.local_batch_slice(16, pe) == (12, 2)


@pytest.mark.parametrize("missing", ["LOCAL_RANK", "LOCAL_WORLD_SIZE"])
def test_half_a_launcher_env_is_not_a_launcher(missing):
    env = dict(TPUJOB[1], WORLD_SIZE="8", RANK="6", LOCAL_RANK="2",
               LOCAL_WORLD_SIZE="4")
    env[missing] = ""
    assert not dist.under_launcher(env)
    assert _jax_fields(dist.process_env(env)) == \
        _jax_fields(jdist.process_env(env))


@pytest.mark.parametrize("batch,world", [(8, 1), (8, 2), (8, 4), (12, 3),
                                         (6, 4), (7, 2)])
def test_local_batch_slice_matches_jax(batch, world):
    for rank in range(world):
        env = {"WORLD_SIZE": str(world), "RANK": str(rank)}
        pe, jpe = dist.process_env(env), jdist.process_env(env)
        if batch % world:
            with pytest.raises(ValueError, match="not divisible"):
                dist.local_batch_slice(batch, pe)
            with pytest.raises(ValueError, match="not divisible"):
                jdist.local_batch_slice(batch, jpe)
        else:
            assert dist.local_batch_slice(batch, pe) == \
                jdist.local_batch_slice(batch, jpe)


def test_initialize_makes_no_group_for_one_process():
    for env in ({}, {"WORLD_SIZE": "1", "MASTER_ADDR": "h"},
                {"TPUJOB_NUM_PROCESSES": "1", "TPUJOB_PROCESS_ID": "0"}):
        pe = dist.process_env(env)
        assert dist.initialize(pe) == pe
        assert not torch.distributed.is_initialized()
        assert dist.group_size() == 1


def test_init_method():
    assert dist.init_method("job-master-0:8476") == "tcp://job-master-0:8476"
    assert dist.init_method("file:///shared/rdzv") == "file:///shared/rdzv"
    assert dist.init_method("tcp://h:1") == "tcp://h:1"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_ranks_through_the_coordinator_address(tmp_path):
    """Two gloo ranks rendezvous at ``TPUJOB_COORDINATOR_ADDRESS``
    (``127.0.0.1:<free port>``, rank 0 hosts the store)."""
    port = _free_port()
    envs = [{"TPUJOB_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
             "TPUJOB_NUM_PROCESSES": "2", "TPUJOB_PROCESS_ID": str(r)}
            for r in range(2)]
    outs = spawn(group_ranks, 2, tmp_path, envs=envs)
    for rank, out in enumerate(outs):
        assert out["pe"].process_id == out["rank"] == rank
        assert out["pe"].num_processes == out["world"] == 2
        assert out["backend"] == "gloo"
        assert out["again_same_group"]
        assert out["refused"] == [True, True]
        assert out["sum"] == out["global_sum"] == 3.0
        assert out["global_mean_bf16"].dtype == torch.bfloat16
        assert out["global_mean_bf16"].item() == 1.5
        assert out["data_parallel"] == "DistributedDataParallel"
        assert out["after_reinit"] == (True, True, 30.0)
        assert out["shut_down"]


@pytest.fixture
def two_cards(monkeypatch):
    """A process that believes it sees four cards (no card is touched)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_resolve_device_takes_the_local_rank(two_cards):
    assert dist.local_device("cuda") == torch.device("cuda")
    two_cards.setenv("TPUJOB_NUM_PROCESSES", "2")
    two_cards.setenv("TPUJOB_PROCESS_ID", "1")
    assert dist.local_device("cuda") == torch.device("cuda", 0)  # one a pod
    for k, v in {"WORLD_SIZE": "8", "RANK": "7", "LOCAL_RANK": "3",
                 "LOCAL_WORLD_SIZE": "4"}.items():
        two_cards.setenv(k, v)
    assert dist.local_device("cuda") == torch.device("cuda", 3)
    # the package root knows nothing of process groups
    assert resolve_device("cuda") == torch.device("cuda")
    assert dist.local_device("cuda:1") == torch.device("cuda", 1)  # kept
    assert dist.local_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="only 4 CUDA card"):
        dist.local_device("cuda:5")
    two_cards.setenv("LOCAL_RANK", "4")
    with pytest.raises(RuntimeError, match="only 4 CUDA card"):
        dist.local_device("cuda")
