"""The port's send/recv smoke (``tpujob_torch.workloads.smoke_dist``) on
the CPU over gloo: at world 1 (its own group on an in-memory store) and
at world 2 (two spawned ranks through ``TPUJOB_COORDINATOR_ADDRESS``),
its exit code when a rank's result is corrupted, and under the env the
operator injects into a job with a Master and one Worker and no ``tpu``
field (``tpujob.controller.tpu_env.cluster_env``), with only the
coordinator host rewritten to 127.0.0.1 (no headless DNS here).
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jobtestutil import new_tpujob
from test_torch_spawn import operator_ranks, smoke_ranks, spawn
from tpujob.api import constants as c
from tpujob.api.progress import parse_progress
from tpujob.controller.tpu_env import cluster_env
from tpujob_torch.workloads import distributed, smoke_dist

ROOT = Path(__file__).resolve().parent.parent
ENV_KEYS = ("TPUJOB_COORDINATOR_ADDRESS", "TPUJOB_NUM_PROCESSES",
            "TPUJOB_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
            "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.fixture
def one_process(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_world_one_passes_and_tears_its_group_down(one_process, caplog):
    caplog.set_level("INFO", logger="tpujob_torch.smoke_dist")
    assert smoke_dist.main(["--device", "cpu"]) == 0
    assert not torch.distributed.is_initialized()
    assert "Result from participant 0" in caplog.text
    assert "smoke send/recv PASSED" in caplog.text


def test_world_one_corrupted_result_exits_1(one_process):
    one_process.setattr(smoke_dist, "work", lambda x: x * x + 1e-3)
    assert smoke_dist.main(["--device", "cpu"]) == 1
    assert not torch.distributed.is_initialized()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_world_two_and_a_corrupted_rank(tmp_path):
    """Two ranks: a clean run (0 on both), then, re-rendezvoused on the
    same port, rank 1's result off by one: every rank sees it (1)."""
    port = _free_port()
    envs = [{"TPUJOB_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
             "TPUJOB_NUM_PROCESSES": "2", "TPUJOB_PROCESS_ID": str(r)}
            for r in range(2)]
    assert spawn(smoke_ranks, 2, tmp_path, 1, envs=envs) == [[0, 1], [0, 1]]


def _localhost(env):
    """The coordinator host rewritten to 127.0.0.1, nothing else."""
    out = dict(env)
    host, port = env["TPUJOB_COORDINATOR_ADDRESS"].rsplit(":", 1)
    out["TPUJOB_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    assert out["MASTER_ADDR"] == host
    out["MASTER_ADDR"] = "127.0.0.1"
    return out


def test_the_operators_env_brings_the_port_up(tmp_path):
    """A Master and one Worker, no ``tpu`` field: the flat one-pod-one-
    process env (``TPUJOB_*`` and ``MASTER_*``/``WORLD_SIZE``/``RANK``).
    Ranks 0 and 1 of world 2; the heartbeat goes out from rank 0 only."""
    job = new_tpujob(master=1, workers=1)
    port = _free_port()
    envs = [cluster_env(job, c.REPLICA_TYPE_MASTER, 0, None, port),
            cluster_env(job, c.REPLICA_TYPE_WORKER, 0, None, port)]
    assert envs[0]["MASTER_ADDR"] == "localhost"
    assert envs[1]["MASTER_ADDR"] != "localhost"  # the headless service
    outs = spawn(operator_ranks, 2, tmp_path,
                 envs=[_localhost(e) for e in envs])
    for rank, (code, pe, shipped, made) in enumerate(outs):
        assert code == 0
        assert (pe.process_id, pe.num_processes, pe.local_rank) == (rank, 2, 0)
        assert pe == distributed.process_env(_localhost(envs[rank]))
    (_, _, shipped0, made0), (_, _, shipped1, made1) = outs
    assert made0 == [0] and made1 == []
    assert shipped1 == []
    beats = [parse_progress(v) for v in shipped0]
    assert [b.step for b in beats] == [1, 1]  # the step, then the close


def test_module_entry_point_on_cpu():
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    out = subprocess.run(
        [sys.executable, "-m", "tpujob_torch.workloads.smoke_dist",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "smoke send/recv PASSED" in out.stderr


def test_entry_point_without_a_card_raises(one_process):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        smoke_dist.main([])
