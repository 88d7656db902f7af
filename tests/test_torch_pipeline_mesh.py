"""Pipeline parallelism at four ranks in the port against the JAX
package, on the CPU: tensor x pipeline (Megatron's TP x PP) and data x
pipeline, for both trainers.

``gpt.run`` and ``bert.run`` for 3 steps (4 layers, 2 a stage) at
pipeline 2 x tensor 2 under GPipe (the JAX package refuses 1F1B with
TP; dense attention, as it refuses flash with TP: inside a stage the
blocks run the port's Megatron TP, and each tensor rank sends its own
copy of the activations down the pipeline), and at data 2 x pipeline 2
(GPT under 1F1B, BERT under GPipe, 2 microbatches of each rank's 2
rows; the gradients averaged over each stage's data pair, never across
stages), each rank loading its blocks of its stage's layers of the JAX
package's initial weights, against the JAX package's ``run`` on the
same mesh of virtual CPU devices: ``test_torch_pipeline_runs``'
``check_pipeline_runs`` (losses 1e-4 relative, the parameters after step
3 gathered whole within 1e-4, each rank's stage and tensor share of the
parameters and moments, the shared parameters and gradients bit-equal
across each pipeline group; under TP the parameters normwise:
``TP_UPDATE_RTOL``), and the mesh's groups.
"""
import pytest

from test_torch_pipeline_runs import LAYERS4, check_pipeline_runs
from test_torch_spawn import shard_trainer_ranks, spawn
from test_torch_tp import JMODULES, TP, flax_init, jax_run, port
from tpujob_torch.workloads import convert

PP2 = ["--pipeline-parallel", "2"]
DP_PP = PP2 + ["--pipeline-microbatches", "2"]

# name -> (trainer, flags, the JAX package's mesh)
CASES = {
    "gpt_tp_pp": ("gpt", PP2 + TP, {"data": 1, "pipeline": 2, "tensor": 2}),
    "bert_tp_pp": ("bert", PP2 + TP, {"data": 1, "pipeline": 2,
                                      "tensor": 2}),
    "gpt_dp_pp_1f1b": ("gpt", DP_PP + ["--pipeline-schedule", "1f1b"],
                       {"data": 2, "pipeline": 2}),
    "bert_dp_pp": ("bert", DP_PP, {"data": 2, "pipeline": 2}),
}


@pytest.fixture(scope="module")
def world_4(tmp_path_factory):
    """The JAX package's run of each case and the port's, four ranks."""
    tmp = tmp_path_factory.mktemp("world_4")
    jax_runs, runs = {}, []
    for key, (name, flags, axes) in CASES.items():
        argv = LAYERS4 + flags
        jm = JMODULES[name]
        tree = flax_init(jm, argv)
        init = {k: v.numpy()
                for k, v in convert.params_from_flax(tree).items()}
        jax_runs[key] = (jax_run(jm, argv, axes, tmp / f"jax_{key}"), init)
        runs.append((name, port(argv, tmp / key), tree))
    return jax_runs, spawn(shard_trainer_ranks, 4, tmp, runs)


@pytest.mark.parametrize("key", list(CASES))
def test_runs_at_world_4_match_jax(world_4, key):
    """Each case against the JAX package's run; under TP the parameters
    normwise (``TP_UPDATE_RTOL``, with its reason)."""
    jax_runs, outs = world_4
    i = list(CASES).index(key)
    (jlosses, jparams), init = jax_runs[key]
    check_pipeline_runs([o[i] for o in outs], jlosses, jparams,
                        init=init if "--tensor-parallel" in CASES[key][1]
                        else None)


def test_mesh_groups(world_4):
    """The row-major mesh (data, pipeline, tensor): under TP x PP a
    rank's pipeline group is the ranks of its tensor index, its tensor
    group its stage's pair; under data x PP its pipeline group is its
    data index's pair and its token (data) group its stage's."""
    _, outs = world_4
    for r, o in enumerate(outs):
        tp = o[0]["groups"]
        assert o[0]["pipeline_group"] == [r % 2, r % 2 + 2]
        assert tp["tensor"] == [r - r % 2, r - r % 2 + 1]
        dp = o[2]["groups"]
        assert o[2]["pipeline_group"] == [r - r % 2, r - r % 2 + 1]
        assert dp["tokens"] == dp["replica"] == [r % 2, r % 2 + 2]
