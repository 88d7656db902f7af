"""The port's mesh (``tpujob_torch.workloads.distributed``) against the JAX
package's (``tpujob.workloads.distributed``), on the CPU without
processes: ``_factor_axes`` and ``hybrid_mesh_shapes`` on a grid, their
errors included, and each rank's coordinates and axis groups against
``make_mesh(...).devices`` on the 8 virtual CPU devices (rank r is device
r).  The process groups themselves are read back in a spawn at world 4 by
``tests/test_torch_sp.py``.
"""
import itertools

import jax
import numpy as np
import pytest

from tpujob.workloads import distributed as jdist
from tpujob_torch.workloads import distributed as tdist

AXES = [
    {"data": -1}, {"data": -1, "sequence": 2}, {"sequence": 2, "data": -1},
    {"data": 2, "sequence": -1}, {"data": -1, "sequence": -1},
    {"data": 0}, {"data": 3}, {"data": -1, "fsdp": 2, "sequence": 2},
    {"tensor": 2, "data": -1, "sequence": 2}, {"data": 2, "tensor": 4},
    {"pipeline": 2, "expert": 2, "data": -1}, {"zeta": 2, "data": -1},
]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("n,axes", list(itertools.product(
    [1, 2, 4, 6, 8], AXES)))
def test_factor_axes_matches_jax(n, axes):
    assert _outcome(tdist._factor_axes, n, axes) == _outcome(
        jdist._factor_axes, n, axes)


@pytest.mark.parametrize("shape,slices", list(itertools.product(
    [(8,), (4, 2), (2, 2, 2), (6, 1)], [0, 1, 2, 3, 4])))
def test_hybrid_mesh_shapes_matches_jax(shape, slices):
    names = ("data", "sequence", "tensor")[:len(shape)]
    assert _outcome(tdist.hybrid_mesh_shapes, names, shape, slices) == \
        _outcome(jdist.hybrid_mesh_shapes, names, shape, slices)


MESHES = [{"data": -1}, {"data": -1, "sequence": 2},
          {"data": 2, "sequence": 4}, {"data": -1, "fsdp": 2, "sequence": 2},
          {"sequence": 2, "data": -1, "tensor": 2},
          {"data": 1, "pipeline": 2, "expert": 2, "sequence": 2}]


@pytest.mark.parametrize("axes", MESHES)
def test_rank_layout_matches_jax_device_mesh(axes):
    """Names, shape, each rank's coordinates and the ranks along each axis
    through it: those of the JAX package's mesh of the 8 virtual devices,
    where rank r is the device with id r (data varies slowest)."""
    jmesh = jdist.make_mesh(axes, env=jdist.process_env({}),
                            devices=jax.devices())
    ids = np.vectorize(lambda dv: dv.id)(jmesh.devices)
    names, shape = tdist.mesh_shape(axes, 8)
    assert names == tuple(jmesh.axis_names)
    assert shape == ids.shape
    for r in range(8):
        mesh = tdist.Mesh(names, shape, r)
        where = tuple(int(i) for i in np.argwhere(ids == r)[0])
        assert mesh.coords == where
        for i, axis in enumerate(names):
            line = ids[tuple(slice(None) if j == i else c
                             for j, c in enumerate(where))]
            assert mesh.axis_ranks(axis) == line.tolist()
            assert mesh.index(axis) == where[i]
            assert mesh.size(axis) == shape[i]


def test_batch_and_sequence_shares():
    """Rows split over the data axes only (each sequence pair feeds the
    same rows), columns over the sequence axis, in rank order."""
    names, shape = tdist.mesh_shape({"data": -1, "sequence": 2}, 4)
    rows = [tdist.local_batch_slice(8, mesh=tdist.Mesh(names, shape, r))
            for r in range(4)]
    cols = [tdist.local_seq_slice(16, tdist.Mesh(names, shape, r))
            for r in range(4)]
    assert rows == [(0, 4), (0, 4), (4, 4), (4, 4)]
    assert cols == [(0, 8), (8, 8), (0, 8), (8, 8)]
    mesh = tdist.Mesh(names, shape, 0)
    assert tdist.batch_axes(mesh) == ("data",)
    assert tdist.batch_divisor(mesh) == 2
    with pytest.raises(ValueError, match="not divisible"):
        tdist.local_batch_slice(3, mesh=mesh)
    with pytest.raises(ValueError, match="not divisible"):
        tdist.local_seq_slice(15, mesh)
    # without a mesh the rows split over the processes, as before
    pe = tdist.process_env({"TPUJOB_NUM_PROCESSES": "4",
                            "TPUJOB_PROCESS_ID": "3"})
    assert tdist.local_batch_slice(8, pe) == (6, 2)


def test_one_process_mesh_has_no_groups():
    mesh = tdist.make_mesh({"data": -1}, env=tdist.process_env({}))
    assert (mesh.axis_names, mesh.shape, mesh.coords) == (("data",), (1,),
                                                          (0,))
    assert mesh.group("data") is None and mesh.size("sequence") == 1


@pytest.mark.parametrize("axes,devices", [
    ({"data": 2, "tensor": 2}, 4), ({"sequence": 2, "tensor": 2}, 4),
    ({"data": -1, "sequence": 2, "tensor": 2}, 8),
    ({"data": -1, "fsdp": 2, "tensor": 2}, 8)])
def test_groups_of_several_axes_match_jax_device_mesh(axes, devices):
    """The ranks a group over several axes holds (``Mesh.grid``, which
    ``make_mesh`` makes each group from): for every rank and every set of
    the mesh's axes (the replica axes data x sequence, the token axes
    data x fsdp x sequence among them), the devices of the JAX package's
    mesh that differ from the rank's along those axes only, row-major over
    them; ``live`` drops the axes the mesh does not carry or holds 1
    long."""
    jmesh = jdist.make_mesh(axes, env=jdist.process_env({}),
                            devices=jax.devices()[:devices])
    ids = np.vectorize(lambda dv: dv.id)(jmesh.devices)
    names, shape = tdist.mesh_shape(axes, devices)
    for r in range(devices):
        mesh = tdist.Mesh(names, shape, r)
        where = tuple(int(i) for i in np.argwhere(ids == r)[0])
        for k in range(1, len(names) + 1):
            for subset in itertools.combinations(names, k):
                block = ids[tuple(slice(None) if a in subset else c
                                  for a, c in zip(names, where))]
                assert mesh.grid(*subset).ravel().tolist() == \
                    block.ravel().tolist(), (r, subset)
        assert mesh.live(tdist.REPLICA_AXES) == tuple(
            a for a in names if a in ("data", "sequence")
            and mesh.size(a) > 1)
        assert mesh.size(*tdist.TOKEN_AXES) == tdist.token_shards(mesh) \
            == devices // mesh.size("tensor")
        # rank r's replica group holds the ranks of its tensor index
        replica = mesh.grid(*tdist.REPLICA_AXES).ravel().tolist()
        assert {q % mesh.size("tensor") for q in replica} == {
            r % mesh.size("tensor")}
