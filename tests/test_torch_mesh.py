"""The port's meshes and shardings (``yolotpu_torch.parallel.mesh``) against
the JAX package's (``yolotpu.parallel.mesh``), with no processes: the
port's mesh made with no process group only lays out the shapes, and
``Sharding.block(x, rank)`` gives any rank's block.

- ``factor_mesh``, ``make_mesh(n).shape`` and ``make_mesh_sp(n).shape``
  equal the JAX package's for n = 1..8;
- ``param_shardings`` marks the same leaves of yolov2 sharded, with the
  same specs, at tp = 1, 2 and 4;
- each rank's block equals the data of the JAX array's addressable shard
  on the device of that index (the 8 CPU devices of tests/conftest.py):
  the params of yolov2 (fp32 and int16) and frames under the batch, the
  spatial and the rows-over-(dp, tp) shardings.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from yolotpu.models import yolov2 as jy
from yolotpu.models import zoo as jzoo
from yolotpu.parallel import mesh as jmesh
from yolotpu.quant import calibrate_activations, quantize_weights
from yolotpu.weights import WeightStore as JStore
from yolotpu_torch.parallel import mesh


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shapes_equal_jax(n):
    assert mesh.factor_mesh(n) == jmesh.factor_mesh(n)
    for ours, theirs in ((mesh.make_mesh(n), jmesh.make_mesh(n)),
                         (mesh.make_mesh_sp(n), jmesh.make_mesh_sp(n))):
        assert ours.shape == dict(theirs.shape)
        assert ours.axis_names == tuple(theirs.axis_names)
        assert ours.size == n and ours.rank is None and not ours.groups


@functools.cache
def _jax_params(kind: str) -> dict:
    spec = jzoo.build("yolov2", width=32, height=32)
    store = JStore.synthetic(spec, seed=0)
    if kind == "fp32":
        return jy.params_fp32(spec, store)
    img = np.random.default_rng(0).random((3, 32, 32)).astype(np.float32)
    quantize_weights(store, calibrate_activations(spec, store, [img]))
    return jy.params_int16(spec, store)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_param_shardings_equal_jax(n):
    params = _jax_params("fp32")
    ours = mesh.param_shardings(params, mesh.make_mesh(n))
    theirs = jmesh.param_shardings(params, jmesh.make_mesh(n))
    assert ours.keys() == theirs.keys()
    sharded = 0
    for name in theirs:
        for leaf in ("w", "b"):
            assert ours[name][leaf].spec == tuple(theirs[name][leaf].spec)
            sharded += ours[name][leaf].spec != ()
    tp = mesh.factor_mesh(n)[1]
    # every yolov2 conv but the 425-channel head divides by 2 and 4
    assert sharded == (0 if tp == 1 else 2 * (len(params) - 1))


@pytest.mark.parametrize("kind", ["fp32", "int16"])
def test_param_blocks_equal_jax_shards(kind):
    params = _jax_params(kind)
    jm, ours = jmesh.make_mesh(8), mesh.make_mesh(8)
    sh = mesh.param_shardings(params, ours)
    placed = jmesh.shard_params(params, jm)
    for name in params:
        for leaf in ("w", "b"):
            full = torch.from_numpy(np.array(params[name][leaf]))
            shards = placed[name][leaf].addressable_shards
            assert sorted(s.device.id for s in shards) == list(range(8))
            for s in shards:
                np.testing.assert_array_equal(
                    sh[name][leaf].block(full, s.device.id).numpy(),
                    np.asarray(s.data), err_msg=f"{name}/{leaf}")


@pytest.mark.parametrize("which", ["batch", "spatial", "rows"])
def test_batch_blocks_equal_jax_shards(which):
    x = np.random.default_rng(1).random((8, 16, 4, 3)).astype(np.float32)
    if which == "spatial":
        jm, ours = jmesh.make_mesh_sp(8), mesh.make_mesh_sp(8)
        theirs, sharding = (jmesh.spatial_batch_sharding(jm),
                            mesh.spatial_batch_sharding(ours))
    else:
        jm, ours = jmesh.make_mesh(8), mesh.make_mesh(8)
        theirs, sharding = jmesh.batch_sharding(jm), mesh.batch_sharding(ours)
        if which == "rows":
            x = x.reshape(64, -1)
            theirs = NamedSharding(jm, P(("dp", "tp"), None))
            sharding = mesh.Sharding(ours, (("dp", "tp"), None))
    placed = jax.device_put(x, theirs)
    for s in placed.addressable_shards:
        np.testing.assert_array_equal(
            sharding.block(torch.from_numpy(x), s.device.id).numpy(),
            np.asarray(s.data))


def test_uneven_split_and_missing_groups_raise():
    m = mesh.make_mesh(8)
    with pytest.raises(ValueError, match="does not split 4 ways"):
        mesh.Sharding(m, (None, "tp")).block(torch.zeros(2, 6), 0)
    with pytest.raises(ValueError, match="no process group"):
        m.group("tp")
    with pytest.raises(ValueError, match="not in the mesh"):
        m.coords(8)
    assert mesh.tp_sharded(1024, m) and not mesh.tp_sharded(425, m)
    assert not mesh.tp_sharded(1024, mesh.make_mesh_sp(8))
