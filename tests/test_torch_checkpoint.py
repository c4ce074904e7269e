"""The port's checkpoints (``yolotpu_torch.checkpoint``) against the JAX
package's, on the CPU: a checkpoint written by either package loads in the
other with equal arrays, both prune to ``keep`` and agree on the latest,
and the exported ``weights.bin``/``bias.bin`` are byte-identical. All
exact: the same numpy arrays are written and read."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolotpu import checkpoint as jckpt
from yolotpu.models import yolov2 as jy
from yolotpu.models import zoo as jzoo
from yolotpu.weights import WeightStore as JStore
from yolotpu_torch import checkpoint as ckpt
from yolotpu_torch.models import yolov2 as ty
from yolotpu_torch.models import zoo
from yolotpu_torch.train import zeros_like_velocity
from yolotpu_torch.weights import WeightStore

SIZE = 64


def _port_tree(seed: int = 0):
    spec = zoo.build("yolov2-tiny", width=SIZE, height=SIZE)
    params = ty.params_fp32(spec, WeightStore.synthetic(spec, seed=seed))
    rng = np.random.default_rng(seed)
    vel = {k: {l: torch.from_numpy(rng.standard_normal(tuple(v.shape))
                                   .astype(np.float32))
               for l, v in p.items()} for k, p in params.items()}
    return spec, params, vel


def _equal_trees(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert set(a[k]) == set(b[k])
        for leaf in a[k]:
            x, y = (np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)
                    for t in (a[k][leaf], b[k][leaf]))
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)


def test_port_checkpoint_loads_in_jax(tmp_path):
    _, params, vel = _port_tree()
    path = ckpt.save_checkpoint(str(tmp_path), 7, params, vel)
    assert os.path.basename(path) == "ckpt_00000007.npz"
    step, p, v = jckpt.load_checkpoint(path)
    assert step == 7
    _equal_trees(p, params)
    _equal_trees(v, vel)
    # the file's keys are the JAX package's
    with np.load(path) as z:
        assert "params/conv0/w" in z.files and "velocity/conv0/b" in z.files
        assert z["params/conv0/w"].shape == tuple(params["conv0"]["w"].shape)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    spec = jzoo.build("yolov2-tiny", width=SIZE, height=SIZE)
    params = jy.params_fp32(spec, JStore.synthetic(spec, seed=1))
    vel = {k: {l: jnp.full(v.shape, 0.25, jnp.float32) for l, v in p.items()}
           for k, p in params.items()}
    np_tree = lambda t: {k: {l: np.asarray(v) for l, v in p.items()}  # noqa: E731
                         for k, p in t.items()}
    path = jckpt.save_checkpoint(str(tmp_path), 12, np_tree(params),
                                 np_tree(vel))
    step, p, v = ckpt.load_checkpoint(path)
    assert step == 12
    _equal_trees(p, np_tree(params))
    _equal_trees(v, np_tree(vel))
    assert ckpt.latest_checkpoint(str(tmp_path)) == path


@pytest.mark.parametrize("keep", [1, 3])
def test_prune_and_latest_as_jax(tmp_path, keep):
    _, params, _ = _port_tree()
    small = {"conv0": params["conv0"]}
    for step in (5, 1, 30, 12):
        ckpt.save_checkpoint(str(tmp_path / "port"), step, small, keep=keep)
        jckpt.save_checkpoint(str(tmp_path / "jax"), step,
                              {"conv0": {l: v.numpy() for l, v in
                                         small["conv0"].items()}}, keep=keep)
    port = sorted(os.listdir(tmp_path / "port"))
    assert port == sorted(os.listdir(tmp_path / "jax"))
    assert len(port) == keep and port[-1] == "ckpt_00000030.npz"
    assert os.path.basename(ckpt.latest_checkpoint(str(tmp_path / "port"))) \
        == os.path.basename(jckpt.latest_checkpoint(str(tmp_path / "jax")))
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None
    step, _, vel = ckpt.load_checkpoint(ckpt.latest_checkpoint(
        str(tmp_path / "port")))
    assert step == 30 and vel is None


def test_save_leaves_no_temporary_file(tmp_path):
    _, params, vel = _port_tree()
    ckpt.save_checkpoint(str(tmp_path), 3, params, vel)
    assert os.listdir(tmp_path) == ["ckpt_00000003.npz"]


def test_exported_artifacts_are_byte_identical(tmp_path):
    spec, params, _ = _port_tree(seed=4)
    jspec = jzoo.build("yolov2-tiny", width=SIZE, height=SIZE)
    ckpt.export_weight_artifacts(params, spec, str(tmp_path / "port"))
    jckpt.export_weight_artifacts(
        {k: {l: v.numpy() for l, v in p.items()} for k, p in params.items()},
        jspec, str(tmp_path / "jax"))
    for name in ("weights.bin", "bias.bin"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()
    # and they load back into the params
    back = WeightStore.load_fp32(spec, str(tmp_path / "port" / "weights.bin"),
                                 str(tmp_path / "port" / "bias.bin"))
    _equal_trees(ty.params_fp32(spec, back), params)


def test_resumed_velocity_is_zero_when_missing():
    _, params, _ = _port_tree()
    vel = zeros_like_velocity(params)
    assert all(float(v.abs().sum()) == 0 for p in vel.values()
               for v in p.values())
