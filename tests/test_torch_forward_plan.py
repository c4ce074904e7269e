"""The int16 engine plan's overrides in the port (yolotpu_torch.models.
engine_plan, YoloV2Q(overrides=), Engine under YOLO2_Q16_PLAN) against the
JAX package's, on the CPU, at small sizes.

- Every kind of yolotpu's ALL_KINDS is accepted on a layer where yolotpu's
  params_q16 accepts it, and maps to the port kernel and pool order of the
  table in engine_plan's docstring; every illegal pairing raises the same
  ValueError in both packages.
- Under the two plan slices that chip_smoke.py runs at 416x416, P1 (the
  "acc" order at convs 0, 2, 6, 10) and P2 (the "acc_h" order at conv 0,
  "out" at conv 2, conv 4 unfused), the yolov2 64x64 head is bit-equal to
  yolotpu's build_forward(..., compute="int32"), and P1's to
  compute="pallas" under the same YOLO2_Q16_PLAN; the calibrated model does
  not wrap, so the fused pools change no bit.
- yolov2-tiny with sd_pool on every conv a 2x2/s2 pool follows; a fused kind
  on conv 16, whose output route 25 reads, runs unfused.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from yolotpu import quant as jquant
from yolotpu import weights as jweights
from yolotpu.models import engine_plan as jplan
from yolotpu.models import yolov2 as jy
from yolotpu.models import zoo as jzoo
from yolotpu_torch import quant as tquant
from yolotpu_torch import weights as tweights
from yolotpu_torch.models import engine_plan
from yolotpu_torch.models import yolov2 as ty
from yolotpu_torch.models import zoo as tzoo

# port? -> the host layer (zoo, weights, quant) that builds spec and store
HOSTS = {False: (jzoo, jweights, jquant), True: (tzoo, tweights, tquant)}

P1 = "0:entry_sdmm,2:sd_pool,6:sd_pool,10:sd_pool"
P2 = "0:entryf,2:conv3p2,4:conv3p2"


@functools.cache
def _setup(model: str, size: int, port: bool = False):
    zoo, weights, quant = HOSTS[port]
    spec = zoo.build(model, width=size, height=size)
    store = weights.WeightStore.synthetic(spec, seed=0)
    img = np.random.default_rng(100).random((3, size, size)).astype(np.float32)
    act_q = quant.calibrate_activations(spec, store, [img])
    quant.quantize_weights(store, act_q)
    quant.quantize_weights_w8a16(store, act_q)
    return spec, store


@functools.cache
def _jax_head(model: str, size: int) -> np.ndarray:
    spec, store = _setup(model, size)
    fwd = jax.jit(jy.build_forward(spec, "int16", store.qtables,
                                   compute="int32", outputs=("head",)))
    return np.asarray(fwd(jy.params_int16(spec, store),
                          jnp.asarray(_frames(size)))["head"])


def _frames(size: int) -> np.ndarray:
    return np.random.default_rng(size).integers(
        0, 256, (2, size, size, 3)).astype(np.uint8)


def _port(model: str, size: int, plan: str):
    spec, store = _setup(model, size, port=True)
    return ty.YoloV2Q(spec, store.qtables, ty.params_int16(spec, store), "cpu",
                      "int16", engine_plan._parse_plan_items(plan))


def _head(net, size: int) -> np.ndarray:
    return net(torch.from_numpy(_frames(size)))["head"].numpy()


# kind -> (a conv of yolov2 64x64 it may run, the port kernel and order)
LEGAL = {
    "mm": (5, ("mm", None)),
    "conv3": (2, ("conv3", None)),
    "entry_sd": (0, ("conv3_pool", "acc")),
    "entry_s2d": (0, ("conv3_pool", "acc")),
    "entry_sdmm": (0, ("conv3_pool", "acc")),
    "sd_pool": (2, ("conv3_pool", "acc")),
    "entryf": (0, ("conv3_pool", "acc_h")),
    "entry8": (0, ("conv3_pool", "acc_h")),
    "conv3p2": (2, ("conv3_pool", "out")),
    "mm_pairs": (0, ("conv3", None)),
    "mm_patches": (4, ("conv3", None)),
    "nchw": (0, ("conv3", None)),
    "xla8": (4, ("conv3", None)),
    "xla": (5, ("mm", None)),
}


def test_legal_table_covers_all_kinds():
    assert sorted(LEGAL) == sorted(jplan.ALL_KINDS)


@pytest.mark.parametrize("kind", sorted(LEGAL))
def test_every_kind_is_accepted_where_yolotpu_accepts_it(kind, monkeypatch):
    idx, route = LEGAL[kind]
    spec, store = _setup("yolov2", 64)
    tspec, _ = _setup("yolov2", 64, port=True)
    overrides = {idx: kind}
    kinds = engine_plan.plan(tspec, overrides)
    assert kinds[idx] == kind
    assert engine_plan.kernels(tspec, kinds)[idx] == route
    monkeypatch.setenv("YOLO2_Q16_PLAN", f"{idx}:{kind}")
    # yolotpu builds its weight pack for the same pairing (xla8 may fall
    # back to xla there, for weights its s8 plane split cannot hold)
    assert jy.params_q16(spec, store)[f"conv{idx}"]["kind"] in (kind, "xla")


@pytest.mark.parametrize("plan", [
    "0:conv3",        # C=3 < 8
    "0:mm",           # 3x3
    "5:conv3",        # 1x1
    "2:entry_sd",     # C=32 > 4
    "2:entryf",
    "4:sd_pool",      # no pool after conv 4
    "4:entry_sdmm",
    "8:conv3p2",      # 4C % 128 != 0 at C=128
    "2:mm_pairs",     # not the first conv
    "2:nchw",
    "5:xla8",         # 1x1
    "16:entry8",
])
def test_illegal_pairing_raises_in_both_packages(plan, monkeypatch):
    spec, store = _setup("yolov2", 64)
    tspec, _ = _setup("yolov2", 64, port=True)
    with pytest.raises(ValueError, match="is not applicable") as port:
        engine_plan.plan(tspec, engine_plan._parse_plan_items(plan))
    monkeypatch.setenv("YOLO2_Q16_PLAN", plan)
    with pytest.raises(ValueError, match="is not applicable") as ref:
        jy.params_q16(spec, store)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("plan,fused,c3", [
    (P1, {0: "acc", 2: "acc", 6: "acc", 10: "acc"}, 11),
    (P2, {0: "acc_h", 2: "out"}, 13),
])
def test_plan_slice_head_bitexact_vs_yolotpu(plan, fused, c3):
    net = _port("yolov2", 64, plan)
    assert {i: o for i, (k, o) in net.route.items() if k == "conv3_pool"} \
        == fused
    kernels = [k for k, _ in net.route.values()]
    assert kernels.count("mm") == 8 and kernels.count("conv3") == c3
    assert net.folded == {i + 1 for i in fused}
    np.testing.assert_array_equal(_head(net, 64), _jax_head("yolov2", 64))


def test_plan_slice_head_bitexact_vs_yolotpu_pallas(monkeypatch):
    monkeypatch.setenv("YOLO2_Q16_PLAN", P1)
    spec, store = _setup("yolov2", 64)
    params = jy.params_q16(spec, store)
    assert params["conv0"]["kind"] == "entry_sdmm"
    assert params["conv10"]["kind"] == "sd_pool"
    fwd = jy.build_forward(spec, "int16", store.qtables, compute="pallas",
                           outputs=("head",))
    x = _frames(64)[:1]
    want = np.asarray(fwd(params, jnp.asarray(x))["head"])
    got = _port("yolov2", 64, P1)(torch.from_numpy(x))["head"].numpy()
    np.testing.assert_array_equal(got, want)


def test_tiny_sd_pool_on_every_pooled_conv():
    spec, _ = _setup("yolov2-tiny", 96, port=True)
    pooled = [l.idx for l in spec.conv_layers()
              if engine_plan.next_is_pool22(spec, l.idx)]
    assert pooled == [0, 2, 4, 6, 8]   # the 2x2/s1 pool at 3x3 is not one
    net = _port("yolov2-tiny", 96, ",".join(f"{i}:sd_pool" for i in pooled))
    assert net.folded == {i + 1 for i in pooled}
    np.testing.assert_array_equal(_head(net, 96), _jax_head("yolov2-tiny", 96))


def test_fused_kind_under_a_route_runs_unfused():
    """Route 25 reads conv 16's own output: sd_pool there runs conv3x3_q16
    and pool 17 as its own op, as yolotpu falls back to its XLA conv."""
    net = _port("yolov2", 64, "16:sd_pool")
    assert net.kinds[16] == "sd_pool"
    assert net.route[16] == ("conv3", None) and not net.folded
    np.testing.assert_array_equal(_head(net, 64), _jax_head("yolov2", 64))


def test_overrides_on_another_tier_raise():
    spec, store = _setup("yolov2", 64, port=True)
    for precision, params in (("int8", ty.params_int16),
                              ("w8a16", ty.params_w8a16)):
        with pytest.raises(ValueError, match="int16 tier only"):
            ty.YoloV2Q(spec, store.qtables, params(spec, store), "cpu",
                       precision, {0: "entry_sdmm"})


def test_engine_reads_the_plan_lever(monkeypatch):
    from yolotpu_torch.runtime.engine import Engine
    spec, store = _setup("yolov2", 64, port=True)
    frames = _frames(64)
    default = Engine(spec, store, "int16", device="cpu")
    assert {k for k, _ in default.model.route.values()} == {"mm", "conv3"}
    monkeypatch.setenv("YOLO2_Q16_PLAN", P2)
    eng = Engine(spec, store, "int16", device="cpu")
    assert eng.model.route[0] == ("conv3_pool", "acc_h")
    assert eng.model.route[2] == ("conv3_pool", "out")
    np.testing.assert_array_equal(eng.predict_batch_rgb(frames),
                                  default.predict_batch_rgb(frames))
    # the other tiers plan nothing, in yolotpu as here
    w8 = Engine(spec, store, "w8a16", device="cpu")
    assert {k for k, _ in w8.model.route.values()} == {"mm", "conv3"}
    monkeypatch.setenv("YOLO2_Q16_PLAN", "0:conv3")
    with pytest.raises(ValueError, match="is not applicable"):
        Engine(spec, store, "int16", device="cpu")
