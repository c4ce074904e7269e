"""The int16 tier's fold rule on every device, its lever and the plan
search in the port (yolotpu_torch.models.engine_plan, tools/plan_search),
against the JAX package, on the CPU, at small sizes.

- The rule: the default int16 head at 64x64 and 128x128 is bit-equal to
  yolotpu's build_forward(compute="int32") and to the port under P1's
  kinds, the kinds the H100's search chose, and at 64x64 to
  compute="pallas" under the same YOLO2_Q16_PLAN (and yolotpu's
  YOLO2_Q16_ENTRY, which keeps its CPU plan file's entry off); the search's
  evidence file names P1, whose kernels are the rule's at yolov2 416.
- The lever wins per conv: ``2:conv3`` unfolds conv 2, ``2:conv3p2``
  folds it in order "out", an unknown kind raises ValueError.
- ``plan_dir`` and ``device_kind_slug`` name the port's evidence files as
  yolotpu names its own.
- plan_search's grid at yolov2 416 (54 legal rows: the rule and the other
  routes of the convs it folds) and its refusal without a card.
- Engine, the profiler's prefixes and report run the rule's route.
"""

import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolotpu import quant as jquant
from yolotpu import weights as jweights
from yolotpu.models import engine_plan as jplan
from yolotpu.models import yolov2 as jy
from yolotpu.models import zoo as jzoo
from yolotpu_torch import quant as tquant
from yolotpu_torch import weights as tweights
from yolotpu_torch.graph import NetworkSpec
from yolotpu_torch.models import engine_plan
from yolotpu_torch.models import yolov2 as ty
from yolotpu_torch.models import zoo
from yolotpu_torch.tools import plan_search

P1 = "0:entry_sdmm,2:sd_pool,6:sd_pool,10:sd_pool"
P2 = "0:entryf,2:conv3p2,4:conv3p2"
H100 = "NVIDIA H100 80GB HBM3"
PLANS = os.path.join(os.path.dirname(engine_plan.__file__), os.pardir,
                     "plans")
HOSTS = {False: (jzoo, jweights, jquant), True: (zoo, tweights, tquant)}


def yolov2_s2(size: int) -> NetworkSpec:
    """yolov2 with each 2x2/s2 maxpool a 3x3/s2 conv of the same width."""
    import re
    import tempfile
    sections, filters = [], None
    for sec in zoo.to_cfg("yolov2").split("\n\n"):
        if sec.startswith("[maxpool]"):
            sec = ("[convolutional]\nbatch_normalize=1\n"
                   f"filters={filters}\nsize=3\nstride=2\npad=1\n"
                   "activation=leaky")
        if sec.startswith("[convolutional]"):
            filters = int(re.search(r"filters=(\d+)", sec).group(1))
        sections.append(sec)
    text = re.sub(r"(width|height)=416", rf"\g<1>={size}",
                  "\n\n".join(sections))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "s2.cfg")
        with open(path, "w") as f:
            f.write(text)
        return NetworkSpec.from_cfg(path)


# ---------------------------------------------------------------------------
# where the evidence files live
# ---------------------------------------------------------------------------

def test_current_device_kind_takes_the_device():
    assert engine_plan.current_device_kind(torch.device("cpu")) == "cpu"
    assert engine_plan.current_device_kind("cpu") == "cpu"


def test_plan_dir_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("YOLO2_PLAN_DIR", raising=False)
    assert os.path.samefile(engine_plan.plan_dir(), PLANS)
    assert not os.path.samefile(engine_plan.plan_dir(), jplan.plan_dir())
    monkeypatch.setenv("YOLO2_PLAN_DIR", "/elsewhere")
    assert engine_plan.plan_dir() == "/elsewhere"


@pytest.mark.parametrize("name", [
    "NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe", "TPU v5 lite", "cpu",
    "  NVIDIA GeForce RTX 4090 (laptop) ", "A--B__c.9"])
def test_device_kind_slug_is_yolotpus(name):
    assert engine_plan.device_kind_slug(name) == jplan.device_kind_slug(name)


# ---------------------------------------------------------------------------
# the lever over the rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lever,route", [
    ("2:conv3", ("conv3", None)), ("2:conv3p2", ("conv3_pool", "out")),
    ("2:warp9", None)])
def test_the_lever_wins_over_the_rule(lever, route, monkeypatch):
    """YOLO2_Q16_PLAN decides each conv it names, fold or none; the rule the
    others: conv 2 runs unfused (pool 3 as its own op) or folds in "out",
    convs 0, 6 and 10 fold by the rule; an unknown kind raises."""
    monkeypatch.setenv("YOLO2_Q16_PLAN", lever)
    spec = zoo.build("yolov2", width=64, height=64)
    if route is None:
        with pytest.raises(ValueError, match="YOLO2_Q16_PLAN: unknown"):
            engine_plan.tier_overrides("int16")
        return
    ov = engine_plan.tier_overrides("int16")
    got = engine_plan.kernels(spec, "int16", ov)
    assert got == {**engine_plan.kernels(spec, "int16"), 2: route}
    assert engine_plan.kernels(spec, "int16")[2] == ("conv3_pool", "acc")
    _, store = _setup("yolov2", 64, port=True)
    net = ty.YoloV2Q(spec, store.qtables, ty.params_int16(spec, store), "cpu",
                     "int16", ov)
    assert net.route == got and (3 in net.folded) == (route[1] == "out")
    np.testing.assert_array_equal(net(torch.from_numpy(_frames(64)))["head"],
                                  _port_head(64, ""))


def test_entry_sd_on_any_network(monkeypatch):
    """yolotpu's entry "sd" is the per-layer kind "entry_sd" here: legal on
    a C<=4 3x3 at even H and W that a darknet 2x2/s2 pool follows (yolov2,
    yolov2-tiny), where it folds the pool; refused where no pool follows
    (yolov2-s2)."""
    monkeypatch.setenv("YOLO2_Q16_PLAN", "0:entry_sd")
    ov = engine_plan.tier_overrides("int16")
    assert ov == {0: "entry_sd"}
    for spec in (zoo.build("yolov2", width=64, height=64),
                 zoo.build("yolov2-tiny", width=96, height=96)):
        assert engine_plan.kernels(spec, "int16", ov)[0] == (
            "conv3_pool", "acc")
    with pytest.raises(ValueError, match="is not applicable"):
        engine_plan.plan(yolov2_s2(64), ov)


def test_select_engine_entry_as_yolotpu():
    """The kind "entry_sd" is legal exactly where yolotpu's select_engine
    picks it under entry "sd"."""
    for model, size in (("yolov2", 64), ("yolov2-tiny", 96), ("yolov2", 72)):
        spec = zoo.build(model, width=size, height=size)
        jspec = jzoo.build(model, width=size, height=size)
        for l, jl in zip(spec.conv_layers(), jspec.conv_layers()):
            try:
                engine_plan.select_engine(l, spec, {l.idx: "entry_sd"})
                got = True
            except ValueError:
                got = False
            want = jplan.select_engine(jl, jspec, entry="sd",
                                       max_hw=1 << 30) == "entry_sd"
            assert got == want, (model, l.idx)


# ---------------------------------------------------------------------------
# the rule at yolov2 416 and the search's evidence for it
# ---------------------------------------------------------------------------

def test_evidence_winner_gives_the_rules_kernels():
    """The H100 search (made when the rule folded nothing, its "" row
    unfused) chose P1 at every batch; P1's kernels are the rule's."""
    with open(os.path.join(PLANS, "plan_search_yolov2_416_"
                           f"{engine_plan.device_kind_slug(H100)}.json")) as f:
        ev = json.load(f)
    spec = zoo.build("yolov2")
    assert ev["device_kind"] == H100 and ev["winner"]["plan"] == P1
    assert len(ev["rows"]) == 54 and ev["rounds"] >= 3
    assert all(r["heads_equal_rule"] for r in ev["rows"])
    assert engine_plan.kernels(spec, "int16", engine_plan._parse_plan_items(
        P1)) == engine_plan.kernels(spec, "int16")
    unfused = {"0": "xla", **dict.fromkeys(("2", "6", "10"), "conv3")}
    assert engine_plan.kernels(spec, "int16", {
        int(i): k for i, k in unfused.items()}) == ty.unfused(
        engine_plan.kernels(spec, "int16"))
    rule = next(r for r in ev["rows"] if r["plan"] == "")
    won = next(r for r in ev["rows"] if r["plan"] == P1)
    assert all(won["median"][b] < rule["median"][b] for b in rule["median"])


@functools.cache
def _setup(model: str, size: int, port: bool = False):
    zoo_, weights, quant = HOSTS[port]
    spec = zoo_.build(model, width=size, height=size)
    store = weights.WeightStore.synthetic(spec, seed=0)
    img = np.random.default_rng(100).random((3, size, size)).astype(np.float32)
    quant.quantize_weights(store, quant.calibrate_activations(spec, store,
                                                              [img]))
    return spec, store


def _frames(size: int) -> np.ndarray:
    return np.random.default_rng(size).integers(
        0, 256, (2, size, size, 3)).astype(np.uint8)


def _port_head(size: int, plan: str) -> np.ndarray:
    spec, store = _setup("yolov2", size, port=True)
    net = ty.YoloV2Q(spec, store.qtables, ty.params_int16(spec, store), "cpu",
                     "int16", engine_plan._parse_plan_items(plan))
    return net(torch.from_numpy(_frames(size)))["head"].numpy()


@pytest.mark.parametrize("size", [64, 128])
def test_default_int16_head_bitexact_vs_yolotpu_under_p1(size):
    """The rule's head (convs 0, 2, 6 and 10 folded in "acc") equals the
    port's under P1's kinds and yolotpu's int32 forward, which pools as its
    own op: the calibrated model does not wrap."""
    import jax
    spec, store = _setup("yolov2", size)
    fwd = jax.jit(jy.build_forward(spec, "int16", store.qtables,
                                   compute="int32", outputs=("head",)))
    want = np.asarray(fwd(jy.params_int16(spec, store),
                          jnp.asarray(_frames(size)))["head"])
    got = _port_head(size, "")
    assert torch.equal(torch.from_numpy(got),
                       torch.from_numpy(_port_head(size, P1)))
    np.testing.assert_array_equal(got, want)


def test_h100_plan_head_bitexact_vs_yolotpu_pallas(monkeypatch):
    """yolotpu's Pallas path under the same plan: YOLO2_Q16_PLAN names the
    plan's kinds and YOLO2_Q16_ENTRY=xla keeps its CPU plan file's "sd"
    entry off a conv the plan leaves to the rule."""
    plan = P1
    monkeypatch.setenv("YOLO2_Q16_PLAN", plan)
    monkeypatch.setenv("YOLO2_Q16_ENTRY", "xla")
    spec, store = _setup("yolov2", 64)
    params = jy.params_q16(spec, store)
    for i, k in engine_plan._parse_plan_items(plan).items():
        assert params[f"conv{i}"]["kind"] == k
    assert params["conv0"]["kind"] != "entry_sd" or "0:" in plan
    fwd = jy.build_forward(spec, "int16", store.qtables, compute="pallas",
                           outputs=("head",))
    x = _frames(64)[:1]
    want = np.asarray(fwd(params, jnp.asarray(x))["head"])
    got = _port_head(64, plan)[:1]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_port_head(64, "")[:1], want)


# ---------------------------------------------------------------------------
# plan_search
# ---------------------------------------------------------------------------

def test_grid_at_yolov2_416():
    spec = zoo.build("yolov2")
    rows = plan_search.grid(spec)
    assert len(rows) == len(set(rows)) == 54 and rows[0] == ""
    routes = set()
    for row in rows:
        routes.add(tuple(engine_plan.kernels(
            spec, "int16", engine_plan._parse_plan_items(row)).values()))
    assert len(routes) == 54   # each row runs other kernels or orders
    for want in (P1, P2):
        assert tuple(engine_plan.kernels(
            spec, "int16", engine_plan._parse_plan_items(want)).values()) \
            in routes
    assert P1 not in rows   # the rule's route: the row ""
    assert plan_search.candidates(spec) == {
        0: {"acc": None, "unfused": "xla", "acc_h": "entryf"},
        2: {"acc": None, "unfused": "conv3", "out": "conv3p2"},
        6: {"acc": None, "unfused": "conv3", "out": "conv3p2"},
        10: {"acc": None, "unfused": "conv3"}}


def test_grid_leaves_out_routed_and_unpooled_convs():
    """yolov2-tiny: its 2x2/s1 pool and yolov2-s2's strided convs fold
    nothing; conv 16 of yolov2, which route 25 reads, is not a candidate."""
    assert sorted(plan_search.candidates(
        zoo.build("yolov2-tiny", width=96, height=96))) == [0, 2, 4, 6, 8]
    assert plan_search.candidates(yolov2_s2(64)) == {}
    assert plan_search.grid(yolov2_s2(64)) == [""]
    assert 16 not in plan_search.candidates(zoo.build("yolov2"))


def test_summarize_median_and_spread():
    med, spread = plan_search.summarize({"b8": [2.0, 2.2, 2.1],
                                         "b1": [0.6, 0.6, 0.7]})
    assert med == {"b8": 2.1, "b1": 0.6}
    assert spread["b8"] == pytest.approx(0.2) and spread["b1"] == \
        pytest.approx(0.1)


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert plan_search.main(["--batch", "8"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the engine, the profiler and reports on the rule's route
# ---------------------------------------------------------------------------

def test_cpu_engine_runs_the_cards_route(monkeypatch):
    """On the CPU the int16 Engine takes the route the card takes: convs
    0, 2, 6 and 10 fold their pool in "acc"; its heads equal the unfused
    lever's engine's."""
    from yolotpu_torch.runtime.engine import Engine
    monkeypatch.delenv("YOLO2_Q16_PLAN", raising=False)
    spec, store = _setup("yolov2", 64, port=True)
    eng = Engine(spec, store, "int16", device="cpu")
    assert eng.model.kinds == engine_plan.plan(spec)
    assert {i: o for i, (k, o) in eng.model.route.items()
            if k == "conv3_pool"} == dict.fromkeys((0, 2, 6, 10), "acc")
    assert eng.model.folded == {1, 3, 7, 11}
    monkeypatch.setenv("YOLO2_Q16_PLAN", "0:xla,2:conv3,6:conv3,10:conv3")
    alone = Engine(spec, store, "int16", device="cpu")
    assert not alone.model.folded
    frames = _frames(64)
    got = eng.predict_batch_rgb(frames)
    assert torch.equal(torch.from_numpy(got),
                       torch.from_numpy(alone.predict_batch_rgb(frames)))
    np.testing.assert_array_equal(got, _port_head(64, "").transpose(0, 3, 1, 2))


@pytest.mark.parametrize("n", [18, 22, 25])
def test_profiler_prefix_leaves_conv16_unfused(n, monkeypatch):
    """A prefix ending between layers 17 and 24 holds pool 17 but not route
    25, which reads conv 16: the rule alone would fold conv 16 there; the
    prefix takes the whole network's route, which does not."""
    from yolotpu_torch.runtime import profiler as tp
    monkeypatch.delenv("YOLO2_Q16_PLAN", raising=False)
    spec, store = _setup("yolov2", 64, port=True)
    pspec = NetworkSpec(spec.net, spec.layers[:n])
    assert engine_plan.kernels(pspec, "int16")[16] == ("conv3_pool", "acc")
    tier = tp._tier(spec, store, "int16", "int32", torch.device("cpu"))
    model = tp._model(pspec, tier, "int16", torch.device("cpu"), ("head",),
                      spec)
    assert model.route == {i: r for i, r in
                           engine_plan.kernels(spec, "int16").items()
                           if i < n}
    assert model.route[16] == ("conv3", None) and 17 not in model.folded


def test_report_records_the_route(tmp_path, monkeypatch):
    from yolotpu_torch.cli import report
    monkeypatch.setenv("YOLO2_Q16_PLAN", "0:entryf")
    argv = ["--report-dir", str(tmp_path / "reports"), "run", "--width",
            "64", "--height", "64", "--batch", "1", "--steps", "1",
            "--synthetic-weights", "--device", "cpu", "--no-batch1-p50"]
    assert report.main(argv) == 0
    (bundle,) = (tmp_path / "reports").iterdir()
    metrics = json.load(open(bundle / "metrics.json"))
    assert "source" not in metrics["plan"]
    assert metrics["plan"]["kinds"]["0"] == "entryf"
    assert len(metrics["plan"]["kinds"]) == len(metrics["plan"]["route"]) == 23
    assert metrics["plan"]["route"]["0"] == ["conv3_pool", "acc_h"]
    assert metrics["plan"]["route"]["2"] == ["conv3_pool", "acc"]
    assert metrics["plan"]["route"]["16"] == ["conv3", None]
    assert ("- plan: kinds 0:entryf; pools folded at convs 0 (acc_h), "
            "2 (acc), 6 (acc), 10 (acc)") in (bundle / "summary.md").read_text()
