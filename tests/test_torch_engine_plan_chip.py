"""The card's engine plan in the port (yolotpu_torch.models.engine_plan's
plan file loader, tools/plan_search) against the JAX package's loader, on
the CPU, at small sizes.

- The loader: a plan file of an invented card drives the knobs, the env
  lever wins per layer, an unknown kind raises ValueError, a card with no
  file runs the port's rule (never yolotpu's V5E_DEFAULTS), the CPU reads
  no file; ``device_kind_slug`` is yolotpu's.
- ``plan_key`` binds a file's per-layer plan to one network: the same for
  yolov2 416 and its copy, another for yolov2-s2, yolov2-tiny and yolov2 at
  608, where the file's kinds (P1, illegal on those networks) are not
  applied and nothing raises.
- The checked-in plan of NVIDIA H100 80GB HBM3 loads, is legal on yolov2
  416 and keyed to it; under its kinds (as explicit overrides: the key binds
  the file to 416) the port's head at 64x64 and 128x128 is bit-equal to
  yolotpu's build_forward(compute="int32"), and at 64x64 to
  compute="pallas" under the same YOLO2_Q16_PLAN (and yolotpu's
  YOLO2_Q16_ENTRY, which keeps its CPU plan file's entry off).
- plan_search's grid at yolov2 416 (54 legal rows, the rule, P1 and P2
  among them), the plan file it emits from fixed readings, and its refusal
  without a card.
- Engine, the profiler's prefixes and report run under a plan.
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
CARD = "NVIDIA H999 Test"   # an invented card
H100 = "NVIDIA H100 80GB HBM3"
PLANS = os.path.join(os.path.dirname(engine_plan.__file__), os.pardir,
                     "plans")
HOSTS = {False: (jzoo, jweights, jquant), True: (zoo, tweights, tquant)}


def _file(tmp_path, name: str, doc: dict) -> str:
    path = tmp_path / f"{engine_plan.device_kind_slug(name)}.json"
    path.write_text(json.dumps(doc))
    return str(path)


@pytest.fixture
def card(monkeypatch, tmp_path):
    """The loader on an invented card whose plan files live in tmp_path."""
    monkeypatch.setenv("YOLO2_PLAN_DIR", str(tmp_path))
    monkeypatch.delenv("YOLO2_Q16_PLAN", raising=False)
    monkeypatch.setattr(engine_plan, "current_device_kind",
                        lambda device: ("cpu" if torch.device(device).type
                                        == "cpu" else CARD))
    return tmp_path


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
# the loader
# ---------------------------------------------------------------------------

def test_plan_file_drives_the_knobs_and_env_wins(card, monkeypatch):
    spec = zoo.build("yolov2", width=64, height=64)
    path = _file(card, CARD, {"device_kind": CARD,
                              "plan_key": engine_plan.plan_key(spec),
                              "plan": {"0": "entry_sd", "2": "sd_pool",
                                       "6": "conv3p2"}})
    knobs = engine_plan.resolve_knobs(spec, torch.device("cuda"))
    assert knobs == {"plan": {0: "entry_sd", 2: "sd_pool", 6: "conv3p2"},
                     "source": path}
    assert engine_plan.load_chip_plan(CARD, spec) == knobs
    assert engine_plan.tier_overrides(spec, "int16", "cuda") == knobs["plan"]
    assert engine_plan.tier_overrides(spec, "int8", "cuda") is None
    # the env lever on top of the file, per layer
    monkeypatch.setenv("YOLO2_Q16_PLAN", "0:conv3,2:conv3p2,4:conv3")
    knobs = engine_plan.resolve_knobs(spec, "cuda")
    assert knobs["plan"] == {0: "conv3", 2: "conv3p2", 4: "conv3",
                             6: "conv3p2"}
    assert knobs["source"] == path
    assert engine_plan.tier_overrides(spec, "int16", "cuda") == knobs["plan"]
    monkeypatch.setenv("YOLO2_Q16_PLAN", "2:warp9")
    with pytest.raises(ValueError, match="YOLO2_Q16_PLAN"):
        engine_plan.resolve_knobs(spec, "cuda")


def test_unknown_kind_in_a_file_raises(card):
    spec = zoo.build("yolov2", width=64, height=64)
    _file(card, CARD, {"plan": {"0": "warp9"}})
    with pytest.raises(ValueError, match="unknown engine kind"):
        engine_plan.resolve_knobs(spec, "cuda")
    _file(card, CARD, {"plan_key": "elsewhere", "plan": {"2": "fused"}})
    with pytest.raises(ValueError, match="unknown engine kind 'fused'"):
        engine_plan.resolve_knobs(spec, "cuda")


def test_no_file_gives_the_rule_not_v5e(card, capsys):
    spec = zoo.build("yolov2", width=64, height=64)
    engine_plan._warned_kinds.discard(CARD)
    knobs = engine_plan.resolve_knobs(spec, "cuda")
    assert knobs == {"plan": {}, "source": None}
    # yolotpu's fallback would run the entry conv as entry_sd; the rule not
    assert jplan.V5E_DEFAULTS["entry"] == "sd"
    assert engine_plan.plan(spec, knobs["plan"])[0] == "conv3"
    assert "max_hw" not in knobs and "xla_min_c" not in knobs
    assert engine_plan.plan(spec, engine_plan.tier_overrides(
        spec, "int16", "cuda")) == engine_plan.plan(spec)
    engine_plan.resolve_knobs(spec, "cuda")
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "engine_plan" in ln]
    assert len(lines) == 1 and str(card) in lines[0]
    assert "plan_search" in lines[0]


def test_cpu_reads_no_file(card, capsys):
    spec = zoo.build("yolov2", width=64, height=64)
    for name in ("cpu", CARD):
        _file(card, name, {"plan_key": engine_plan.plan_key(spec),
                           "plan": {"2": "sd_pool"}})
    assert engine_plan.resolve_knobs(spec, "cpu") == {"plan": {},
                                                      "source": None}
    assert engine_plan.tier_overrides(spec, "int16", torch.device("cpu")) == {}
    assert "engine_plan" not in capsys.readouterr().out


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
# plan_key
# ---------------------------------------------------------------------------

def test_plan_key_binds_the_plan_to_its_network():
    spec = zoo.build("yolov2")
    key = engine_plan.plan_key(spec)
    assert engine_plan.plan_key(zoo.build("yolov2")) == key
    assert engine_plan.plan_key(NetworkSpec(spec.net, list(spec.layers))) == key
    others = {"yolov2-s2": yolov2_s2(416),
              "yolov2-tiny": zoo.build("yolov2-tiny"),
              "yolov2 608": zoo.build("yolov2", width=608, height=608),
              "yolov2-voc": zoo.build("yolov2-voc")}
    keys = {n: engine_plan.plan_key(s) for n, s in others.items()}
    assert key not in keys.values() and len(set(keys.values())) == 4


@pytest.mark.parametrize("model", ["yolov2-s2", "yolov2-tiny", "yolov2 608"])
def test_a_foreign_key_runs_the_rule(card, model):
    """P1, keyed to yolov2 416, is not applied to another network (where its
    sd_pool would raise); yolov2 416 takes it."""
    spec = zoo.build("yolov2")
    path = _file(card, CARD, {"plan_key": engine_plan.plan_key(spec),
                              "plan": {
                                  str(i): k for i, k in
                                  engine_plan._parse_plan_items(P1).items()}})
    other = {"yolov2-s2": lambda: yolov2_s2(416),
             "yolov2-tiny": lambda: zoo.build("yolov2-tiny"),
             "yolov2 608": lambda: zoo.build("yolov2", width=608,
                                             height=608)}[model]()
    if model != "yolov2 608":
        with pytest.raises(ValueError, match="is not applicable"):
            engine_plan.plan(other, engine_plan._parse_plan_items(P1))
    ov = engine_plan.tier_overrides(other, "int16", "cuda")
    assert ov == {}
    assert engine_plan.resolve_knobs(other, "cuda")["source"] == path
    assert engine_plan.plan(other, ov) == engine_plan.plan(other)
    ov = engine_plan.tier_overrides(spec, "int16", "cuda")
    assert ov == engine_plan._parse_plan_items(P1)


def test_entry_sd_on_any_network(card, monkeypatch):
    """yolotpu's entry "sd" is the per-layer kind "entry_sd" here: legal on
    a C<=4 3x3 at even H and W that a darknet 2x2/s2 pool follows (yolov2,
    yolov2-tiny), where it folds the pool; refused where no pool follows
    (yolov2-s2)."""
    monkeypatch.setenv("YOLO2_Q16_PLAN", "0:entry_sd")
    for spec in (zoo.build("yolov2", width=64, height=64),
                 zoo.build("yolov2-tiny", width=96, height=96)):
        ov = engine_plan.tier_overrides(spec, "int16", "cuda")
        assert ov == {0: "entry_sd"}
        assert engine_plan.kernels(spec, engine_plan.plan(spec, ov))[0] == (
            "conv3_pool", "acc")
    s2 = yolov2_s2(64)
    with pytest.raises(ValueError, match="is not applicable"):
        engine_plan.plan(s2, engine_plan.tier_overrides(s2, "int16", "cuda"))


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
# the card's checked-in plan
# ---------------------------------------------------------------------------

def _h100_doc() -> dict:
    with open(os.path.join(PLANS, f"{engine_plan.device_kind_slug(H100)}"
                                  ".json")) as f:
        return json.load(f)


def _h100_plan() -> str:
    return plan_search.plan_string(
        {int(i): k for i, k in _h100_doc()["plan"].items()})


def test_h100_plan_is_checked_in_and_keyed_to_yolov2_416(monkeypatch):
    monkeypatch.delenv("YOLO2_PLAN_DIR", raising=False)
    monkeypatch.delenv("YOLO2_Q16_PLAN", raising=False)
    doc = _h100_doc()
    spec = zoo.build("yolov2")
    assert doc["device_kind"] == H100 and doc["model"] == "yolov2"
    assert doc["plan_key"] == engine_plan.plan_key(spec)
    assert doc["nvidia_smi"].startswith(H100)
    knobs = engine_plan.load_chip_plan(H100, spec)
    assert knobs["plan"] == {int(i): k for i, k in doc["plan"].items()}
    assert "entry" not in doc
    engine_plan.plan(spec, knobs["plan"])   # legal: no raise
    # the evidence it names: every row's heads equal the rule's, and the plan
    # is its winner (the rule where none won)
    with open(os.path.join(PLANS, doc["evidence"])) as f:
        ev = json.load(f)
    assert ev["device_kind"] == H100 and ev["plan_key"] == doc["plan_key"]
    assert len(ev["rows"]) == 54 and ev["rounds"] >= 3
    assert all(r["heads_equal_rule"] for r in ev["rows"])
    assert {r["plan"] for r in ev["rows"]} == set(plan_search.grid(spec))
    assert ev["winner"] == doc["winner"]
    assert (doc["winner"] or {"plan": ""})["plan"] == _h100_plan()
    assert plan_search.plan_document(
        H100, spec, "yolov2", ev["rows"], ev["batch"], doc["evidence"],
        doc["date"], doc["nvidia_smi"]) == doc


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
def test_h100_plan_head_bitexact_vs_yolotpu(size):
    import jax
    spec, store = _setup("yolov2", size)
    fwd = jax.jit(jy.build_forward(spec, "int16", store.qtables,
                                   compute="int32", outputs=("head",)))
    want = np.asarray(fwd(jy.params_int16(spec, store),
                          jnp.asarray(_frames(size)))["head"])
    np.testing.assert_array_equal(_port_head(size, _h100_plan()), want)


def test_h100_plan_head_bitexact_vs_yolotpu_pallas(monkeypatch):
    """yolotpu's Pallas path under the same plan: YOLO2_Q16_PLAN names the
    plan's kinds and YOLO2_Q16_ENTRY=xla keeps its CPU plan file's "sd"
    entry off a conv the plan leaves to the rule."""
    plan = _h100_plan()
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


# ---------------------------------------------------------------------------
# plan_search
# ---------------------------------------------------------------------------

def test_grid_at_yolov2_416():
    spec = zoo.build("yolov2")
    rows = plan_search.grid(spec)
    assert len(rows) == len(set(rows)) == 54 and rows[0] == ""
    routes = set()
    for row in rows:
        kinds = engine_plan.plan(spec, engine_plan._parse_plan_items(row))
        routes.add(tuple(engine_plan.kernels(spec, kinds).values()))
    assert len(routes) == 54   # each row runs other kernels or orders
    for want in (P1, P2):
        kinds = engine_plan.plan(spec, engine_plan._parse_plan_items(want))
        assert tuple(engine_plan.kernels(spec, kinds).values()) in routes
    assert P1 in rows
    assert plan_search.candidates(spec) == {
        0: {"unfused": None, "acc": "entry_sdmm", "acc_h": "entryf"},
        2: {"unfused": None, "acc": "sd_pool", "out": "conv3p2"},
        6: {"unfused": None, "acc": "sd_pool", "out": "conv3p2"},
        10: {"unfused": None, "acc": "sd_pool"}}


def test_grid_leaves_out_routed_and_unpooled_convs():
    """yolov2-tiny: its 2x2/s1 pool and yolov2-s2's strided convs fold
    nothing; conv 16 of yolov2, which route 25 reads, is not a candidate."""
    assert sorted(plan_search.candidates(
        zoo.build("yolov2-tiny", width=96, height=96))) == [0, 2, 4, 6, 8]
    assert plan_search.candidates(yolov2_s2(64)) == {}
    assert plan_search.grid(yolov2_s2(64)) == [""]
    assert 16 not in plan_search.candidates(zoo.build("yolov2"))


def _rows(rule: float, best: float, spread: float) -> list[dict]:
    def row(plan, b128):
        return {"plan": plan, "median": {"b128": b128, "b8": b128 / 16,
                                         "b1": b128 / 50},
                "spread": {"b128": spread, "b8": spread / 16,
                           "b1": spread / 50}}
    return [row("", rule), row(P1, best), row("0:entryf", rule - 0.01)]


def test_emitted_plan_fields():
    spec = zoo.build("yolov2")
    rows = _rows(35.0, 29.0, 0.3)
    doc = plan_search.plan_document(H100, spec, "yolov2", rows, 128,
                                    "ev.json", "2026-10-18",
                                    f"{H100}, 700.00 W")
    assert doc == {
        "device_kind": H100, "model": "yolov2", "size": [416, 416],
        "plan_key": engine_plan.plan_key(spec),
        "plan": {"0": "entry_sdmm", "10": "sd_pool", "2": "sd_pool",
                 "6": "sd_pool"},
        "batch": 128,
        "winner": {"plan": P1, "median_ms": rows[1]["median"],
                   "spread_ms": rows[1]["spread"]},
        "rule": {"median_ms": rows[0]["median"],
                 "spread_ms": rows[0]["spread"]},
        "evidence": "ev.json", "date": "2026-10-18",
        "nvidia_smi": f"{H100}, 700.00 W"}
    # a win inside the spread is no win: the rule stays
    doc = plan_search.plan_document(H100, spec, "yolov2",
                                    _rows(35.0, 34.8, 0.3), 128, "ev.json",
                                    "2026-10-18", "")
    assert doc["plan"] == {} and doc["winner"] is None
    assert plan_search.choose(_rows(35.0, 36.0, 0.1)) is None


def test_choose_needs_a_win_at_every_batch():
    """One plan serves b=128, 8 and 1: a row that is fastest at b=128 but
    loses, or wins only inside the spread, at another batch is not taken;
    of the rows that win at every batch, the least mean of the medians over
    the rule's is."""
    rows = _rows(35.0, 29.0, 0.3)
    assert plan_search.choose(rows)["plan"] == P1
    rows[1]["median"]["b1"] = rows[0]["median"]["b1"] + 0.01
    assert plan_search.choose(rows) is None   # 0:entryf: inside spread
    rows[2]["median"].update(b128=34.0, b8=2.0, b1=0.6)
    assert plan_search.choose(rows)["plan"] == "0:entryf"
    rows[2]["median"]["b8"] = rows[0]["median"]["b8"] - rows[0]["spread"]["b8"]
    assert plan_search.choose(rows) is None
    # two rows that win everywhere: the faster at b=128 loses on the mean
    rows = _rows(35.0, 29.0, 0.3)   # P1: 29/35 at every batch
    rows[2]["median"].update(b128=28.9, b8=2.1, b1=0.68)
    assert plan_search.choose(rows)["plan"] == P1
    rows[2]["median"].update(b8=1.7, b1=0.5)
    assert plan_search.choose(rows)["plan"] == "0:entryf"


def test_emitted_plan_loads_for_its_network_only(card):
    spec = zoo.build("yolov2")
    doc = plan_search.plan_document(CARD, spec, "yolov2",
                                    _rows(35.0, 29.0, 0.3), 128, "ev.json",
                                    "2026-10-18", "")
    path = _file(card, CARD, doc)
    assert engine_plan.tier_overrides(spec, "int16", "cuda") == \
        engine_plan._parse_plan_items(P1)
    tiny = zoo.build("yolov2-tiny")
    assert engine_plan.tier_overrides(tiny, "int16", "cuda") == {}
    assert engine_plan.resolve_knobs(tiny, "cuda")["source"] == path


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
# the engine, the profiler and reports under a plan
# ---------------------------------------------------------------------------

def test_engine_on_cpu_keeps_the_rule(card, monkeypatch):
    """A plan file for the CPU's name and another card's change nothing on
    the CPU: Engine picks the rule's kinds and reads no file."""
    from yolotpu_torch.runtime.engine import Engine
    spec, store = _setup("yolov2", 64, port=True)
    for name in ("cpu", CARD):
        _file(card, name, {"plan_key": engine_plan.plan_key(spec),
                           "plan": {"2": "sd_pool"}})
    eng = Engine(spec, store, "int16", device="cpu")
    assert eng.plan_source is None
    assert eng.model.kinds == engine_plan.plan(spec)
    monkeypatch.setenv("YOLO2_Q16_PLAN", "0:entry_sd")   # the lever applies
    eng = Engine(spec, store, "int16", device="cpu")
    assert eng.model.kinds[0] == "entry_sd" and eng.plan_source is None
    np.testing.assert_array_equal(eng.predict_batch_rgb(_frames(64)),
                                  _port_head(64, "").transpose(0, 3, 1, 2))


def test_profiler_prefixes_take_the_networks_plan(card):
    """A prefix of the network has another plan_key: it takes the whole
    network's plan, less a fused kind at its last layer."""
    spec = zoo.build("yolov2", width=64, height=64)
    _file(card, CARD, {"plan_key": engine_plan.plan_key(spec),
                       "plan": {"0": "entry_sdmm", "2": "sd_pool"}})
    full = {0: "entry_sdmm", 2: "sd_pool"}
    assert engine_plan.tier_overrides(spec, "int16", "cuda") == full
    for n in (1, 2, 3, 4):
        pspec = NetworkSpec(spec.net, spec.layers[:n])
        assert engine_plan.tier_overrides(pspec, "int16", "cuda") == {}
        got = engine_plan.tier_overrides(pspec, "int16", "cuda", spec)
        assert got == {i: k for i, k in full.items() if i != n - 1}, n


def test_report_records_the_plan(tmp_path, monkeypatch):
    from yolotpu_torch.cli import report
    monkeypatch.setenv("YOLO2_Q16_PLAN", "0:entryf")
    argv = ["--report-dir", str(tmp_path / "reports"), "run", "--width",
            "64", "--height", "64", "--batch", "1", "--steps", "1",
            "--synthetic-weights", "--device", "cpu", "--no-batch1-p50"]
    assert report.main(argv) == 0
    (bundle,) = (tmp_path / "reports").iterdir()
    metrics = json.load(open(bundle / "metrics.json"))
    assert metrics["plan"]["source"] is None
    assert metrics["plan"]["kinds"]["0"] == "entryf"
    assert len(metrics["plan"]["kinds"]) == 23
    assert "- plan: the default rule (0:entryf)" in (
        bundle / "summary.md").read_text()
