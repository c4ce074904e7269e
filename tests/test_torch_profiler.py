"""The port's per-layer profiler (yolotpu_torch.runtime.profiler) against
yolotpu's, on the CPU: layer_ops_bytes for every yolov2 layer,
prefix_alive_sets and attribute_prefix_delta equal, and render, as_dicts,
roofline_table and render_roofline equal for the same report and chip
dict (the integer tiers; fp32 is held against the H100's fp32 peak); both
profilers run with a row per layer (their times are the CPU's, not
checked); each prefix runs the layers its last one needs, its output
bit-equal to the whole forward's; without a card, profiling on cuda raises. chip_smoke.py's bounds
read their peaks from H100_CHIP."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from yolotpu.models import zoo as jzoo
from yolotpu.runtime import profiler as jp
from yolotpu_torch.models import zoo
from yolotpu_torch.models.yolov2 import YoloV2Q
from yolotpu_torch.runtime import profiler as tp
from yolotpu_torch.runtime.engine import load_or_synthesize

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", ["yolov2", "yolov2-tiny", "yolov2-voc"])
@pytest.mark.parametrize("batch,eb", [(1, 2), (8, 1), (3, 4)])
def test_layer_ops_bytes_equal(name, batch, eb):
    ts, js = zoo.build(name), jzoo.build(name)
    for tl, jl in zip(ts.layers, js.layers):
        assert tp.layer_ops_bytes(tl, batch, eb) == jp.layer_ops_bytes(
            jl, batch, eb), tl.idx


@pytest.mark.parametrize("name", ["yolov2", "yolov2-tiny"])
def test_prefix_alive_sets_and_attribution_equal(name):
    ts, js = zoo.build(name, width=64, height=64), jzoo.build(
        name, width=64, height=64)
    alive = tp.prefix_alive_sets(ts)
    assert alive == jp.prefix_alive_sets(js)
    rng = np.random.default_rng(0)
    for trial in range(3):
        # a DCE-ing device (cum = the alive set's cost) and a device that
        # runs every layer of a prefix (PyTorch's), with noise
        cost = {l.idx: float(rng.uniform(0, 1)) for l in ts.layers}
        got, want = [], []
        for out, fn in ((got, tp.attribute_prefix_delta),
                        (want, jp.attribute_prefix_delta)):
            cums, deltas = {}, {}
            for l in ts.layers:
                cur = (sum(cost[k] for k in alive[l.idx]) if trial == 0 else
                       sum(cost[k] for k in range(l.idx + 1))
                       + (trial - 1) * 0.01 * (l.idx % 3))
                ms = fn(alive, cums, deltas, l.idx, cur)
                cums[l.idx], deltas[l.idx] = cur, ms
                out.append(ms)
        assert got == want
        if trial == 0:
            np.testing.assert_allclose(got, [cost[l.idx] for l in ts.layers])


def _reports(spec, rng):
    """The same seeded timings in a report of each package."""
    t, j = tp.ProfileReport(), jp.ProfileReport()
    for l in spec.layers:
        ms = float(rng.choice([0.0, rng.uniform(0.001, 2.0)], p=[0.1, 0.9]))
        args = (l.idx, l.type, ms, f"d{l.idx}" if l.idx % 2 else "",
                float(rng.uniform(0, 99)), float(rng.uniform(0, 999)))
        t.timings.append(tp.LayerTiming(*args))
        j.timings.append(jp.LayerTiming(*args))
    t.total_ms = j.total_ms = sum(x.ms for x in t.timings)
    return t, j


@pytest.mark.parametrize("precision", ["int16", "int8", "w8a16"])
@pytest.mark.parametrize("chip", ["v5e", "h100"])
def test_render_and_roofline_equal(precision, chip):
    chip = jp.V5E_CHIP if chip == "v5e" else tp.H100_CHIP
    spec = zoo.build("yolov2")
    t, j = _reports(spec, np.random.default_rng(1))
    assert t.render() == j.render()
    assert t.as_dicts() == j.as_dicts()
    got = tp.roofline_table(t, spec, 8, precision, chip)
    want = jp.roofline_table(j, jzoo.build("yolov2"), 8, precision, chip)
    assert got == want
    assert tp.render_roofline(got) == jp.render_roofline(want)


def test_h100_chip_and_fp32_bound():
    chip = tp.H100_CHIP
    assert (chip["peak_s8_tops"], chip["hbm_gbs"], chip["peak_fp32_tops"]) == (
        1979.0, 3350.0, 67.0)
    assert chip["s8_units_per_mac"] == {"int16": 4, "w8a16": 2, "int8": 1}
    spec = zoo.build("yolov2")
    t, _ = _reports(spec, np.random.default_rng(2))
    doc = tp.roofline_table(t, spec, 8, "fp32")
    assert doc["useful_tops_ceiling"] == 67.0 and doc["chip"] == chip["name"]
    conv = next(l for l in spec.layers if l.idx == 2)
    ops, byt = tp.layer_ops_bytes(conv, 8, 4)
    row = doc["rows"][2]
    assert row["floor_mxu_ms"] == round(ops / 67e12 * 1e3, 3)
    assert row["floor_hbm_ms"] == round(byt / 3350e9 * 1e3, 3)
    # the default chip is the H100's
    assert tp.roofline_table(t, spec, 8, "int16") == tp.roofline_table(
        t, spec, 8, "int16", chip)


def test_chip_smoke_bounds_read_h100_chip():
    """chip_smoke.py's peaks have one definition, the profiler's."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    peaks = {t.id: ast.unparse(node.value) for node in tree.body
             if isinstance(node, ast.Assign) for t in node.targets
             if isinstance(t, ast.Name) and t.id.startswith("PEAK_")}
    assert peaks == {
        "PEAK_MAC8": "H100_CHIP['peak_s8_tops'] * 1000000000000.0 / 2",
        "PEAK_BYTES": "H100_CHIP['hbm_gbs'] * 1000000000.0",
        "PEAK_FP32": "H100_CHIP['peak_fp32_tops'] * 1000000000000.0"}
    # the same values as the literals they replaced
    assert tp.H100_CHIP["peak_s8_tops"] * 1e12 / 2 == 1979e12 / 2
    assert tp.H100_CHIP["hbm_gbs"] * 1e9 == 3.35e12
    assert tp.H100_CHIP["peak_fp32_tops"] * 1e12 == 67e12


@pytest.mark.parametrize("name,width,precision", [
    ("yolov2", 64, "int16"), ("yolov2", 64, "int8"),
    ("yolov2-tiny", 96, "w8a16"), ("yolov2-tiny", 96, "fp32")])
def test_profilers_run_on_cpu_with_a_row_per_layer(name, width, precision,
                                                   capsys, monkeypatch):
    spec = zoo.build(name, width=width, height=width)
    store = load_or_synthesize(spec, None, precision, synthetic=True)
    layers = tp.profile_layers(spec, store, precision, batch=2, repeats=1,
                               device="cpu", progress=True)
    monkeypatch.setattr(tp, "PREFIX_ROUNDS", 1)
    prefix = tp.profile_prefix(spec, store, precision, batch=2,
                               device="cpu", progress=True)
    out = capsys.readouterr().out
    for rep in (layers, prefix):
        assert [t.idx for t in rep.timings] == [l.idx for l in spec.layers]
        assert all(t.ms >= 0 for t in rep.timings)
        assert len(rep.as_dicts()) == spec.n and "Top 10" in rep.render()
    assert out.count("  layer ") == spec.n and out.count("  prefix ") == spec.n
    convs = [t for t in layers.timings if t.type == "convolutional"]
    assert all(t.ms > 0 for t in convs)
    if precision != "fp32":
        kinds = {"mm", "conv3"}
        assert all(t.detail.split("[")[1].split("]")[0] in kinds
                   for t in convs)
    assert layers.total_ms == pytest.approx(sum(t.ms for t in layers.timings))
    doc = tp.roofline_table(prefix, spec, 2, precision)
    assert len(doc["rows"]) == spec.n
    assert list(prefix.prefix_ms) == [l.idx for l in spec.layers]
    assert prefix.total_ms == prefix.prefix_ms[spec.layers[-1].idx]


def test_profilers_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card path")
    spec = zoo.build("yolov2-tiny", width=32, height=32)
    store = load_or_synthesize(spec, None, "fp32", synthetic=True)
    for fn in (tp.profile_layers, tp.profile_prefix):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(spec, store, "fp32", device="cuda")
    with pytest.raises(ValueError, match="compute mode"):
        tp.profile_layers(spec, store, "fp32", "exact", device="cpu")


def test_prefix_forward_runs_the_alive_layers():
    """Each prefix's forward gives its last layer's output in the tier's
    dtype, bit-equal to the whole forward's, and runs only the layers that
    output needs (prefix_alive_sets): the prefixes ending at 25-27 (route
    25, conv 26, reorg 27) leave out the 13^2 tower, 17-24."""
    spec = zoo.build("yolov2", width=64, height=64)
    store = load_or_synthesize(spec, None, "int16", synthetic=True)
    tier = tp._tier(spec, store, "int16", "int32", torch.device("cpu"))
    x = torch.from_numpy(np.random.default_rng(3).random(
        (1, 64, 64, 3), dtype=np.float32))
    full = YoloV2Q(spec, tier[1], tier[0], "cpu", "int16",
                   outputs=("acts",))(x)["acts"]
    alive = tp.prefix_alive_sets(spec)
    assert alive[27] == set(range(17)) | {25, 26, 27}
    from yolotpu_torch.graph import NetworkSpec
    for n in range(1, spec.n + 1):
        pspec = NetworkSpec(spec.net, spec.layers[:n])
        model = tp._model(pspec, tier, "int16", torch.device("cpu"),
                          ("head",))
        ran = []
        step = model.step
        model.step = lambda l, cur, acts: ran.append(l.idx) or step(
            l, cur, acts)
        got = tp._prefix_forward(model, pspec, alive[n - 1])(x)
        assert ran == sorted(alive[n - 1]), n
        assert got.dtype == full[n - 1].dtype
        assert torch.equal(got, full[n - 1]), n


def test_tier_overrides_leave_out_a_pool_kind_at_the_prefix_end(monkeypatch):
    """The engine and the profiler build a tier's model under one choice of
    overrides: YOLO2_Q16_PLAN for int16, less a kind that folds the pool
    after the spec's last layer; each prefix under P1 builds and runs."""
    from yolotpu_torch.graph import NetworkSpec
    from yolotpu_torch.models import engine_plan
    monkeypatch.setenv("YOLO2_Q16_PLAN", "0:entry_sdmm,2:sd_pool")
    spec = zoo.build("yolov2", width=64, height=64)
    p1 = {0: "entry_sdmm", 2: "sd_pool"}
    assert engine_plan.tier_overrides(spec, "int16") == p1
    assert engine_plan.tier_overrides(spec, "int8") is None
    store = load_or_synthesize(spec, None, "int16", synthetic=True)
    tier = tp._tier(spec, store, "int16", "int32", torch.device("cpu"))
    x = torch.from_numpy(np.random.default_rng(4).random(
        (1, 64, 64, 3), dtype=np.float32))
    alive = tp.prefix_alive_sets(spec)
    for n in (1, 2, 3, 4):
        pspec = NetworkSpec(spec.net, spec.layers[:n])
        ov = engine_plan.tier_overrides(pspec, "int16")
        assert ov == {i: k for i, k in p1.items() if i != n - 1}, n
        model = tp._model(pspec, tier, "int16", torch.device("cpu"),
                          ("head",))
        out = tp._prefix_forward(model, pspec, alive[n - 1])(x)
        assert out.shape[1] == pspec.layers[-1].out_h, n


def test_roofline_tool_writes_its_table_on_cpu(tmp_path, monkeypatch, capsys):
    """``python -m yolotpu_torch.tools.roofline --device cpu`` at 64x64:
    one row per layer in the file it writes (named for the device), the
    table printed; with no card it raises by default and writes nothing."""
    import json

    from yolotpu_torch.tools import roofline

    monkeypatch.setattr(tp, "PREFIX_ROUNDS", 1)
    out = tmp_path / "plans"
    assert roofline.main(["--device", "cpu", "--width", "64", "--height",
                          "64", "--batch", "1", "--out-dir", str(out)]) == 0
    doc = json.load(open(out / "roofline_int16_cpu.json"))
    assert len(doc["rows"]) == zoo.build("yolov2").n
    assert doc["chip"] == tp.H100_CHIP["name"] and doc["device_kind"] == "cpu"
    assert doc["power_limit_w"] is None
    assert "Roofline: NVIDIA H100 SXM int16 b1" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            roofline.main(["--width", "64", "--height", "64",
                           "--out-dir", str(tmp_path / "never")])
        assert not (tmp_path / "never").exists()
