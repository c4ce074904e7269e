"""The port's report bundles (yolotpu_torch.cli.report) and staged pipeline
(yolotpu_torch.cli.pipeline) against yolotpu's, on the CPU: run, list,
compare and parse-log (run on --device cpu; on cuda with no card it
raises); parse_inference_log and _flatten equal; the stage windowing, the
JAX stage names taken as the port's, and the reference's argv lists parsed
by both; the --init-config text; the config reader against
yaml.safe_load; the host stages at 64x64 (the card stages exit 1 with no
card)."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from yolotpu.cli import pipeline as jpl
from yolotpu.cli import report as jrp
from yolotpu_torch.cli import pipeline as pl
from yolotpu_torch.cli import report as rp
from yolotpu_torch.models import zoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = ["--report-dir", "reports", "run", "--model", "yolov2", "--width",
       "64", "--height", "64", "--batch", "2", "--steps", "3",
       "--synthetic-weights", "--device", "cpu", "--batch1-chain", "8"]


def test_report_run_list_compare_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("YOLO2_NO_DUMP", "1")
    assert rp.main([*RUN, "--label", "a", "--precision", "int16",
                    "--profile-layers"]) == 0
    assert rp.main([*RUN, "--label", "b", "--precision", "fp32"]) == 0
    dirs = sorted(os.listdir("reports"))
    assert [d.split("_", 2)[2] for d in dirs] == ["a", "b"]
    for d in dirs:
        assert sorted(os.listdir(f"reports/{d}")) == [
            "meta.json", "metrics.json", "summary.md"]
    a = json.load(open(f"reports/{dirs[0]}/metrics.json"))
    b = json.load(open(f"reports/{dirs[1]}/metrics.json"))
    assert a["latency"]["count"] == 3 and a["latency"]["fps"] > 0
    assert (a["platform"], a["device"], a["power_limit_w"]) == ("cpu", "cpu",
                                                               None)
    assert a["torch_version"] == torch.__version__
    assert {"build_seconds", "capture_seconds", "memory", "cuda_version",
            "batch1_device_p50_ms", "batch1_chain"} <= set(a)
    assert "compile_seconds" not in a and "rpc_floor_ms" not in a
    assert [t["idx"] for t in a["per_layer"]] == list(range(32))
    assert "per_layer" not in b and b["precision"] == "fp32"
    summary = open(f"reports/{dirs[0]}/summary.md").read()
    assert "## Per-layer utilization" in summary and "| 31 | region |" in summary
    meta = json.load(open(f"reports/{dirs[0]}/meta.json"))
    assert meta["label"] == "a"
    capsys.readouterr()
    assert rp.main(["--report-dir", "reports", "list"]) == 0
    out = capsys.readouterr().out
    assert "yolov2 int16 b2" in out and "yolov2 fp32 b2" in out
    assert rp.main(["--report-dir", "reports", "compare", *dirs]) == 0
    out = capsys.readouterr().out
    assert "latency.median_ms" in out and "batch1_device_p50_ms" in out
    # the JAX package's compare reads the port's bundles alike
    assert jrp.main(["--report-dir", "reports", "compare", *dirs]) == 0
    assert capsys.readouterr().out == out
    assert rp.main(["--report-dir", "reports2", "init"]) == 0
    assert os.path.isdir("reports2") and rp.main(
        ["--report-dir", "reports2", "list"]) == 0


def test_report_run_on_cuda_raises_without_a_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card path")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rp.main([a for a in RUN if a not in ("--device", "cpu")])
    assert not os.path.exists("reports")


@pytest.mark.parametrize("lines", [
    ["frame 0: inference time: 10.00 ms", "noise", "inference time: 20 ms",
     "frame 2: inference time: 30.5 ms"],
    ["inference time: 7.25 ms"] * 5 + ["inference time:1ms"],
    ["nothing here"],
], ids=["three", "six", "none"])
def test_parse_inference_log_equal(tmp_path, lines, capsys):
    log = tmp_path / "run.log"
    log.write_text("\n".join(lines) + "\n")
    got = rp.parse_inference_log(str(log))
    assert got == jrp.parse_inference_log(str(log))
    rc = rp.main(["parse-log", str(log)])
    assert rc == jrp.main(["parse-log", str(log)])
    assert rc == (0 if got["count"] else 1)


def test_flatten_equal():
    doc = {"a": 1, "b": {"c": 2.5, "d": {"e": 3, "f": "x"}, "g": [1]},
           "h": True, "i": None, "latency": {"count": 3, "fps": 1e3}}
    assert rp._flatten(doc) == jrp._flatten(doc)
    assert rp._flatten(doc, "p.") == jrp._flatten(doc, "p.")


def test_stage_windowing_and_aliases():
    assert pl.compute_stage_list(None, None) == pl.STAGES
    assert pl.STAGES == [pl.ALIASES.get(s, s) for s in jpl.STAGES]
    for i, a in enumerate(jpl.STAGES):
        for b in jpl.STAGES[i:]:
            assert pl.compute_stage_list(a, b) == [
                pl.ALIASES.get(s, s) for s in jpl.compute_stage_list(a, b)]
            assert pl.compute_stage_list(pl.ALIASES.get(a, a), b) == \
                pl.compute_stage_list(a, b)
    for a, b in (("report", "artifacts"), ("tpu_run", "tpu_compile"),
                 ("gpu_run", "host_sanity")):
        with pytest.raises(ValueError):
            pl.compute_stage_list(a, b)
    with pytest.raises(ValueError):
        jpl.compute_stage_list("tpu_run", "tpu_compile")


@pytest.mark.parametrize("argv", [
    [], ["--from", "tpu_compile", "--to", "tpu_run"], ["--from", "artifacts"],
    ["--to", "host_quickstart"], ["--config", "pipe.yaml", "--from",
                                  "tpu_run"], ["--from", "report"]],
    ids=["none", "tpu", "from", "to", "config", "report"])
def test_reference_argv_parses_in_both(argv, capsys):
    assert jpl.main(argv + ["--list-stages"]) == 0
    want = capsys.readouterr().out.split()
    assert pl.main(argv + ["--list-stages"]) == 0
    assert capsys.readouterr().out.split() == [pl.ALIASES.get(s, s)
                                               for s in want]
    for bad in (["--from", "nope"], ["--to", "compile"]):
        with pytest.raises(SystemExit):
            pl.main(bad)


def test_init_config_text(tmp_path):
    for mod in (pl, jpl):
        p = tmp_path / f"{mod.__name__}.yaml"
        assert mod.main(["--init-config", str(p)]) == 0
    texts = [(tmp_path / f"{m.__name__}.yaml").read_text() for m in (pl, jpl)]
    assert texts[0] == texts[1] == pl.DEFAULT_CONFIG
    assert pl.parse_config(texts[0]) == yaml.safe_load(texts[1])


@pytest.mark.parametrize("text", [
    pl.DEFAULT_CONFIG,
    jpl.DEFAULT_CONFIG,
    open(os.path.join(REPO, "pipeline.yaml")).read(),
    "a: 1.5\nb: -3\nc: 'x y'\nd: \"q # r\"\ne: yes\nf: Off\ng: ~\nh: 1_000\n"
    "i: .5\nj: 1e5\nk: 2.5e+3\nl: abc # c\nm:\nn: 0\no: +7\np: NULL\n"
    "# full-line comment\n\nq: weights/dir\nr: 3.\n",
], ids=["default", "jax-default", "pipeline.yaml", "scalars"])
def test_config_reader_equals_yaml(text):
    assert pl.parse_config(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["- a\n", "a b\n", "a:b\n", ": x\n"])
def test_config_reader_refuses_other_forms(text):
    with pytest.raises(ValueError, match="config line 1"):
        pl.parse_config(text)


def test_pipeline_host_stages_and_card_stages(tmp_path, monkeypatch, capsys):
    """host_sanity, artifacts and host_quickstart at 64x64 (the model and
    the generated test image cut to that size); the card stages exit 1
    with no card."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("YOLO2_NO_DUMP", "1")
    build = zoo.build
    monkeypatch.setattr(zoo, "build", lambda name, batch=1, width=None,
                        height=None: build(name, batch, 64, 64))
    monkeypatch.setattr(pl, "_test_image", lambda cfg: np.random.default_rng(
        7).random((3, 64, 64)).astype(np.float32))
    (tmp_path / "pipe.yaml").write_text("model: yolov2\nsynthetic_weights: "
                                        "true\nbatch: 2\n")
    assert pl.main(["--config", "pipe.yaml", "--from", "host_sanity", "--to",
                    "host_quickstart"]) == 0
    out = capsys.readouterr().out
    assert f"torch {torch.__version__}" in out and "nvcc:" in out
    assert "golden fp32:" in out and "golden int16:" in out
    assert sorted(os.listdir("weights")) == [
        "bias.bin", "bias_int16.bin", "bias_int16_Q.bin", "iofm_Q.bin",
        "weight_int16.bin", "weight_int16_Q.bin", "weights.bin"]
    assert pl.main(["--config", "pipe.yaml", "--from", "report"]) == 0
    if torch.cuda.is_available():
        return
    for stage in ("tpu_compile", "gpu_build", "tpu_run", "gpu_run"):
        assert pl.main(["--config", "pipe.yaml", "--from", stage, "--to",
                        stage]) == 1
        assert "no CUDA device" in capsys.readouterr().err
    assert not os.path.exists("reports")
