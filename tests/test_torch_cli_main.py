"""The port's runtime CLI (yolotpu_torch.cli.main, the yolo2_linux analog)
and its gpu_check against yolotpu's cli.main and cli.tpu_check, on the CPU:
the same argv parses to the same values; image mode and video mode on a
small cfg write the same JSONL records and annotated PNG as yolotpu's;
--profile prints a row per layer in each mode; gpu_check fails without a
card."""

import os

import numpy as np
import pytest
import torch

from yolotpu.cli import main as jmain
from yolotpu_torch.cli import gpu_check, main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the port's parser's own destination
DIFFERENT = {"device"}

ARGVS = [
    ["-i", "a.png", "-t", "0.3", "-n", "0.5", "-v", "2"],
    ["--camera", "/dev/video1", "--cam-width", "320", "--cam-height", "240",
     "--cam-fps", "15", "--cam-format", "yuyv", "--batch-size", "8",
     "--device-nms", "--topk", "845", "--output-json", "o.jsonl"],
    ["--video", "v.mp4", "--video-width", "640", "--video-height", "480",
     "--video-fps", "10", "--infer-every", "3", "--max-frames", "9",
     "--save-annotated-dir", "ann", "--stream-mjpeg", "127.0.0.1:8090",
     "--stream-mjpeg-quality", "60", "--stream-mjpeg-fps", "5"],
    ["-w", "wdir", "-c", "net.cfg", "-l", "labels.txt", "--model",
     "yolov2-tiny", "--precision", "w8a16", "--backend", "golden",
     "--compute", "exact", "--synthetic-weights"],
    ["--profile", "--profile-mode", "prefix", "--profile-batch", "4"],
    [],
]

CFG = """[net]
batch=1
width=32
height=32
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
size=1
stride=1
pad=1
filters=16
activation=linear

[region]
anchors=1.0,1.0,3.0,3.0
bias_match=1
classes=3
coords=4
num=2
softmax=1
thresh=.6
"""


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) or "defaults"
                                             for a in ARGVS])
def test_main_argv_parses_as_in_the_jax_cli(argv):
    want = vars(jmain.build_argparser().parse_args(argv))
    got = vars(main.build_argparser().parse_args(argv))
    assert set(got) - set(want) == DIFFERENT and set(want) <= set(got)
    for dest in want:
        assert got[dest] == want[dest], dest
    assert got["device"] == "cuda"


def _run_both(tmp_path, monkeypatch, argv):
    """Each side's JSONL bytes and annotated files for the same argv (the
    port on the CPU's device backend, yolotpu on its golden backend)."""
    monkeypatch.setenv("YOLO2_NO_DUMP", "1")
    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "net.cfg"
    cfg.write_text(CFG)
    out = {}
    for who, mod, extra in (("port", main, ["--device", "cpu"]),
                            ("jax", jmain, ["--backend", "golden"])):
        d = tmp_path / who
        rc = mod.main(["-c", str(cfg), "--synthetic-weights", "--precision",
                       "int16", "-t", "0.01", "-v", "0", "--output-json",
                       str(d) + ".jsonl", "--save-annotated-dir", str(d)]
                      + argv + extra)
        assert rc == 0
        out[who] = ((tmp_path / f"{who}.jsonl").read_bytes(),
                    {p.name: p.read_bytes() for p in sorted(d.iterdir())})
    return out


# square frames: a letterboxed frame's padding holds boxes that lie outside
# the frame, which the drawing of both packages cannot draw (PIL refuses a
# rectangle whose bottom is above its top)
def test_image_mode_equals_yolotpu(tmp_path, monkeypatch):
    from PIL import Image
    png = tmp_path / "scene.png"
    Image.fromarray(np.random.default_rng(0).integers(
        0, 256, (96, 96, 3), dtype=np.uint8)).save(png)
    got = _run_both(tmp_path, monkeypatch, ["-i", str(png)])
    assert got["port"] == got["jax"]
    assert b'"mode":"image"' in got["port"][0]
    assert list(got["port"][1]) == ["scene_annotated.png"]


def test_video_mode_equals_yolotpu(tmp_path, monkeypatch):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.mp4")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (96, 96))
    if not wr.isOpened():
        pytest.skip("cv2 VideoWriter unavailable")
    rng = np.random.default_rng(1)
    for _ in range(6):
        wr.write((rng.random((96, 96, 3)) * 255).astype(np.uint8))
    wr.release()
    got = _run_both(tmp_path, monkeypatch,
                    ["--video", path, "--video-width", "96", "--video-height",
                     "96", "--batch-size", "2", "--max-frames", "5"])
    assert got["port"] == got["jax"]
    assert got["port"][0].count(b"\n") == 5
    assert len(got["port"][1]) == 5


@pytest.mark.parametrize("mode,compute,printed", [
    ("layer", "int32", "layer"), ("prefix", "int32", "prefix"),
    ("auto", "int32", "layer"), ("auto", "pallas", "prefix")])
def test_profile_prints_a_row_per_layer(tmp_path, monkeypatch, capsys, mode,
                                        compute, printed):
    """--profile on the CPU at 64x64: a row per layer in each mode (auto:
    prefix for --compute pallas, layer otherwise, as yolotpu picks), the
    top-10 table, then the run."""
    from yolotpu_torch.models import zoo
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("YOLO2_NO_DUMP", "1")
    (tmp_path / "y.cfg").write_text(zoo.to_cfg("yolov2").replace(
        "width=416", "width=64").replace("height=416", "height=64"))
    image = os.path.join(REPO, "examples", "small.png")
    assert main.main(["-c", "y.cfg", "--synthetic-weights", "--device", "cpu",
                      "--profile", "--profile-mode", mode, "--profile-batch",
                      "1", "--compute", compute, "-i", image]) == 0
    out = capsys.readouterr().out
    rows = [l for l in out.splitlines() if l.startswith(f"  {printed} ")]
    assert [int(l.split()[1]) for l in rows] == (
        list(range(32)) if printed == "layer" else list(range(1, 33)))
    assert "Top 10 slowest layers:" in out and "inference time:" in out
    assert main.main(["-i", "a.png", "--video", "b.mp4"]) == 2


def test_gpu_check_fails_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card path")
    assert gpu_check.main([]) == 1
    out = capsys.readouterr().out
    assert "devices=0" in out and "FAILURES PRESENT" in out
    assert out.count("EXCEPTION: no CUDA device") == 4
    assert gpu_check.main(["alloc"]) == 1


@pytest.mark.parametrize("port_argv,jax_argv", [
    (["--device", "cpu"], ["--backend", "cpu"]),
    (["--backend", "cpu", "--compute", "exact"], ["--backend", "cpu",
                                                  "--compute", "exact"]),
], ids=["device-vs-golden", "exact"])
def test_detect_cli_dump_layers_equal_yolotpu(tmp_path, monkeypatch,
                                              port_argv, jax_argv):
    """The detect CLI's --dump-layers: the port's layerNN.bin files equal
    yolotpu's byte for byte (the device backend's int16 against the golden
    int32 mode; both golden backends in exact mode)."""
    from PIL import Image
    from yolotpu.cli import detect as jdetect
    from yolotpu_torch.cli import detect
    monkeypatch.setenv("YOLO2_NO_DUMP", "1")
    monkeypatch.chdir(tmp_path)
    (tmp_path / "net.cfg").write_text(CFG)
    png = tmp_path / "scene.png"
    Image.fromarray(np.random.default_rng(2).integers(
        0, 256, (96, 96, 3), dtype=np.uint8)).save(png)
    for who, mod, extra in (("port", detect, port_argv),
                            ("jax", jdetect, jax_argv)):
        assert mod.main(["--cfg", "net.cfg", "--synthetic-weights",
                         "--precision", "int16", "--dump-layers", who,
                         "--output", f"pred_{who}", str(png)] + extra) == 0
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == [f"layer{i:02d}.bin" for i in range(4)]
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
