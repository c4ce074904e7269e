"""yolotpu_torch stands without JAX and without the JAX package, and its
kernel path never falls back.

- No source of the port, nor chip_smoke.py, imports JAX or anything of
  ``yolotpu``.
- A fresh interpreter with JAX and ``yolotpu`` blocked imports every module
  of the port, builds its spec and store from the port alone, and runs the
  slice (the int16 Engine, under the default plan and under
  YOLO2_Q16_PLAN; the fp32 Engine with device NMS on raw frames; the
  detect CLI; the golden backend, per-layer dumps, the stream runner with
  the native library, and the runtime CLIs; a darknet blob through
  weight_gen and back, the runtime CLI's --profile, a report bundle and the
  pipeline; a step of the training CLI with its checkpoint and export, and
  the accuracy protocol's hash and metrics; the plan search's grid, and its
  refusal without a card) at 64x64 on the CPU.
- With no card, Engine(device="cuda") raises, and a kernel launch raises
  without counting a launch.
- The nvcc command targets sm_90a and compiles only the port's csrc/*.cu
  (checked without running nvcc).
"""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import yolotpu_torch
from yolotpu_torch.ops import _build, q8, q16

REPO = Path(__file__).resolve().parent.parent
PKG = Path(yolotpu_torch.__file__).resolve().parent

_NO_JAX_RUN = r"""
import importlib, os, pkgutil, sys
sys.modules["jax"] = None          # any import of JAX fails,
sys.modules["flax"] = None
sys.modules["yolotpu"] = None      # and any of the JAX package
import numpy as np
import yolotpu_torch
for m in pkgutil.walk_packages(yolotpu_torch.__path__, "yolotpu_torch."):
    importlib.import_module(m.name)
from yolotpu_torch.models import zoo
from yolotpu_torch.runtime.engine import Engine, load_or_synthesize
from yolotpu_torch.cli.detect import main
spec = zoo.build("yolov2", width=64, height=64)
store = load_or_synthesize(spec, None, "int16", synthetic=True, seed=0)
eng = Engine(spec, store, "int16", device="cpu")
frames = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
heads = eng.predict_batch_rgb(frames)
assert heads.shape == (2, 425, 2, 2) and np.isfinite(heads).all(), heads.shape
os.environ["YOLO2_Q16_PLAN"] = "0:entryf,2:conv3p2,4:conv3p2"
planned = Engine(spec, store, "int16", device="cpu")
del os.environ["YOLO2_Q16_PLAN"]
assert planned.model.route[2] == ("conv3_pool", "out"), planned.model.route
assert (planned.predict_batch_rgb(frames) == heads).all()
fp32 = Engine(spec, load_or_synthesize(spec, None, "fp32", synthetic=True),
              device="cpu", device_nms=True)
tables = fp32.predict_batch_raw_frames(frames[:, :48])
assert [t.shape for t in tables] == [(2, 20, 4), (2, 20), (2, 20), (2, 20)]
rc = main(["--synthetic-weights", "--device", "cpu", "--net-size", "64",
           "--output", sys.argv[2], sys.argv[1]])
assert rc == 0, rc
# the runtime: the golden backend, per-layer dumps, the stream runner (its
# native letterbox included) and the runtime CLIs
from yolotpu_torch import native
from yolotpu_torch.cli import gpu_check, main as runtime_main
from yolotpu_torch.runtime.stream import StreamConfig, StreamRunner
gold = Engine(spec, store, "int16", backend="golden")
boxed = frames[0].transpose(2, 0, 1) / np.float32(255)
assert (gold.predict(boxed).head_chw == eng.predict(boxed).head_chw).all()
assert len(eng.predict_layers(boxed)) == 32
class Src:
    def __init__(self): self.f = list(frames)
    def read(self): return self.f.pop() if self.f else None
summary = StreamRunner(eng, StreamConfig(mode="video")).run(Src())
assert summary["count"] == 2 and native.available()
import torch
assert gpu_check.main(["enumerate"]) == (0 if torch.cuda.is_available() else 1)
# the plan search's grid, and its refusal without a card
from yolotpu_torch.tools import plan_search
assert len(plan_search.grid(zoo.build("yolov2"))) == 54
if not torch.cuda.is_available():
    assert plan_search.main([]) == 2
# the artifact-to-report flow: a darknet blob through weight_gen, reloaded;
# main --profile; a report bundle; the pipeline
from yolotpu_torch import darknet
from yolotpu_torch.cli import pipeline, report, weight_gen
cfg = os.path.join(sys.argv[2] + "_w", "yolov2_64.cfg")
os.makedirs(os.path.dirname(cfg))
open(cfg, "w").write(zoo.to_cfg("yolov2").replace("width=416", "width=64")
                     .replace("height=416", "height=64"))
blob = cfg.replace(".cfg", ".weights")
darknet.write_darknet(blob, spec, {l.idx: darknet.ConvParams(
    *store.fp32[l.idx], *((np.ones(l.n, np.float32), np.zeros(l.n, np.float32),
                          np.ones(l.n, np.float32)) if l.batch_normalize
                         else ())) for l in spec.conv_layers()})
wdir = os.path.dirname(cfg)
assert weight_gen.main(["--cfg", cfg, "--from-darknet", blob, "--out-dir",
                        wdir, "--reorg-out"]) == 0
mem = weight_gen.from_darknet(spec, blob, wdir, [boxed], reorg_out=True)
back = load_or_synthesize(spec, wdir, "int16")
assert back.qtables == mem.qtables and all(
    (back.int16[i][0] == mem.int16[i][0]).all() for i in back.int16)
assert runtime_main.main(["-c", cfg, "-w", wdir, "--device", "cpu",
                          "--profile", "--profile-mode", "layer",
                          "--profile-batch", "1", "-i", sys.argv[1]]) == 0
try:
    runtime_main.main(["-c", cfg, "--synthetic-weights", "--profile"])
    raise AssertionError("--profile ran with no card")
except RuntimeError as e:
    assert torch.cuda.is_available() or "no CUDA device" in str(e), e
assert report.main(["--report-dir", wdir + "/reports", "run", "--width", "64",
                    "--height", "64", "--batch", "1", "--steps", "1",
                    "--synthetic-weights", "--device", "cpu",
                    "--no-batch1-p50"]) == 0
assert pipeline.main(["--to", "host_sanity"]) == 0
assert pipeline.main(["--from", "gpu_build", "--to", "gpu_build"]) == (
    0 if torch.cuda.is_available() else 1)
# training and the accuracy protocol: a step of cli.train with a
# checkpoint and an export, the protocol's hash and its metrics
from yolotpu_torch import accuracy, eval as yeval
from yolotpu_torch.cli import train as train_cli
from yolotpu_torch.weights import WeightStore
assert accuracy.protocol_hash() == "b50b290992cfde91"
assert train_cli.main(["--cfg", cfg, "--synthetic-data", "--steps", "1",
                       "--batch", "1", "--device", "cpu", "--ckpt-dir",
                       wdir + "/ck", "--export-weights", wdir + "/trained"]) == 0
trained = WeightStore.load_fp32(spec, wdir + "/trained/weights.bin",
                                wdir + "/trained/bias.bin")
assert len(trained.fp32) == 23
gt = yeval.GroundTruth(np.array([[0.5, 0.5, 0.2, 0.2]], np.float32),
                       np.array([1], np.int32))
pred = yeval.Prediction(gt.boxes, gt.classes, np.ones(1, np.float32))
assert yeval.map_coco([pred], [gt], 2)["mAP_50_95"] == 1.0
loaded = sorted(n for n, m in sys.modules.items() if m is not None
                and n.split(".")[0] in ("jax", "jaxlib", "flax", "yolotpu"))
assert not loaded, loaded
print("NO_JAX_OK")
"""


def test_slice_runs_with_jax_blocked(tmp_path):
    out = tmp_path / "pred"
    env = dict(os.environ, PYTHONPATH=str(REPO), YOLO2_NO_DUMP="1")
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_RUN, str(REPO / "examples" / "small.png"),
         str(out)], capture_output=True, text=True, env=env, cwd=tmp_path,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout
    assert (tmp_path / "pred.png").exists()


def test_port_sources_never_import_jax():
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax)\b|"
                     r"^\s*(import|from)\s+yolotpu(\.|\s|$)", re.M)
    sources = [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]
    offenders = [str(p.relative_to(REPO)) for p in sources
                 if bad.search(p.read_text())]
    assert not offenders, offenders
    names = {m.name for m in pkgutil.walk_packages(yolotpu_torch.__path__,
                                                   "yolotpu_torch.")}
    assert {"yolotpu_torch.ops.q16", "yolotpu_torch.ops.q8",
            "yolotpu_torch.ops.nms", "yolotpu_torch.ops.letterbox",
            "yolotpu_torch.models.yolov2", "yolotpu_torch.golden",
            "yolotpu_torch.native", "yolotpu_torch.runtime.engine",
            "yolotpu_torch.runtime.stream", "yolotpu_torch.runtime.profiler",
            "yolotpu_torch.runtime.jsonl", "yolotpu_torch.runtime.camera",
            "yolotpu_torch.runtime.v4l2", "yolotpu_torch.runtime.video",
            "yolotpu_torch.runtime.mjpeg", "yolotpu_torch.cli.detect",
            "yolotpu_torch.cli.main", "yolotpu_torch.cli.gpu_check",
            "yolotpu_torch.darknet", "yolotpu_torch.cli.weight_gen",
            "yolotpu_torch.cli.report", "yolotpu_torch.cli.pipeline",
            "yolotpu_torch.train", "yolotpu_torch.checkpoint",
            "yolotpu_torch.eval", "yolotpu_torch.accuracy",
            "yolotpu_torch.cli.train", "yolotpu_torch.tools.accuracy_protocol",
            "yolotpu_torch.tools.int8_accuracy_sweep",
            "yolotpu_torch.tools.roofline", "yolotpu_torch.tools.plan_search",
            "yolotpu_torch.parallel.mesh",
            "yolotpu_torch.parallel.dryrun", "yolotpu_torch.parallel.comm",
            "yolotpu_torch.parallel.forward",
            "yolotpu_torch.parallel.launch"} <= names


def test_engine_on_cuda_raises_without_a_card():
    from yolotpu_torch.models import zoo
    from yolotpu_torch.runtime.engine import Engine, load_or_synthesize
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card path")
    spec = zoo.build("yolov2-tiny", width=32, height=32)
    store = load_or_synthesize(spec, None, "int16", synthetic=True, seed=0)
    for precision in ("int16", "fp32"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(spec, store, precision, device="cuda")


def test_kernel_launch_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        pytest.skip("a CUDA toolkit is installed; this checks the no-nvcc path")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    _build.load_library.cache_clear()
    try:
        out = torch.empty((4, 3), dtype=torch.int16)
        before = dict(q16.LAUNCHES)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.launch("mm_q16", "yq16_mm", out, 0, 0, 0, 0, None, 4, 8,
                          3, 0, 0, 1, counts=q16.LAUNCHES)
        assert q16.LAUNCHES == before
    finally:
        _build.load_library.cache_clear()


def test_nvcc_command_targets_sm90a_and_csrc_only():
    """One compile per source (started together), then one link."""
    compiles, link = _build.nvcc_commands("nvcc", Path("/tmp/b/lib.so"))
    srcs = []
    for cmd in compiles + [link]:
        assert cmd[0] == "nvcc"
        i = cmd.index("-gencode")
        assert cmd[i + 1] == "arch=compute_90a,code=sm_90a"
    for cmd in compiles:
        assert {"-c", "-O3", "-std=c++17"} <= set(cmd)
        assert cmd[cmd.index("-I") + 1] == str(PKG / "csrc")
        srcs += [Path(a) for a in cmd if a.endswith((".cu", ".cpp", ".c"))]
    assert srcs == sorted((PKG / "csrc").glob("*.cu"))
    assert {p.name for p in srcs} == {
        "mm_q16.cu", "conv3x3_q16.cu", "conv3x3_pool_q16.cu", "mm_s8.cu",
        "mm_w8a16.cu", "conv3x3_s8.cu", "conv3x3_w8a16.cu", "nms_greedy.cu",
        "conv_q16.cu", "conv_s8.cu", "conv_w8a16.cu", "conv3x3_pool_s8.cu"}
    objs = [cmd[cmd.index("-o") + 1] for cmd in compiles]
    assert "-shared" in link and link[link.index("-o") + 1] == "/tmp/b/lib.so"
    assert link[-len(objs):] == objs
    # the build key follows the sources
    assert re.fullmatch(r"[0-9a-f]{16}", _build.source_digest())


def test_plain_versions_have_no_kernel_launch():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-99, 99, (2, 5, 5, 8)).astype(np.int16))
    w = torch.from_numpy(rng.integers(-99, 99, (3, 3, 8, 4)).astype(np.int16))
    b = torch.zeros(4, dtype=torch.int32)
    before = dict(q16.LAUNCHES), dict(q8.LAUNCHES), dict(q8.INT16_OUT_LAUNCHES)
    q16.conv3x3_q16(x, w, b, 3, True)
    for order in q16.POOL_ORDERS:
        q16.conv3x3_pool_q16(x[:, :4, :4], w, b, 3, True, order)
    q16.mm_q16(x.reshape(-1, 8), w[0, 0].contiguous(), b, 3, True)
    x8, w8 = x.to(torch.int8), w.to(torch.int8)
    s = torch.full((4,), 3, dtype=torch.int32)
    q8.conv3x3_s8(x8, w8, b, s, True)
    q8.conv3x3_int8(x8, w8, b, 3, True)
    q8.conv3x3_w8a16(x, w8, b, s, True)
    for out in (torch.int8, torch.int16):
        q8.mm_s8(x8.reshape(-1, 8), w8[0, 0].contiguous(), b, s, True, out)
    q8.mm_w8a16(x.reshape(-1, 8), w8[0, 0].contiguous(), b, s, True)
    q16.conv_q16(x, w, b, 3, True, 2, 1)
    for out in (torch.int8, torch.int16):
        q8.conv_s8(x8, w8, b, s, True, 2, 0, out)
    q8.conv_w8a16(x, w8, b, s, True, 1, 0)
    assert (q16.LAUNCHES, q8.LAUNCHES, q8.INT16_OUT_LAUNCHES) == before
