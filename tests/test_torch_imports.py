"""yolotpu_torch stands without JAX, and its kernel path never falls back.

- A fresh interpreter with JAX blocked imports every module of the port and
  runs the slice (Engine and the detect CLI) at 64x64 on the CPU.
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
from yolotpu_torch.ops import _build, q16

REPO = Path(__file__).resolve().parent.parent
PKG = Path(yolotpu_torch.__file__).resolve().parent

_NO_JAX_RUN = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of JAX fails
sys.modules["flax"] = None
import numpy as np
import yolotpu_torch
for m in pkgutil.walk_packages(yolotpu_torch.__path__, "yolotpu_torch."):
    importlib.import_module(m.name)
from yolotpu.models import zoo
from yolotpu.runtime.engine import load_or_synthesize
from yolotpu_torch.runtime.engine import Engine
from yolotpu_torch.cli.detect import main
spec = zoo.build("yolov2", width=64, height=64)
store = load_or_synthesize(spec, None, "int16", synthetic=True, seed=0)
eng = Engine(spec, store, device="cpu")
frames = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
heads = eng.predict_batch_rgb(frames)
assert heads.shape == (2, 425, 2, 2) and np.isfinite(heads).all(), heads.shape
rc = main(["--synthetic-weights", "--device", "cpu", "--net-size", "64",
           "--output", sys.argv[2], sys.argv[1]])
assert rc == 0, rc
loaded = sorted(n for n, m in sys.modules.items()
                if m is not None and n.split(".")[0] in ("jax", "jaxlib", "flax"))
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
                     r"yolotpu\.(models\.yolov2|ops|train|parallel)\b", re.M)
    offenders = [str(p.relative_to(REPO)) for p in PKG.rglob("*.py")
                 if bad.search(p.read_text())]
    assert not offenders, offenders
    names = {m.name for m in pkgutil.walk_packages(yolotpu_torch.__path__,
                                                   "yolotpu_torch.")}
    assert {"yolotpu_torch.ops.q16", "yolotpu_torch.models.yolov2",
            "yolotpu_torch.runtime.engine", "yolotpu_torch.cli.detect"} <= names


def test_engine_on_cuda_raises_without_a_card():
    from yolotpu.models import zoo
    from yolotpu.runtime.engine import load_or_synthesize
    from yolotpu_torch.runtime.engine import Engine
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card path")
    spec = zoo.build("yolov2-tiny", width=32, height=32)
    store = load_or_synthesize(spec, None, "int16", synthetic=True, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(spec, store, device="cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(spec, store, precision="int8", device="cpu")


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
            q16._launch("mm_q16", "yq16_mm", out, 0, 0, 0, 0, 4, 8, 3, 0, 0)
        assert q16.LAUNCHES == before
    finally:
        _build.load_library.cache_clear()


def test_nvcc_command_targets_sm90a_and_csrc_only():
    cmd = _build.nvcc_command("nvcc", Path("/tmp/lib.so"))
    assert cmd[0] == "nvcc"
    i = cmd.index("-gencode")
    assert cmd[i + 1] == "arch=compute_90a,code=sm_90a"
    assert {"-shared", "-O3", "-std=c++17"} <= set(cmd)
    srcs = [Path(a) for a in cmd if a.endswith((".cu", ".cpp", ".c"))]
    assert srcs == sorted((PKG / "csrc").glob("*.cu"))
    assert {p.name for p in srcs} == {"mm_q16.cu", "conv3x3_q16.cu"}
    assert cmd[cmd.index("-I") + 1] == str(PKG / "csrc")
    # the build key follows the sources
    assert re.fullmatch(r"[0-9a-f]{16}", _build.source_digest())


def test_plain_versions_have_no_kernel_launch():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-99, 99, (2, 5, 5, 8)).astype(np.int16))
    w = torch.from_numpy(rng.integers(-99, 99, (3, 3, 8, 4)).astype(np.int16))
    b = torch.zeros(4, dtype=torch.int32)
    before = dict(q16.LAUNCHES)
    q16.conv3x3_q16(x, w, b, 3, True)
    q16.mm_q16(x.reshape(-1, 8), w[0, 0].contiguous(), b, 3, True)
    assert q16.LAUNCHES == before
