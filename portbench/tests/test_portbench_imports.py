"""What a run loads: nothing whose top-level name is jax, jaxlib, flax or
the JAX package yolotpu (compared whole: the port's yolotpu_torch is not
yolotpu), and the reference nothing of the port."""

import json
import subprocess
import sys
from pathlib import Path

from portbench.run import forbidden_loaded

ROOT = Path(__file__).resolve().parents[2]


def test_names_are_compared_whole():
    mods = ["yolotpu_torch", "yolotpu_torch.ops.q16", "jaxtyping", "flaxen",
            "numpy", "yolotpu", "yolotpu.ops", "jax.numpy", "jaxlib", "flax"]
    assert forbidden_loaded(mods) == ["flax", "jax.numpy", "jaxlib",
                                      "yolotpu", "yolotpu.ops"]


def _python(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=240)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_nor_the_jax_package():
    got = _python("""
import json, sys, time
from pathlib import Path
from portbench import traffic
from portbench.cell import run_cell
from portbench.run import forbidden_loaded
data = Path("portbench/tests/data")
cfg = json.loads((data / "configs" / "tiny-64-int8.json").read_text())
res, _ = run_cell(cfg, traffic.load("tiny-camera", root=data),
                  [{"name": "fps", "unit": "frames/s"}], 1, 0.3, True, "cpu",
                  time.perf_counter())
print(json.dumps({"correct": res["correct"], "bad": forbidden_loaded(),
                  "port": "yolotpu_torch" in sys.modules}))
""")
    assert got == {"correct": True, "bad": [], "port": True}


def test_the_reference_imports_nothing_of_the_port():
    got = _python("""
import json, sys
from pathlib import Path
from portbench import traffic
from portbench.control import control_numbers
import portbench.references.darknet_int, portbench.check, portbench.work
data = Path("portbench/tests/data")
cfg = json.loads((data / "configs" / "tiny-64-int16.json").read_text())
n = control_numbers(cfg, traffic.load("tiny-offline", root=data), 3, "cpu")
tops = {m.split(".")[0] for m in sys.modules}
print(json.dumps({"detections": n["detections"],
                  "loaded": sorted(tops & {"yolotpu_torch", "yolotpu", "jax",
                                           "jaxlib", "flax"})}))
""")
    assert got["detections"] > 0 and got["loaded"] == []
