"""Staged pipeline runner: ``run_pipeline.py`` equivalent, for the card.

The reference drives host-sanity -> quickstart -> HLS IP -> Vivado ->
firmware packaging -> deploy -> board run (``scripts/run_pipeline.py:847-
855``), YAML-configured with --from/--to stage windowing (``:866-888``).
The port's flow has no bitstream; its stages are:

  host_sanity     python, torch, torch's CUDA version, the card count, and
                  nvcc (the kernels' compiler) and g++ (native preprocessing)
  artifacts       synthetic or real weight artifacts + int16 quantization
  host_quickstart golden fp32 + int16 smoke detection at 128x128 on the CPU
                  (the reference's host quickstart gate, run_pipeline.py:
                  394-449)
  gpu_build       the kernels' build and the capture of the flagship
                  engine's CUDA graph on the card
  gpu_run         timed detection run on the card (a ``report run`` bundle)
  report          the bundles so far (``report list``)

``tpu_compile`` and ``tpu_run``, the JAX package's names of the card stages,
are taken by --from/--to as ``gpu_build`` and ``gpu_run``. The config is
``pipeline.yaml``'s flat ``key: value`` form, read by ``parse_config``
(no YAML package needed). Stage windowing (--from/--to), per-stage ordering
and the failure exit 1 are preserved; re-entry is cheap because artifacts
are cached on disk. The card stages raise without a card.

Mirrors ``yolotpu/cli/pipeline.py``.

    python -m yolotpu_torch.cli.pipeline --config pipeline.yaml --to gpu_build
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import time

STAGES = ["host_sanity", "artifacts", "host_quickstart",
          "gpu_build", "gpu_run", "report"]
# the JAX package's stage names -> the port's
ALIASES = {"tpu_compile": "gpu_build", "tpu_run": "gpu_run"}

DEFAULT_CONFIG = """\
# yolotpu pipeline configuration (run_pipeline equivalent)
model: yolov2
precision: int16
compute: int32
weights_dir: weights
synthetic_weights: true
test_image: null          # defaults to a generated image
report_label: pipeline
batch: 16
steps: 10
"""

# YAML 1.1's plain scalars, as yaml.safe_load resolves them
_NULL = {"", "~", "null", "Null", "NULL"}
_BOOL = {**dict.fromkeys(("true", "True", "TRUE", "yes", "Yes", "YES", "on",
                          "On", "ON"), True),
         **dict.fromkeys(("false", "False", "FALSE", "no", "No", "NO", "off",
                          "Off", "OFF"), False)}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?")


def _scalar(v: str):
    if v in _NULL:
        return None
    if v in _BOOL:
        return _BOOL[v]
    if _INT.fullmatch(v):
        return int(v.replace("_", ""))
    if _FLOAT.fullmatch(v) and any(ch.isdigit() for ch in v):
        return float(v.replace("_", ""))
    return v


def parse_config(text: str) -> dict:
    """A flat ``key: value`` config (``pipeline.yaml``'s form: one scalar a
    line, ``#`` comments) -> dict, its values typed as yaml.safe_load types
    the scalars such a file holds (null, booleans, decimal integers and
    floats, quoted and plain strings). A line of another form raises
    ValueError."""
    cfg = {}
    for n, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, sep, value = line.partition(":")
        value = value.strip()
        if value[:1] in ("'", '"'):
            end = value.find(value[0], 1)
            rest = value[end + 1:].strip() if end > 0 else None
            if rest is None or (rest and not rest.startswith("#")):
                raise ValueError(f"config line {n}: unterminated or trailed "
                                 f"quote: {line!r}")
            value = value[1:end]
        else:
            value = _scalar(re.sub(r"(^|\s)#.*$", "", value).strip())
        if not sep or not key.strip() or line[len(key) + 1:][:1] not in (
                "", " ", "\t"):
            raise ValueError(f"config line {n}: not 'key: value': {line!r}")
        cfg[key.strip()] = value
    return cfg


def _load_config(path: str | None) -> dict:
    cfg = parse_config(DEFAULT_CONFIG)
    if path:
        with open(path) as f:
            cfg.update(parse_config(f.read()))
    return cfg


def stage_host_sanity(cfg: dict) -> None:
    import shutil

    import numpy  # noqa: F401
    import torch

    from ..ops import _build
    print(f"  python {sys.version.split()[0]}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"devices={torch.cuda.device_count()}")
    try:
        nvcc = _build.find_nvcc()
    except RuntimeError:
        nvcc = "MISSING (the kernels cannot build)"
    print(f"  nvcc: {nvcc}")
    for tool in ("g++",):
        print(f"  {tool}: {'ok' if shutil.which(tool) else 'MISSING (native preproc disabled)'}")


def _test_image(cfg: dict):
    import numpy as np
    from ..image import load_image
    if cfg.get("test_image"):
        return load_image(cfg["test_image"])
    rng = np.random.default_rng(7)
    return rng.random((3, 416, 416)).astype(np.float32)


def stage_artifacts(cfg: dict) -> None:
    from ..models import zoo
    from ..quant import calibrate_activations, quantize_weights
    from ..weights import WeightStore
    wd = cfg["weights_dir"]
    spec = zoo.build(cfg["model"])
    if cfg.get("synthetic_weights", True):
        store = WeightStore.synthetic(spec, seed=0)
        store.save_fp32(wd)
        act_q = calibrate_activations(spec, store, [_test_image(cfg)])
        quantize_weights(store, act_q)
        store.save_int16(wd)
        print(f"  synthetic artifact set -> {wd}/")
    else:
        if not os.path.exists(os.path.join(wd, "weights.bin")):
            raise FileNotFoundError(f"real weights not found in {wd}/")
        print(f"  using existing artifacts in {wd}/")


def stage_host_quickstart(cfg: dict) -> None:
    from ..models import zoo
    from ..runtime.engine import Engine, load_or_synthesize
    spec = zoo.build(cfg["model"], width=128, height=128)
    img = _test_image(cfg)[:, :128, :128]
    for precision in ("fp32", "int16"):
        store = load_or_synthesize(spec, None, precision, synthetic=True)
        compute = "exact" if precision == "int16" else "int32"
        eng = Engine(spec, store, precision=precision, backend="golden",
                     compute=compute)
        dets, res = eng.detect(img, 0.25, 0.45)
        print(f"  golden {precision}: {len(dets)} dets in {res.seconds:.2f}s")


def _card():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("this stage runs on the card: no CUDA device is "
                           "available to this process")
    return torch.device("cuda", torch.cuda.current_device())


def stage_gpu_build(cfg: dict) -> None:
    import torch

    from ..models import zoo
    from ..ops import _build
    from ..runtime.engine import Engine, load_or_synthesize
    dev = _card()
    t0 = time.perf_counter()
    _build.load_library()
    built = time.perf_counter() - t0
    spec = zoo.build(cfg["model"])
    store = load_or_synthesize(spec, cfg["weights_dir"], cfg["precision"],
                               synthetic=cfg.get("synthetic_weights", True))
    t0 = time.perf_counter()
    eng = Engine(spec, store, cfg["precision"], dev, compute=cfg["compute"],
                 warmup_batch=int(cfg["batch"]))
    torch.cuda.synchronize(dev)
    print(f"  kernels built in {built:.1f}s, {len(eng.graphs)} graph "
          f"captured in {time.perf_counter() - t0:.1f}s on "
          f"{torch.cuda.get_device_name(dev)}")


def stage_gpu_run(cfg: dict) -> None:
    from . import report as rp
    _card()
    args = ["--report-dir", "reports", "run", "--label",
            f"{cfg.get('report_label', 'pipeline')}_gpu_run",
            "--model", cfg["model"], "--precision", cfg["precision"],
            "--compute", cfg["compute"], "--batch", str(cfg["batch"]),
            "--steps", str(cfg["steps"]), "--device", "cuda"]
    if cfg.get("synthetic_weights", True):
        args.append("--synthetic-weights")
    if rp.main(args) != 0:
        raise RuntimeError(f"report {' '.join(args)} failed")


def stage_report(cfg: dict) -> None:
    from . import report as rp
    rp.main(["--report-dir", "reports", "list"])


STAGE_FNS = {
    "host_sanity": stage_host_sanity,
    "artifacts": stage_artifacts,
    "host_quickstart": stage_host_quickstart,
    "gpu_build": stage_gpu_build,
    "gpu_run": stage_gpu_run,
    "report": stage_report,
}


def compute_stage_list(from_stage: str | None, to_stage: str | None) -> list[str]:
    """--from/--to windowing (run_pipeline.py:866-888); the JAX package's
    stage names are taken for the port's (``ALIASES``)."""
    from_stage = ALIASES.get(from_stage, from_stage)
    to_stage = ALIASES.get(to_stage, to_stage)
    lo = STAGES.index(from_stage) if from_stage else 0
    hi = STAGES.index(to_stage) if to_stage else len(STAGES) - 1
    if lo > hi:
        raise ValueError(f"--from {from_stage} is after --to {to_stage}")
    return STAGES[lo:hi + 1]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="run_pipeline", description=__doc__)
    names = STAGES + list(ALIASES)
    ap.add_argument("--config", default=None, help="pipeline YAML")
    ap.add_argument("--from", dest="from_stage", choices=names, default=None)
    ap.add_argument("--to", dest="to_stage", choices=names, default=None)
    ap.add_argument("--list-stages", action="store_true")
    ap.add_argument("--init-config", metavar="PATH",
                    help="write a config template and exit")
    args = ap.parse_args(argv)

    if args.list_stages:
        print("\n".join(STAGES))
        return 0
    if args.init_config:
        with open(args.init_config, "w") as f:
            f.write(DEFAULT_CONFIG)
        print(f"wrote {args.init_config}")
        return 0

    cfg = _load_config(args.config)
    stages = compute_stage_list(args.from_stage, args.to_stage)
    for i, st in enumerate(stages, 1):
        print(f"[{i}/{len(stages)}] stage {st}")
        t0 = time.time()
        try:
            STAGE_FNS[st](cfg)
        except Exception as e:
            print(f"  FAILED after {time.time() - t0:.1f}s: {e}", file=sys.stderr)
            return 1
        print(f"  ok ({time.time() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
