"""Inference engine on PyTorch: weights + graph + device -> detections.

The counterpart of ``yolotpu/runtime/engine.py`` for the integer tiers
(int16-exact, int8 w8a8 with the head16 epilogue, w8a16). The host steps
around the network (letterbox, region activation, box decode, NMS, region
dumps) are the port's copies of the JAX package's numpy code; the network
runs as ``models.yolov2.YoloV2Q`` on ``device``. ``PredictResult``,
``maybe_dump_region``, ``load_or_synthesize`` and ``_first_existing``
mirror ``yolotpu/runtime/engine.py``. In the int16 tier
``YOLO2_Q16_PLAN`` ("idx:kind,...") overrides the engine kind of conv
layers, as it does in ``yolotpu`` (``models.engine_plan``).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..graph import NetworkSpec
from ..image import letterbox_image
from ..models import engine_plan
from ..models.yolov2 import YoloV2Q, params_int8, params_int16, params_w8a16
from ..postprocess import (Detection, do_nms_sort, forward_region,
                           get_region_detections)
from ..quant import (calibrate_activations, calibrate_activations_int8,
                     quantize_weights, quantize_weights_int8,
                     quantize_weights_w8a16)
from ..weights import WeightStore
from . import logging as ylog

# precision -> (store weights, store Q tables, params function, what is missing
# when the store has no such weights)
_TIERS = {
    "int16": ("int16", "qtables", params_int16,
              "int16 engine needs quantized weights "
              "(load int16 artifacts or calibrate+quantize)"),
    "int8": ("int8", "qtables8", params_int8,
             "int8 engine needs quantize_weights_int8"),
    "w8a16": ("w8a16", "qtables_w8", params_w8a16,
              "w8a16 engine needs quantize_weights_w8a16"),
}


@dataclass
class PredictResult:
    head_chw: np.ndarray          # (oc, h, w) fp32 raw region input
    seconds: float


class Engine:
    def __init__(self, spec: NetworkSpec, store: WeightStore,
                 precision: str = "int16", device: torch.device | str = "cuda"):
        if precision == "fp32":
            raise NotImplementedError("precision 'fp32' is not ported to "
                                      "PyTorch yet (ROADMAP.md, Queue 1, "
                                      "item M6)")
        if precision not in _TIERS:
            raise ValueError(f"precision {precision!r} (one of "
                             f"{', '.join(_TIERS)})")
        weights, qtables, make_params, missing = _TIERS[precision]
        if not getattr(store, weights):
            raise ValueError(missing)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda'): no CUDA device is "
                               "available to this process")
        self.spec = spec
        self.store = store
        self.precision = precision
        self.qtables = getattr(store, qtables)
        self.params = make_params(spec, store, self.device)
        # the int16 tier's per-layer engine lever, read as yolotpu's
        # params_q16 reads it; no plan file until one is measured on the card
        overrides = (engine_plan.plan_overrides() if precision == "int16"
                     else None)
        self.model = YoloV2Q(spec, self.qtables, self.params, self.device,
                             precision, overrides)

    def _head_nchw(self, x: torch.Tensor) -> np.ndarray:
        head = self.model(x.to(self.device))["head"]
        return head.permute(0, 3, 1, 2).cpu().numpy()

    def predict(self, boxed_chw: np.ndarray) -> PredictResult:
        """One letterboxed (3, H, W) float image -> the raw region head in
        CHW (dump/parity layout)."""
        t0 = time.perf_counter()
        x = torch.from_numpy(np.ascontiguousarray(
            boxed_chw.transpose(1, 2, 0)[None], np.float32))
        head = self._head_nchw(x)[0]
        return PredictResult(head_chw=np.ascontiguousarray(head),
                             seconds=time.perf_counter() - t0)

    def predict_batch(self, boxed_nchw: np.ndarray) -> np.ndarray:
        """(N, 3, H, W) letterboxed float frames -> (N, oc, h, w) heads."""
        x = torch.from_numpy(np.ascontiguousarray(
            boxed_nchw.transpose(0, 2, 3, 1), np.float32))
        return self._head_nchw(x)

    def predict_batch_rgb(self, frames_nhwc_u8: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) net-sized uint8 RGB frames -> (N, oc, h, w) heads;
        the frames cross to the device as uint8 and /255 runs there."""
        if frames_nhwc_u8.dtype != np.uint8:
            raise TypeError(f"predict_batch_rgb wants uint8 frames, got "
                            f"{frames_nhwc_u8.dtype}")
        return self._head_nchw(torch.from_numpy(
            np.ascontiguousarray(frames_nhwc_u8)))

    def detect(self, image_chw: np.ndarray, thresh: float = 0.25,
               nms: float = 0.45) -> tuple[list[Detection], PredictResult]:
        """Full pipeline on an original (not letterboxed) CHW float image."""
        net_w, net_h = self.spec.net.width, self.spec.net.height
        boxed = letterbox_image(image_chw, net_w, net_h)
        res = self.predict(boxed)
        raw_flat = res.head_chw.reshape(-1)
        maybe_dump_region(raw_flat, raw=True)
        act = forward_region(raw_flat, self.spec.region)
        maybe_dump_region(act, raw=False)
        dets = get_region_detections(act, self.spec.region,
                                     im_w=image_chw.shape[2],
                                     im_h=image_chw.shape[1],
                                     net_w=net_w, net_h=net_h, thresh=thresh)
        dets = do_nms_sort(dets, self.spec.region.classes, nms)
        return dets, res


def maybe_dump_region(values: np.ndarray, raw: bool) -> None:
    """Region tensor text dumps, env-compatible with the reference
    (``yolo2_model.cpp:426-439``, ``yolov2_main.cpp:297-306``): one float per
    line, '%.9g'; disabled by YOLO2_NO_DUMP; paths via YOLO2_DUMP_REGION_RAW
    / YOLO2_DUMP_REGION; defaults yolov2_region_{raw,proc}_cpu.txt."""
    nd = os.environ.get("YOLO2_NO_DUMP", "")
    if nd and nd != "0":
        return
    if raw:
        path = (os.environ.get("YOLO2_DUMP_REGION_RAW_CPU")
                or os.environ.get("YOLO2_DUMP_REGION_RAW")
                or "yolov2_region_raw_cpu.txt")
    else:
        path = (os.environ.get("YOLO2_DUMP_REGION")
                or "yolov2_region_proc_cpu.txt")
    try:
        with open(path, "w") as f:
            for v in values:
                f.write(f"{v:.9g}\n")
        print(f"Dumped {values.size} floats to {path}")
    except OSError as e:
        ylog.error(f"Warning: cannot open dump file {path}: {e}")


def load_or_synthesize(spec: NetworkSpec, weights_dir: str | None,
                       precision: str, synthetic: bool = False,
                       seed: int = 0,
                       calib_images: list[np.ndarray] | None = None) -> WeightStore:
    """Load the reference .bin artifact set from ``weights_dir`` or build a
    synthetic store (with on-the-fly Q calibration for int16)."""
    if not synthetic and weights_dir:
        if precision == "int16":
            wp = _first_existing(weights_dir, ["weights_reorg_int16.bin",
                                               "weight_int16.bin"])
            reorg = wp.endswith("weights_reorg_int16.bin")
            return WeightStore.load_int16(
                spec, wp, os.path.join(weights_dir, "bias_int16.bin"),
                weights_dir, reorg=reorg)
        wp = _first_existing(weights_dir, ["weights_reorg.bin", "weights.bin"])
        reorg = wp.endswith("weights_reorg.bin")
        return WeightStore.load_fp32(
            spec, wp, os.path.join(weights_dir, "bias.bin"), reorg=reorg)

    ylog.info(f"using synthetic weights (seed={seed})")
    store = WeightStore.synthetic(spec, seed=seed)
    if precision in ("int16", "int8", "w8a16"):
        if calib_images is None:
            rng = np.random.default_rng(seed)
            calib_images = [rng.random(
                (spec.net.channels, spec.net.height, spec.net.width)
            ).astype(np.float32)]
        act_q = calibrate_activations(spec, store, calib_images)
        quantize_weights(store, act_q)
        if precision == "int8":
            # int8 activations calibrate at their own margin (1.4, not the
            # int16 tier's 2.0 — see quant.calibrate_activations_int8)
            act_q8 = calibrate_activations_int8(spec, store, calib_images)
            quantize_weights_int8(store, act_q8)
        elif precision == "w8a16":
            quantize_weights_w8a16(store, act_q)
    return store


def _first_existing(dirpath: str, names: list[str]) -> str:
    for n in names:
        p = os.path.join(dirpath, n)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"none of {names} found in {dirpath}")
