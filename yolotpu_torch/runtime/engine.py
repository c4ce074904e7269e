"""Inference engine on PyTorch: weights + graph + device -> detections.

The counterpart of ``yolotpu/runtime/engine.py`` for the int16-exact tier.
The host steps around the network (letterbox, region activation, box
decode, NMS, region dumps) are the JAX package's numpy code, reused
unchanged; the network runs as ``models.yolov2.YoloV2Int16`` on ``device``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from yolotpu.graph import NetworkSpec
from yolotpu.image import letterbox_image
from yolotpu.postprocess import (Detection, do_nms_sort, forward_region,
                                 get_region_detections)
from yolotpu.runtime.engine import PredictResult, maybe_dump_region
from yolotpu.weights import WeightStore

from ..models.yolov2 import YoloV2Int16, params_int16

# precision tier -> the ROADMAP item that ports it
_UNPORTED = {"fp32": "M6", "int8": "M7", "w8a16": "M8"}


class Engine:
    def __init__(self, spec: NetworkSpec, store: WeightStore,
                 precision: str = "int16", device: torch.device | str = "cuda"):
        if precision != "int16":
            item = _UNPORTED.get(precision)
            raise NotImplementedError(
                f"precision {precision!r} is not ported to PyTorch yet"
                + (f" (ROADMAP.md, Queue 1, item {item})" if item else ""))
        if not store.int16:
            raise ValueError("int16 engine needs quantized weights "
                             "(load int16 artifacts or calibrate+quantize)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda'): no CUDA device is "
                               "available to this process")
        self.spec = spec
        self.store = store
        self.precision = precision
        self.params = params_int16(spec, store, self.device)
        self.model = YoloV2Int16(spec, store.qtables, self.params, self.device)

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
