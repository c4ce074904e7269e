"""Inference engine on PyTorch: weights + graph + device -> detections.

The counterpart of ``yolotpu/runtime/engine.py``'s ``xla`` backend, in the
four tiers (fp32, int16-exact, int8 w8a8 with the head16 epilogue, w8a16).
The network runs as ``models.yolov2.YoloV2Q`` on ``device``. On a card each
forward is one captured CUDA graph, the counterpart of the JAX engine's one
jitted program: one graph per (entry, batch, input dtype, frame shape),
captured at first use (at construction for ``warmup_batch`` float frames,
as the JAX engine compiles then) and replayed for every request, which
copies its frames into the graph's input. A capture that fails raises. On
the CPU the forward runs eagerly. With ``device_nms`` the graph also
decodes and runs the class-wise NMS (``ops.nms``), so only a top-K table
leaves the card; ``predict_batch_raw_frames`` letterboxes raw uint8 frames
on the device (``ops.letterbox``) inside the graph. The host steps around
the network (letterbox, region activation, box decode, NMS, region dumps)
are the port's copies of the JAX package's numpy code. ``PredictResult``,
``maybe_dump_region``, ``load_or_synthesize`` and ``_first_existing``
mirror ``yolotpu/runtime/engine.py``. In the int16 tier
``YOLO2_Q16_PLAN`` ("idx:kind,...") overrides the engine kind of conv
layers, as it does in ``yolotpu`` (``models.engine_plan``).
"""

from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..graph import NetworkSpec
from ..image import letterbox_image
from ..models import engine_plan
from ..models.yolov2 import (YoloV2Q, params_fp32, params_int8, params_int16,
                             params_w8a16)
from ..ops.letterbox import device_letterbox
from ..postprocess import (Detection, correct_region_boxes, do_nms_sort,
                           forward_region, get_region_detections)
from ..quant import (calibrate_activations, calibrate_activations_int8,
                     quantize_weights, quantize_weights_int8,
                     quantize_weights_w8a16)
from ..weights import WeightStore
from . import logging as ylog

# precision -> (store weights, store Q tables, params function, what is missing
# when the store has no such weights)
_TIERS = {
    "fp32": ("fp32", None, params_fp32, "fp32 engine needs fp32 weights"),
    "int16": ("int16", "qtables", params_int16,
              "int16 engine needs quantized weights "
              "(load int16 artifacts or calibrate+quantize)"),
    "int8": ("int8", "qtables8", params_int8,
             "int8 engine needs quantize_weights_int8"),
    "w8a16": ("w8a16", "qtables_w8", params_w8a16,
              "w8a16 engine needs quantize_weights_w8a16"),
}
_DETECTIONS = ("det_boxes", "det_scores", "det_classes", "det_valid")


@dataclass
class PredictResult:
    head_chw: np.ndarray          # (oc, h, w) fp32 raw region input
    seconds: float


@dataclass
class CapturedForward:
    """One captured CUDA graph of a forward: its static input, which each
    request overwrites, its static outputs, which each replay overwrites,
    and how many times it was replayed."""
    graph: torch.cuda.CUDAGraph
    inp: torch.Tensor
    out: dict
    replays: int = 0


def capture(fn, inp: torch.Tensor) -> CapturedForward:
    """fn(inp) captured into a CUDA graph on inp's card. fn runs once first
    on a side stream, as PyTorch's graph capture requires: the kernels build,
    the split and tap-table caches fill and cuDNN takes its plans there, so
    the capture copies nothing from the host. Memory that fn allocates (the
    split-K workspaces among it) comes from the graph's own pool and lives
    as long as the graph."""
    here = torch.cuda.current_stream(inp.device)
    side = torch.cuda.Stream(inp.device)
    side.wait_stream(here)
    with torch.cuda.stream(side):
        fn(inp)
    here.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(inp)
    return CapturedForward(graph, inp, out)


class Engine:
    def __init__(self, spec: NetworkSpec, store: WeightStore,
                 precision: str = "fp32", device: torch.device | str = "cuda",
                 device_nms: bool = False, thresh: float = 0.25,
                 nms: float = 0.45, topk: int = 256, warmup: bool = True,
                 warmup_batch: int = 1):
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
        self.device_nms = device_nms
        self.qtables = getattr(store, qtables) if qtables else None
        self.params = make_params(spec, store, self.device)
        # the int16 tier's per-layer engine lever, read as yolotpu's
        # params_q16 reads it; no plan file until one is measured on the card
        overrides = (engine_plan.plan_overrides() if precision == "int16"
                     else None)
        self.model = YoloV2Q(spec, self.qtables, self.params, self.device,
                             precision, overrides,
                             ("head", "detections") if device_nms else ("head",),
                             thresh, nms, topk)
        # (letterboxed on the device?, input dtype, input shape) -> graph
        self.graphs: dict[tuple, CapturedForward] = {}
        if warmup and self.device.type == "cuda":
            net = spec.net
            self._graph(torch.zeros((warmup_batch, net.height, net.width,
                                     net.channels)), letterbox=False)

    def _forward(self, x: torch.Tensor, letterbox: bool) -> dict:
        if letterbox:
            x = device_letterbox(x, self.spec.net.width, self.spec.net.height)
        return self.model(x)

    def _graph(self, x: torch.Tensor, letterbox: bool) -> CapturedForward:
        key = (letterbox, x.dtype, tuple(x.shape))
        if key not in self.graphs:
            self.graphs[key] = capture(
                functools.partial(self._forward, letterbox=letterbox),
                torch.zeros_like(x, device=self.device))
        return self.graphs[key]

    def _run(self, frames: np.ndarray, letterbox: bool = False) -> dict:
        """One forward of host NHWC frames: a replay of its graph on a card
        (the frames copied into the graph's input), an eager run on the CPU.
        Returns the device outputs, which the next replay overwrites."""
        x = torch.from_numpy(np.ascontiguousarray(frames))
        if self.device.type != "cuda":
            return self._forward(x.to(self.device), letterbox)
        g = self._graph(x, letterbox)
        g.inp.copy_(x)
        g.graph.replay()
        g.replays += 1
        return g.out

    def _detections(self, out: dict) -> tuple:
        """The top-K tables of a device-NMS forward, on the host."""
        host = {k: out[k].cpu().numpy() for k in (*_DETECTIONS,
                                                   "det_saturated")}
        self._warn_saturated(host)
        return tuple(host[k] for k in _DETECTIONS)

    def predict(self, boxed_chw: np.ndarray) -> PredictResult:
        """One letterboxed (3, H, W) float image -> the raw region head in
        CHW (dump/parity layout)."""
        t0 = time.perf_counter()
        head = self._run(boxed_chw.transpose(1, 2, 0)[None].astype(np.float32))
        head = head["head"][0].permute(2, 0, 1).cpu().numpy()
        return PredictResult(head_chw=np.ascontiguousarray(head),
                             seconds=time.perf_counter() - t0)

    def predict_batch(self, boxed_nchw: np.ndarray) -> np.ndarray:
        """(N, 3, H, W) letterboxed float frames -> (N, oc, h, w) heads."""
        out = self._run(boxed_nchw.transpose(0, 2, 3, 1).astype(np.float32))
        return out["head"].permute(0, 3, 1, 2).cpu().numpy()

    def predict_batch_rgb(self, frames_nhwc_u8: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) net-sized uint8 RGB frames -> (N, oc, h, w) heads;
        the frames cross to the device as uint8 and /255 runs there."""
        if frames_nhwc_u8.dtype != np.uint8:
            raise TypeError(f"predict_batch_rgb wants uint8 frames, got "
                            f"{frames_nhwc_u8.dtype}")
        return self._run(frames_nhwc_u8)["head"].permute(0, 3, 1, 2).cpu().numpy()

    def predict_batch_raw_frames(self, frames_nhwc_u8: np.ndarray):
        """(N, H, W, 3) raw uint8 frames of any one size: the darknet-exact
        letterbox runs on the device (``ops.letterbox``), in the graph of
        that source shape, so only the raw pixels cross to the card.
        Returns the (N, oc, h, w) heads, or, with device_nms, the top-K
        tables (boxes, scores, classes, valid)."""
        if frames_nhwc_u8.dtype != np.uint8:
            raise TypeError(f"predict_batch_raw_frames wants uint8 frames, "
                            f"got {frames_nhwc_u8.dtype}")
        out = self._run(frames_nhwc_u8, letterbox=True)
        if self.device_nms:
            return self._detections(out)
        return out["head"].permute(0, 3, 1, 2).cpu().numpy()

    def predict_batch_detections(self, frames: np.ndarray) -> tuple:
        """Batched device decode + NMS (engine built with device_nms=True):
        only the top-K tables leave the card. frames: (N, H, W, 3) uint8 or
        (N, 3, H, W) float, letterboxed to the network size."""
        if not self.device_nms:
            raise ValueError("engine built without device_nms=True")
        x = (frames if frames.dtype == np.uint8
             else frames.transpose(0, 2, 3, 1).astype(np.float32))
        return self._detections(self._run(x))

    def _warn_saturated(self, out: dict) -> None:
        """Device NMS truncation: more above-threshold candidates than top-K
        means the host path (which takes all h*w*n boxes,
        yolo_post.cpp:54-85) could return other detections."""
        sat = out.get("det_saturated")
        if sat is not None and np.any(sat):
            ylog.info(f"device NMS top-K saturated on "
                      f"{int(np.sum(sat))} frame(s); results may be "
                      "truncated (raise --topk)")

    def detections_from_topk(self, sb, ss, sc, sv, im_w: int,
                             im_h: int) -> list[Detection]:
        """One frame's top-K table -> host Detection list (the letterbox
        inverse applied to the surviving boxes only)."""
        keep = sv & (ss > 0)
        classes = self.spec.region.classes
        if not keep.any():
            return []
        boxes = correct_region_boxes(sb[keep], im_w, im_h,
                                     self.spec.net.width,
                                     self.spec.net.height)
        dets = []
        for b, s, c in zip(boxes, ss[keep], sc[keep]):
            prob = np.zeros(classes, np.float32)
            prob[int(c)] = s
            dets.append(Detection(bbox=tuple(float(v) for v in b),
                                  objectness=float(s), prob=prob,
                                  classes=classes))
        return dets

    def detect_device(self, image_chw: np.ndarray) -> tuple[list[Detection], float]:
        """On-device decode + class-wise NMS of an original (not
        letterboxed) CHW float image: only the top-K table is read back.
        The thresholds are the engine's (device_nms=True)."""
        if not self.device_nms:
            raise ValueError("engine built without device_nms=True")
        boxed = letterbox_image(image_chw, self.spec.net.width,
                                self.spec.net.height)
        t0 = time.perf_counter()
        sb, ss, sc, sv = (t[0] for t in self._detections(self._run(
            boxed.transpose(1, 2, 0)[None].astype(np.float32))))
        seconds = time.perf_counter() - t0
        return (self.detections_from_topk(sb, ss, sc, sv, image_chw.shape[2],
                                          image_chw.shape[1]), seconds)

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
