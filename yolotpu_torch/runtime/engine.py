"""Inference engine on PyTorch: weights + graph + backend -> detections.

The counterpart of ``yolotpu/runtime/engine.py``, in the four tiers (fp32,
int16-exact, int8 w8a8 with the head16 epilogue, w8a16), with its two
backends:

  "device" — the counterpart of its ``xla`` backend: the network runs as
             ``models.yolov2.YoloV2Q`` on ``device`` (the card by default)
  "golden" — the numpy oracle (``golden.GoldenNet``) on the host, with the
             bit-exact reference-semantics mode ``compute="exact"``

On a card each forward of the device backend is one captured CUDA graph,
the counterpart of the JAX engine's one jitted program: one graph per
(entry, batch, input dtype, frame shape), captured at first use (at
construction for ``warmup_batch`` float frames, as the JAX engine compiles
then) and replayed for every request, which copies its frames into the
graph's input: above ``STAGE_MIN_BYTES`` through the graph's pinned
stage, in chunks of whole frames (``stage_chunks``), each chunk's DMA
overlapping the staging of the next. A capture that fails raises. On the
CPU the forward runs eagerly. With ``device_nms`` the graph also decodes
and runs the class-wise NMS (``ops.nms``), so only a top-K table leaves
the card;
``predict_batch_raw_frames`` letterboxes raw uint8 frames on the device
(``ops.letterbox``) inside the graph. Every device call, its copy to the
host included, runs under the watchdog ``Engine._guarded``
(``YOLO2_LAYER_TIMEOUT_MS``) on the engine's worker thread. A request
made under ``torch.profiler`` records its spans (``runtime.trace``).
``predict_layers``/``dump_layers`` give every layer's output. The host
steps around the network (letterbox, region activation, box decode, NMS,
region dumps) are the port's copies of the JAX package's numpy code.
``PredictResult``, ``maybe_dump_region``, ``load_or_synthesize`` and
``_first_existing`` mirror ``yolotpu/runtime/engine.py``. Each conv runs
the route ``models.engine_plan.kernels`` gives it from the graph and the
tier, on any device; the int16 tier also takes the ``YOLO2_Q16_PLAN``
lever.
"""

from __future__ import annotations

import functools
import os
import queue
import threading
import time
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from ..golden import GoldenNet
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
from . import trace

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
# a copy in of more bytes than STAGE_MIN_BYTES goes through the graph's
# pinned stage, staged on the intra-op threads; one of fewer bytes goes
# straight from pageable memory, which the stage does not beat there (and
# after a camera's idle gap the threads first wake up). The staged copy
# runs in chunks of whole frames of about STAGE_CHUNK_BYTES, so that the
# DMA of one chunk overlaps the staging of the next; each chunk costs a fork
# and join of the intra-op threads (about 0.25 ms on an H100's host), so the
# chunks are few. PERF.md gives the sweep behind both sizes
# (``python -m yolotpu_torch.tools.stage_sweep`` on the card)
STAGE_MIN_BYTES = 8 << 20
STAGE_CHUNK_BYTES = 32 << 20


@dataclass
class PredictResult:
    head_chw: np.ndarray          # (oc, h, w) fp32 raw region input
    seconds: float


@dataclass
class CapturedForward:
    """One captured CUDA graph of a forward: its static input, which each
    request overwrites, its static outputs, which each replay overwrites,
    and how many times it was replayed. A graph whose frames an engine
    copies in through a stage (``Engine._copy_in``) also holds, from its
    first such copy, the page-locked host tensor they pass through
    (``stage``, the input's shape and dtype) and the event recorded after
    a copy's last DMA (``copied``)."""
    graph: torch.cuda.CUDAGraph
    inp: torch.Tensor
    out: dict
    replays: int = 0
    stage: torch.Tensor | None = None
    copied: torch.cuda.Event | None = None


def stage_chunks(frames: int, nbytes: int,
                 chunk_bytes: int) -> list[tuple[int, int]]:
    """The [a, b) ranges of whole frames in which ``frames`` frames of
    ``nbytes`` bytes in all are copied in, in order, covering [0, frames)
    once: one range up to ``chunk_bytes``, above it ceil(nbytes /
    chunk_bytes) of them (at most one a frame), their sizes within one
    frame of each other."""
    k = max(1, min(frames, -(-nbytes // chunk_bytes)))
    return [(i * frames // k, (i + 1) * frames // k) for i in range(k)]


def stage_in(inp: torch.Tensor, stage: torch.Tensor, x: torch.Tensor,
             chunks: list[tuple[int, int]]) -> None:
    """Host frames ``x`` into the device tensor ``inp`` through the pinned
    ``stage``, chunk by chunk: frames a:b staged by torch's CPU copy, on
    its intra-op threads, then their DMA enqueued on the current stream,
    which the host does not wait for, so the DMA of one chunk overlaps the
    staging of the next."""
    for a, b in chunks:
        stage[a:b].copy_(x[a:b])
        inp[a:b].copy_(stage[a:b], non_blocking=True)


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
    # thread_local: the capture may run on the engine's watchdog worker,
    # and another thread's CUDA call must not invalidate it
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = fn(inp)
    return CapturedForward(graph, inp, out)


class _Worker:
    """A daemon thread that runs an engine's guarded device calls one at a
    time, in order, on the engine's card: a graph's static input and outputs
    serve one call at a time. A call that outlives its deadline abandons the
    worker: the next call gets a fresh one, calls queued behind the late one
    are skipped once their callers have given up, and the abandoned thread
    ends once its call returns (a hung call never does; as a daemon it
    cannot block the interpreter's exit)."""

    def __init__(self, cuda_index: int | None):
        self._jobs: queue.SimpleQueue = queue.SimpleQueue()
        self._cuda_index = cuda_index
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="yolo2-watchdog")
        self.thread.start()

    def _loop(self) -> None:
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        while True:
            job = self._jobs.get()
            if job is None:
                return
            self._do(*job)
            del job     # hold no call (nor its engine) between calls

    @staticmethod
    def _do(fn, args, box, done, req) -> None:
        if done.is_set():   # its caller gave up while it was queued
            return
        if req is not None:
            req.close("engine.queue")
        try:
            box.append((True, fn(*args)))
        except BaseException as e:  # raised again by run(), in the caller
            box.append((False, e))
        if req is not None:
            req.open("engine.resume")
        done.set()

    def stop(self) -> None:
        """End the thread once its current call, if any, returns."""
        self._jobs.put(None)

    def run(self, fn, args: tuple, seconds: float, req=None):
        """fn(*args) on the worker: (value,), or None when it ran past
        ``seconds``, its wait behind earlier calls included (the worker is
        then abandoned). fn's exception is raised here. ``req``: a traced
        request (``trace.Request``), whose ``engine.queue`` (the job put
        here -> the worker starts fn) and ``engine.resume`` (the worker's
        ``done.set()`` -> the wait here returns) spans this records; or
        None."""
        box: list = []
        done = threading.Event()
        if req is not None:
            req.open("engine.queue")
        self._jobs.put((fn, args, box, done, req))
        if not done.wait(seconds):
            done.set()      # still queued: the worker skips it
            if not box:
                self.stop()
                return None
        if req is not None:
            req.close("engine.resume")
        ok, val = box[0]
        if not ok:
            raise val
        return (val,)


def _heads(out: dict) -> np.ndarray:
    """The (N, oc, h, w) heads of a forward's outputs, on the host."""
    return out["head"].permute(0, 3, 1, 2).cpu().numpy()


def _tables(out: dict) -> dict:
    """The top-K tables of a device-NMS forward's outputs, on the host."""
    return {k: out[k].cpu().numpy() for k in (*_DETECTIONS, "det_saturated")}


class Engine:
    """``backend="device"`` runs the network on ``device`` (the card by
    default; "cpu" runs the kernels' plain versions); ``backend="golden"``
    runs the numpy oracle ``golden.GoldenNet`` on the host, in the int16
    tier in ``compute="exact"`` mode (the HLS core's per-4-channel
    saturating accumulation) or the production ``int32`` contract.
    ``compute`` "int32" and "pallas" both name the exact int32 contract the
    port's kernels compute; "exact" is the golden backend's; the TPU MXU's
    approximate float modes "f32" and "f32_highest" are not carried over and
    raise. ``device_nms`` applies to the device backend only.

    Every device call runs under the watchdog ``_guarded``, its copy to the
    host included, as ``yolotpu``'s engine bounds its device calls."""

    # Max abandoned (timed-out, still-parked) watchdog threads before the
    # engine fails fast instead of dispatching again: a flapping device
    # must not stack daemon threads silently.
    WATCHDOG_MAX_ABANDONED = int(os.environ.get(
        "YOLO2_WATCHDOG_MAX_ABANDONED", "4"))

    def __init__(self, spec: NetworkSpec, store: WeightStore,
                 precision: str = "fp32", device: torch.device | str = "cuda",
                 backend: str = "device", compute: str = "int32",
                 device_nms: bool = False, thresh: float = 0.25,
                 nms: float = 0.45, topk: int = 256, warmup: bool = True,
                 warmup_batch: int = 1):
        if precision not in _TIERS:
            raise ValueError(f"precision {precision!r} (one of "
                             f"{', '.join(_TIERS)})")
        if backend not in ("device", "golden"):
            raise ValueError(f"backend {backend!r} (use 'device' or 'golden')")
        if compute in ("f32", "f32_highest"):
            raise ValueError(
                f"compute={compute!r} is the TPU MXU's approximate float "
                "mode of yolotpu, which the port does not carry over; its "
                "results would differ from the JAX package's (use 'int32')")
        if compute not in ("int32", "pallas", "exact"):
            raise ValueError(f"compute mode {compute!r} (one of int32, "
                             "pallas, exact)")
        if compute == "exact" and backend != "golden":
            raise ValueError("compute='exact' (the HLS core's per-group "
                             "saturating accumulation) runs on the golden "
                             "backend only: use backend='golden'")
        self.qtables = tier_qtables(store, precision)
        self.device = torch.device(device)
        if (backend == "device" and self.device.type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError("Engine(device='cuda'): no CUDA device is "
                               "available to this process")
        self.spec = spec
        self.store = store
        self.precision = precision
        self.backend = backend
        self.compute = compute
        self.device_nms = device_nms and backend == "device"
        # (letterboxed on the device?, input dtype, input shape) -> graph
        self.graphs: dict[tuple, CapturedForward] = {}
        # the watchdog's state: keys seen (no first-use grace), the worker,
        # the threads of timed-out calls
        self._seen_shapes: set = set()
        self._abandoned_threads: list[threading.Thread] = []
        self._worker: _Worker | None = None
        self._guard_lock = threading.Lock()
        self._cuda_index = None
        self._debug = None    # the "acts" model of predict_layers
        if backend == "golden":
            self._golden = GoldenNet(spec)
            self.params = self.model = None
            return
        if self.device.type == "cuda":
            self._cuda_index = (self.device.index if self.device.index
                                is not None else torch.cuda.current_device())
        self.params = tier_params(spec, store, precision, self.device)
        self._overrides = engine_plan.tier_overrides(precision)
        self.model = YoloV2Q(spec, self.qtables, self.params, self.device,
                             precision, self._overrides,
                             ("head", "detections") if device_nms else ("head",),
                             thresh, nms, topk)
        if warmup and self.device.type == "cuda":
            net = spec.net
            self._graph(torch.zeros((warmup_batch, net.height, net.width,
                                     net.channels)), letterbox=False)

    # ------------------------------------------------------------------
    def _guarded(self, fn, *args, tag: str = "main", key: tuple | None = None,
                 req=None):
        """Per-call watchdog, the board app's wait_for_idle analog
        (yolo2_accel_linux.c:266-381): fn(*args) runs on the engine's worker
        thread, bounded by YOLO2_LAYER_TIMEOUT_MS (default 60000; <= 0 runs
        it unbounded on the caller's thread). A key seen for the first time,
        (tag, *key) (by default the args' shapes), gets a deadline of at
        least 900 s: its call may build the kernels and capture a graph. A
        call that times out is re-dispatched once on a fresh worker; a
        second timeout raises TimeoutError. Once WATCHDOG_MAX_ABANDONED
        timed-out workers are still parked, the engine refuses to dispatch
        (RuntimeError). Calls run one at a time, in order, on the one worker
        (a graph's static input and outputs serve one call at a time), so a
        call's deadline also covers its wait behind earlier calls; the lock
        guards only the watchdog's own state. fn must not call the engine's
        guarded methods. ``req``: a traced request, whose hand-off to the
        worker and back the worker's ``run`` records, or None."""
        try:
            ms = float(os.environ.get("YOLO2_LAYER_TIMEOUT_MS", "60000"))
        except ValueError:
            ms = 60000.0
        if ms <= 0:
            return fn(*args)
        key = (tag,) + (tuple(key) if key is not None else
                        tuple(getattr(a, "shape", None) for a in args))
        with self._guard_lock:
            if key not in self._seen_shapes:
                ms = max(ms, 900_000.0)
            self._abandoned_threads = [t for t in self._abandoned_threads
                                       if t.is_alive()]
            if len(self._abandoned_threads) >= self.WATCHDOG_MAX_ABANDONED:
                raise RuntimeError(
                    f"watchdog: {len(self._abandoned_threads)} abandoned "
                    f"device calls still parked (cap "
                    f"{self.WATCHDOG_MAX_ABANDONED}); refusing to dispatch — "
                    "the device looks wedged, restart the engine")

        def dispatch():
            with self._guard_lock:
                if self._worker is None:
                    self._worker = _Worker(self._cuda_index)
                    # the worker holds no reference to the engine: stop it
                    # when the engine goes
                    weakref.finalize(self, self._worker.stop)
                worker = self._worker
            out = worker.run(fn, args, ms / 1000.0, req)
            if out is None:
                with self._guard_lock:
                    if self._worker is worker:
                        self._abandoned_threads.append(worker.thread)
                        self._worker = None
            return out

        out = dispatch()
        if out is None:
            # one recovery attempt on a fresh worker, as the reference
            # driver's timeout path resumes once (yolo2_accel_linux.c:
            # 350-377); a call queued behind a hung one on the card times
            # out too
            ylog.info(f"watchdog: inference exceeded {ms:.0f} ms; "
                      "attempting one re-dispatch")
            out = dispatch()
            if out is None:
                raise TimeoutError(
                    f"inference exceeded YOLO2_LAYER_TIMEOUT_MS={ms:.0f} ms "
                    "twice (watchdog; recovery re-dispatch also timed out)")
            ylog.info("watchdog: recovery re-dispatch succeeded")
        self._seen_shapes.add(key)
        return out[0]

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

    @staticmethod
    def _copy_in(g: CapturedForward, x: torch.Tensor, req=None) -> None:
        """Host frames ``x`` into g's input. Frames of more than
        ``STAGE_MIN_BYTES`` pass through g's pinned stage (``stage_in``, in
        ``stage_chunks`` of ``STAGE_CHUNK_BYTES``, the stage made at g's
        first such copy) and the host does not wait for their DMAs; the
        stream puts what follows after them all. ``g.copied``, recorded
        after the last DMA, keeps a call from writing the stage while an
        earlier call's DMA may still read it: a call waits on it only then
        (a call queued behind a held stream, a re-dispatch). Fewer bytes (a
        camera frame, ``predict``), or one intra-op thread to stage on (a
        process on one CPU), go straight from pageable memory (CUDA's own
        copy, which blocks): the stage measured no faster there (PERF.md).
        ``req``: a traced request, whose ``staged`` (bytes), ``chunks``
        (DMAs) and ``syncs`` (1 where the copy blocked) this counts, or
        None."""
        if x.nbytes <= STAGE_MIN_BYTES or torch.get_num_threads() == 1:
            g.inp.copy_(x)
            if req is not None:
                req.attrs["syncs"] += 1
            return
        chunks = stage_chunks(len(x), x.nbytes, STAGE_CHUNK_BYTES)
        if g.stage is None:
            g.stage = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            g.copied = torch.cuda.Event()
        waited = not g.copied.query()
        if waited:
            g.copied.synchronize()
        stage_in(g.inp, g.stage, x, chunks)
        g.copied.record()
        if req is not None:
            req.attrs["syncs"] += waited
            req.attrs["staged"] += x.nbytes
            req.attrs["chunks"] += len(chunks)

    def _run(self, x: torch.Tensor, letterbox: bool = False,
             req=None) -> dict:
        """One forward of host NHWC frames: a replay of its graph on a card
        (the frames copied into the graph's input, ``_copy_in``), an eager
        run on the CPU. Returns the device outputs, which the next replay
        overwrites. ``req``: a traced request, whose
        ``engine.copy_in`` and ``engine.launch`` spans this records and
        whose counts the copy in adds to, or None."""
        if self.device.type != "cuda":
            if req is None:
                return self._forward(x.to(self.device), letterbox)
            with req.span("engine.copy_in"):
                x = x.to(self.device)
            req.attrs["syncs"] += 1     # a copy with x.to blocks
            with req.span("engine.launch"):
                return self._forward(x, letterbox)
        g = self._graph(x, letterbox)
        if req is None:
            self._copy_in(g, x)
            g.graph.replay()
        else:
            with req.span("engine.copy_in"):
                self._copy_in(g, x, req)
            with req.span("engine.launch"):
                g.graph.replay()
        g.replays += 1
        return g.out

    def forward_ms(self, frames: np.ndarray, n: int) -> list[float]:
        """ms of each of ``n`` forwards of host NHWC ``frames``: on a card
        the device time, CUDA events around each replay of the graph that
        serves them (captured at first use, the frames copied in once); on
        the CPU the host clock around each eager forward."""
        if self.backend != "device":
            raise ValueError("forward_ms times the device backend; the "
                             "engine was built with backend='golden'")
        x = torch.from_numpy(np.ascontiguousarray(frames))
        ts = []
        if self.device.type != "cuda":
            for _ in range(n):
                t0 = time.perf_counter()
                self._forward(x, letterbox=False)
                ts.append((time.perf_counter() - t0) * 1e3)
            return ts
        g = self._graph(x, letterbox=False)
        g.inp.copy_(x)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        for _ in range(n):
            start.record()
            g.graph.replay()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        g.replays += n
        return ts

    def _call(self, frames: np.ndarray, fetch, letterbox: bool = False):
        """fetch(outputs) of one forward of host NHWC frames, under the
        watchdog, keyed by the forward's graph key. fetch copies what the
        caller needs to the host inside the guarded call: a replay returns
        before the card is done, and the next one overwrites its outputs."""
        if self.backend != "device":
            raise ValueError("this call runs on the device backend; the "
                             "engine was built with backend='golden'")
        # the profiler's switch is thread-local: asked on the caller's
        if torch.autograd._profiler_enabled():
            return self._traced_call(frames, fetch, letterbox)
        x = torch.from_numpy(np.ascontiguousarray(frames))
        return self._guarded(lambda v: fetch(self._run(v, letterbox)), x,
                             key=(letterbox, x.dtype, tuple(x.shape)))

    def _traced_call(self, frames: np.ndarray, fetch, letterbox: bool):
        """``_call`` with its spans recorded (``runtime.trace``): the root
        ``engine.request`` on the caller's thread, with the counts
        ``frames``, ``syncs`` (the blocking points the engine calls: one a
        table the fetch reads back, and the copy in where it blocks: from
        pageable memory always, through the stage only where it waits for
        an earlier copy), ``staged`` (the bytes through the graph's pinned
        stage) and ``chunks`` (the DMAs that copy them in; both 0 where the
        frames do not pass the stage), and under it ``engine.queue``,
        ``engine.copy_in``, ``engine.launch``, ``engine.fetch`` and
        ``engine.resume``."""
        with trace.request("engine.request", frames=len(frames), syncs=0,
                           staged=0, chunks=0) as req:
            x = torch.from_numpy(np.ascontiguousarray(frames))

            def traced(v):
                out = self._run(v, letterbox, req)
                with req.span("engine.fetch"):
                    host = fetch(out)
                # one blocking read an array
                req.attrs["syncs"] += len(host) if isinstance(host,
                                                              dict) else 1
                return host
            return self._guarded(traced, x, req=req,
                                 key=(letterbox, x.dtype, tuple(x.shape)))

    def _detections(self, frames: np.ndarray, letterbox: bool = False) -> tuple:
        """The top-K tables of a device-NMS forward, on the host."""
        host = self._call(frames, _tables, letterbox)
        self._warn_saturated(host)
        return tuple(host[k] for k in _DETECTIONS)

    def _golden_forward(self, boxed_chw: np.ndarray,
                        keep_all: bool = False) -> dict[int, np.ndarray]:
        """The golden backend's forward of one letterboxed CHW image, in the
        tier's mode."""
        if self.precision == "fp32":
            return self._golden.forward_fp32(boxed_chw, self.store.fp32,
                                             keep_all=keep_all)
        weights, qtables = _TIERS[self.precision][:2]
        mode = (("exact" if self.compute == "exact" else "int32")
                if self.precision == "int16" else self.precision)
        return self._golden.forward_int16(
            boxed_chw, getattr(self.store, weights),
            getattr(self.store, qtables), keep_all=keep_all, mode=mode)

    def predict(self, boxed_chw: np.ndarray) -> PredictResult:
        """One letterboxed (3, H, W) float image -> the raw region head in
        CHW (dump/parity layout)."""
        t0 = time.perf_counter()
        if self.backend == "golden":
            head = self._golden_forward(boxed_chw)[self.spec.n - 1]
        else:
            head = self._call(boxed_chw.transpose(1, 2, 0)[None]
                              .astype(np.float32), _heads)[0]
        return PredictResult(head_chw=np.ascontiguousarray(head),
                             seconds=time.perf_counter() - t0)

    # ------------------------------------------------------------------
    def predict_layers(self, boxed_chw: np.ndarray) -> dict[int, np.ndarray]:
        """Every layer's output for one letterboxed (3, H, W) float image,
        {layer idx: CHW array} in the tier's dtype (the user-facing analog
        of the reference cosim's per-layer dumps,
        vitis/yolo2_cosim_tb.cpp:970-979). Golden backend: keep_all acts;
        device backend: a second model with the "acts" output
        (``YoloV2Q``), built at first use and run eagerly under the
        watchdog (tag "debug")."""
        if self.backend == "golden":
            return {i: np.asarray(a) for i, a in
                    self._golden_forward(boxed_chw, keep_all=True).items()}
        if self._debug is None:
            self._debug = YoloV2Q(self.spec, self.qtables, self.params,
                                  self.device, self.precision,
                                  self._overrides, ("acts",))
        x = torch.from_numpy(np.ascontiguousarray(
            boxed_chw.transpose(1, 2, 0)[None], np.float32))
        return self._guarded(
            lambda v: {i: a[0].permute(2, 0, 1).cpu().numpy() for i, a in
                       self._debug(v.to(self.device))["acts"].items()},
            x, tag="debug", key=(False, x.dtype, tuple(x.shape)))

    def dump_layers(self, boxed_chw: np.ndarray, dirpath: str) -> None:
        """Write layerNN.bin per layer (raw CHW, exactly c*h*w elements in
        the tier's dtype: int16/int8/fp32; no arena row alignment)."""
        os.makedirs(dirpath, exist_ok=True)
        acts = self.predict_layers(boxed_chw)
        for idx, a in sorted(acts.items()):
            np.ascontiguousarray(a).tofile(
                os.path.join(dirpath, f"layer{idx:02d}.bin"))
        ylog.info(f"dumped {len(acts)} layer tensors to {dirpath}")

    # ------------------------------------------------------------------
    def predict_batch(self, boxed_nchw: np.ndarray) -> np.ndarray:
        """(N, 3, H, W) letterboxed float frames -> (N, oc, h, w) heads."""
        if self.backend == "golden":
            return np.stack([self.predict(b).head_chw for b in boxed_nchw])
        return self._call(boxed_nchw.transpose(0, 2, 3, 1).astype(np.float32),
                          _heads)

    def predict_batch_rgb(self, frames_nhwc_u8: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) net-sized uint8 RGB frames -> (N, oc, h, w) heads;
        on the device backend the frames cross to the device as uint8 and
        /255 runs there."""
        if frames_nhwc_u8.dtype != np.uint8:
            raise TypeError(f"predict_batch_rgb wants uint8 frames, got "
                            f"{frames_nhwc_u8.dtype}")
        if self.backend == "golden":
            return self.predict_batch(frames_nhwc_u8.astype(np.float32)
                                      .transpose(0, 3, 1, 2) / 255.0)
        return self._call(frames_nhwc_u8, _heads)

    def predict_batch_raw_frames(self, frames_nhwc_u8: np.ndarray):
        """(N, H, W, 3) raw uint8 frames of any one size: the darknet-exact
        letterbox runs on the device (``ops.letterbox``), in the graph of
        that source shape, so only the raw pixels cross to the card.
        Returns the (N, oc, h, w) heads, or, with device_nms, the top-K
        tables (boxes, scores, classes, valid)."""
        if frames_nhwc_u8.dtype != np.uint8:
            raise TypeError(f"predict_batch_raw_frames wants uint8 frames, "
                            f"got {frames_nhwc_u8.dtype}")
        if self.device_nms:
            return self._detections(frames_nhwc_u8, letterbox=True)
        return self._call(frames_nhwc_u8, _heads, letterbox=True)

    def predict_batch_detections(self, frames: np.ndarray) -> tuple:
        """Batched device decode + NMS (engine built with device_nms=True):
        only the top-K tables leave the card. frames: (N, H, W, 3) uint8 or
        (N, 3, H, W) float, letterboxed to the network size."""
        if not self.device_nms:
            raise ValueError("engine built without device_nms=True")
        return self._detections(
            frames if frames.dtype == np.uint8
            else frames.transpose(0, 2, 3, 1).astype(np.float32))

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
        sb, ss, sc, sv = (t[0] for t in self._detections(
            boxed.transpose(1, 2, 0)[None].astype(np.float32)))
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


def tier_qtables(store: WeightStore, precision: str):
    """The store's Q tables of a precision tier (None for fp32);
    ValueError when the store lacks the tier's weights."""
    weights, qtables, _, missing = _TIERS[precision]
    if not getattr(store, weights):
        raise ValueError(missing)
    return getattr(store, qtables) if qtables else None


def tier_params(spec: NetworkSpec, store: WeightStore, precision: str,
                device: torch.device | str) -> dict:
    """The parameters of a precision tier on ``device``, from the store, as
    the engine's device backend takes them; ValueError when the store lacks
    the tier's weights."""
    tier_qtables(store, precision)
    return _TIERS[precision][2](spec, store, device)


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
