"""One run of one cell: set-up, the measured window, the check, the metrics.

Set-up makes the inputs from the seed, builds the system, makes the cell's
first call (which captures its graph, and in a checkout's first run builds
the kernels) and the traffic's warm-up calls; with ``trace`` it also starts
and stops the profiler once, so that its own start-up is set-up too. The
window then sends requests for ``seconds`` seconds, as the traffic's loop
(``portbench/loops/<loop>.py``) has them arrive, and a traced run profiles
a stretch of it. Once the window has closed the device's peak memory is
read, the system is freed, and the reference computes a sample of the
requests, drawn from the seed, for the check.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import check, loops, stats, synth, system
from .manifest import reader
from .netcfg import Layer, layers_of
from .references import load as load_reference
from .trace import Timeline, Tracer, timeline
from .traffic import Traffic


@dataclass
class Run:
    """What the metrics' readers read: the cell, the host clock's record of
    the window, and with ``--trace 1`` the profiled stretch."""
    config: dict
    traffic: Traffic
    layers: list[Layer]
    seconds: float
    setup_s: float
    latencies: list[float] = field(default_factory=list)   # s, in the window
    frames_done: int = 0
    timeline: Timeline | None = None

    @property
    def precision(self) -> str:
        return self.config["precision"]


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sample(results: list, batch: int, frames: int, seed: int) -> list[int]:
    """The requests the check compares: enough to hold ``frames`` frames,
    drawn from the seed among all the window's requests."""
    n = min(len(results), math.ceil(frames / batch))
    rng = np.random.default_rng([seed, 2])
    return sorted(rng.choice(len(results), n, replace=False).tolist())


def compare(ref, results: list, picked: list[int], pool, traffic: Traffic,
            chk: dict) -> dict:
    """The check's numbers over the picked requests: each frame's valid
    detections of the system's tables against the reference's, which
    computes each pool batch the picked requests drew once."""
    drawn = sorted({results[i][0] for i in picked})
    frames = np.concatenate([traffic.request(pool, c) for c in drawn])
    dets = ref.detect(frames, traffic.raw)
    b = traffic.batch
    want_of = {c: dets[k * b:(k + 1) * b] for k, c in enumerate(drawn)}
    got, want = [], []
    for i in picked:
        choice, out = results[i]
        want += want_of[choice]
        ok = (out is not None and len(out) == 4
              and all(len(t) == b for t in out))
        got += [check.frame_detections(out, f) if ok else None
                for f in range(b)]
    return check.compare(got, want, chk["pair_box"], chk["pair_score"])


def run_cell(config: dict, traffic: Traffic, metrics: list[dict], seed: int,
             seconds: float, trace: bool, device: str, t0: float,
             build=system.build) -> tuple[dict, dict]:
    """One run. -> (the result line's object without its check, the check's
    numbers beside their limits). ``t0``: the process's start on the
    ``time.perf_counter`` clock."""
    dev = torch.device(device)
    layers = layers_of(config)
    net_h, net_w = layers[0].h, layers[0].w
    marks = [("start", t0), ("imports", time.perf_counter())]
    inputs = synth.make_inputs(layers, config["weights"], config["engine"],
                               traffic.pool_shape(net_h, net_w), traffic.raw,
                               seed, dev)
    marks.append(("inputs", time.perf_counter()))
    engine = build(config, inputs.weights, inputs.calib, device)
    marks.append(("system", time.perf_counter()))
    say(f"portbench: {config['name']} {config['precision']} plan file "
        f"{getattr(engine, 'plan_source', None)}")
    call = getattr(engine, traffic.entry)
    pool = inputs.pool
    call(traffic.request(pool, 0))
    marks.append(("first call", time.perf_counter()))
    for i in range(traffic.warmup_requests):
        call(traffic.request(pool, (i + 1) % traffic.choices))
    marks.append(("warm-up", time.perf_counter()))
    say("portbench: set-up " + ", ".join(
        f"{name} {t - marks[k][1]:.2f} s" for k, (name, t) in
        enumerate(marks[1:])))
    tracer = Tracer() if trace else None
    if tracer is not None:   # the profiler's own start-up, in set-up
        tracer.start()
        with tracer.span("portbench.call"):
            call(traffic.request(pool, 0))
        tracer.stop()
        tracer = Tracer()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    loop = loops.load(traffic.loop)
    run = Run(config, traffic, layers, seconds, time.perf_counter() - t0)
    requests = loops.Requests(call, pool, traffic, seed, seconds, tracer, run)
    loop.window(requests, synth.request_order(seed, traffic.choices))
    results = requests.close()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    if requests.first_error:
        say(f"portbench: a request failed:\n{requests.first_error}")
    if run.latencies:
        say("portbench: latency ms " + ", ".join(
            f"p{q} {stats.percentile(run.latencies, q) * 1e3:.3f}"
            for q in (50, 90, 95, 99, 100)) + f" over {len(run.latencies)}")
    if tracer is not None and tracer.prof is not None:
        run.timeline = timeline(tracer.prof, traffic.batch)
    del engine, call
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    chk = config["check"]
    ref = load_reference(config["reference"])(config, inputs.weights,
                                              inputs.calib,
                                              config["precision"], dev)
    t_built = time.perf_counter()
    picked = sample(results, traffic.batch, chk["sample_frames"], seed)
    numbers = compare(ref, results, picked, pool, traffic, chk)
    correct, shown = check.judge(numbers, chk["limits"])
    failed = sum(out is None for _, out in results)
    say(f"portbench: reference over {len(picked)} requests, "
        f"{numbers['detections']} detections, largest gaps of a pair: "
        f"score {numbers['score_gap']:.3g}, box {numbers['box_gap']:.3g}; "
        f"set-up "
        f"{t_built - t_ref:.2f} s, heads {ref.seconds['heads']:.2f} s, "
        f"tables {ref.seconds['tables']:.2f} s, all "
        f"{time.perf_counter() - t_ref:.2f} s")

    values = {}
    for m in metrics:
        v = reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": bool(correct and failed == 0),
              "attempted": len(results), "failed": failed, "metrics": values,
              "device": device_info(dev, peak, run.timeline)}
    if run.timeline is not None and run.timeline.device:
        result["breakdown"] = breakdown(run.timeline)
    return result, shown


def device_info(dev: torch.device, peak: int, tl: Timeline | None) -> dict:
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": 1, "memory_peak_bytes": int(peak),
            "cpus": len(os.sched_getaffinity(0))}
    if tl is not None and tl.spans:
        iv = [(e.start, e.end) for e in tl.device]
        info["busy_s"] = stats.covered(iv, tl.start, tl.end)
        info["window_s"] = tl.seconds
    return info


def breakdown(tl: Timeline) -> dict:
    """The device operations that took most time in the stretch, and its
    longest idle gaps, each named by the benchmark's span the host was in
    and the innermost host operation running at the gap's middle."""
    by: dict[str, float] = {}
    for e in tl.within(tl.start, tl.end):
        by[e.name] = by.get(e.name, 0.0) + (e.end - e.start)
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    gaps = stats.gaps([(e.start, e.end) for e in tl.device], tl.start, tl.end)
    named = []
    for lo, hi in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (lo + hi) / 2
        span = next((s.name.removeprefix("portbench.") for s in tl.spans
                     if s.start <= mid < s.end), "between spans")
        inner = [c for c in tl.cpu if c.start <= mid < c.end]
        op = min(inner, key=lambda c: c.end - c.start).name if inner else ""
        named.append([f"{span}/{op}" if op else span, hi - lo])
    return {"device_ops": [[k[:160], v] for k, v in ops],
            "idle_gaps": named}
