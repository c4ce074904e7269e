"""Timing reports of the runtime: ``StepTimer``, the end-to-end step latency
collector the streaming loop reports from.

Mirrors ``StepTimer`` of ``yolotpu/runtime/profiler.py``; the port keeps its
own copy and imports nothing of ``yolotpu``. The rest of that module (the
per-layer profiler, the roofline table) comes with ROADMAP.md Queue 1, M11.
"""

from __future__ import annotations

import numpy as np


class StepTimer:
    """End-to-end step latency collector -> p50/p90/mean/fps (the metrics
    the reference's report tool extracts from 'inference time:' log lines,
    scripts/YOLO2_REPORT_TOOL.md:177-184)."""

    def __init__(self):
        self.samples_ms: list[float] = []

    def add(self, ms: float) -> None:
        self.samples_ms.append(ms)

    def summary(self, frames_per_step: int = 1) -> dict:
        a = np.asarray(self.samples_ms)
        if a.size == 0:
            return {"count": 0}
        return {
            "count": int(a.size),
            "mean_ms": float(a.mean()),
            "median_ms": float(np.median(a)),
            "p90_ms": float(np.percentile(a, 90)),
            "fps": float(frames_per_step * 1000.0 / np.median(a)),
        }
