"""Spans and the profiler's timeline of a traced stretch of the window.

The benchmark records its own spans around the calls into the system
(``portbench.pick``: the request's frames taken from the pool;
``portbench.call``: the engine call, from the frames on the host to the
tables on the host; ``portbench.keep``: the tables kept for the check) as
``torch.profiler.record_function`` ranges, so that they lie on the same
clock as the device's kernels and copies. ``torch.profiler`` runs over a
steady stretch of the window (the traffic's ``trace_after_s`` and
``trace_s``); ``Timeline`` holds what it saw, in seconds.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

SPANS = ("portbench.pick", "portbench.call", "portbench.keep")


@dataclass(frozen=True)
class Event:
    name: str
    start: float     # seconds on the profiler's clock
    end: float
    kind: str        # kernel, memset, h2d, d2h, memcpy; cpu; span


@dataclass
class Timeline:
    """A traced stretch: the device's activities, the host's operations and
    the benchmark's spans (each call span one request of
    ``frames_per_call`` frames); the stretch runs from the first span's
    start to the last span's end."""
    device: list[Event] = field(default_factory=list)
    cpu: list[Event] = field(default_factory=list)
    spans: list[Event] = field(default_factory=list)
    frames_per_call: int = 1

    @property
    def calls(self) -> list[Event]:
        return [s for s in self.spans if s.name == "portbench.call"]

    @property
    def start(self) -> float:
        return min(s.start for s in self.spans)

    @property
    def end(self) -> float:
        return max(s.end for s in self.spans)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def frames(self) -> int:
        return len(self.calls) * self.frames_per_call

    def within(self, lo: float, hi: float, kinds=None) -> list[Event]:
        """Device events that start within [lo, hi], of ``kinds`` if given."""
        return [e for e in self.device if lo <= e.start and e.start < hi
                and (kinds is None or e.kind in kinds)]


def _kind(name: str, activity: str) -> str | None:
    """A device event's kind, from its activity type and name; None for
    what is not device work (a range of a user annotation on the device)."""
    low = name.lower()
    if activity in ("gpu_user_annotation", "user_annotation"):
        return None
    if low.startswith("memcpy"):
        if "htod" in low:
            return "h2d"
        if "dtoh" in low:
            return "d2h"
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    if activity in ("", "kernel") and not name.startswith("portbench."):
        return "kernel"
    return None


def _ns(e, what: str) -> float:
    """An event's start or end in ns, from either of the profiler's APIs."""
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return float(f())
    return float(getattr(e, f"{what}_us")()) * 1e3


def timeline(prof, frames_per_call: int) -> Timeline:
    """The Timeline of a finished ``torch.profiler.profile``: its raw kineto
    events, split into device activities, host operations and spans.
    Spans that did not end within the profile are left out."""
    tl = Timeline(frames_per_call=frames_per_call)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, end = _ns(e, "start") * 1e-9, _ns(e, "end") * 1e-9
        act = getattr(e, "activity_type", None)
        act = str(act() if callable(act) else act or "").lower()
        if e.device_type() == DeviceType.CUDA:
            kind = _kind(name, act)
            if kind is not None:
                tl.device.append(Event(name, start, end, kind))
        elif name in SPANS:
            if end > start:
                tl.spans.append(Event(name, start, end, "span"))
        elif act in ("cpu_op", "cuda_runtime", "cuda_driver", ""):
            tl.cpu.append(Event(name, start, end, "cpu"))
    tl.device.sort(key=lambda ev: ev.start)
    tl.spans.sort(key=lambda ev: ev.start)
    return tl


class Tracer:
    """The spans of the window, and the profiler over its stretch: ``span``
    is a no-op until ``start`` and after ``stop``."""

    def __init__(self):
        self.prof = None
        self.active = False

    def start(self) -> None:
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.active = True

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self.active = False

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        return record_function(name)
