"""The arrival processes of the traffic mixes, one file each, found by the
name a mix's ``loop`` gives: ``loops/<loop>.py`` holds
``window(requests, order)``, which sends requests through ``requests.send``
until ``requests.deadline``, drawing their pool batches from ``order``. A
new arrival process is a new file here; a new mix of an existing one is a
data file under ``traffic/``.

``Requests`` is what every loop shares: the profiler's stretch, one
request's call under the benchmark's spans, and the window's record (the
requests sent, their tables, and the latencies and frames of those that
returned within the window)."""

from __future__ import annotations

import contextlib
import importlib.util
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(name: str, root: Path = HERE):
    """The module ``loops/<name>.py``."""
    path = root / f"{name}.py"
    if name.startswith("_") or not path.exists():
        raise FileNotFoundError(f"no loop {name!r} under {root}")
    spec = importlib.util.spec_from_file_location(f"portbench.loops.{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _no_span(name: str):
    return contextlib.nullcontext()


class Requests:
    """One window of requests into ``call``: ``send`` makes one, and
    ``results`` holds [(pool batch, tables or None)] in order; latencies
    (seconds) and frames of those that returned within the window go to
    ``run``."""

    def __init__(self, call, pool, traffic, seed: int, seconds: float,
                 tracer, run):
        self.call, self.pool, self.traffic = call, pool, traffic
        self.seed, self.tracer, self.run = seed, tracer, run
        self.results: list = []
        self.first_error: str | None = None
        self.start = time.perf_counter()
        self.deadline = self.start + seconds
        self._trace_on = self.start + traffic.trace_after_s
        self._trace_off = self._trace_on + traffic.trace_s

    def _span(self, now: float):
        tracer = self.tracer
        if tracer is None:
            return _no_span
        if tracer.prof is None and now >= self._trace_on:
            tracer.start()
        elif tracer.active and now >= self._trace_off:
            tracer.stop()
        return tracer.span

    def send(self, choice: int, since: float | None = None) -> float:
        """Request pool batch ``choice`` now; its latency runs from
        ``since`` (its arrival; by default the call's start) to its tables
        on the host. -> the time it returned."""
        span = self._span(time.perf_counter())
        with span("portbench.pick"):
            frames = self.traffic.request(self.pool, choice)
        with span("portbench.call"):
            t0 = time.perf_counter()
            try:
                out = self.call(frames)
            except Exception:   # counted as failed; the window goes on
                out = None
                self.first_error = self.first_error or traceback.format_exc()
            t1 = time.perf_counter()
        with span("portbench.keep"):
            self.results.append((choice, out))
        if out is not None and t1 <= self.deadline:
            self.run.latencies.append(t1 - (t0 if since is None else since))
            self.run.frames_done += self.traffic.batch
        return t1

    def close(self) -> list:
        if self.tracer is not None and self.tracer.active:
            self.tracer.stop()
        return self.results
