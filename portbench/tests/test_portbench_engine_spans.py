"""The readers of the port's engine spans (``handoff_ms``, ``copy_in_ms``,
``launch_ms``, ``fetch_ms``, ``host_syncs``): on a hand-built timeline and
hand-built spans, the values worked out by hand, ``fetch_ms`` cut at the
first device-to-host copy inside the fetch; None with no span, with a port
that records none, and for requests outside the stretch. On the CPU a
traced rehearsal reads the four that need no device; on the card a traced
run of each camera cell reads all five."""

import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import traffic
from portbench.cell import run_cell
from portbench.manifest import reader
from portbench.trace import Event, Timeline

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
NAMES = ("handoff_ms", "copy_in_ms", "launch_ms", "fetch_ms", "host_syncs")
MS = 1_000_000                     # ns
T0 = 1_800_000_000 * 10**9         # the stretch's start, ns on the epoch
# the timeline's seconds on the epoch are floats good to 0.24 us
TOL_MS = 1e-3


def _span(trace, name, start, end, req, syncs=None):
    """A span of request ``req`` from ``start`` to ``end`` ms after T0."""
    root = name == "engine.request"
    return trace.Span(name, T0 + round(start * MS), T0 + round(end * MS),
                      req, None if root else req, 1, req if root else 0,
                      {"frames": 1, "syncs": syncs} if root else {})


def _request(trace, req, at, queue, copy_in, launch, fetch, d2h_at,
             resume, syncs):
    """A request starting ``at`` ms, its spans back to back, of the given
    lengths (ms); its device-to-host copies ``d2h_at`` ms into its fetch.
    -> (its spans, its device events)."""
    t, spans = at, []
    for name, ms in (("engine.queue", queue), ("engine.copy_in", copy_in),
                     ("engine.launch", launch), ("engine.fetch", fetch),
                     ("engine.resume", resume)):
        spans.append(_span(trace, name, t, t + ms, req))
        if name == "engine.fetch":
            d2h = [_event(t + d, t + d + 0.01, "d2h") for d in d2h_at]
        t += ms
    spans.append(_span(trace, "engine.request", at, t + 0.01, req, syncs))
    return spans, d2h


def _event(start_ms, end_ms, kind, name=None):
    return Event(name or kind, (T0 + start_ms * MS) * 1e-9,
                 (T0 + end_ms * MS) * 1e-9, kind)


@pytest.fixture
def trace():
    from yolotpu_torch.runtime import trace
    return trace


@pytest.fixture
def built(trace, monkeypatch):
    """Two requests in a 10 ms stretch, one before it and one after, with
    lengths that would move every mean."""
    spans, device = [], []
    for req, at, lens in (
            (1, 0.5, (0.1, 0.2, 0.05, 1.0, (0.5, 0.7), 0.15, 6)),
            (2, 5.0, (0.3, 0.4, 0.15, 1.0, (0.8,), 0.1, 2)),
            (3, -50.0, (9.0, 9.0, 9.0, 9.0, (0.1,), 9.0, 50)),
            (4, 10.5, (9.0, 9.0, 9.0, 9.0, (0.1,), 9.0, 50))):
        s, d = _request(trace, req, at, *lens)
        spans += s
        device += d
    # a copy back of the forward's, in the launch: not the fetch's first
    device.append(_event(5.75, 5.76, "d2h"))
    device.append(_event(1.0, 1.2, "kernel", "conv"))
    tl = Timeline(device=sorted(device, key=lambda e: e.start),
                  spans=[_event(0.0, 4.5, "span", "portbench.call"),
                         _event(4.9, 10.0, "span", "portbench.call")])
    monkeypatch.setattr(trace, "spans", lambda: list(spans))
    return SimpleNamespace(timeline=tl)


@pytest.mark.parametrize("name,want", [
    ("handoff_ms", ((0.1 + 0.15) + (0.3 + 0.1)) / 2),
    ("copy_in_ms", (0.2 + 0.4) / 2),
    ("launch_ms", (0.05 + 0.15) / 2),
    # request 1: 1.0 - 0.5 (two copies; the first cuts); 2: 1.0 - 0.8
    ("fetch_ms", (0.5 + 0.2) / 2),
    ("host_syncs", (6 + 2) / 2)])
def test_a_reader_gives_the_value_worked_by_hand(built, name, want):
    assert reader(name)(built) == pytest.approx(want, abs=TOL_MS)


@pytest.mark.parametrize("name", NAMES)
def test_a_reader_ignores_requests_outside_the_stretch(built, trace,
                                                       monkeypatch, name):
    """Dropping the requests before and after the stretch changes no
    value."""
    want = reader(name)(built)
    inside = [s for s in trace.spans() if s.request in (1, 2)]
    monkeypatch.setattr(trace, "spans", lambda: inside)
    assert reader(name)(built) == want


@pytest.mark.parametrize("name", NAMES)
def test_a_reader_finds_nothing_without_spans(built, trace, monkeypatch,
                                              name):
    monkeypatch.setattr(trace, "spans", lambda: [])
    assert reader(name)(built) is None
    assert reader(name)(SimpleNamespace(timeline=None)) is None
    assert reader(name)(SimpleNamespace(timeline=Timeline())) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_reader_of_a_port_without_spans_finds_nothing(built, monkeypatch,
                                                        name):
    """A version of the port with no ``runtime.trace`` (the benchmark's
    files laid over an older checkout): None, nothing raised."""
    import yolotpu_torch.runtime
    monkeypatch.delattr(yolotpu_torch.runtime, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "yolotpu_torch.runtime.trace", None)
    assert reader(name)(built) is None


def test_fetch_without_a_copy_inside_finds_nothing(built):
    built.timeline.device = [e for e in built.timeline.device
                             if e.kind != "d2h"]
    assert reader("fetch_ms")(built) is None
    assert reader("launch_ms")(built) == pytest.approx(0.1, abs=TOL_MS)


def test_a_traced_rehearsal_reads_the_engine_spans():
    """The CPU: every traced request records its spans; the readers that
    need no device find them (fetch_ms needs the device's copies)."""
    cfg = json.loads((DATA / "configs" / "tiny-64-int16.json").read_text())
    metrics = [{"name": n, "unit": "ms"} for n in NAMES]
    result, _ = run_cell(cfg, traffic.load("tiny-camera", root=DATA),
                         metrics, 5, 0.6, True, "cpu", time.perf_counter())
    got = result["metrics"]
    assert result["correct"] is True
    assert sorted(got) == sorted(set(NAMES) - {"fetch_ms"})
    assert got["host_syncs"]["value"] == 6
    assert all(got[n]["value"] > 0 for n in ("handoff_ms", "copy_in_ms",
                                             "launch_ms"))


CAMERA = [w["name"] for w in
          json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
          if w["traffic"].startswith("camera")]


@pytest.mark.card
@pytest.mark.parametrize("cell", CAMERA)
def test_a_traced_camera_run_reads_every_engine_metric(card, cell):
    """3 s: the camera mixes profile from 2.0 s into the window."""
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          cell, "--seed", "2147483659", "--seconds", "3",
                          "--trace", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])["metrics"]
    for n in NAMES:
        assert got[f"{n}.camera"]["value"] is not None, n
    assert got["host_syncs.camera"]["value"] == 6
