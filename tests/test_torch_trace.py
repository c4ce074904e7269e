"""The port's span recorder (``runtime/trace``) and the engine's spans on
its request path: nothing recorded without a profiler; under one, a root
``engine.request`` on the caller's thread and its children (the hand-off
to the watchdog worker and back, the copy in, the launch, the fetch) on the
threads that run them, closed even when the request raises; the root's
``syncs``; the buffer's bound; and the spans on the profiler's clock."""

import functools
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from yolotpu_torch.models import zoo
from yolotpu_torch.runtime import engine, trace

SIZE = 64
CHILDREN = ("engine.queue", "engine.copy_in", "engine.launch",
            "engine.fetch", "engine.resume")
# how far a span may reach outside the profiler's range around it: the
# profiler stamps its events from an approximate clock converted to
# time.time_ns()'s epoch
CLOCK_SLACK_NS = 50_000


@functools.cache
def _store():
    spec = zoo.build("yolov2", width=SIZE, height=SIZE)
    return spec, engine.load_or_synthesize(spec, None, "fp32", synthetic=True)


def _engine(**kw):
    spec, store = _store()
    return engine.Engine(spec, store, device="cpu", device_nms=True, **kw)


def _raw(n=1):
    return np.random.default_rng(3).integers(0, 256, (n, 48, 80, 3),
                                             dtype=np.uint8)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def _by_name(spans):
    out: dict = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


@pytest.fixture(autouse=True)
def _empty():
    trace.clear()
    yield
    trace.clear()


def test_no_profiler_records_nothing(monkeypatch):
    eng = _engine()
    eng.predict_batch_raw_frames(_raw())

    def refused(*a, **k):
        raise AssertionError("a request made a span with no profiler on")

    monkeypatch.setattr(trace, "Request", refused)
    eng.predict_batch_raw_frames(_raw())
    eng.predict_batch(np.zeros((1, 3, SIZE, SIZE), np.float32))
    assert trace.spans() == []


def test_a_request_records_its_spans_on_their_threads():
    eng = _engine()
    eng.predict_batch_raw_frames(_raw())     # the worker exists, key seen
    _profiled(lambda: eng.predict_batch_raw_frames(_raw(2)))
    got = _by_name(trace.spans())
    assert sorted(got) == sorted(("engine.request", *CHILDREN))
    assert all(len(v) == 1 for v in got.values())
    root = got["engine.request"][0]
    assert root.parent is None and root.request == root.id
    assert root.attrs == {"frames": 2, "syncs": 6}
    caller, worker = threading.get_ident(), eng._worker.thread.ident
    assert root.thread == caller
    for name in CHILDREN:
        s = got[name][0]
        assert s.request == root.id and s.parent == root.id
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        assert s.thread == (caller if name == "engine.resume" else worker)
    order = [got[n][0] for n in CHILDREN]
    assert all(a.end_ns <= b.start_ns for a, b in zip(order, order[1:]))


@pytest.mark.parametrize("entry,syncs", [("detections", 6), ("heads", 2)])
def test_syncs_counts_the_copy_in_and_each_table_read(entry, syncs):
    eng = _engine()
    boxed = np.random.default_rng(4).random((1, 3, SIZE, SIZE),
                                            dtype=np.float32)
    call = {"detections": eng.predict_batch_detections,
            "heads": eng.predict_batch}[entry]
    _profiled(lambda: call(boxed))
    (root,) = _by_name(trace.spans())["engine.request"]
    assert root.attrs["syncs"] == syncs


def test_timeout_zero_has_no_hand_off(monkeypatch):
    monkeypatch.setenv("YOLO2_LAYER_TIMEOUT_MS", "0")
    eng = _engine()
    _profiled(lambda: eng.predict_batch_raw_frames(_raw()))
    got = _by_name(trace.spans())
    assert sorted(got) == sorted(("engine.request", "engine.copy_in",
                                  "engine.launch", "engine.fetch"))
    assert {s.thread for v in got.values() for s in v} == {
        threading.get_ident()}


def test_a_request_that_raises_closes_its_spans(monkeypatch):
    eng = _engine()
    eng.predict_batch_raw_frames(_raw())

    def broken(out):
        raise RuntimeError("the tables' read failed")

    monkeypatch.setattr(engine, "_tables", broken)
    with pytest.raises(RuntimeError, match="tables' read"):
        _profiled(lambda: eng.predict_batch_raw_frames(_raw()))
    got = _by_name(trace.spans())
    assert sorted(got) == sorted(("engine.request", *CHILDREN))
    root = got["engine.request"][0]
    assert root.attrs["syncs"] == 1      # the copy in; no table came back
    assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
               for v in got.values() for s in v)


def test_a_dispatch_again_gets_a_second_queue_span(monkeypatch):
    """A call that outlives its deadline is dispatched again on a fresh
    worker: two queue spans under the one request; the abandoned call's
    later spans are not kept once its request has ended. The forward is
    one computed beforehand, so that only the hang decides the timing."""
    eng = _engine()
    eng.predict_batch_raw_frames(_raw())      # seen: no first-use grace
    out = eng._forward(torch.from_numpy(_raw()), letterbox=True)
    monkeypatch.setattr(eng, "_run", lambda v, letterbox=False, req=None: out)
    monkeypatch.setenv("YOLO2_LAYER_TIMEOUT_MS", "500")
    tables = engine._tables
    calls = {"n": 0}

    def slow_once(out):
        calls["n"] += 1
        if calls["n"] == 1:
            time.sleep(1.5)
        return tables(out)

    monkeypatch.setattr(engine, "_tables", slow_once)
    _profiled(lambda: eng.predict_batch_raw_frames(_raw()))
    for t in list(eng._abandoned_threads):
        t.join(timeout=10)
        assert not t.is_alive()
    got = _by_name(trace.spans())
    (root,) = got["engine.request"]
    assert len(got["engine.queue"]) == 2
    assert len(got["engine.fetch"]) == 1     # the second call's
    assert {s.request for v in got.values() for s in v} == {root.id}
    assert all(s.end_ns <= root.end_ns for v in got.values() for s in v)


def test_the_buffer_keeps_the_newest_within_its_bound():
    req = trace.Request("r")
    for i in range(trace.LIMIT + 100):
        with req.span(f"s{i}"):
            pass
    req.end()
    kept = trace.spans()
    assert len(kept) == trace.LIMIT
    assert kept[0].name == "s101" and kept[-1].name == "r"


def test_spans_lie_on_the_profilers_clock():
    """A span recorded 2 ms inside a record_function range, on either
    side, lies at least 2 ms inside the range's start_ns and end_ns as the
    profiler stamps them, to within CLOCK_SLACK_NS."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with record_function(f"outer{i}"):
                time.sleep(0.002)
                with trace.request(f"inner{i}"):
                    time.sleep(0.001)
                time.sleep(0.002)
    outer = {e.name(): (e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("outer")}
    inner = {s.name: s for s in trace.spans()}
    assert len(outer) == len(inner) == 5
    for i in range(5):
        lo, hi = outer[f"outer{i}"]
        s = inner[f"inner{i}"]
        assert s.start_ns - lo >= 2_000_000 - CLOCK_SLACK_NS
        assert hi - s.end_ns >= 2_000_000 - CLOCK_SLACK_NS


def test_the_off_path_asks_the_profiler_once(monkeypatch):
    """With no profiler running, a request asks torch's thread-local switch
    once, on the caller's thread, and makes no span."""
    eng = _engine()
    eng.predict_batch_raw_frames(_raw())
    asked = []
    real = torch.autograd._profiler_enabled

    def spy():
        asked.append(threading.get_ident())
        return real()

    monkeypatch.setattr(torch.autograd, "_profiler_enabled", spy)
    eng.predict_batch_raw_frames(_raw())
    monkeypatch.undo()
    assert asked == [threading.get_ident()]
    assert trace.spans() == []
