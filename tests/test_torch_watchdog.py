"""The engine watchdog ``Engine._guarded`` of the port against yolotpu's:
the same hang scripts (tests/test_runtime.py's two watchdog tests) run on
both engines, with the same outcomes and exception types; a call made
while another hangs, bounded by its own deadline (the port runs its calls
one at a time, so it waits behind the hung one); the first-use
grace keyed by the engine's graph key (letterbox, dtype, shape), not by
shape alone; YOLO2_LAYER_TIMEOUT_MS=0; and every device call of the port
going through the watchdog, its copy to the host included."""

import functools
import threading
import time

import numpy as np
import pytest
import torch

from yolotpu.models import zoo as jzoo
from yolotpu.runtime import engine as jengine
from yolotpu_torch.models import zoo
from yolotpu_torch.runtime import engine

SIZE = 64


@functools.cache
def _stores():
    spec = zoo.build("yolov2", width=SIZE, height=SIZE)
    jspec = jzoo.build("yolov2", width=SIZE, height=SIZE)
    return (spec, engine.load_or_synthesize(spec, None, "fp32", synthetic=True),
            jspec, jengine.load_or_synthesize(jspec, None, "fp32",
                                              synthetic=True))


def _both(**kw):
    """(port engine on the CPU's device backend, yolotpu's golden engine)."""
    spec, store, jspec, jstore = _stores()
    return {"port": engine.Engine(spec, store, device="cpu", **kw),
            "jax": jengine.Engine(jspec, jstore, "fp32", backend="golden")}


def _outcome(fn):
    try:
        return ("ok", fn())
    except (TimeoutError, RuntimeError) as e:
        return (type(e).__name__, str(e).split(";")[0])


def _recovery_script(eng):
    """A single hung step recovers through one re-dispatch; two
    consecutive hangs raise (tests/test_runtime.py's first watchdog test)."""
    eng._seen_shapes = {("t", (1,))}     # seen: no first-use grace
    calls = {"n": 0}

    def hang_once(x):
        calls["n"] += 1
        if calls["n"] == 1:
            time.sleep(1.2)
        return x * 2

    def hang_always(x):
        time.sleep(1.2)
        return x

    got = [_outcome(lambda: eng._guarded(hang_once, np.ones(1), tag="t")[0])]
    got.append(calls["n"])
    eng._seen_shapes.add(("t2", (1,)))
    got.append(_outcome(lambda: eng._guarded(hang_always, np.ones(1),
                                             tag="t2")))
    return got


def _cap_script(eng, cap):
    """Once the cap of abandoned workers is parked, dispatch fails fast;
    once they drain it works again (the second watchdog test)."""
    release = threading.Event()

    def hang_until_released(x):
        release.wait(timeout=30)
        return x

    got = []
    eng._seen_shapes = getattr(eng, "_seen_shapes", set())
    for i in range(cap // 2):
        eng._seen_shapes.add((f"c{i}", (1,)))
        got.append(_outcome(lambda i=i: eng._guarded(
            hang_until_released, np.ones(1), tag=f"c{i}")))
    got.append(len(eng._abandoned_threads))
    eng._seen_shapes.add(("cap", (1,)))
    got.append(_outcome(lambda: eng._guarded(hang_until_released, np.ones(1),
                                             tag="cap")))
    release.set()
    for t in list(eng._abandoned_threads):
        t.join(timeout=10)
        assert not t.is_alive()
    got.append(_outcome(lambda: eng._guarded(lambda x: x * 3, np.ones(1),
                                             tag="cap")[0]))
    return got


def test_watchdog_recovery_redispatch_as_yolotpu(monkeypatch):
    monkeypatch.setenv("YOLO2_LAYER_TIMEOUT_MS", "300")
    got = {who: _recovery_script(eng) for who, eng in _both().items()}
    assert got["port"] == got["jax"]
    assert got["port"][:2] == [("ok", 2.0), 2]
    assert got["port"][2][0] == "TimeoutError"
    assert "twice" in got["port"][2][1]


def test_watchdog_abandoned_thread_cap_as_yolotpu(monkeypatch):
    monkeypatch.setenv("YOLO2_LAYER_TIMEOUT_MS", "100")
    cap = engine.Engine.WATCHDOG_MAX_ABANDONED
    assert cap == jengine.Engine.WATCHDOG_MAX_ABANDONED
    got = {who: _cap_script(eng, cap) for who, eng in _both().items()}
    assert got["port"] == got["jax"]
    assert got["port"] == ([("TimeoutError", got["port"][0][1])] * (cap // 2)
                           + [cap, ("RuntimeError", f"watchdog: {cap} abandoned "
                                     f"device calls still parked (cap {cap})"),
                              ("ok", 3.0)])


def _behind(eng, first):
    """Call "b" made while call "a" hangs on its first dispatch: the
    outcomes of both and how many times b's function ran."""
    eng._seen_shapes = {("a", (1,)), ("b", (1,))}
    runs = {"b": 0}

    def b(x):
        runs["b"] += 1
        return x * 3

    got = {}
    t = threading.Thread(target=lambda: got.update(a=_outcome(
        lambda: eng._guarded(first, np.ones(1), tag="a")[0])))
    t.start()
    time.sleep(0.05)
    t0 = time.perf_counter()
    got["b"] = _outcome(lambda: eng._guarded(b, np.ones(1), tag="b")[0])
    got["b_s"] = time.perf_counter() - t0
    t.join(timeout=10)
    for w in list(eng._abandoned_threads):
        w.join(timeout=10)
    return got, runs["b"]


def test_a_call_behind_a_hung_one_as_yolotpu(monkeypatch):
    """yolotpu runs b beside a at once; the port's one worker runs b behind
    a, so b times out there, re-dispatches beside a's re-dispatch and
    succeeds; its queued first dispatch is skipped, so b ran once."""
    monkeypatch.setenv("YOLO2_LAYER_TIMEOUT_MS", "300")
    got = {}
    for who, eng in _both().items():
        calls = {"n": 0}

        def hang_once(x):
            calls["n"] += 1
            if calls["n"] == 1:
                time.sleep(1.2)
            return x * 2

        out, runs = _behind(eng, hang_once)
        got[who] = (out["a"], out["b"], runs)
        if who == "port":
            assert out["b_s"] < 2 * 0.3 + 0.3
    assert got["port"] == got["jax"] == (("ok", 2.0), ("ok", 3.0), 1)


def test_a_call_behind_one_hung_twice_is_bounded_by_its_deadline(monkeypatch):
    """The port serialises its device calls (a graph's buffers serve one
    call at a time): a call queued behind one that hangs every time waits
    no longer than its own two deadlines, raises TimeoutError, and never
    runs."""
    monkeypatch.setenv("YOLO2_LAYER_TIMEOUT_MS", "300")

    def hang(x):
        time.sleep(1.2)
        return x

    out, runs = _behind(_both()["port"], hang)
    assert out["a"][0] == out["b"][0] == "TimeoutError"
    assert "twice" in out["b"][1] and runs == 0
    assert out["b_s"] < 2 * 0.3 + 0.3


def test_first_use_grace_is_keyed_by_the_graph_key(monkeypatch):
    """A slow first call of a key passes (900 s grace); the same key again
    times out twice; a float input of the same shape, or raw frames to
    letterbox, are other graphs and get the grace again."""
    eng = _both()["port"]
    run = eng._run

    def slow_run(x, letterbox=False):
        time.sleep(0.3)
        return run(x, letterbox)

    monkeypatch.setattr(eng, "_run", slow_run)
    monkeypatch.setenv("YOLO2_LAYER_TIMEOUT_MS", "100")
    u8 = np.random.default_rng(0).integers(0, 256, (2, SIZE, SIZE, 3),
                                           dtype=np.uint8)
    heads = eng.predict_batch_rgb(u8)
    assert ("main", False, torch.uint8, (2, SIZE, SIZE, 3)) in eng._seen_shapes
    with pytest.raises(TimeoutError, match="twice"):
        eng.predict_batch_rgb(u8)
    f32 = u8.transpose(0, 3, 1, 2) / np.float32(255)
    assert np.array_equal(eng.predict_batch(f32), heads)
    assert ("main", False, torch.float32, (2, SIZE, SIZE, 3)) in eng._seen_shapes
    assert eng.predict_batch_raw_frames(u8).shape == heads.shape
    assert ("main", True, torch.uint8, (2, SIZE, SIZE, 3)) in eng._seen_shapes
    for t in list(eng._abandoned_threads):
        t.join(timeout=10)


def test_timeout_zero_runs_unbounded_on_the_callers_thread(monkeypatch):
    monkeypatch.setenv("YOLO2_LAYER_TIMEOUT_MS", "0")
    for eng in _both().values():
        def slow():
            time.sleep(0.2)
            return threading.current_thread()

        assert eng._guarded(slow, tag="z") is threading.current_thread()
    monkeypatch.setenv("YOLO2_LAYER_TIMEOUT_MS", "60000")
    t = _both()["port"]._guarded(threading.current_thread)
    assert t is not threading.current_thread() and t.daemon


def test_every_device_call_goes_through_the_watchdog(monkeypatch):
    spec, store, _, _ = _stores()
    eng = engine.Engine(spec, store, device="cpu", device_nms=True)
    calls = []
    guarded = eng._guarded

    def spy(fn, *args, tag="main", key=None):
        calls.append((tag, key and key[0]))
        return guarded(fn, *args, tag=tag, key=key)

    monkeypatch.setattr(eng, "_guarded", spy)
    rng = np.random.default_rng(1)
    boxed = rng.random((3, SIZE, SIZE), dtype=np.float32)
    u8 = rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    raw = rng.integers(0, 256, (2, 48, 80, 3), dtype=np.uint8)
    eng.predict(boxed)
    eng.predict_batch(boxed[None])
    eng.predict_batch_rgb(u8)
    eng.predict_batch_raw_frames(raw)
    eng.predict_batch_detections(boxed[None])
    eng.detect_device(rng.random((3, 48, 80), dtype=np.float32))
    eng.predict_layers(boxed)
    assert calls == [("main", False)] * 3 + [("main", True)] + \
        [("main", False)] * 2 + [("debug", False)]
