"""The statistics and the per-layer readers on synthetic samples and
timelines: a percentile over all requests, a rate over all the window's
frames and time, busy and idle time, each reader's arithmetic."""

import json
from pathlib import Path

import pytest

from portbench import manifest, netcfg, stats, traffic, work
from portbench.cell import Run, breakdown
from portbench.trace import Event, Timeline

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "configs"
                     / "yolov2-416-int16.json").read_text())
LAYERS = netcfg.layers_of(CONFIG)
MIX = traffic.load("offline-b128")


def test_percentile_over_all_requests():
    lat = [float(i) for i in range(1, 101)]   # 1..100
    assert stats.percentile(lat, 50) == pytest.approx(50.5)
    assert stats.percentile(lat, 95) == pytest.approx(95.05)
    # one slow request among many moves the tail, not the median
    slow = [1.0] * 99 + [1000.0]
    assert stats.percentile(slow, 50) == 1.0
    assert stats.percentile(slow + [1000.0] * 5, 95) > 1.0


def test_rate_counts_all_frames_over_all_the_time():
    run = Run(CONFIG, MIX, LAYERS, seconds=10.0, setup_s=1.0,
              latencies=[0.03] * 300, frames_done=300 * 128)
    assert manifest.reader("fps")(run) == pytest.approx(3840.0)
    # a stall in the window lowers the rate, though no step got slower
    stalled = Run(CONFIG, MIX, LAYERS, seconds=12.0, setup_s=1.0,
                  latencies=[0.03] * 300, frames_done=300 * 128)
    assert manifest.reader("fps")(stalled) == pytest.approx(3200.0)
    assert manifest.reader("setup_s")(run) == 1.0


def test_latency_readers():
    run = Run(CONFIG, MIX, LAYERS, 10.0, 1.0,
              latencies=[0.001 * i for i in range(1, 101)])
    assert manifest.reader("latency_p50_ms")(run) == pytest.approx(50.5)
    assert manifest.reader("latency_p50_ms")(Run(CONFIG, MIX, LAYERS, 10.0,
                                                 1.0)) is None


def test_union_covered_gaps_idle():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert stats.union(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert stats.covered(iv, 0.0, 5.0) == 3.0
    assert stats.covered(iv, 1.5, 3.5) == 1.0
    assert stats.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert stats.idle_share(iv, 0.0, 5.0) == pytest.approx(0.4)


CONV = "void yq::tc::igemm_tc_kernel<yq::tc::Q16, yq::tc::ConvTc<short>>"


def timeline():
    """Two requests of 128 frames: each 10 ms, with a 2 ms frame copy in, a
    5 ms conv, 1 ms of glue and a 0.5 ms memset, the rest host time."""
    tl = Timeline(frames_per_call=128)
    for k in range(2):
        t = 0.010 * k
        tl.spans += [Event("portbench.pick", t, t + 0.0001, "span"),
                     Event("portbench.call", t + 0.0001, t + 0.0099, "span"),
                     Event("portbench.keep", t + 0.0099, t + 0.01, "span")]
        tl.device += [
            Event("Memcpy HtoD (Pageable -> Device)", t + 0.001, t + 0.003,
                  "h2d"),
            Event(CONV, t + 0.003, t + 0.008, "kernel"),
            Event("Memset (Device)", t + 0.008, t + 0.0085, "memset"),
            Event("void at::native::elementwise_kernel<128, 2>", t + 0.0085,
                  t + 0.0095, "kernel"),
        ]
        tl.cpu += [Event("aten::copy_", t + 0.0005, t + 0.0031, "cpu")]
    return tl


def traced_run():
    return Run(CONFIG, MIX, LAYERS, 10.0, 1.0, timeline=timeline())


def test_layer_readers_on_a_synthetic_timeline():
    run = traced_run()
    read = lambda name: manifest.reader(name)(run)  # noqa: E731
    assert read("h2d_ms.offline") == pytest.approx(2.0)
    assert read("glue_ms.offline") == pytest.approx(1.5)
    # the call spans 9.8 ms, of which the device covers 2 + 5 + 0.5 + 1
    assert read("host_overhead_ms.offline") == pytest.approx(1.3)
    # busy 8.5 ms of each request's 10, from the first span to the last
    assert read("device_idle.offline") == pytest.approx(15.0)
    ops = work.frame_ops(LAYERS)
    assert read("mfu.offline") == pytest.approx(
        256 * ops / (0.02 * 1979e12 / 4) * 100)
    assert read("conv_roofline.offline") == pytest.approx(
        256 * work.conv_bound_seconds(LAYERS, "int16") / 0.010 * 100)


def test_readers_leave_out_what_they_cannot_read():
    run = Run(CONFIG, MIX, LAYERS, 10.0, 1.0)   # untraced
    for m in ("h2d_ms", "host_overhead_ms", "glue_ms", "device_idle", "mfu",
              "conv_roofline"):
        assert manifest.reader(m)(run) is None
    empty = Run(CONFIG, MIX, LAYERS, 10.0, 1.0, timeline=Timeline())
    assert manifest.reader("mfu.camera")(empty) is None


def test_breakdown_names_ops_and_gaps():
    b = breakdown(timeline())
    assert b["device_ops"][0][0].startswith("void yq::tc::igemm_tc_kernel")
    assert b["device_ops"][0][1] == pytest.approx(0.010)
    assert len(b["idle_gaps"]) <= 10
    # the longest idle stretch, 1.6 ms between a request's last kernel and
    # the next one's copy, lies across the keep and pick spans
    names = [g[0] for g in b["idle_gaps"]]
    assert any(n.startswith("call/aten::copy_") for n in names)
    assert all(g[1] > 0 for g in b["idle_gaps"])
