"""host_overhead_ms (ms a request, device trace and the benchmark's spans):
for each request of the traced stretch, its engine call's span less the
time in it that a device kernel, copy or memset covers; averaged. What the
host adds around the device's work: the hand-off to the engine's watchdog
worker and back, the copy's staging, the graph launch, the tables' reads."""

from portbench import stats


def read(run):
    tl = run.timeline
    if tl is None or not tl.device or not tl.calls:
        return None
    iv = [(e.start, e.end) for e in tl.device]
    host = sum((c.end - c.start) - stats.covered(iv, c.start, c.end)
               for c in tl.calls)
    return host / len(tl.calls) * 1e3
