"""h2d_ms (ms a request, device trace): the device time of the
host-to-device copies (the frames into the graph's input) in the traced
stretch, over its requests."""


def read(run):
    tl = run.timeline
    if tl is None or not tl.device or not tl.calls:
        return None
    h2d = tl.within(tl.start, tl.end, ("h2d",))
    return sum(e.end - e.start for e in h2d) / len(tl.calls) * 1e3
