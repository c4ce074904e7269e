"""fetch_ms (ms a request, the port's engine spans and the device trace,
on one clock): for each request of the traced stretch (an
``engine.request`` span of ``yolotpu_torch.runtime.trace`` that starts
within it), the part of its ``engine.fetch`` span from the start of the
first device-to-host copy that begins inside the span to the span's end:
the tables' reads once the forward is done. The part before that copy is
the device still computing, and is not counted. Averaged over the requests
whose fetch holds such a copy; None where none does, the port records no
span or the stretch holds no request."""

import bisect


def read(run):
    tl = run.timeline
    if tl is None or not tl.calls:
        return None
    try:
        from yolotpu_torch.runtime import trace
    except ImportError:     # a version of the port that records no span
        return None
    spans = trace.spans()
    lo, hi = tl.start, tl.end
    ids = {s.request for s in spans
           if s.name == "engine.request" and lo <= s.start_ns * 1e-9 < hi}
    d2h = sorted(e.start for e in tl.device if e.kind == "d2h")
    parts: dict[int, float] = {}
    for s in spans:
        if s.request in ids and s.name == "engine.fetch":
            start, end = s.start_ns * 1e-9, s.end_ns * 1e-9
            i = bisect.bisect_left(d2h, start)
            if i < len(d2h) and d2h[i] < end:
                parts[s.request] = parts.get(s.request, 0.0) + end - d2h[i]
    if not parts:
        return None
    return sum(parts.values()) / len(parts) * 1e3
