"""launch_ms (ms a request, the port's engine spans on the device trace's
clock): for each request of the traced stretch (an ``engine.request`` span
of ``yolotpu_torch.runtime.trace`` that starts within it), its
``engine.launch`` span: the host's time in the graph's replay call;
averaged. None where the port records no span or the stretch holds no
request."""


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
    if not ids:
        return None
    ns = sum(s.end_ns - s.start_ns for s in spans
             if s.request in ids and s.name == "engine.launch")
    return ns / len(ids) * 1e-6
