"""host_syncs (syncs a request, the port's engine spans): for each request
of the traced stretch (an ``engine.request`` span of
``yolotpu_torch.runtime.trace`` that starts within it), its root span's
``syncs`` count: the blocking points the engine calls, the copy in and one
a table it reads back; averaged. None where the port records no span or
the stretch holds no request."""


def read(run):
    tl = run.timeline
    if tl is None or not tl.calls:
        return None
    try:
        from yolotpu_torch.runtime import trace
    except ImportError:     # a version of the port that records no span
        return None
    lo, hi = tl.start, tl.end
    syncs = [s.attrs["syncs"] for s in trace.spans()
             if s.name == "engine.request" and lo <= s.start_ns * 1e-9 < hi]
    return sum(syncs) / len(syncs) if syncs else None
