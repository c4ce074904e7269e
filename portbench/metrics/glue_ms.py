"""glue_ms (ms a request, device trace): the device time of the kernels and
memsets that are not the port's hand-written kernels (``work.is_ours``):
PyTorch's ops for /255, quantization, the letterbox, dequantization, the
decode, the top-K selection and the NMS's torch ops; over the stretch's
requests."""

from portbench import work


def read(run):
    tl = run.timeline
    if tl is None or not tl.device or not tl.calls:
        return None
    glue = [e for e in tl.within(tl.start, tl.end, ("kernel", "memset"))
            if not work.is_ours(e.name)]
    return sum(e.end - e.start for e in glue) / len(tl.calls) * 1e3
