"""conv_roofline (%, device trace): for every frame served in the traced
stretch, the least time of the network's convs (for each conv the larger of
its operations over the tier's peak and its bytes over the memory's, each
input, weight and output once; portbench.work), over the device time of the
port's conv kernels in the stretch (``work.CONV_KERNELS``: every conv of
the integer tiers, the ones fused with their pool included). The split-K
workspaces' memsets are left out of the time."""

from portbench import work


def read(run):
    tl = run.timeline
    if tl is None or not tl.device or not tl.calls:
        return None
    conv = sum(e.end - e.start
               for e in tl.within(tl.start, tl.end, ("kernel",))
               if work.is_conv(e.name))
    if conv <= 0:
        return None
    bound = work.conv_bound_seconds(run.layers, run.precision)
    return tl.frames * bound / conv * 100
