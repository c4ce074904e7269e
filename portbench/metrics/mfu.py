"""mfu (%, device trace and the spans): the network's conv operations of
every frame served in the traced stretch (2 x the MACs counted from the
configuration's layers: 29.46e9 a frame for yolov2 at 416x416), over the
stretch's seconds times the tier's peak on the 8-bit tensor cores
(portbench.work: 1979e12 a second over the 8-bit products a MAC takes, 4
for int16, 1 for int8)."""

from portbench import work


def read(run):
    tl = run.timeline
    if tl is None or not tl.device or not tl.calls:
        return None
    ops = work.frame_ops(run.layers)
    peak = work.tier_peak_ops(run.precision)
    return tl.frames * ops / (tl.seconds * peak) * 100
