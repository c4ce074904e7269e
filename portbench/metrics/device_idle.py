"""device_idle (%, device trace): the share of the traced stretch, from its
first span's start to its last span's end, in which no kernel, copy or
memset ran on the device."""

from portbench import stats


def read(run):
    tl = run.timeline
    if tl is None or not tl.device or not tl.calls:
        return None
    iv = [(e.start, e.end) for e in tl.device]
    return stats.idle_share(iv, tl.start, tl.end) * 100
