"""fps (frames/s, host clock): every frame whose tables came back to the
host within the window, over the window's seconds."""

from portbench import stats


def read(run):
    return stats.rate(run.frames_done, run.seconds)
