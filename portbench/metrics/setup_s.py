"""setup_s (s, host clock): from the process's start to the first request
of the window: imports, the seeded inputs, the system's calibration,
quantization and weight packing, the cell's graph capture (and in a
checkout's first run the kernels' build), the warm-up calls."""


def read(run):
    return run.setup_s
