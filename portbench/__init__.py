"""The benchmark of the PyTorch and CUDA port (``yolotpu_torch``) on one
NVIDIA H100: ``python3 -m portbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.

What belongs to one configuration, traffic mix or metric is a file of its
own, found by name: ``configs/<config>.json`` (the network, the tier, the
engine settings, the seeded weights' shape, the check's limits),
``traffic/<mix>.json`` (read by the one generator, ``traffic.py``, and
sent by the arrival process it names, ``loops/<loop>.py``),
``metrics/<metric>.py`` (a reader of the window's record or the traced
stretch), ``references/<name>.py`` (the plain reference). The yardstick
lives here too: ``netcfg.py`` (darknet's sections and their shapes: convs,
maxpools, routes, reorgs, shortcuts, upsamples, and one region head or
several yolo heads), ``darknet_float.py`` (the float64 darknet: forward,
letterbox, the heads' decode, top-K and NMS), ``work.py`` (operations,
bytes, the card's peaks, the port's kernels by name), ``stats.py``,
``check.py`` (the comparison that decides ``correct``), ``synth.py`` (the
seeded inputs, each head fitted). ``system.py`` alone touches the port.
``python3 -m portbench.control`` reads the controls that set the limits.
CPU tests: ``python -m pytest portbench/tests -q``.

A new configuration, of any family whose heads ``netcfg`` reads, comes as
files and entries alone: its config, ``configs/<config>.json``, with its
entry in ``BENCHMARK.json``'s ``configs``; its reference module,
``references/<module>.py``, which the config names by ``reference``; its
cell, an entry in ``workloads``; its metrics' reader files,
``metrics/<metric>.py``, with their entries; and its cell's name appended
to the ``workloads`` lists of the metrics it reports.
``tests/test_portbench_manifest.py`` holds the document to the rules such
an addition has to meet, and ``tests/test_portbench_addition.py`` rehearses
one.
"""
