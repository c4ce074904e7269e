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
lives here too: ``work.py`` (operations, bytes, the card's peaks, the
port's kernels by name), ``stats.py``, ``check.py`` (the comparison that
decides ``correct``), ``synth.py`` (the seeded inputs). ``system.py`` alone touches the port.
``python3 -m portbench.control`` reads the controls that set the limits.
CPU tests: ``python -m pytest portbench/tests -q``.
"""
