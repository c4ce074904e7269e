"""The metrics' readers, one file a metric: ``read(run)`` returns the
metric's value from a ``portbench.cell.Run``, or None where the run holds
nothing to read (the harness then leaves the metric out of the line)."""
