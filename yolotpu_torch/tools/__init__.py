"""The port's evidence tools, run as modules (``python -m
yolotpu_torch.tools.<name>``): ``accuracy_protocol``, ``int8_accuracy_sweep``
and ``roofline``, the counterparts of ``tools/*.py``."""
