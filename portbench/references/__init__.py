"""The plain references, one module a family of configurations, named by a
configuration's ``reference`` key; each has a ``Reference(config, weights,
calib, tier, device)`` with ``detect(frames, raw)``."""

from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"{__name__}.{name}").Reference
