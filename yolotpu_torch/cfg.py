"""Darknet ``.cfg`` reader.

Behavioral contract follows the reference parser (``src/core/yolo_net.cpp:172-205``
``read_cfg`` and ``src/core/yolo_cfg.cpp:8-59`` option handling):

- every line has ALL whitespace stripped (darknet's ``strip()`` removes internal
  whitespace too, so ``anchors = 1.0, 2.0`` becomes ``anchors=1.0,2.0``),
- lines starting with ``#`` or ``;`` (or empty) are skipped,
- ``[name]`` opens a new section; ``key=value`` pairs attach to the current one,
- unused keys produce a warning at the end of parsing a section
  (``option_unused``, ``yolo_cfg.cpp:34-42``).

Mirrors ``yolotpu/cfg.py``; the port keeps its own copy and imports nothing
of ``yolotpu``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field


@dataclass
class Section:
    """One ``[type]`` section with its key=value options."""

    type: str
    line: int
    options: dict[str, str] = field(default_factory=dict)
    _used: set[str] = field(default_factory=set)

    # --- option_find_* equivalents (yolo_cfg.cpp:44-59) ------------------
    def get_str(self, key: str, default: str | None = None) -> str | None:
        if key in self.options:
            self._used.add(key)
            return self.options[key]
        return default

    def get_int(self, key: str, default: int) -> int:
        v = self.get_str(key)
        return int(v) if v is not None else default

    def get_float(self, key: str, default: float) -> float:
        v = self.get_str(key)
        return float(v) if v is not None else default

    def get_floats(self, key: str) -> list[float] | None:
        v = self.get_str(key)
        if v is None:
            return None
        return [float(t) for t in v.split(",") if t != ""]

    def get_ints(self, key: str) -> list[int] | None:
        v = self.get_str(key)
        if v is None:
            return None
        return [int(t) for t in v.split(",") if t != ""]

    def warn_unused(self, file=sys.stderr) -> list[str]:
        """Mirror of ``option_unused``: report keys never consumed."""
        unused = [k for k in self.options if k not in self._used]
        for k in unused:
            print(f"Unused field: '{k} = {self.options[k]}'", file=file)
        return unused


def _strip_all_whitespace(line: str) -> str:
    return "".join(ch for ch in line if not ch.isspace())


def read_cfg(path: str) -> list[Section]:
    """Parse a darknet cfg file into an ordered list of Sections."""
    sections: list[Section] = []
    with open(path, "r") as f:
        for lineno, raw in enumerate(f, start=1):
            line = _strip_all_whitespace(raw)
            if not line or line[0] in "#;":
                continue
            if line[0] == "[":
                if not line.endswith("]"):
                    raise ValueError(f"{path}:{lineno}: malformed section header {line!r}")
                sections.append(Section(type=line[1:-1], line=lineno))
            else:
                if "=" not in line:
                    raise ValueError(f"{path}:{lineno}: expected key=value, got {line!r}")
                if not sections:
                    raise ValueError(f"{path}:{lineno}: option before any section")
                key, _, val = line.partition("=")
                sections[-1].options[key] = val
    return sections
