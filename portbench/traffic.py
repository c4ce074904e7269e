"""The one traffic generator. A mix is a data file,
``portbench/traffic/<name>.json``, that it reads:

- ``entry``: the engine call each request makes (``predict_batch_detections``
  takes frames at the network's size, ``predict_batch_raw_frames`` raw
  frames that the engine letterboxes on the device);
- ``frame``: ``"net"``, or ``[height, width]`` of raw frames;
- ``batch``: frames a request carries; ``pool_frames``: the seeded frames
  made in set-up, cut into ``pool_frames / batch`` batches that the requests
  draw in a seeded order;
- ``loop``: the arrival process, ``portbench/loops/<loop>.py`` (``closed``:
  one client, each request sent once the one before it has returned;
  ``open``: seeded Poisson arrivals), found by name; the loop's own
  parameters (such as ``rate_per_s``) are further keys of the mix;
- ``cpus``: the host CPUs the run's process may use (the last ones it is
  allowed), or null for all of them;
- ``warmup_requests``: calls made in set-up after the first, which captures
  the cell's graph;
- ``trace_after_s``, ``trace_s``: where in the window a ``--trace 1`` run
  profiles, and for how long.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent
COMMON = ("entry", "frame", "batch", "pool_frames", "loop", "cpus",
          "warmup_requests", "trace_after_s", "trace_s")


@dataclass(frozen=True)
class Traffic:
    name: str
    entry: str
    frame: tuple[int, int] | None     # raw (height, width); None: the net's
    batch: int
    pool_frames: int
    loop: str
    cpus: int | None
    warmup_requests: int
    trace_after_s: float
    trace_s: float
    params: dict = field(default_factory=dict)   # the loop's own keys

    @property
    def raw(self) -> bool:
        """Whether requests carry raw frames, letterboxed by the system."""
        return self.frame is not None

    @property
    def choices(self) -> int:
        return self.pool_frames // self.batch

    def pool_shape(self, net_h: int, net_w: int) -> tuple[int, int, int, int]:
        h, w = self.frame or (net_h, net_w)
        return (self.choices * self.batch, h, w, 3)

    def request(self, pool, choice: int):
        """The frames of a request drawing pool batch ``choice``: a view."""
        return pool[choice * self.batch:(choice + 1) * self.batch]


def load(name: str, root: Path = ROOT) -> Traffic:
    """The mix ``traffic/<name>.json``."""
    d = json.loads((root / "traffic" / f"{name}.json").read_text())
    missing = [k for k in COMMON if k not in d]
    if missing:
        raise ValueError(f"traffic {name}: no {', '.join(missing)}")
    frame = None if d["frame"] == "net" else tuple(d["frame"])
    cpus = None if d["cpus"] is None else int(d["cpus"])
    return Traffic(name, d["entry"], frame, int(d["batch"]),
                   int(d["pool_frames"]), d["loop"], cpus,
                   int(d["warmup_requests"]), float(d["trace_after_s"]),
                   float(d["trace_s"]),
                   {k: v for k, v in d.items() if k not in COMMON})
