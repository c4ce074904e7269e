"""The port's spans: the engine's request path, recorded while the request's
caller runs under ``torch.profiler``.

``Engine._call`` asks ``torch.autograd._profiler_enabled()`` once a
request, on the caller's thread (the profiler's switch is thread-local);
with no profiler running nothing else happens. With one, the request gets a
``Request``, which travels with its job to the engine's watchdog worker:
every span of the request carries the request's id, whichever thread
records it. A span's start and end are ``time.time_ns()``, the clock of the
profiler's own events (kineto's ``start_ns``/``end_ns``), so the spans lie
on the device trace's timeline with no conversion.

Spans are kept in memory, the newest ``LIMIT`` of them (older ones are
dropped); ``spans()`` reads them and ``clear()`` empties the buffer.
Nothing is written anywhere. An operator reads a profiled stretch so::

    with torch.profiler.profile(activities=[...]):
        engine.predict_batch_raw_frames(frames)
    for s in trace.spans():
        print(s.name, s.request, (s.end_ns - s.start_ns) / 1e6, s.attrs)
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from types import MappingProxyType
from typing import Mapping, NamedTuple

# the spans kept: a camera request records 7, so about 9,000 requests (the
# benchmark's traced stretches hold about 300)
LIMIT = 65536

_buffer: collections.deque = collections.deque(maxlen=LIMIT)
_lock = threading.Lock()
_ids = itertools.count(1)


class Span(NamedTuple):
    name: str
    start_ns: int          # time.time_ns(), the profiler's clock
    end_ns: int
    request: int           # the request's id: its root span's id
    parent: int | None     # the parent span's id; None for the root
    thread: int            # threading.get_ident() of the recording thread
    id: int
    attrs: Mapping = MappingProxyType({})   # the root's counts


def spans() -> list[Span]:
    """The spans recorded and kept, oldest first; each one once it ended."""
    with _lock:
        return list(_buffer)


def clear() -> None:
    """Forget every span recorded."""
    with _lock:
        _buffer.clear()


def _keep(span: Span) -> None:
    with _lock:
        _buffer.append(span)


class Request:
    """One traced request: its root span (``engine.request``, recorded when
    the request ends, with ``attrs``), and the spans its threads record
    under it. A span that starts on one thread and ends on another (the
    hand-off to the worker and back) is opened with ``open`` and recorded
    by ``close`` on the thread that closes it."""

    def __init__(self, name: str, **attrs):
        self.name = name
        self.id = next(_ids)
        self.attrs = attrs
        self.thread = threading.get_ident()
        self.start_ns = time.time_ns()
        self.ended = False
        self._open: dict[str, int] = {}

    def _record(self, name: str, start_ns: int) -> None:
        if not self.ended:   # a call abandoned by the watchdog ends later
            _keep(Span(name, start_ns, time.time_ns(), self.id, self.id,
                       threading.get_ident(), next(_ids)))

    def span(self, name: str) -> "_Block":
        """A span of this thread around a ``with`` block, recorded even if
        the block raises."""
        return _Block(self, name)

    def open(self, name: str) -> None:
        """Start span ``name`` here; ``close`` ends it, on any thread. A
        span of the name still open (a call the watchdog abandoned before
        its worker started it) ends now."""
        if name in self._open:
            self.close(name)
        self._open[name] = time.time_ns()

    def close(self, name: str) -> None:
        """End span ``name``, opened by ``open``, on this thread."""
        start = self._open.pop(name, None)
        if start is not None:
            self._record(name, start)

    def end(self) -> None:
        """Record the root span, closing first every span still open."""
        for name in list(self._open):
            self.close(name)
        _keep(Span(self.name, self.start_ns, time.time_ns(), self.id, None,
                   self.thread, self.id, dict(self.attrs)))
        self.ended = True


class _Block:
    __slots__ = ("req", "name", "start")

    def __init__(self, req: Request, name: str):
        self.req, self.name = req, name

    def __enter__(self) -> None:
        self.start = time.time_ns()

    def __exit__(self, *exc) -> None:
        self.req._record(self.name, self.start)


@contextlib.contextmanager
def request(name: str, **attrs):
    """A traced request around the block: -> its ``Request``; its root span
    is recorded when the block ends, raising or not."""
    req = Request(name, **attrs)
    try:
        yield req
    finally:
        req.end()
