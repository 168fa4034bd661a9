"""Spans and counters: where the System's time goes, inside its layers.

A :class:`Tracer` keeps one flat dict of numbers, ``totals``: each span's
seconds under its name, the number of times it was entered under ``"n_"``
and its name, and each counter under its own name. The names a tracer is
made with are there from the start, at zero. A span is a ``with`` block::

    with trace.span("track.iter"):
        ...

A name says where the span belongs: ``track.iter`` is a part of ``track``.
The top-level spans, :data:`LAYERS`, also own the waits: :func:`wait` runs
one blocking read of the device (``int()`` or ``bool()`` of a CUDA tensor,
``.cpu()``, ``torch.cuda.synchronize``) as the span ``<layer>.wait`` of the
innermost open layer, and leaves its seconds out of the spans open inside
that layer. So the parts of a layer never overlap, and they add up to at
most the layer; on the card a wait's length is how long the host sat until
the device reached that point.

With no profiler recording, a span costs two clock reads and two dict
updates, and ``torch.profiler.record_function`` is never entered. While a
``torch.profiler`` profile records, each span and wait also enters
``record_function(name)``, so it lands in the profile's trace beside the
kernels, on the profiler's clock.

A System makes its tracer current for each of its ``track_*`` calls
(:meth:`Tracer.current`); the functions of the modules below it record
into the current tracer through the module-level :func:`span`, :func:`wait`
and :func:`count`, which do nothing but run the read when no tracer is
current.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Callable, Iterable, Iterator, Optional, TypeVar

import torch

LAYERS = frozenset(("frame", "frontend", "track", "kf", "map"))

R = TypeVar("R")

_CURRENT: contextvars.ContextVar[Optional["Tracer"]] = contextvars.ContextVar(
    "gsorb_slam_tracer", default=None)
_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("tracer", "name", "args", "t0", "held", "rf", "seconds")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[str]):
        self.tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        self.held = 0.0  # seconds of waits inside, left out of this span
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name, self.args)
            self.rf.__enter__()
        self.tracer._open.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self.t0
        tr = self.tracer
        tr._open.pop()
        tot = tr.totals
        tot[self.name] = tot.get(self.name, 0.0) + self.seconds - self.held
        n = "n_" + self.name
        tot[n] = tot.get(n, 0) + 1
        if self.rf is not None:
            self.rf.__exit__(*exc)


class Tracer:
    """Span and counter totals of one System (or one standalone frontend)."""

    def __init__(self, spans: Iterable[str] = (), counters: Iterable[str] = ()):
        self.totals: dict[str, float] = {}
        for name in spans:
            self.totals[name] = 0.0
            self.totals["n_" + name] = 0
        for name in counters:
            self.totals[name] = 0
        self._open: list[_Span] = []

    def span(self, name: str, args: Optional[str] = None) -> _Span:
        """A ``with`` block timed under ``name``; ``args`` goes to the
        profiler's range."""
        return _Span(self, name, args)

    def wait(self, read: Callable[..., R], *args) -> R:
        """``read(*args)``, timed as ``<layer>.wait`` of the innermost open
        layer and left out of the spans open inside that layer."""
        opened = self._open
        i = len(opened) - 1
        while i >= 0 and opened[i].name not in LAYERS:
            i -= 1
        layer = opened[i].name if i >= 0 else "frame"
        with _Span(self, layer + ".wait", None) as w:
            out = read(*args)
        for s in opened[i + 1:]:
            s.held += w.seconds
        return out

    def count(self, name: str, n: int) -> None:
        self.totals[name] = self.totals.get(name, 0) + n

    def clear(self) -> None:
        """Every total back to zero."""
        for k, v in self.totals.items():
            self.totals[k] = type(v)(0)

    @contextlib.contextmanager
    def current(self) -> Iterator["Tracer"]:
        """Make this tracer the one the module-level functions record into."""
        token = _CURRENT.set(self)
        try:
            yield self
        finally:
            _CURRENT.reset(token)


def active() -> Optional[Tracer]:
    """The current tracer, or None."""
    return _CURRENT.get()


def span(name: str):
    """A span of the current tracer (a no-op block without one)."""
    tr = _CURRENT.get()
    return _NULL if tr is None else _Span(tr, name, None)


def wait(read: Callable[..., R], *args) -> R:
    """``read(*args)``, a wait of the current tracer if there is one."""
    tr = _CURRENT.get()
    return read(*args) if tr is None else tr.wait(read, *args)


def count(name: str, n: int) -> None:
    """Add ``n`` to the current tracer's counter ``name``."""
    tr = _CURRENT.get()
    if tr is not None:
        tr.count(name, n)
