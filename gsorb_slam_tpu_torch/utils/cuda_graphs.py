"""Loop iterations replayed as CUDA graphs, and the registry that keeps them.

Issued from Python, an iteration of the tracking or the mapping loop is
hundreds of small launches, which the host issues slower than the card runs
them. A :class:`Replay` holds an iteration as an ordered tuple of
zero-argument bodies on fixed device buffers. Until the capture, ``run(i)``
runs body ``i`` eagerly and returns its output; the first iteration's last
body then captures every body, in order, into graphs that share one memory
pool. From then on ``run(i)`` replays graph ``i`` and returns what body
``i`` returned under capture, which the replay rewrites.

A capture launches nothing, so the kernel launches it counted
(``_build.launches``) are taken back and added again at each replayed
iteration, with one ``<prefix>_replays``; each capture counts one
``<prefix>_captures`` (``utils/trace.py``).

:func:`kept` holds the newest graph per slot, e.g. ``("track", device,
use_features)`` or ``("map", device, init_mode)``, under a key of what the
owner's call observes.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from gsorb_slam_tpu_torch import _build
from gsorb_slam_tpu_torch.utils import trace

_GRAPHS: dict[tuple, tuple[tuple, Any]] = {}  # slot -> (key, graph)


def kept(slot: tuple, key: tuple, make: Callable[[], Any]) -> Any:
    """The graph kept for ``slot`` if it was made under ``key``; otherwise
    the slot's graph is dropped and ``make()``'s is kept in its place."""
    held = _GRAPHS.get(slot)
    if held is None or held[0] != key:
        _GRAPHS.pop(slot, None)
        held = _GRAPHS[slot] = (key, make())
    return held[1]


class Replay:
    """An iteration's bodies, run eagerly until the first iteration's last
    body, then replayed as one CUDA graph each."""

    def __init__(self, bodies: tuple[Callable[[], Any], ...], prefix: str):
        self._bodies = bodies
        self._prefix = prefix
        self._graphs: list[torch.cuda.CUDAGraph] = []
        self._outs: list = []
        self._launches: dict[str, int] = {}  # kernel launches per replayed iteration

    def run(self, i: int):
        """Body ``i`` of this iteration: replayed, or eager before the capture."""
        if not self._graphs:
            out = self._bodies[i]()
            if i == len(self._bodies) - 1:
                self._capture()
            return out
        if i == 0:
            for name, n in self._launches.items():
                _build.launches[name] += n
            trace.count(self._prefix + "_replays", 1)
        self._graphs[i].replay()
        return self._outs[i]

    def _capture(self) -> None:
        before = dict(_build.launches)
        graphs, outs, pool = [], [], None
        for body in self._bodies:
            graphs.append(torch.cuda.CUDAGraph())
            with torch.cuda.graph(graphs[-1], pool=pool):
                outs.append(body())
            pool = graphs[0].pool()
        self._launches = {k: v - before[k] for k, v in _build.launches.items() if v != before[k]}
        _build.launches.update(before)
        self._graphs, self._outs = graphs, outs
        trace.count(self._prefix + "_captures", 1)
