"""Round-robin resource rotation.

A copy of ``dlaf_tpu/common/round_robin.py`` (reference
``common/round_robin.h:10-35``): a fixed pool of resources handed out in
turn, so that a microbenchmark's timed runs rotate between independent
input sets instead of re-reading the buffers the previous run just
touched.
"""

from __future__ import annotations

from typing import Generic, Iterable, Sequence, TypeVar

T = TypeVar("T")

__all__ = ["RoundRobin"]


class RoundRobin(Generic[T]):
    """Cycle through a fixed pool of resources.

    ``next_resource()`` returns pool items in order, wrapping around
    (reference ``RoundRobin::nextResource``); ``current_resource()``
    re-reads the last item handed out without advancing (reference
    ``currentResource``).
    """

    def __init__(self, items: Iterable[T]):
        self._items: Sequence[T] = tuple(items)
        if not self._items:
            raise ValueError("RoundRobin needs at least one resource")
        self._index = len(self._items) - 1  # first next_resource() -> items[0]

    def next_resource(self) -> T:
        self._index = (self._index + 1) % len(self._items)
        return self._items[self._index]

    def current_resource(self) -> T:
        return self._items[self._index]

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        """Iterate the pool once in storage order (does not advance the
        rotation)."""
        return iter(self._items)
