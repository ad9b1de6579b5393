"""Small statistics shared by the traffic kinds."""

from __future__ import annotations

import math
import random

__all__ = ["percentile", "Reservoir"]


def percentile(values, q):
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of ``values``:
    the smallest value with at least q% of the values at or below it.
    Failed requests enter as ``inf`` and rank above every other."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no values")
    rank = max(1, math.ceil(q / 100 * len(ordered)))
    return ordered[rank - 1]


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length, drawn
    from ``seed`` (Algorithm R): every item offered has the same chance to
    be kept, wherever the window ends."""

    def __init__(self, k, seed):
        self.k = k
        self.items = []
        self.seen = 0
        self._rng = random.Random(seed)

    def offer(self, item_fn):
        """Offers the next item; ``item_fn()`` makes it, called only when
        it is kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item_fn())
            return
        j = self._rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = item_fn()
