"""Launch counts of the kernels' wrappers, on the card and under a graph.

Each wrapper keeps a plain integer count of its launches on itself
(``binary_residual_block.launches``, ``bgemm.launches``,
``bgemm.splitk_launches``), so that a run can show which kernels its path
went through. Eagerly a wrapper adds one where it launches. While a CUDA
graph is captured nothing runs: the wrappers of the capturing thread write
into a ledger instead (``recording``), and whoever replays the graph adds
the ledger to the counts once per replay (``add``). The counts then hold
launches on the card, however the forward ran.
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["count", "recording", "add"]

_LOCAL = threading.local()


def count(wrapper, attr="launches"):
    """One launch of ``wrapper``'s kernel: ``wrapper.<attr>`` goes up by one,
    or, inside ``recording()`` in this thread, the ledger's entry does."""
    ledger = getattr(_LOCAL, "ledger", None)
    if ledger is None:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)
    else:
        ledger[wrapper, attr] = ledger.get((wrapper, attr), 0) + 1


@contextlib.contextmanager
def recording():
    """Inside the block this thread's launches are counted into the yielded
    ledger, ``{(wrapper, attr): launches}``, and not into the wrappers'
    counts. Other threads count as before."""
    saved = getattr(_LOCAL, "ledger", None)
    _LOCAL.ledger = ledger = {}
    try:
        yield ledger
    finally:
        _LOCAL.ledger = saved


def add(ledger, times=1):
    """Add ``times`` the ledger's launches to the wrappers' counts."""
    for (wrapper, attr), n in ledger.items():
        setattr(wrapper, attr, getattr(wrapper, attr) + n * times)
