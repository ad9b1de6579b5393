"""Launch counts of the kernels' wrappers, on the card and under a graph.

Each wrapper keeps a plain integer count of its launches on itself
(``binary_residual_block.launches``, ``bgemm.launches``,
``bgemm.splitk_launches``; the model builder's channel concatenation,
``models.builder.concat.launches``), so that a run can show which kernels
its path went through. Eagerly a wrapper adds one where it launches. While
a CUDA graph is captured nothing runs: the wrappers of the capturing thread
write into a ledger instead (``recording``), and whoever replays the graph
adds the ledger to the counts once per replay (``add``). The counts then hold
launches on the card, however the forward ran. A ledger that records a
capture refuses a launch on a stream that is not capturing (one on another
card than the capture's, say): that launch would run once, now, and no
replay would repeat it.
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["count", "recording", "add"]

_LOCAL = threading.local()


def count(wrapper, attr="launches"):
    """One launch of ``wrapper``'s kernel, counted with the launch's card
    current: ``wrapper.<attr>`` goes up by one, or, inside ``recording()``
    in this thread, the ledger's entry does. Inside ``recording(capture=
    True)`` a launch on a stream that is not capturing raises."""
    ledger = getattr(_LOCAL, "ledger", None)
    if ledger is None:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)
        return
    if _LOCAL.capture and not torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{getattr(wrapper, '__name__', wrapper)} launched on a stream "
            "that is not capturing while a capture records its launches: "
            "no replay would repeat it")
    ledger[wrapper, attr] = ledger.get((wrapper, attr), 0) + 1


@contextlib.contextmanager
def recording(capture=False):
    """Inside the block this thread's launches are counted into the yielded
    ledger, ``{(wrapper, attr): launches}``, and not into the wrappers'
    counts. Other threads count as before. With ``capture`` the block
    captures a graph, and every launch in it must be captured too."""
    saved = (getattr(_LOCAL, "ledger", None),
             getattr(_LOCAL, "capture", False))
    ledger = {}
    _LOCAL.ledger, _LOCAL.capture = ledger, capture
    try:
        yield ledger
    finally:
        _LOCAL.ledger, _LOCAL.capture = saved


def add(ledger, times=1):
    """Add ``times`` the ledger's launches to the wrappers' counts."""
    for (wrapper, attr), n in ledger.items():
        setattr(wrapper, attr, getattr(wrapper, attr) + n * times)
