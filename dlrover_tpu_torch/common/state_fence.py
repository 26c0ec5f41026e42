"""Reads of the train state that the next in-place write must wait for.

The trainer updates params and moments in place, where the reference's
jax arrays are immutable. A reader that still needs the current values
after it returns (the checkpoint engine's device-to-host snapshot, which
its drain thread streams out while the next step runs) registers a waiter
here; the trainer calls :func:`wait_readers` right before it writes the
state, so the forward and backward of the next step, which only read it,
overlap the copies and the optimizer does not.
"""

import threading
from typing import Callable, List

_lock = threading.Lock()
_waiters: List[Callable[[], None]] = []


def add_reader(wait: Callable[[], None]) -> None:
    """Register ``wait``: a call that returns once the reader is done."""
    with _lock:
        _waiters.append(wait)


def wait_readers() -> None:
    """Wait for (and forget) every registered reader."""
    with _lock:
        waiters = list(_waiters)
        _waiters.clear()
    for wait in waiters:
        wait()
