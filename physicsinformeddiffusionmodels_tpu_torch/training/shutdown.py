"""Graceful-shutdown hook for long training runs (port of
``training/shutdown.py``).

``install_graceful_stop()`` turns SIGTERM/SIGINT into a flag the training
loop polls each iteration, so the loop saves a final checkpoint before it
exits instead of dying mid-step. A second signal falls back to the previous
(hard) behaviour, so a stuck save can still be interrupted.
"""

from __future__ import annotations

import signal
from typing import Callable


def install_graceful_stop(
    signals: tuple[int, ...] = (signal.SIGTERM, signal.SIGINT),
) -> Callable[[], bool]:
    """Install one-shot handlers; returns ``should_stop()``.

    The first delivery of any of ``signals`` sets the flag and restores the
    previous handlers of all of them, so a second signal of any kind
    terminates normally.
    """
    state = {"stop": False}
    previous = {}

    def handler(signum, frame):
        state["stop"] = True
        for s, prev in previous.items():
            # signal.signal() returns None for a handler installed outside
            # Python; passing that back would raise, so use the default
            signal.signal(s, prev if prev is not None else signal.SIG_DFL)
        print(
            f"signal {signal.Signals(signum).name}: finishing current step, "
            "saving checkpoint, then exiting (send again to force)",
            flush=True,
        )

    for s in signals:
        previous[s] = signal.signal(s, handler)

    return lambda: state["stop"]
