"""Injectable clock for deterministic tests.

Python analog of the reference's ``ITimeProvider``
(ref: src/Pyrope.GarnetServer/Services/TimeProvider.cs:5-17) — every
time-dependent component (cache TTLs, quota windows, write-heat tracking,
billing intervals) takes a ``Clock`` so tests can step time manually.
"""

from __future__ import annotations

import time


class Clock:
    """Real wall clock (seconds since epoch, float)."""

    def now(self) -> float:
        return time.time()

    def monotonic(self) -> float:
        return time.monotonic()


class ManualClock(Clock):
    """Test clock advanced explicitly."""

    def __init__(self, start: float = 1_000_000.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def monotonic(self) -> float:
        return self._t

    def advance(self, seconds: float) -> None:
        self._t += seconds

    def set(self, t: float) -> None:
        self._t = float(t)


SYSTEM_CLOCK = Clock()
