"""Failure-detection timers — host control plane.

The reference detects leader failure by followers checking a heartbeat SID
slot on a timer (``hb_receive_cb``, ``dare_server.c:822-922``) with an
**adaptive** election timeout that grows when it observes false positives
(``to_adjust_cb`` ``:763-817``: the timeout is raised until the false-
positive rate over recent trials is negligible). Randomization within
[low, high] desynchronizes simultaneous candidacies (classic Raft; the
reference draws random election timeouts the same way).
"""

from __future__ import annotations

import random
import time
from typing import Optional

from rdma_paxos_tpu_torch.config import TimeoutConfig


class ElectionTimer:
    """Per-replica election timer with adaptive widening.

    ``beat()`` on every observed heartbeat; ``expired()`` polls; a timeout
    that turns out to be a false positive (the leader was alive — we saw
    its heartbeat again within the old term) should be reported via
    ``false_positive()``, which widens the low bound multiplicatively,
    mirroring the reference's grow-until-quiet adjustment."""

    def __init__(self, cfg: TimeoutConfig, seed: Optional[int] = None,
                 clock=time.monotonic):
        self.cfg = cfg
        self.low = cfg.elec_timeout_low
        self.high = cfg.elec_timeout_high
        self._rng = random.Random(seed)
        self._clock = clock
        self._deadline = 0.0
        self.beat()

    def _draw(self) -> float:
        return self._rng.uniform(self.low, self.high)

    def beat(self) -> None:
        self._deadline = self._clock() + self._draw()

    def expired(self) -> bool:
        return self._clock() >= self._deadline

    def remaining(self) -> float:
        """Seconds until this timer would fire (0.0 when already
        expired) — the idle-quiescence margin: a parked poll loop must
        wake and heartbeat well before any follower timer fires."""
        return max(0.0, self._deadline - self._clock())

    def false_positive(self) -> None:
        self.low = min(self.low * 1.5, self.high)
        self.beat()


class GroupStepTimer:
    """Per-group jittered election timer in the STEP domain — the
    production sharded driver's replacement for wall-clock
    ``ElectionTimer`` choreography (and for explicit ``place_leaders``
    timeout scripting).

    The driver polls in logical steps, so the timer counts polling
    iterations, not seconds: a leaderless group fires after a jittered
    ``[lo, hi]`` step period, re-drawn after every firing (randomized-
    timeout desynchronization, the :class:`ElectionTimer` analog with
    steps for seconds — the same domain as the chaos harness's
    ``StepTimerModel``). Seeding is per ``(seed, group)`` through the
    string-seeded RNG (sha512, PYTHONHASHSEED-independent), so a chaos
    replay that replays the same step sequence redraws the identical
    periods — election timing is bit-reproducible where a wall-clock
    timer would race the scheduler."""

    def __init__(self, group: int, seed: int = 0, lo: int = 6,
                 hi: int = 12):
        if not 1 <= lo <= hi:
            raise ValueError(f"need 1 <= lo <= hi, got [{lo}, {hi}]")
        self.group = int(group)
        self.lo, self.hi = int(lo), int(hi)
        self._rng = random.Random(f"group-timer:{seed}:{group}")
        self._since = 0
        self._period = self._rng.randint(self.lo, self.hi)

    def beat(self) -> None:
        """A heartbeat (the group is led) — reset the countdown."""
        self._since = 0

    def tick(self) -> bool:
        """Advance one polling step; True when the timer fires (and
        the next period is re-jittered)."""
        self._since += 1
        if self._since >= self._period:
            self._since = 0
            self._period = self._rng.randint(self.lo, self.hi)
            return True
        return False


class Pacer:
    """Fixed-period pacing for the host polling loop (the libev timer
    cadence: hb_period for leaders doubles as the step cadence here,
    since every step carries the heartbeat)."""

    def __init__(self, period: float, clock=time.monotonic,
                 sleep=time.sleep):
        self.period = period
        self._clock = clock
        self._sleep = sleep
        self._next = clock()

    def wait(self) -> None:
        now = self._clock()
        if now < self._next:
            self._sleep(self._next - now)
        self._next = max(self._next + self.period, now)
