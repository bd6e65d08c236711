"""Static configuration of the PyTorch/CUDA consensus core.

The port's own copy of the log geometry, the protocol constants the
replicated write path needs and the driver's timing block (the JAX
package's ``config.py`` is the
reference; ``tests/test_torch_hygiene.py`` pins every copied constant
against it). The reference splits configuration across the libconfig
``nodes.local.cfg`` timing block, env vars and compile-time constants
(``LOG_SIZE`` ``dare_log.h:76``, ``MAX_SERVER_COUNT`` ``dare.h:26``).

Also home of :func:`resolve_device`, the one rule every entry point of
the port uses to pick its device: the card unless the caller names the
CPU, and an error (never a silent fallback) when there is no card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

# Deepest fused burst any driver dispatches; the rebase-headroom check
# below accounts for it.
MAX_BURST_K = 8

# Consecutive post-threshold steps with the rebase delta pinned at 0
# before the stall is surfaced.
REBASE_STALL_STEPS = 25

MAX_SERVER_COUNT = 13   # reference src/include/dare/dare.h:26

# Layout version of the audit digest fold (``consensus/step.py:
# digest_fold``: which columns are folded, in what order, with what
# mixer). Digests from different layouts are incomparable, not unequal:
# the audit ledger stamps it into every window, dump and snapshot and
# refuses cross-epoch comparison. Bump on any change to the fold.
DIGEST_EPOCH = 1


@dataclasses.dataclass(frozen=True)
class LogConfig:
    """Geometry of the on-device replicated log: a slot ring of
    ``n_slots`` fixed-size slots addressed by a global monotone int32
    entry index (slot of ``g`` is ``g % n_slots``). ``window_slots``
    entries move leader->followers per step, ``batch_slots`` client
    entries are appended per step. When any end offset crosses
    ``rebase_threshold`` the runtime renumbers every offset down by the
    minimum head (the coordinated i32 rollover)."""

    n_slots: int = 1024
    slot_bytes: int = 512
    window_slots: int = 128
    batch_slots: int = 64
    rebase_threshold: int = 1 << 30

    def __post_init__(self) -> None:
        if self.n_slots & (self.n_slots - 1):
            raise ValueError("n_slots must be a power of two")
        if self.slot_bytes % 4:
            raise ValueError("slot_bytes must be a multiple of 4")
        if self.window_slots > self.n_slots:
            raise ValueError("window_slots must be <= n_slots")
        if self.batch_slots > self.window_slots:
            raise ValueError("batch_slots must be <= window_slots")
        if self.rebase_threshold <= self.n_slots:
            raise ValueError("rebase_threshold must exceed n_slots")
        # a fused burst can advance end by up to MAX_BURST_K batches
        # past the threshold before the rollover lands
        headroom = (MAX_BURST_K + 2) * self.n_slots
        if self.rebase_threshold > (1 << 31) - 1 - headroom:
            raise ValueError(
                "rebase_threshold too close to the i32 ceiling; leave "
                f">= (MAX_BURST_K+2)*n_slots = {headroom} of headroom "
                "(fused bursts can advance end by up to "
                "MAX_BURST_K*batch_slots past the threshold before the "
                "rollover lands)")

    @property
    def slot_words(self) -> int:
        return self.slot_bytes // 4


@dataclasses.dataclass(frozen=True)
class TimeoutConfig:
    """Timing block — mirrors the ``dare_global_config`` section of
    ``nodes.local.cfg`` (reference ``target/nodes.local.cfg:22-35``).

    Values are seconds. The defaults mirror the reference's DEBUG profile
    (hb 10 ms, election 100–300 ms); the production profile in the
    reference is hb 1 ms, election 10–30 ms.
    """

    hb_period: float = 0.010
    elec_timeout_low: float = 0.100
    elec_timeout_high: float = 0.300
    retransmit_period: float = 0.040
    rc_info_period: float = 0.050      # membership/bootstrap gossip period
    log_pruning_period: float = 0.050

    @classmethod
    def production(cls) -> "TimeoutConfig":
        return cls(hb_period=0.001, elec_timeout_low=0.010,
                   elec_timeout_high=0.030)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: the card when ``device`` is
    None, else exactly what the caller named. Raises when the card is
    asked for (explicitly or by default) and none is present — the port
    never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return dev
