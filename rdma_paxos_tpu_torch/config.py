"""Static configuration of the PyTorch/CUDA consensus core.

The port's own copy of the log geometry, the protocol constants the
replicated write path needs and the driver's timing block (the JAX
package's ``config.py`` is the
reference; ``tests/test_torch_hygiene.py`` pins every copied constant
against it). The reference splits configuration across the libconfig
``nodes.local.cfg`` timing block, env vars and compile-time constants
(``LOG_SIZE`` ``dare_log.h:76``, ``MAX_SERVER_COUNT`` ``dare.h:26``).

The cluster identity block (:class:`ClusterConfig`, with
:meth:`ClusterConfig.from_env` reading the reference's launch env vars)
and :func:`load_config`, the JSON config-file loader, are the port's
copies of the JAX package's (``config.py:150-237``).

Also home of :func:`resolve_device`, the one rule every entry point of
the port uses to pick its device: the card unless the caller names the
CPU, and an error (never a silent fallback) when there is no card.
"""

from __future__ import annotations

import dataclasses
import json
import os
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


# ---------------------------------------------------------------------------
# Cluster identity / membership
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Per-instance identity and group shape.

    The reference passes these through env vars (``server_idx``,
    ``group_size``, ``server_type``, ``config_path``, ``dare_log_file``,
    ``mgid`` — ``src/proxy/proxy.c:33-59``); :meth:`from_env` accepts the
    same names so drivers written against the reference's launch
    convention (``benchmarks/run.sh:24-33``) keep working.
    """

    server_idx: int = 0
    group_size: int = 3
    server_type: str = "start"          # "start" | "join"
    config_path: Optional[str] = None
    log_file: Optional[str] = None
    # bootstrap: "host:port" of every replica's control endpoint (the
    # analog of the IB multicast group, dare_ibv_ud.h:25)
    peers: tuple = ()

    def __post_init__(self) -> None:
        if not (1 <= self.group_size <= MAX_SERVER_COUNT):
            raise ValueError(
                f"group_size must be in [1, {MAX_SERVER_COUNT}]")
        if self.server_type not in ("start", "join"):
            raise ValueError("server_type must be 'start' or 'join'")

    @classmethod
    def from_env(cls, env: Optional[dict] = None) -> "ClusterConfig":
        e = os.environ if env is None else env
        return cls(
            server_idx=int(e.get("server_idx", 0)),
            group_size=int(e.get("group_size", 3)),
            server_type=e.get("server_type", "start"),
            config_path=e.get("config_path"),
            log_file=e.get("dare_log_file"),
            peers=tuple(p for p in e.get("peers", "").split(",") if p),
        )

    @property
    def majority(self) -> int:
        return self.group_size // 2 + 1


def load_config(path: str, env: Optional[dict] = None):
    """Load a cluster config file — the analog of ``dare_read_config`` +
    ``proxy_read_config`` over ``nodes.local.cfg`` (reference
    ``src/config-comp/``), in JSON::

        {
          "log":     {"n_slots": 16384, "slot_bytes": 256, ...},
          "timing":  {"hb_period": 0.001, "elec_timeout_low": 0.01, ...},
          "cluster": {"group_size": 3, "peers": ["h0:9000", ...], ...}
        }

    Per-instance identity still comes from env vars (``server_idx``
    etc.), exactly like the reference. Returns ``(LogConfig,
    TimeoutConfig, ClusterConfig)``."""
    with open(path) as f:
        raw = json.load(f)
    log_cfg = LogConfig(**raw.get("log", {}))
    timing = TimeoutConfig(**raw.get("timing", {}))
    cluster_raw = dict(raw.get("cluster", {}))
    if "peers" in cluster_raw:
        cluster_raw["peers"] = tuple(cluster_raw["peers"])
    e = os.environ if env is None else env
    if "server_idx" in e:
        cluster_raw["server_idx"] = int(e["server_idx"])
    if "group_size" in e:
        cluster_raw["group_size"] = int(e["group_size"])
    if "server_type" in e:
        cluster_raw["server_type"] = e["server_type"]
    if "dare_log_file" in e:
        cluster_raw["log_file"] = e["dare_log_file"]
    cluster_raw["config_path"] = path
    return log_cfg, timing, ClusterConfig(**cluster_raw)


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
