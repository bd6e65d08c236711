"""Health reporter — periodic per-replica health snapshots as JSON files.

The port's copy of the JAX package's ``obs/health.py`` (standard library only;
``tests/test_torch_alerts.py`` holds its documents equal to the
reference's with the wall-clock stamps removed).

The drivers build one small dict per replica each reporting period
(role, term, commit/apply indices, log headroom against the i32 rebase
ceiling, inflight waiter count, stable-store progress) and this module
writes each atomically (tmp + rename, never fsynced — loss only costs
one period) to ``<workdir>/replica<r>.health.json``, where an operator,
the bench harness, or a supervising process can poll them without
touching the driver. ``ClusterDriver.health()`` aggregates the same
dicts live.

Schema: every snapshot carries at least :data:`HEALTH_FIELDS`; extra
keys (store stats, rebase counters) ride along freely.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

# the required schema — tests and aggregators key off these
HEALTH_FIELDS = (
    "replica", "role", "term", "leader_id",
    "commit", "apply", "end", "head",
    "log_headroom",          # rebase_threshold - end (i32 ceiling margin)
    "inflight",              # blocked commit waiters
    "ts",                    # time.time() at snapshot
)

# the CLUSTER-level schema (``ClusterDriver.health()`` /
# ``ShardedClusterDriver.health()``): every field the subsystems
# emit — alert firing state, audit summary + artifact
# path, repair pipeline status, lease/read-path status. Values may be
# None (e.g. ``audit`` on an unaudited cluster) but the KEYS must be
# present, so aggregators (the fleet console, the bundle assembler)
# never have to feature-probe a health document.
CLUSTER_HEALTH_FIELDS = (
    "n_replicas", "replicas",
    "alerts",                # AlertEngine.state() (since/duration_s)
    "audit",                 # AuditLedger.summary() or None
    "audit_artifact",        # last dumped artifact path or None
    "repair",                # RepairController.status() or None
    "leases",                # LeaseManager.status() or None
    "reads",                 # ReadHub.status() or None
    "streams",               # StreamHub.status() or None
    "txn",                   # TxnCoordinator.health() or None
    "blame",                 # tracectx.health_blame() or None
    "ts",
)


def validate(snap: dict) -> List[str]:
    """-> the list of required fields missing from ``snap`` (empty when
    the snapshot conforms)."""
    return [f for f in HEALTH_FIELDS if f not in snap]


def validate_cluster(snap: dict) -> List[str]:
    """Cluster-health schema check: the :data:`CLUSTER_HEALTH_FIELDS`
    keys plus a leader view — ``leader`` (single-group) or
    ``leaders`` (one per group, sharded). Returns the missing field
    names (empty when the document conforms)."""
    missing = [f for f in CLUSTER_HEALTH_FIELDS if f not in snap]
    if "leader" not in snap and "leaders" not in snap:
        missing.append("leader|leaders")
    return missing


def make_cluster_snapshot(**fields) -> dict:
    """Stamp cluster-level health ``fields`` with the same
    schema/clock headers :func:`make_snapshot` gives per-replica
    snapshots (wall + monotonic + the shared anchor pair), so a saved
    ``health()`` document merges onto the fleet timebase like every
    other dump."""
    from rdma_paxos_tpu_torch.obs.clock import anchor
    snap = dict(schema=2, ts=time.time(),
                ts_monotonic=time.monotonic(), anchor=anchor())
    snap.update(fields)
    return snap


def make_snapshot(**fields) -> dict:
    """Stamp ``fields`` into a schema-versioned snapshot dict. Carries
    both clocks — ``ts`` (wall, operator-meaningful) and
    ``ts_monotonic`` (ordering-safe) — plus the process's shared
    ``(monotonic, wall)`` anchor pair (obs.clock), so health files
    align on the same timebase as trace-ring and span dumps."""
    from rdma_paxos_tpu_torch.obs.clock import anchor
    snap = dict(schema=1, ts=time.time(), ts_monotonic=time.monotonic(),
                anchor=anchor())
    snap.update(fields)
    return snap


class HealthReporter:
    """Cadenced atomic per-replica JSON writer + reader."""

    def __init__(self, workdir: str, period: float = 0.5,
                 clock=time.monotonic):
        self.workdir = workdir
        self.period = period
        self._clock = clock
        self._last = float("-inf")

    def path(self, replica: int) -> str:
        return os.path.join(self.workdir, f"replica{replica}.health.json")

    def due(self) -> bool:
        return self._clock() - self._last >= self.period

    def write(self, snaps: Dict[int, dict]) -> None:
        """Write every replica's snapshot atomically and reset the
        cadence clock. Atomic against process death (tmp + rename); NOT
        fsynced — a power loss costs at most one period's snapshot,
        which the next period rewrites."""
        for r, snap in snaps.items():
            path = self.path(r)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(snap, f, indent=2)
            os.replace(tmp, path)
        self._last = self._clock()

    def maybe_write(self, snaps: Dict[int, dict]) -> bool:
        """Cadenced write; returns True if a write happened."""
        if not self.due():
            return False
        self.write(snaps)
        return True

    def cluster_path(self) -> str:
        return os.path.join(self.workdir, "cluster.health.json")

    def write_cluster(self, doc: dict) -> None:
        """Atomic write of the CLUSTER-level health document
        (``make_cluster_snapshot`` shape) next to the per-replica
        files — the file-based fleet console and the postmortem
        bundle's alert-state source read it."""
        path = self.cluster_path()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2)
        os.replace(tmp, path)

    def read(self, replica: int) -> Optional[dict]:
        try:
            with open(self.path(replica)) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def read_all(self, n_replicas: int) -> List[Optional[dict]]:
        return [self.read(r) for r in range(n_replicas)]
