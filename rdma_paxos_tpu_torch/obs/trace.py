"""Protocol trace ring — a bounded in-memory ring of typed protocol
events with monotonic timestamps, dumpable on failure or on demand.

Per-replica text logs (``utils/debug.py``, the ``debug.h`` analog) are
the greppable operator surface; this ring is the STRUCTURED one: every
protocol-level transition (election start/win, step batch sizes, commit
index advance, rebase applied/stalled, snapshot taken/installed,
membership change, proxy event enqueue / ack release) is recorded as a
typed event the harness can assert on and a failure handler can dump as
JSON. Bounded (deque ``maxlen``) so a hot loop can record freely — the
ring holds the most recent window, which is exactly what a post-mortem
wants.

Host-side only: nothing here may run inside jitted/``shard_map``ped
code (see ``tests/test_obs.py``).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import List, NamedTuple, Optional

# ---------------------------------------------------------------------------
# event kinds (typed protocol events)
# ---------------------------------------------------------------------------

ELECTION_START = "election_start"        # timeout fired / deliberate depose
ELECTION_WIN = "election_win"            # became_leader (the LEADER line)
STEP_BATCH = "step_batch"                # leader appended a batch
COMMIT_ADVANCE = "commit_advance"        # commit index moved
REBASE_APPLIED = "rebase_applied"        # coordinated i32 rollover ran
REBASE_STALLED = "rebase_stalled"        # end past threshold, delta pinned 0
SNAPSHOT_TAKEN = "snapshot_taken"        # donor snapshot captured
SNAPSHOT_INSTALLED = "snapshot_installed"  # snapshot installed into replica
CHECKPOINT_TAKEN = "checkpoint_taken"    # app-state checkpoint + compaction
MEMBERSHIP_CHANGE = "membership_change"  # CONFIG transit/stable/eviction
PROXY_ENQUEUE = "proxy_enqueue"          # shim event queued for consensus
PROXY_ACK_RELEASE = "proxy_ack_release"  # commit released blocked waiters
INFLIGHT_FAILED = "inflight_failed"      # waiters failed (-1)
STEP_DOWN = "step_down"                  # lost-majority step-down
QUIESCE_UNKNOWN = "quiesce_unknown"      # kernel-queue barrier unverifiable
GENERATION_CUT = "generation_cut"        # elastic world cut
GENERATION_BREAK = "generation_break"    # elastic world broken
STOP_FORCED = "stop_forced"              # stop() with a wedged poll thread
LOG_LINE = "log"                         # routed ReplicaLog event line
FAULT_INJECTED = "fault_injected"        # chaos nemesis fault applied
CRASH_RESTART = "crash_restart"          # chaos crash-restart recovery ran
NEMESIS_VIOLATION = "nemesis_violation"  # chaos invariant/linearize failure
AUDIT_DIVERGENCE = "audit_divergence"    # digest mismatch at (term, index)
AUDIT_DUMPED = "audit_dumped"            # audit artifact written
AUDIT_EPOCH_MISMATCH = "audit_epoch_mismatch"  # incomparable digest layout
REPLICA_QUARANTINED = "replica_quarantined"  # diverged minority isolated
REPAIR_DONOR_REJECTED = "repair_donor_rejected"  # donor failed digest verify
REPAIR_INSTALLED = "repair_installed"    # digest-verified snapshot re-install
REPAIR_BACKFILLED = "repair_backfilled"  # range re-digest restored coverage
REPAIR_READMITTED = "repair_readmitted"  # probation passed; serving again
REPAIR_ESCALATED = "repair_escalated"    # bounded retries exhausted (page)
ALERT_FIRED = "alert_fired"              # SLO alert rule started firing
ALERT_RESOLVED = "alert_resolved"        # SLO alert rule stopped firing
LEASE_GRANTED = "lease_granted"          # leader lease activated
LEASE_RENEWED = "lease_renewed"          # verified-quorum renewal (sampled)
LEASE_EXPIRED = "lease_expired"          # validity lapsed (no fresh quorum)
LEASE_REVOKED = "lease_revoked"          # deposed / quarantined / stepped down
GOVERNOR_TIER = "governor_tier"          # dispatch tier changed
GOVERNOR_SHED = "governor_shed"          # SLO burn pager dropped tier to serial
GOVERNOR_RESUME = "governor_resume"      # shed latch cleared (pager resolved)
IDLE_QUIESCE = "idle_quiesce"            # poll loop entered idle quiescence
TOPOLOGY_PROPOSED = "topology_proposed"  # policy proposed a split/merge
TOPOLOGY_SEEDED = "topology_seeded"      # migrating range copied to targets
TOPOLOGY_VERIFIED = "topology_verified"  # range digests matched pre-cutover
TOPOLOGY_FROZEN = "topology_frozen"      # migrating-range writes queued
TOPOLOGY_CUTOVER = "topology_cutover"    # router swapped, epoch bumped
TOPOLOGY_DONE = "topology_done"          # transition window closed
TOPOLOGY_ABANDONED = "topology_abandoned"  # window gave up (deadline)


class TraceEvent(NamedTuple):
    seq: int          # global monotone order within this ring
    ts: float         # time.monotonic() at record
    kind: str
    replica: int      # -1 when not replica-scoped
    fields: dict

    def as_dict(self) -> dict:
        # fields first so a field that collides with a header key
        # (seq/ts/kind/replica) can never shadow the header — the
        # header is the record's identity
        out = dict(self.fields)
        out.update(seq=self.seq, ts=self.ts, kind=self.kind,
                   replica=self.replica)
        return out


class TraceRing:
    """Bounded, ordered, thread-safe ring of :class:`TraceEvent`."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0

    def record(self, kind: str, replica: int = -1,
               **fields) -> TraceEvent:
        with self._lock:
            self._seq += 1
            ev = TraceEvent(self._seq, time.monotonic(), kind, replica,
                            fields)
            self._ring.append(ev)
        return ev

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def events(self, kind: Optional[str] = None,
               replica: Optional[int] = None) -> List[TraceEvent]:
        """Snapshot of retained events, oldest first, optionally
        filtered by kind and/or replica."""
        with self._lock:
            evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        if replica is not None:
            evs = [e for e in evs if e.replica == replica]
        return evs

    def dump(self) -> List[dict]:
        return [e.as_dict() for e in self.events()]

    def dump_json(self, reason: Optional[str] = None,
                  indent: Optional[int] = None) -> str:
        # every event ts is time.monotonic(); the stamped anchor pair
        # (obs.clock) lets readers project them onto the shared wall
        # timebase and align this dump with health/span exports
        from rdma_paxos_tpu_torch.obs.clock import anchor
        return json.dumps(dict(reason=reason, capacity=self.capacity,
                               anchor=anchor(), events=self.dump()),
                          indent=indent)

    def dump_on_failure(self, path: str, reason: str) -> str:
        """Persist the ring (atomic tmp + rename) for post-mortem —
        called from failure paths (poll-loop crash, wedged stop) and on
        demand. Returns ``path``."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.dump_json(reason=reason, indent=2))
        os.replace(tmp, path)
        return path

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


# process-global default — sink for module-level instrumentation with
# no driver instance in scope (snapshot.py, elastic.py, proxy quiesce)
_default = TraceRing()


def default_ring() -> TraceRing:
    return _default
