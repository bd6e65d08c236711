"""Read scaling — leader leases and read-index follower reads.

The port's copy of the JAX package's ``runtime/reads.py`` (numpy and
the standard library only; ``tests/test_torch_reads.py`` holds it to
the reference). A linearizable GET need not ride the replicated log:
this module serves reads as a HOST-SIDE subsystem with zero device
changes — the replica step is the same with it attached.

**Leader leases** (:class:`LeaseManager`) — step-domain leases
piggybacked on the quorum machinery the protocol already runs: every
finished step whose outputs show a leader with
``leadership_verified`` (a majority acked its window — the heartbeat
round) RENEWS that leader's lease for its group. A leaseholder serves
linearizable reads from its local applied state with zero log
traffic. Safety is conservative under the timeout skew the chaos
nemesis injects:

* validity is ``now - last_verified < lease_steps`` in FINISHED-step
  time, with ``now`` taken as ``max(step_index, dispatch_clock)`` so
  in-flight pipelined dispatches age the lease, never extend it;
* ``lease_steps`` defaults to 2: even a maximally skew-accelerated
  rival (an election timer firing ONE step after the holder's last
  verified quorum) needs one step to win votes and one more to commit
  — so the usurper's first committed write always lands STRICTLY
  after the deposed holder's last possible lease serve;
* a new leader must wait out the old lease before its own activates
  (``barrier`` = old ``last_verified + lease_steps + guard_steps``);
  until then it serves reads only through the read-index path;
* deposition, ``need_recovery``, repair quarantine, and step-down all
  revoke immediately (the step-count expiry is the load-bearing
  guard; revocation is hygiene that also feeds the trace timeline).

**Read-index follower reads** (:class:`ReadHub`) — a queued read at
replica ``f`` confirms the leader's commit index ONCE (from a
finished step where the leader verified leadership), waits for ``f``'s
local apply frontier to reach it, then serves from ``f``'s state —
fanning read load across all R replicas. The hub's queue is drained
at the tail of the engines' ``finish()``, which under the pipelined
drivers runs on the READBACK thread — reads interleave between
pipelined tickets and never enter ``begin_*``, never consume ring
slots, never perturb the replica step.

Served reads export ``reads_served_total{path=lease|read_index|log,
replica=,group=}`` counters, a ``read_latency_us`` histogram, and a
cheap read-span variant on the span recorder; lease transitions
(grant / renew / expire / revoke) ride the protocol trace ring.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from rdma_paxos_tpu_torch.consensus.state import Role
from rdma_paxos_tpu_torch.obs import trace as obs_trace
from rdma_paxos_tpu_torch.obs.metrics import LATENCY_BUCKETS_US

_LEADER = int(Role.LEADER)


def leader_claim(role_row, term_row, n: int) -> Tuple[int, int]:
    """Highest-term self-claimed leader of one group's result rows —
    the drivers' failover view rule (terms are unique per leader by
    quorum election, so max-term picks the real one). Returns
    ``(leader, term)``, ``(-1, 0)`` when nobody claims. The ONE copy
    this module uses for both lease observation and hub confirmation."""
    best_r, best_t = -1, 0
    for r in range(n):
        if int(role_row[r]) == _LEADER:
            t = int(term_row[r])
            if best_r < 0 or t > best_t:
                best_r, best_t = r, t
    return best_r, best_t

# served-path labels (the reads_served_total{path=} vocabulary)
PATH_LEASE = "lease"
PATH_READ_INDEX = "read_index"
PATH_LOG = "log"


def count_read(obs, path: str, replica: int, *,
               group: Optional[int] = None, t0: Optional[float] = None,
               n: int = 1) -> None:
    """Export one (or ``n``) served reads: the per-path counter, the
    latency histogram (when the caller timed it from ``t0``,
    ``time.monotonic``), and the cheap read-span variant. The ONE
    accounting rule every serving site (KVS sync reads, the hub, the
    bench's log-path baseline) shares, so the ``path=`` series always
    add up to the reads actually served."""
    if obs is None:
        return
    labels = dict(path=path, replica=replica)
    if group is not None:
        labels["group"] = group
    obs.metrics.inc("reads_served_total", n, **labels)
    if t0 is not None:
        now = time.monotonic()
        from rdma_paxos_tpu_torch.obs.spans import active_recorder
        rec = active_recorder(obs)
        rid = None
        if rec is not None:
            # span first: a sampled read's id becomes the latency
            # histogram's exemplar, so a read-SLO page resolves to a
            # concrete read span on the merged timeline
            rid = rec.read_span(replica, path, t0,
                                group=(-1 if group is None else group))
        obs.metrics.observe("read_latency_us", (now - t0) * 1e6,
                            buckets=LATENCY_BUCKETS_US, exemplar=rid,
                            path=path)


def read_counts(obs) -> Dict[str, int]:
    """Per-path totals summed over replicas/groups from the registry —
    the deterministic accounting chaos verdicts and bench proofs
    embed."""
    out = {PATH_LEASE: 0, PATH_READ_INDEX: 0, PATH_LOG: 0}
    if obs is None:
        return out
    for key, v in obs.metrics.snapshot()["counters"].items():
        if not key.startswith("reads_served_total"):
            continue
        for path in out:
            if f"path={path}" in key:
                out[path] += int(v)
    return out


class _LeaseState:
    """Per-group lease bookkeeping (host dict ops only)."""

    __slots__ = ("holder", "active_from", "last_verified", "barrier",
                 "term", "expired_marked")

    def __init__(self):
        self.holder = -1          # current leader view (may be inactive)
        self.active_from = -1     # step the lease activated; -1 = none
        self.last_verified = -1   # newest verified-quorum step observed
        self.barrier = 0          # no lease may activate before this step
        self.term = 0
        self.expired_marked = False   # expire event emitted once per lapse

    def as_dict(self) -> dict:
        return dict(holder=self.holder, active_from=self.active_from,
                    last_verified=self.last_verified,
                    barrier=self.barrier, term=self.term)


class LeaseManager:
    """Step-domain per-group leader leases, renewed by the finished
    steps' verified-quorum outputs (see the module docstring for the
    safety argument). Engine-agnostic: :meth:`observe` handles both
    the ``[R]`` (SimCluster) and ``[G, R]`` (ShardedCluster — vmap or
    mesh) result shapes."""

    def __init__(self, n_groups: int = 1, *, lease_steps: int = 2,
                 guard_steps: int = 2, renew_trace_every: int = 16):
        if lease_steps < 1:
            raise ValueError("lease_steps must be >= 1")
        self.G = int(n_groups)
        self.lease_steps = int(lease_steps)
        self.guard_steps = int(guard_steps)
        self.renew_trace_every = max(1, int(renew_trace_every))
        # guarded-by: _lock
        self._st: List[_LeaseState] = [_LeaseState()
                                       for _ in range(self.G)]
        self._lock = threading.Lock()
        self._now = 0        # guarded-by: _lock [writes]
        self._now_max = 0    # guarded-by: _lock [writes]
        self._obs = None         # refreshed from the engine each observe
        self.grants = 0
        self.renewals = 0
        self.revocations = 0

    # ------------------------------------------------------------------
    # observation (engines' finish() tail — readback-thread safe)
    # ------------------------------------------------------------------

    def observe(self, engine, res) -> None:
        """Fold one finished step's outputs into the lease state:
        renew the verified leader's lease per group, revoke on
        deposition / leaderlessness / repair holds, and advance the
        conservative clocks. The leader-claim extraction is ONE
        vectorized numpy pass — this runs on the readback hot path
        every finished step, so a G×R Python scan would tax the
        readback thread of the pipelined driver."""
        self._obs = getattr(engine, "obs", None)
        step = int(engine.step_index)
        disp = int(getattr(engine, "_dispatch_clock", step))
        role = np.asarray(res["role"])
        sharded = role.ndim == 2
        term = np.asarray(res["term"])
        ver = np.asarray(res["leadership_verified"])
        if not sharded:
            role, term, ver = role[None], term[None], ver[None]
        # per-group highest-term claimant (the leader_claim rule,
        # vectorized): mask non-claimants to -1, argmax the terms
        masked = np.where(role == _LEADER, term, -1)        # [G, R]
        leaders = masked.argmax(axis=1)
        has = masked[np.arange(masked.shape[0]), leaders] >= 0
        nr = engine.need_recovery
        rb = getattr(engine, "read_blocked", ())
        with self._lock:
            self._now = step
            # dispatch-ahead aging, CLAMPED: in-flight dispatches age
            # a lease (extra conservatism on top of the finished-step
            # safety argument) but may never fully cover the window —
            # unclamped, a pipeline depth >= lease_steps would expire
            # every lease the same observe that granted it, silently
            # disabling the lease path and churning grant/expire
            # events every verified step
            self._now_max = max(step, min(disp,
                                          step + self.lease_steps - 1))
            for g in range(self.G):
                leader = int(leaders[g]) if has[g] else -1
                key = (g, leader) if sharded else leader
                blocked = leader >= 0 and (key in nr or key in rb)
                verified = leader >= 0 and bool(ver[g, leader])
                lterm = int(masked[g, leader]) if leader >= 0 else 0
                self._observe_group(g, step, leader, lterm, verified,
                                    blocked)

    # holds-lock: _lock
    def _observe_group(self, g: int, step: int, leader: int,
                       term: int, verified: bool,
                       blocked: bool) -> None:
        st = self._st[g]
        if leader != st.holder:
            if st.holder >= 0:
                self._revoke_locked(
                    g, "deposed" if leader >= 0 else "leaderless")
            st.holder = leader
            st.term = term
            st.last_verified = -1
        if leader < 0:
            return
        st.term = term
        if blocked:
            if st.active_from >= 0:
                self._revoke_locked(g, "need_recovery")
            return
        if verified:
            active = (st.active_from >= 0 and not st.expired_marked
                      and step - st.last_verified <= self.lease_steps)
            if active:
                st.last_verified = step
                self.renewals += 1
                if self._obs is not None \
                        and (self.renewals - 1) \
                        % self.renew_trace_every == 0:
                    self._obs.trace.record(
                        obs_trace.LEASE_RENEWED, replica=leader,
                        group=g, step=step, term=term)
            elif step >= st.barrier:
                # grant (or re-grant after a lapse) — a NEW lease may
                # only activate once the previous holder's lease has
                # been waited out (the barrier); a lapsed lease of the
                # SAME still-unique leader re-activates immediately
                # (validity derives purely from verified-quorum
                # recency, and no rival can have been elected without
                # deposing it — which resets the holder above)
                st.active_from = step
                st.last_verified = step
                st.expired_marked = False
                self.grants += 1
                if self._obs is not None:
                    self._obs.metrics.inc("lease_grants_total",
                                          replica=leader, group=g)
                    self._obs.metrics.set("lease_holder", leader,
                                          group=g)
                    self._obs.trace.record(
                        obs_trace.LEASE_GRANTED, replica=leader,
                        group=g, step=step, term=term,
                        barrier=st.barrier)
        # natural expiry: emit the timeline event once per lapse
        if (st.active_from >= 0 and not st.expired_marked
                and self._now_max - st.last_verified
                >= self.lease_steps):
            st.expired_marked = True
            if self._obs is not None:
                self._obs.metrics.inc("lease_expired_total",
                                      replica=st.holder, group=g)
                self._obs.trace.record(
                    obs_trace.LEASE_EXPIRED, replica=st.holder,
                    group=g, step=step, last_verified=st.last_verified)

    # ------------------------------------------------------------------
    # queries / control
    # ------------------------------------------------------------------

    def valid(self, group: int, replica: int,
              now: Optional[int] = None) -> bool:
        """True iff ``replica`` holds an ACTIVE, unexpired lease for
        ``group`` at ``now`` (default: the conservative
        ``max(step_index, dispatch_clock)`` of the last observe)."""
        with self._lock:
            st = self._st[group]
            if st.holder != replica or st.active_from < 0 \
                    or st.last_verified < 0:
                return False
            n = self._now_max if now is None else int(now)
            return n - st.last_verified < self.lease_steps

    def serving_holder(self, group: int) -> int:
        """The replica currently able to serve lease reads for
        ``group`` (-1 when none)."""
        with self._lock:
            st = self._st[group]
            holder = st.holder
        if holder >= 0 and self.valid(group, holder):
            return holder
        return -1

    def holders(self) -> List[int]:
        return [self.serving_holder(g) for g in range(self.G)]

    def revoke(self, group: int, replica: int, reason: str) -> bool:
        """External revocation (repair quarantine, driver step-down):
        immediately invalidates ``replica``'s lease for ``group`` and
        arms the wait-out barrier. No-op when it holds no lease."""
        with self._lock:
            st = self._st[group]
            if st.holder != replica:
                return False
            return self._revoke_locked(group, reason)

    def revoke_any(self, group: int, reason: str) -> bool:
        """Revoke whatever lease ``group`` currently has, holder
        unknown to the caller — the topology cutover's fence (serving
        through a lease granted under the OLD routing must provably
        stop before the router swaps). No-op when nothing is held."""
        with self._lock:
            return self._revoke_locked(group, reason)

    def revoke_all(self, replica: int, reason: str) -> int:
        """Revoke every group lease ``replica`` holds (driver
        step-down / crash paths)."""
        n = 0
        for g in range(self.G):
            if self.revoke(g, replica, reason):
                n += 1
        return n

    def _revoke_locked(self, g: int, reason: str) -> bool:
        st = self._st[g]
        had = st.active_from >= 0
        if st.last_verified >= 0:
            # waiter-side conservative expiry of the old lease: no new
            # lease may activate before it has provably lapsed even
            # under the in-flight/pipelined clock uncertainty
            st.barrier = max(st.barrier, st.last_verified
                             + self.lease_steps + self.guard_steps)
        holder = st.holder
        st.active_from = -1
        st.expired_marked = False
        if had:
            self.revocations += 1
            if self._obs is not None:
                self._obs.metrics.inc("lease_revoked_total",
                                      replica=holder, group=g,
                                      reason=reason)
                self._obs.metrics.set("lease_holder", -1, group=g)
                self._obs.trace.record(
                    obs_trace.LEASE_REVOKED, replica=holder, group=g,
                    step=self._now, reason=reason)
        return had

    def status(self) -> dict:
        """Deterministic (step-domain) export for health snapshots and
        chaos verdicts."""
        with self._lock:
            return dict(
                lease_steps=self.lease_steps,
                guard_steps=self.guard_steps,
                now=self._now, now_max=self._now_max,
                grants=self.grants, renewals=self.renewals,
                revocations=self.revocations,
                groups=[st.as_dict() for st in self._st],
                holders=[(st.holder
                          if st.active_from >= 0 and st.last_verified >= 0
                          and self._now_max - st.last_verified
                          < self.lease_steps else -1)
                         for st in self._st],
            )


class ReadTicket:
    """One queued linearizable read: submitted from any thread, served
    (or failed) by the hub drain on the finishing thread."""

    __slots__ = ("group", "replica", "serve_fn", "on_done", "patience",
                 "step0", "t0", "read_index", "path", "value", "status",
                 "pass_ticket", "_ev")

    def __init__(self, serve_fn, replica: int, group: int,
                 patience: int, step0: int, on_done,
                 pass_ticket: bool = False):
        self.serve_fn = serve_fn
        self.pass_ticket = bool(pass_ticket)
        self.replica = int(replica)
        self.group = int(group)
        self.patience = int(patience)
        self.step0 = int(step0)
        self.t0 = time.monotonic()
        self.read_index: Optional[int] = None   # absolute, once confirmed
        self.path: Optional[str] = None
        self.value = None
        self.status: Optional[str] = None       # None | "ok" | "failed"
        self.on_done = on_done
        self._ev = threading.Event()

    @property
    def done(self) -> bool:
        return self.status is not None

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._ev.wait(timeout)


class ReadHub:
    """The drivers' read queue: linearizable reads queued from client
    threads, drained at the tail of every finished step (the readback
    thread under pipelining) — between pipelined tickets, never
    inside one. Path selection per read, in order: the replica's
    valid LEASE (serve from local applied state, zero log traffic),
    else READ-INDEX (confirm the verified leader's commit index once,
    wait for the local apply frontier to reach it), else keep queued
    until the step-domain patience lapses (fail — the read
    definitively did not happen, so it constrains nothing)."""

    def __init__(self, leases: Optional[LeaseManager] = None, *,
                 patience_steps: int = 64):
        self.leases = leases
        self.patience_steps = int(patience_steps)
        self._lock = threading.Lock()
        # guarded-by: _lock [strict]
        self._q: collections.deque = collections.deque()
        # guarded-by: _lock
        self.served: Dict[str, int] = {PATH_LEASE: 0,
                                       PATH_READ_INDEX: 0}
        self.failed = 0    # guarded-by: _lock
        # runtime lock sanitizer: _q is [strict] — under RP_SANITIZE=1
        # even READS assert the hub lock (no lock-free read exists)
        from rdma_paxos_tpu_torch.analysis import runtime_guard
        runtime_guard.maybe_guard(self, "_lock", __file__)

    def submit(self, serve_fn: Optional[Callable] = None, *,
               replica: int, group: int = 0,
               patience: Optional[int] = None,
               step0: Optional[int] = None, on_done=None,
               pass_ticket: bool = False) -> ReadTicket:
        """Queue a read at ``replica`` (thread-safe). ``step0`` anchors
        the step-domain patience; without it the first drain stamps
        the current finished step (a client thread rarely knows the
        engine clock). ``pass_ticket=True`` calls ``serve_fn(ticket)``
        instead of ``serve_fn()`` — the serve callback runs AT the
        linearization point, and a range scan needs the confirmed
        ``read_index`` there to pin its consistent cut."""
        t = ReadTicket(serve_fn, replica, group,
                       self.patience_steps if patience is None
                       else patience,
                       -1 if step0 is None else step0, on_done,
                       pass_ticket)
        with self._lock:
            self._q.append(t)
        return t

    def pending_count(self) -> int:
        with self._lock:
            return len(self._q)

    # ------------------------------------------------------------------

    def _commit(self, t: ReadTicket, status: str, path: Optional[str],
                value) -> bool:
        """Atomically move a ticket to its terminal state; False when
        another completer already won. FIRST COMPLETION WINS: the
        stop-path ``fail_all`` can race the readback thread's drain
        over the same ticket, and a double completion would flip a
        client-visible status and fire ``on_done`` twice."""
        with self._lock:
            if t.status is not None:
                return False
            t.status = status
            t.path = path
            t.value = value
            if status == "ok":
                self.served[path] = self.served.get(path, 0) + 1
            else:
                self.failed += 1
        if t.on_done is not None:
            try:
                t.on_done(t.status, t.value)
            except Exception:  # noqa: BLE001 — callbacks never kill
                pass           # the finishing thread
        t._ev.set()
        return True

    def _finish(self, obs, t: ReadTicket, path: Optional[str],
                ok: bool) -> None:
        if not ok:
            self._commit(t, "failed", None, None)
            return
        try:
            if t.serve_fn is None:
                value = None
            elif t.pass_ticket:
                value = t.serve_fn(t)
            else:
                value = t.serve_fn()
        except Exception:  # noqa: BLE001 — a failing serve callback
            # must fail THE READ, never the finishing (readback)
            # thread the whole data path runs on
            self._commit(t, "failed", path, None)
            return
        if self._commit(t, "ok", path, value):
            count_read(obs, path, t.replica, group=t.group, t0=t.t0)

    def drain(self, engine) -> int:
        """Serve every due queued read against ``engine``'s last
        FINISHED step (called from the engines' ``finish()`` tail).
        Returns the number of reads resolved this pass."""
        res = engine.last
        if res is None:
            return 0
        with self._lock:
            if not self._q:
                return 0
            pending = list(self._q)
        obs = getattr(engine, "obs", None)
        sharded = res["role"].ndim == 2
        now = int(engine.step_index)
        nr = engine.need_recovery
        rb = getattr(engine, "read_blocked", ())
        views: Dict[int, tuple] = {}

        def view(g: int):
            v = views.get(g)
            if v is None:
                role = res["role"][g] if sharded else res["role"]
                term = res["term"][g] if sharded else res["term"]
                ver = (res["leadership_verified"][g] if sharded
                       else res["leadership_verified"])
                commit = res["commit"][g] if sharded else res["commit"]
                applied = (engine.applied[g] if sharded
                           else engine.applied)
                reb = (int(engine.rebased_total[g]) if sharded
                       else int(engine.rebased_total))
                leader, _t = leader_claim(role, term, int(engine.R))
                verified = leader >= 0 and bool(ver[leader])
                v = (leader, verified, commit, applied, reb)
                views[g] = v
            return v

        R = int(engine.R)
        G = int(getattr(engine, "G", 1))
        resolved = []
        for t in pending:
            if t.done:
                resolved.append(t)          # already terminal: prune
                continue
            if not (0 <= t.replica < R and 0 <= t.group < G):
                # a malformed ticket must fail ITSELF, never the
                # finishing (readback) thread via an IndexError below
                self._finish(obs, t, None, False)
                resolved.append(t)
                continue
            if t.step0 < 0:
                t.step0 = now               # patience anchors here
            key = (t.group, t.replica) if sharded else t.replica
            if key in nr or key in rb:
                # a quarantined / repair-held / recovering replica
                # serves nothing — same gate as the KVS read path
                self._finish(obs, t, None, False)
                resolved.append(t)
                continue
            leader, verified, commit, applied, reb = view(t.group)
            lm = self.leases
            if lm is not None and lm.valid(t.group, t.replica) \
                    and int(applied[t.replica]) \
                    >= int(commit[t.replica]):
                self._finish(obs, t, PATH_LEASE, True)
                resolved.append(t)
                continue
            if t.read_index is None and leader >= 0 and verified:
                # the ONE confirmation round: the leader proved its
                # authority on this finished step, so its commit index
                # upper-bounds every write acked before this read
                t.read_index = int(commit[leader]) + reb
            if t.read_index is not None \
                    and int(applied[t.replica]) + reb >= t.read_index:
                self._finish(obs, t, PATH_READ_INDEX, True)
                resolved.append(t)
                continue
            if now - t.step0 > t.patience:
                self._finish(obs, t, None, False)
                resolved.append(t)
        if resolved:
            with self._lock:
                gone = set(id(t) for t in resolved)
                self._q = collections.deque(
                    t for t in self._q if id(t) not in gone)
        return len(resolved)

    def fail_all(self, reason: str = "shutdown") -> int:
        """Fail every still-queued read (run end / driver stop):
        nothing will ever step again, so they must fail, not hang.
        Completion goes through the same first-wins commit as the
        drain, so racing the readback thread is safe."""
        with self._lock:
            pending = list(self._q)
            self._q.clear()
        n = 0
        for t in pending:
            if self._commit(t, "failed", None, None):
                n += 1
        return n

    def status(self) -> dict:
        with self._lock:
            return dict(pending=len(self._q), served=dict(self.served),
                        failed=self.failed,
                        patience_steps=self.patience_steps)


def attach(cluster, *, lease_steps: int = 2, guard_steps: int = 2,
           patience_steps: int = 64,
           renew_trace_every: int = 16) -> LeaseManager:
    """Enable the read path on an engine (SimCluster or
    ShardedCluster, any execution mode): creates the per-group
    :class:`LeaseManager` + :class:`ReadHub` pair and hangs them on
    ``cluster.leases`` / ``cluster.reads`` — the engines' ``finish()``
    observes/drains them from then on. Pure host bookkeeping: the
    replica step is untouched."""
    G = int(getattr(cluster, "G", 1))
    lm = LeaseManager(G, lease_steps=lease_steps,
                      guard_steps=guard_steps,
                      renew_trace_every=renew_trace_every)
    hub = ReadHub(lm, patience_steps=patience_steps)
    cluster.leases = lm
    cluster.reads = hub
    return lm
