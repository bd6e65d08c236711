"""ShardedClusterDriver — the e2e data plane over G consensus groups.

The port of the JAX package's ``runtime/sharded_driver.py``: the
:class:`~rdma_paxos_tpu_torch.runtime.driver.ClusterDriver` polling and
pipelining loop serving a :class:`~rdma_paxos_tpu_torch.shard.cluster.
ShardedCluster` on the card (``device="cpu"`` in the tests):

  * **Every replica is a serving front-end.** Clients connect to any
    replica's app; each of the G groups elects its own leader, spread
    across the R replicas by per-group step-domain election timers
    (:class:`~rdma_paxos_tpu_torch.runtime.timers.GroupStepTimer`;
    group g's first candidate is replica ``g % R``).
  * **Connections are routed by key prefix.** A shim connection is
    pinned to the group that owns the key prefix of its first
    replicated SEND (:func:`key_prefix_of`, ``KeyRouter.group_of``);
    all of its traffic then rides that group's log.
  * **CONNECT is held, not blocked.** It is acked at once and
    submitted ahead of the connection's first SEND into the routed
    group's log (FIFO within the group).
  * **Acks demux per group.** Commit waiters are tracked per
    ``(replica, group)`` FIFO; group g's commit stream releases only
    g's waiters.
  * **Transactions.** With ``txn=True`` the engine runs the vote lane,
    and a coordinator attached over a ``ShardedKVS`` on
    ``driver.cluster`` decides off the loop's serial steps: while one
    is in flight the loop gives way from bursts and pipelining.

  * **Self-healing and the governor.** ``repair=True`` (with
    ``audit=True``) repairs per group through the controller's
    engine-level digest-verified install (one group's repair never
    stalls the others); a front-end held in any group admits no new
    session, its held group's waiters fail at quarantine, and a held
    replica is never an election candidate. ``governor=True`` caps the
    all-groups burst at the highest per-group rung. :meth:`health` is
    the engine's per-group document with the driver's view.

  * **Elastic topology.** With a controller attached
    (``topology.attach_topology`` over ``ShardedKVS(driver.cluster)``)
    the loop runs its passes on drained serial iterations, keeps
    stepping through an open window and its cooldown, and at each
    cutover fails the donor groups' in-flight waiters and unpins their
    connections so retries re-route under the new map.

Differences from the JAX driver, each failing loudly: the surfaces that
are single-group by design raise as in the JAX driver (membership,
``recover_replica``, ``reset_app``, ``checkpoint_app``).

With ``mesh=(group_shards, R)`` and a device list (``device=``, None for
the machine's cards) the cluster is the device-list engine; the loop is
unchanged. Its dispatch returns only once every worker thread has passed
its last seam (the engine's ``begin_*`` joins its world), so the
readback thread never meets a half-stepped engine, and ``stop()`` joins
the world's threads.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional

from rdma_paxos_tpu_torch.config import LogConfig
from rdma_paxos_tpu_torch.consensus.log import EntryType
from rdma_paxos_tpu_torch.consensus.state import Role
from rdma_paxos_tpu_torch.obs import trace as obs_trace
from rdma_paxos_tpu_torch.obs.metrics import LATENCY_BUCKETS_S
from rdma_paxos_tpu_torch.obs.health import (
    make_cluster_snapshot, make_snapshot)
from rdma_paxos_tpu_torch.obs.spans import span_trace_id
from rdma_paxos_tpu_torch.obs.tracectx import health_blame as _health_blame
from rdma_paxos_tpu_torch.proxy.proxy import PendingEvent
from rdma_paxos_tpu_torch.runtime.driver import (
    PHASE_INTAKE_LOCK_WAIT, PHASE_POST_STEP_RULES, PHASE_STORE_SYNC,
    PHASE_SUBMIT_PUMP, ClusterDriver, conn_origin)
from rdma_paxos_tpu_torch.runtime.hostpath import plan_segment
from rdma_paxos_tpu_torch.runtime.timers import GroupStepTimer
from rdma_paxos_tpu_torch.shard.cluster import ShardedCluster
from rdma_paxos_tpu_torch.shard.router import KeyRouter
from rdma_paxos_tpu_torch.utils.codec import fragment

PREFIX_DELIMS = (b"-", b":", b".")


def key_prefix_of(payload: bytes) -> bytes:
    """The routing key prefix of a replicated SEND payload: the first
    command's key, truncated at the first prefix delimiter. Parses both
    RESP arrays (``*3\\r\\n$3\\r\\nSET\\r\\n$5\\r\\nkey-1...``) and
    inline/space-separated commands (``SET key-1 v1``). A payload with
    no recognizable key routes by the empty prefix."""
    key = b""
    if payload[:1] == b"*":
        parts = payload.split(b"\r\n", 5)
        if len(parts) >= 5:
            key = parts[4]
    else:
        toks = payload.split(None, 2)
        if len(toks) >= 2:
            key = toks[1]
        elif toks:
            key = toks[0]
    # truncate at the FIRST-occurring delimiter: b"user.1-x" routes as
    # b"user", never b"user.1"
    cut = len(key)
    for d in PREFIX_DELIMS:
        i = key.find(d, 0, cut)
        if i > 0:
            cut = i
    return key[:cut]


class ShardedClusterDriver(ClusterDriver):
    """One polling loop serving G consensus groups end to end."""

    def __init__(self, cfg: LogConfig, n_replicas: int, n_groups: int,
                 *, router: Optional[KeyRouter] = None,
                 key_of=key_prefix_of, mesh=None,
                 group_timer_lo: int = 6, group_timer_hi: int = 12,
                 **kw):
        if kw.get("link_model") is not None:
            raise ValueError(
                "sharded driver: attach per-group link models via "
                "cluster.link_models[g], not link_model=")
        self.G = int(n_groups)
        self._router = router if router is not None else KeyRouter(self.G)
        self._key_of = key_of
        self._mesh = mesh
        # per-group leader views; _leader_view becomes the all-groups-led
        # aggregate (0 when every group is led, else -1)
        # guarded-by: _lock [writes]
        self._group_views: List[int] = [-1] * self.G
        # guarded-by: _lock
        self._conn_group: Dict[int, int] = {}    # conn -> pinned group
        # guarded-by: _lock
        self._conn_hold: Dict[int, bytes] = {}   # conn -> held CONNECT
        super().__init__(cfg, n_replicas, **kw)
        # (replica, group) commit-waiter FIFOs and replay cursors
        # guarded-by: _lock
        self._inflight_g: List[List[collections.deque]] = [
            [collections.deque() for _ in range(self.G)]
            for _ in range(n_replicas)]
        # guarded-by: _lock
        self._replay_cursor = [[0] * self.G for _ in range(n_replicas)]
        seed = kw.get("seed", 0)
        self._gtimers = [GroupStepTimer(g, seed=seed, lo=group_timer_lo,
                                        hi=group_timer_hi)
                         for g in range(self.G)]
        self._elect_round = [0] * self.G
        # elastic-topology cutover hook: the controller calls this on
        # the driver thread right after the atomic router swap
        self.cluster._on_topology_cutover = self._on_topology_cutover

    def _make_cluster(self, cfg, n_replicas, group_size, mode, fanout,
                      audit, telemetry, device, txn=False):
        return ShardedCluster(cfg, n_replicas, self.G, router=self._router,
                              fanout=fanout, group_size=group_size,
                              audit=audit, mesh=self._mesh,
                              telemetry=telemetry, scan=self._scan,
                              txn=txn, device=device)

    def _wire_repair(self) -> None:
        """Sharded driver: repair uses the controller's ENGINE-level
        digest-verified install (per-group snapshot and backfill — one
        group's repair never stalls the others); the driver only
        resyncs its per-(replica, group) replay cursor and fails the
        held front-end's waiters at quarantine."""
        self.repair.post_install = self._repair_post_install
        self.repair.on_quarantine = self._repair_on_quarantine

    def _repair_post_install(self, g: int, r: int, donor: int) -> None:
        with self._lock:
            self._replay_cursor[r][g] = len(self.cluster.replayed[g][r])

    def _repair_on_quarantine(self, g: int, r: int) -> None:
        """A front-end just entered quarantine for group ``g``: its
        replay for that group is frozen, so its blocked commit waiters
        can never be ack-released — fail them now so clients retry
        against a healthy front-end (invoked by the controller OUTSIDE
        its lock)."""
        releases = []
        with self._lock:
            dq = self._inflight_g[r][g]
            while dq:
                ev, _ = dq.popleft()
                releases.append(ev)
        for ev in releases:
            ev.release(-1)
        if releases:
            self.obs.metrics.inc("inflight_failed_total", len(releases),
                                 replica=r)
            self.obs.trace.record(obs_trace.INFLIGHT_FAILED,
                                  replica=r, group=g, count=len(releases),
                                  site="repair quarantine")
            self.obs.spans.fail_open(self._span_rep(g, r))

    def _on_topology_cutover(self, donors, targets) -> None:
        """An elastic cutover just swapped the live router: some keys
        moved OFF every group in ``donors``. Their blocked commit
        waiters are failed (clients retry and re-resolve the owner —
        same contract as a leadership change) and proxy conn->group
        pins on donor groups are dropped so the next SEND re-routes
        under the new map. Held CONNECTs stay held: they carry no key
        and route with their first SEND. Invoked by the topology
        controller (its lock held) on the driver thread — we take
        self._lock here, fixing the topology._lock -> driver._lock
        order the _busy/_pipeline_ready gates respect by checking
        ``needs_drain()`` OUTSIDE self._lock."""
        for g in donors:
            self._fail_group_inflight(g, "topology cutover")
        with self._lock:
            stale = [c for c, g in self._conn_group.items()
                     if g in donors]
            for c in stale:
                del self._conn_group[c]

    def _span_rep(self, g: int, r: int) -> int:
        """Span-track replica id in the engine's group namespace."""
        return self.cluster._span_rep(g, r)

    @property
    def router(self) -> KeyRouter:
        return self._router

    def leaders(self) -> List[int]:
        with self._lock:
            return list(self._group_views)

    # ------------------------------------------------------------------
    # intake: key-prefix routing
    # ------------------------------------------------------------------

    def _accepts_clients(self, r: int) -> bool:
        # every replica fronts the cluster while any group is led (the
        # per-group availability check happens at SEND routing time) —
        # EXCEPT a replica the repair pipeline holds in any group: its
        # replay for the held group is frozen, so sessions it admits
        # could stall forever on ack release
        if (self.repair is not None
                and self.repair.serving_blocked_any(r)):
            return False
        return any(v >= 0 for v in self._group_views)

    # holds-lock: _lock
    def _enqueue_locked(self, r: int, rt, etype: int, conn_id: int,
                        payload: bytes):
        if etype == int(EntryType.CONNECT):
            # held until the first SEND names a key; acked at once (it
            # carries no data — an acked SEND later proves it committed,
            # FIFO within its group)
            self._conn_hold[conn_id] = payload
            self.obs.metrics.inc("proxy_events_total", replica=r)
            return 0
        g = self._conn_group.get(conn_id)
        if g is None and etype == int(EntryType.CLOSE):
            # nothing of this conn ever replicated
            self._conn_hold.pop(conn_id, None)
            return 0
        if g is None:
            g = self._router.group_of(self._key_of(payload))
            self._conn_group[conn_id] = g
        if self._group_views[g] < 0:
            # the routed group is (transiently) leaderless: fail fast so
            # the client retries
            rt.replicated_conns.discard(conn_id)
            self._conn_group.pop(conn_id, None)
            self._conn_hold.pop(conn_id, None)
            self.obs.metrics.inc("events_refused_total", replica=r)
            return -1
        rows = []
        held = self._conn_hold.pop(conn_id, None)
        if held is not None:
            rt.submit_seq += 1
            rows.append((g, int(EntryType.CONNECT), conn_id, held,
                         rt.submit_seq))
        frags = (fragment(payload, self.cfg.slot_bytes)
                 if etype == int(EntryType.SEND) else [payload])
        ev = PendingEvent(EntryType(etype), conn_id, payload)
        for f in frags:
            rt.submit_seq += 1
            rows.append((g, etype, conn_id, f, rt.submit_seq))
        if etype == int(EntryType.CLOSE):
            self._conn_group.pop(conn_id, None)
        self._submitq[r].extend(rows)
        self._inflight_g[r][g].append((ev, rt.submit_seq))
        self.obs.metrics.inc("proxy_events_total", replica=r)
        self.obs.trace.record(obs_trace.PROXY_ENQUEUE, replica=r,
                              etype=etype, conn=conn_id, group=g,
                              frags=len(frags), submit_seq=rt.submit_seq)
        # span birth keyed (conn, final fragment seq) on the group-
        # namespaced front-end track
        self.obs.spans.begin(conn_id, rt.submit_seq, self._span_rep(g, r))
        self._wake.set()
        return ev

    def _pump_submitq(self) -> None:
        """Move intake rows into the engine's pending queues: demuxed
        per group, one locked extend per (group, current leader). Rows
        of a group whose leadership vanished since enqueue land on a
        non-leader and are dropped by design (the leadership-change
        sweep fails their waiters)."""
        prof = self._phase_prof
        prof.start(PHASE_SUBMIT_PUMP)
        prof.start(PHASE_INTAKE_LOCK_WAIT)
        with self._lock, self.cluster._host_lock:
            prof.stop(PHASE_INTAKE_LOCK_WAIT)
            views = self._group_views
            for r in range(self.R):
                if not self._submitq[r]:
                    continue
                per_g: Dict[int, list] = {}
                for g, etype, conn, frag, seq in self._submitq[r]:
                    per_g.setdefault(g, []).append((etype, conn, seq, frag))
                for g, rows in per_g.items():
                    q = views[g] if views[g] >= 0 else 0
                    self.cluster.submit_many(g, q, rows)
                self._submitq[r].clear()
        prof.stop(PHASE_SUBMIT_PUMP)

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------

    def _backlog(self) -> int:
        return max(len(q) for row in self.cluster.pending for q in row)

    # holds-lock: _lock
    def _waiter_count(self) -> int:
        return sum(len(dq) for row in self._inflight_g for dq in row)

    def _busy(self) -> bool:
        # checked OUTSIDE self._lock: the topology cutover hook runs
        # with the controller's lock held and takes self._lock
        # (topology._lock -> driver._lock); nesting the reverse order
        # here would deadlock
        topo = getattr(self.cluster, "topology", None)
        if topo is not None and (topo.needs_drain() or topo.cooling()):
            return True     # keep stepping so the window's records
            # land and the bounded post-window cooldown expires
        with self._lock:
            return bool(any(self._submitq) or self._backlog()
                        or self._waiter_count()
                        or (self.cluster.reads is not None
                            and self.cluster.reads.pending_count())
                        or self._txn_live())

    def step(self) -> Dict:
        """One host-loop iteration: elections for leaderless groups ride
        the same dispatch as every other group's step; any backlog
        rides a fused all-groups burst."""
        self._drain_admin()
        self._pump_submitq()
        c = self.cluster
        timeouts: Dict[int, list] = {}
        if c.last is not None:
            for g in range(self.G):
                if self._group_views[g] >= 0:
                    continue
                # a leaderless group ticks its step-domain timer once per
                # iteration; a firing targets the rotation's next
                # candidate, starting at g % R. Replicas the repair
                # pipeline holds are skipped: a quarantined candidate is
                # cut off and can never win, and a probation replica
                # must not lead while its hysteresis runs.
                if self._gtimers[g].tick():
                    cand = -1
                    for _ in range(self.R):
                        cc = (g + self._elect_round[g]) % self.R
                        self._elect_round[g] += 1
                        if not self._repair_blocked(cc, g):
                            cand = cc
                            break
                    if cand < 0:
                        continue        # every replica held — escalated
                    timeouts[g] = [cand]
                    self.obs.metrics.inc("election_timeouts_total",
                                         group=g)
        # governed tier: per-GROUP rung decisions share one dispatch, so
        # the cap is the max rung (dec.max_k); a serial decision routes
        # through the all-groups single step
        dec = (self.governor.decision if self.governor is not None
               else None)
        if (not timeouts and c.last is not None
                and all(v >= 0 for v in self._group_views)
                and self._backlog() and not self._txn_live()
                and (dec is None or dec.max_k > 1)):
            res = c.step_burst(max_k=dec.max_k if dec is not None
                               else None)
        else:
            res = c.step(timeouts=timeouts)
        return self._post_step(res)

    def _pipeline_ready(self) -> bool:
        c = self.cluster
        if c.last is None:
            return False
        if any(v < 0 for v in self._group_views):
            return False
        if c.need_recovery:
            return False
        # a due repair needs one drained serial iteration (per-group
        # surgery); pipelining re-engages right after
        if self.repair is not None and self.repair.needs_drain():
            return False
        if int(c.last["end"].max()) >= self.cfg.rebase_threshold:
            return False
        if self._txn_live():
            return False
        # an open topology transition window holds the serial path
        # (checked before self._lock — see _busy's lock-order note)
        topo = getattr(c, "topology", None)
        if topo is not None and topo.needs_drain():
            return False
        # the governor engages/disengages pipelining (see
        # ClusterDriver._pipeline_ready)
        if (self.governor is not None
                and not self.governor.decision.pipeline):
            return False
        # append batches only (see ClusterDriver._pipeline_ready)
        with self._lock:
            return bool(any(self._submitq) or self._backlog())

    def _idle_margin(self) -> float:
        """The sharded election timers are step-domain and tick only for
        leaderless groups, and the idle skip needs every group led: no
        timer can fire while parked."""
        return float("inf")

    def _repair_held_any(self) -> bool:
        return any(self.repair.blocked_replicas(g)
                   for g in range(self.G))

    def _update_leader_view(self, res) -> None:
        views = []
        for g in range(self.G):
            # a repair-held replica's self-claim is not a serving
            # leadership: treating its group as leaderless fails the
            # waiters (clients retry) and lets the group timer elect a
            # healthy replacement
            claims = [(int(res["term"][g, r]), r)
                      for r in range(self.R)
                      if int(res["role"][g, r]) == int(Role.LEADER)
                      and not self._repair_blocked(r, g)]
            views.append(max(claims)[1] if claims else -1)
        with self._lock:
            prev = self._group_views
            self._group_views = views
            self._leader_view = (0 if all(v >= 0 for v in views) else -1)
        for g in range(self.G):
            if views[g] != prev[g] or views[g] < 0:
                # leadership moved or vanished: entries submitted to the
                # old leader may never commit — fail g's blocked waiters
                # so clients retry (late commits are harmless: acks
                # match by stamped seq, released events are terminal)
                self._fail_group_inflight(g, "leadership change")

    def _fail_group_inflight(self, g: int, site: str) -> None:
        with self._lock:
            for r in range(self.R):
                dq = self._inflight_g[r][g]
                n = len(dq)
                if not n:
                    continue
                rt = self.runtimes[r]
                if (rt.proxy is not None and rt.proxy.spec_mode
                        and not rt.app_dirty):
                    rt.app_dirty = True
                    rt.log.info_wtime(
                        "APP DIRTY: %d speculated events failed at %s "
                        "(group %d)" % (n, site, g))
                while dq:
                    ev, _ = dq.popleft()
                    ev.release(-1)
                self.obs.metrics.inc("inflight_failed_total", n,
                                     replica=r)
                self.obs.trace.record(obs_trace.INFLIGHT_FAILED,
                                      replica=r, group=g, count=n,
                                      site=site)
                self.obs.spans.fail_open(self._span_rep(g, r))

    # holds-lock: _lock
    def _fail_inflight_locked(self, rt, site: str) -> None:
        """Fail EVERY group's blocked waiters on this replica (caller
        holds ``_lock``) — crash/stop paths."""
        n = sum(len(dq) for dq in self._inflight_g[rt.idx])
        if (n and rt.proxy is not None and rt.proxy.spec_mode
                and not rt.app_dirty):
            rt.app_dirty = True
            rt.log.info_wtime(
                "APP DIRTY: %d speculated events failed at %s" % (n, site))
        for g, dq in enumerate(self._inflight_g[rt.idx]):
            while dq:
                ev, _ = dq.popleft()
                ev.release(-1)
            self.obs.spans.fail_open(self._span_rep(g, rt.idx))
        if n:
            self.obs.metrics.inc("inflight_failed_total", n,
                                 replica=rt.idx)
            self.obs.trace.record(obs_trace.INFLIGHT_FAILED,
                                  replica=rt.idx, count=n, site=site)

    def _post_step(self, res) -> Dict:
        prof = self._phase_prof
        prof.start(PHASE_POST_STEP_RULES)
        self._update_leader_view(res)
        for g in range(self.G):
            if self._group_views[g] >= 0:
                self._gtimers[g].beat()
        for r, rt in enumerate(self.runtimes):
            self._apply_new_entries(r, rt)
        # self-healing observation (the base driver's contract): the
        # surgery waits for a drained serial iteration
        if self.repair is not None:
            self.repair.observe()
        self._observe_step(res)
        prof.stop(PHASE_POST_STEP_RULES)
        self._cadence_observe()
        return res

    # ------------------------------------------------------------------
    # apply / ack release (per group)
    # ------------------------------------------------------------------

    def _apply_new_entries(self, r: int, rt) -> None:
        c = self.cluster
        progressed = False
        releases: list = []
        sampled: set = set()      # (conn, req) span keys acked now
        replaying = rt.replay is not None and not rt.app_dirty

        def own_of(conns, _gens):
            return conn_origin(conns) == r

        # post_step_rules (opened by _post_step) pauses for the
        # apply_replay_ack phase and times the drain, sync and release
        self._phase_prof.stop(PHASE_POST_STEP_RULES)
        self._phase_prof.start("apply_replay_ack")
        for g in range(self.G):
            stream = c.replayed[g][r]
            n = len(stream)
            cur = self._replay_cursor[r][g]
            if cur >= n:
                continue
            segs = stream.segments_from(cur)
            self._replay_cursor[r][g] = n
            progressed = True
            if rt.store is not None:
                blobs = c.frames[g][r]
                if blobs:
                    c.frames[g][r] = []
                    for b in blobs:
                        rt.store.append_framed(b)
            own_max = -1
            for seg in segs:
                seg_max, ops, _n_rem = plan_segment(seg, own_of,
                                                    want_ops=replaying)
                own_max = max(own_max, seg_max)
                if replaying:
                    for etype, conn, payload in ops:
                        rt.replay.apply(etype, conn, payload)
            if own_max >= 0:
                self._phase_prof.start("ack_release")
                self._phase_prof.start(PHASE_INTAKE_LOCK_WAIT)
                with self._lock:
                    self._phase_prof.stop(PHASE_INTAKE_LOCK_WAIT)
                    dq = self._inflight_g[r][g]
                    while dq and dq[0][1] <= own_max:
                        releases.append(dq.popleft())
                sampled.update(
                    self.obs.spans.ack_release(self._span_rep(g, r),
                                               own_max))
                self._phase_prof.stop("ack_release")
        self._phase_prof.stop("apply_replay_ack")
        self._phase_prof.start(PHASE_POST_STEP_RULES)
        if progressed and replaying:
            rt.replay.drain_responses()
        if progressed and rt.store is not None:
            now = time.monotonic()
            if now - rt.last_sync > self.sync_period:
                self._phase_prof.start(PHASE_STORE_SYNC)
                rt.store.sync()
                self._phase_prof.stop(PHASE_STORE_SYNC)
                rt.last_sync = now
        if releases:
            acked = {req: conn for conn, req in sampled}
            now = time.perf_counter()
            for ev, seq in releases:
                ev.release(0)
                self.obs.metrics.observe(
                    "commit_latency_seconds", now - ev.t0,
                    buckets=LATENCY_BUCKETS_S,
                    exemplar=(span_trace_id(acked[seq], seq)
                              if seq in acked else None),
                    replica=r)
            self.obs.trace.record(obs_trace.PROXY_ACK_RELEASE,
                                  replica=r, count=len(releases))

    # ------------------------------------------------------------------
    # observability / status
    # ------------------------------------------------------------------

    def _observe_step(self, res) -> None:
        m = self.obs.metrics
        for r in range(self.R):
            m.set("inflight_waiters",
                  sum(len(dq) for dq in self._inflight_g[r]), replica=r)
        m.set("cluster_leader", self._leader_view)

    def _health_snapshots(self, res) -> Dict[int, Dict]:
        snaps = {}
        for r in range(self.R):
            rt = self.runtimes[r]
            snaps[r] = make_snapshot(
                replica=r,
                groups_led=[g for g in range(self.G)
                            if self._group_views[g] == r],
                inflight=sum(len(dq) for dq in self._inflight_g[r]),
                app_dirty=rt.app_dirty,
                store=(rt.store.stats() if rt.store is not None
                       else None))
        return snaps

    def health(self) -> Dict:
        """Sharded cluster health, conforming to the same
        ``obs.health.CLUSTER_HEALTH_FIELDS`` schema as the single-group
        driver's (``leaders`` stands in for ``leader``)."""
        h = self.cluster.health()
        h.pop("schema", None)     # the wrapper stamps the schema
        h.update(
            leaders=self.leaders(),
            all_groups_led=self.leader() >= 0,
            replicas=[snap for _, snap in
                      sorted(self._health_snapshots(None).items())],
            loop_error=(repr(self.loop_error) if self.loop_error
                        else None),
            alerts=self.alerts.state(),
            audit_artifact=self.audit_artifact,
            repair=(self.repair.status()
                    if self.repair is not None else None),
            reads=(self.cluster.reads.status()
                   if self.cluster.reads is not None else None),
            streams=(self.cluster.streams.status()
                     if self.cluster.streams is not None else None),
            governor=(self.governor.status()
                      if self.governor is not None else None),
            txn=(self.cluster.txn.health()
                 if self.cluster.txn is not None else None),
            blame=_health_blame(self.obs))
        return make_cluster_snapshot(**h)

    def read(self, fn=None, *, key=None, group: Optional[int] = None,
             replica: Optional[int] = None, timeout: float = 30.0):
        """Queue one linearizable read against the group owning ``key``
        (or an explicit ``group``), served by that group's lease holder
        by default (``place_leaders`` spreads them across replicas)."""
        if group is None:
            if key is None:
                raise ValueError("read needs key= or group=")
            group = self._router.group_of(key)
        if replica is None:
            replica = self.read_replica(group)
        return super().read(fn, replica=replica, group=group,
                            timeout=timeout)

    def read_replica(self, group: int = 0) -> int:
        lm = self.cluster.leases
        r = lm.serving_holder(group) if lm is not None else -1
        if r < 0:
            with self._lock:
                r = self._group_views[group]
        return r if r >= 0 else 0

    def can_serve_read(self, r: int) -> bool:
        """True iff replica ``r`` verified its leadership on the latest
        step for EVERY group it leads (and leads at least one)."""
        last = self.cluster.last
        if last is None:
            return False
        led = [g for g in range(self.G) if self._group_views[g] == r]
        return bool(led) and all(
            bool(last["leadership_verified"][g, r]) for g in led)

    # ------------------------------------------------------------------
    # single-group operator surfaces (as in the JAX driver)
    # ------------------------------------------------------------------

    def request_membership(self, new_mask: int) -> None:
        raise NotImplementedError(
            "membership changes are single-group only (ROADMAP: "
            "elastic resharding)")

    def recover_replica(self, r, donor=None, timeout: float = 60.0):
        raise NotImplementedError("snapshot recovery is single-group only")

    def reset_app(self, r: int, timeout: float = 60.0) -> None:
        raise NotImplementedError("app reset is single-group only")

    def checkpoint_app(self, r: int, timeout: float = 60.0) -> None:
        raise NotImplementedError("app checkpoints are single-group only")
