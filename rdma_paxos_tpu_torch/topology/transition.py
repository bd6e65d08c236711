"""The two-router transition window — online split/merge execution.

The port's copy of the JAX package's ``topology/transition.py`` (the
runtime lock sanitizer's ``maybe_guard`` call left out, ROADMAP Queue
1, item 15). ``tests/test_torch_topology.py`` holds its windows, router
and tables equal to the reference's.

A transition migrates one key RANGE between groups with zero
linearizability violations, while clients keep writing. The trick is
that nothing ever serves a half-moved range: the LIVE router keeps
routing every key to its old owner until one atomic cutover, and the
window works off a CANDIDATE router (the live one ± exactly one
range-override rule) that nothing serves — it only answers "where
will this key live AFTER the cutover". Split installs the rule, merge
removes it; both directions are the same window because every
decision is a diff between the two routers:

    for every live in-range key k:
        src = live.group_of(k)        # authoritative copy today
        dst = candidate.group_of(k)   # owner after cutover
        src != dst  ⟹  (k, v) must be seeded into dst

The window phases (exported in ``status()``, drawn in the console):

  IDLE ──propose──▶ SEED ──converged──▶ FREEZE ──verified──▶ CUTOVER
                      ▲                    │ (deadline/repair)    │
                      └────── deltas ◀─────┴──abandon──▶ IDLE     ▼
                                                          IDLE + cooldown

* **SEED / catch-up** — on each drained-serial ``drive()`` pass the
  donors' tables are enumerated (``items_in_range``) and diffed
  against the targets' tables; missing/stale pairs are copied as
  exactly-once stamped PUT records (per-record conn ids, the txn
  coordinator's stamping recipe), stale target copies are deleted.
  Completion of every record is epoch-proofed (``topology/epoch`` —
  committed under an unchanged term, INVALIDATED placements retried
  under the same stamp), so seeding survives donor/target failovers.
  Writes to the range stay OPEN — they land on donors and the next
  pass picks them up.
* **FREEZE** — once a pass finds zero deltas, new writes to the
  migrating range queue at the client gate (``gate_key``); the few
  pre-freeze writes still in the pipeline drain, the next passes copy
  the final deltas. Freeze is bounded by a step-domain deadline —
  blown deadline abandons the window (unfreeze, nothing served ever
  moved, orphaned seed copies are reconciled or deleted by the next
  window over the range).
* **CUTOVER** — with dispatches drained (``require_drained``), zero
  deltas, digests verified donor-vs-target, no live txns and no
  repair on the affected groups: leases on every affected group are
  revoked FIRST (the trace ring orders LEASE_REVOKED before
  TOPOLOGY_CUTOVER — the chaos proof), then the live router's
  override table is swapped atomically and ``version`` bumps with the
  topology epoch. The drivers' cutover hook fails donor in-flight
  waiters and unpins their conns; the txn coordinator's
  router-version check aborts any straggler. Unfreeze, re-granting
  happens naturally once the lease barrier lapses.

Old-owner copies left behind a split are orphans the router can no
longer reach — invisible to every reader, hence harmless, and the
reverse (merge) window deletes them as stale target copies.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Tuple

from rdma_paxos_tpu_torch.models.kvs import OP_PUT, OP_RM, encode_cmd
from rdma_paxos_tpu_torch.obs import trace as obs_trace
from rdma_paxos_tpu_torch.shard.router import RangeRule, canon_key
from rdma_paxos_tpu_torch.topology import epoch as _epoch

# window phases
IDLE = "idle"
SEED = "seed"          # copying / catch-up passes (range writes open)
FROZEN = "frozen"      # range writes queued; final deltas draining


def range_digest(items: List[Tuple[bytes, bytes]]) -> str:
    """Order-independent-input digest of a sorted ``(key, value)``
    list — the donor-vs-target agreement witness recorded in the
    TOPOLOGY_VERIFIED trace event (the repair pipeline's
    digest-verified-transfer idiom, host-side)."""
    h = hashlib.sha256()
    for k, v in items:
        h.update(len(k).to_bytes(4, "big") + k)
        h.update(len(v).to_bytes(4, "big") + v)
    return h.hexdigest()


class TopologyController:
    """Drives split/merge transition windows over a ``ShardedKVS``.

    Attached at ``cluster.topology`` (``attach_topology``): the
    finish() tail feeds ``note_appends``/``observe`` (record
    placement + completion proofs, off the readback thread), the
    drivers' ``_drain_admin`` calls ``drive()`` on drained-serial
    iterations (enumeration, freezing, cutover), and ``needs_drain``
    holds pipelining for the whole window — the same give-way
    contract repair uses."""

    # conn-id namespace base for seed records: far above real clients
    # AND the txn coordinator's 1<<20 (per-record conn = BASE + serial,
    # pushed through ShardedKVS.conn_for — unique forever, so the
    # fold's per-conn high-water dedup is exactly-once per record with
    # no FIFO assumption across records)
    SEED_CLIENT_BASE = 1 << 21

    def __init__(self, kvs, *, obs=None, deadline_steps: int = 2048,
                 freeze_deadline_steps: int = 256,
                 cooldown_steps: int = 64):
        self.kvs = kvs
        self.cluster = kvs.shard
        self.G = self.cluster.G
        self.obs = obs if obs is not None else getattr(
            self.cluster, "obs", None)
        self.deadline_steps = int(deadline_steps)
        self.freeze_deadline_steps = int(freeze_deadline_steps)
        self.cooldown_steps = int(cooldown_steps)
        self.policy = None                  # bound by attach_topology
        self.epoch = _epoch.EpochClock(self.kvs.router.version)
        self.transitions_total = 0
        self.abandoned_total = 0
        # ---- controller-lock discipline ----
        # window phase (IDLE/SEED/FROZEN)  # guarded-by: _lock [writes]
        self._phase = IDLE
        # active transition: direction ("split"/"merge"), the rule
        # being installed/removed, and the candidate router
        # guarded-by: _lock [writes]
        self._direction: Optional[str] = None
        self._rule: Optional[RangeRule] = None       # guarded-by: _lock [writes]
        self._cand = None                            # guarded-by: _lock [writes]
        # absolute step bounds of the window / freeze / cooldown
        # guarded-by: _lock [writes]
        self._deadline = 0
        self._freeze_deadline = 0                    # guarded-by: _lock [writes]
        self._cooldown_until = 0                     # guarded-by: _lock [writes]
        # groups the active window touches (lease revocation set)
        # guarded-by: _lock [writes]
        self._affected: set = set()
        # in-flight seed records: (g, req) -> dict(kind, key, payload,
        # index, term, retry)  # guarded-by: _lock [writes]
        self._records: Dict[Tuple[int, int], dict] = {}
        # per-group stamped-request counter (rides the per-record conn
        # id, so it never resets)  # guarded-by: _lock [writes]
        self._req = [0] * self.G
        # per-group deposition watch for in-flight seed appends — the
        # SHARED epoch machinery (one copy with txn/coordinator.py)
        # guarded-by: _lock [writes]
        self._terms = _epoch.TermWatch(self.G)
        # digests of the last verified pass (status/trace export)
        # guarded-by: _lock [writes]
        self._last_digest: Dict[int, str] = {}
        # trace-plane ids of the ACTIVE and the LAST transition-window
        # trace. Written only under _lock; READ lock-free (plain
        # attribute load) by the txn coordinator when it blames a
        # TOPOLOGY abort on the window — the coordinator must never
        # take this lock (drive() calls txn.wants_serial() while
        # holding it: taking _lock from under the coordinator's lock
        # would be the ABBA inversion).
        # guarded-by: _lock [writes]
        self.window_trace: Optional[str] = None
        self.last_window_trace: Optional[str] = None  # guarded-by: _lock [writes]
        self._lock = threading.RLock()
        # client write gate: while a range is frozen, put/remove/txn
        # admissions for its keys wait here until cutover or abandon.
        # The frozen-range copy below is read under _gate_cv by client
        # threads and written under BOTH (_lock then _gate_cv) by the
        # drive/abandon paths.
        self._gate_cv = threading.Condition()
        # guarded-by: _gate_cv [writes]
        self._frozen_range: Optional[Tuple[bytes, Optional[bytes]]] = None

    def _tracer(self):
        """The shared trace plane, or None when span sampling is off
        (one switch silences spans AND subsystem traces)."""
        from rdma_paxos_tpu_torch.obs.tracectx import active_tracer
        return active_tracer(self.obs)

    # ---------------- proposals ----------------

    def propose_split(self, lo, hi, group: int) -> bool:
        """Open a split window: install ``RangeRule(lo, hi, group)``
        at cutover, seeding every live in-range key into ``group``.
        Returns False (refused) while a window is open or cooling
        down."""
        return self._propose("split", RangeRule(lo, hi, group))

    def propose_merge(self, rule: RangeRule) -> bool:
        """Open a merge window: REMOVE an installed override rule at
        cutover, seeding the rule group's in-range keys back into
        their ring owners. The rule must be installed verbatim."""
        if rule not in self.kvs.router.overrides:
            raise ValueError(f"rule not installed: {rule!r}")
        return self._propose("merge", rule)

    def _propose(self, direction: str, rule: RangeRule) -> bool:
        with self._lock:
            if self._phase != IDLE:
                return False
            if self.cluster.step_index < self._cooldown_until:
                return False
            cand = (self.kvs.router.with_rule(rule)
                    if direction == "split"
                    else self.kvs.router.without_rule(rule))
            self._direction = direction
            self._rule = rule
            self._cand = cand
            self._deadline = self.cluster.step_index + self.deadline_steps
            self._affected = {rule.group}
            self._records.clear()
            self._last_digest = {}
            self._phase = SEED
            tr = self._tracer()
            if tr is not None:
                # TraceContext is leaf-locked: safe to call under _lock
                self.window_trace = tr.begin(
                    "topology", direction=direction,
                    group=rule.group, lo=rule.lo.hex(),
                    hi=rule.hi.hex() if rule.hi is not None else None)
        self._trace(obs_trace.TOPOLOGY_PROPOSED, direction=direction,
                    lo=rule.lo.hex(),
                    hi=rule.hi.hex() if rule.hi is not None else None,
                    group=rule.group, step=self.cluster.step_index)
        self._metric_inc("topology_proposed_total", direction=direction)
        return True

    # ---------------- driver / cluster surface ----------------

    def needs_drain(self) -> bool:
        """True for the whole window: transitions run on drained
        serial iterations only (the repair give-way contract)."""
        with self._lock:
            return self._phase != IDLE

    def in_window(self) -> bool:
        return self.needs_drain()

    def cooling(self) -> bool:
        """True while the post-window cooldown runs. The sharded
        driver's busy gate keeps stepping through it (64 fast
        iterations, bounded) — the cooldown is step-domain, and a
        PARKED driver's step index only advances at the idle
        heartbeat, which would stretch a 64-step cooldown into
        minutes of refused proposals."""
        with self._lock:
            return (self._phase == IDLE
                    and self.cluster.step_index < self._cooldown_until)

    def frozen(self) -> bool:
        with self._gate_cv:
            return self._frozen_range is not None

    def would_block(self, key) -> bool:
        """True when :meth:`gate_key` would block for ``key`` right
        now. Single-threaded embedders (the chaos runner steps the
        cluster and issues writes on ONE thread) must consult this
        and DEFER in-range writes while frozen — calling a blocking
        put from the only thread that can drive the unfreeze would
        wedge."""
        kb = canon_key(key)
        with self._gate_cv:
            fr = self._frozen_range
        if fr is None:
            return False
        lo, hi = fr
        return kb >= lo and (hi is None or kb < hi)

    def gate_key(self, key) -> None:
        """Client write gate: block while ``key`` is in a frozen
        migrating range (bounded — cutover or abandon always clears
        the freeze; the wait wakes on either). Called on client
        threads BEFORE any coordinator/cluster lock is taken."""
        kb = canon_key(key)
        with self._gate_cv:
            while True:
                fr = self._frozen_range
                if fr is None:
                    return
                lo, hi = fr
                if kb < lo or (hi is not None and kb >= hi):
                    return
                self._gate_cv.wait(timeout=0.05)

    def note_appends(self, g: int, r: int, take, term: int,
                     end_abs: int) -> None:
        """Stamp-loop hook (cluster.finish, outside the host lock —
        same ABBA contract as the txn coordinator's): learn each seed
        record's ``(term, index)`` placement."""
        with self._lock:
            if not self._records:
                return
            base = end_abs - len(take)
            for i, (_et, c, req, _p) in enumerate(take):
                rec = self._records.get((g, req))
                if rec is None or c != self._conn(g, req):
                    continue
                if rec["index"] < 0:
                    rec["index"] = base + i
                    rec["term"] = term
                    self._terms.note(g, term)

    def observe(self, cluster, res) -> None:
        """finish()-tail hook: epoch-proof seed-record completion
        (committed under an unchanged term), forget-and-retry
        INVALIDATED placements, resubmit dropped records — the same
        rules ``txn/coordinator._observe_decided`` applies, via the
        same shared module. The bound policy's load observer rides
        the same hook — BEFORE the controller lock (the policy lock
        is outermost, see its class doc)."""
        pol = self.policy
        if pol is not None:
            pol.observe(cluster, res)
        with self._lock:
            if self._phase == IDLE or not self._records:
                return
            commit_abs = _epoch.commit_frontier(
                res, self.cluster.rebased_total)
            term_now = _epoch.term_now(res)
            for (g, req), rec in list(self._records.items()):
                st = _epoch.placement_status(rec["index"], rec["term"],
                                             commit_abs[g], term_now[g])
                if st == _epoch.COMPLETE:
                    del self._records[(g, req)]
                elif st == _epoch.INVALIDATED:
                    rec["index"] = -1
                    rec["retry"] = self.cluster.step_index
                elif rec["index"] < 0:
                    lead = self.cluster.leader_hint(g)
                    if (lead >= 0 and self.cluster.step_index
                            > rec["retry"] + _epoch.RETRY_STEPS):
                        rec["retry"] = self.cluster.step_index
                        self.cluster.submit(g, lead, rec["payload"],
                                            conn=self._conn(g, req),
                                            req_id=req)

    def drive(self) -> None:
        """One transition pass, on the stepping thread with the
        dispatch pipeline drained (``_drain_admin``). Enumerate →
        diff → seed deltas; converged ⟹ freeze; frozen + converged +
        verified + quiet ⟹ cutover. Defers (returns) whenever
        anything is still in flight."""
        with self._lock:
            if self._phase == IDLE:
                return
            with self.cluster._host_lock:
                if self.cluster._tickets:
                    return          # not drained — next iteration
            step = self.cluster.step_index
            if step > self._deadline:
                self._abandon("deadline")
                return
            if self._phase == FROZEN and step > self._freeze_deadline:
                self._abandon("freeze_deadline")
                return
            if self._records:
                return              # seed records still proving
            # repair owns any affected group ⟹ give way (abandon if
            # already frozen: repair's config surgery must not wait
            # out a freeze, and nothing served has moved yet)
            busy = {g for g, _r in self.cluster.need_recovery}
            if busy & self._affected:
                if self._phase == FROZEN:
                    self._abandon("repair")
                return
            enum = self._enumerate()
            if enum is None:
                return      # a group is mid-election — a follower's
                # fold can under-report committed state, so never
                # enumerate (or verify) off one; next pass retries
            expected, actual, affected = enum
            self._affected |= affected
            deltas = self._deltas(expected, actual)
            if deltas:
                self._submit_deltas(deltas)
                return
            if self._phase == SEED:
                # converged as-of-now: freeze the range so the NEXT
                # passes only chase the bounded pre-freeze pipeline
                self._phase = FROZEN
                self._freeze_deadline = step + self.freeze_deadline_steps
                with self._gate_cv:
                    self._frozen_range = (self._rule.lo, self._rule.hi)
                tr = self._tracer()
                if tr is not None and self.window_trace is not None:
                    tr.phase(self.window_trace, "freeze")
                self._trace(obs_trace.TOPOLOGY_FROZEN,
                            direction=self._direction, step=step,
                            deadline=self._freeze_deadline)
                self._metric_set("topology_frozen", 1)
                return
            # FROZEN and zero deltas: every pre-freeze write is
            # copied. Verify digests, then cut over — unless a live
            # txn still holds the commit lane (it finishes within the
            # freeze deadline or we abandon).
            txn = getattr(self.cluster, "txn", None)
            if txn is not None and txn.wants_serial():
                return
            digests = {}
            for t in sorted(set(expected) | set(actual)):
                want = sorted(expected.get(t, {}).items())
                # only what t will SERVE post-cutover counts: a
                # donor's left-behind copies (cand routes them away)
                # are invisible orphans, not a divergence
                have = sorted((k, v)
                              for k, v in actual.get(t, {}).items()
                              if self._cand.group_of(k) == t)
                if want != have:
                    return          # raced — next pass re-diffs
                digests[t] = range_digest(want)
            self._last_digest = digests
            tr = self._tracer()
            if tr is not None and self.window_trace is not None:
                tr.phase(self.window_trace, "verify", once=True)
            self._trace(obs_trace.TOPOLOGY_VERIFIED,
                        direction=self._direction, step=step,
                        digests={str(t): d for t, d in digests.items()})
            self._cutover()

    # ---------------- internals (all hold _lock) ----------------

    def _conn(self, g: int, req: int) -> int:
        """Per-record conn id (the coordinator's stamping recipe, its
        own namespace): unique per (group, req) forever."""
        return self.kvs.conn_for(self.SEED_CLIENT_BASE + req, g)

    # holds-lock: _lock
    def _enumerate(self):
        """Walk every group leader's in-range live pairs. Returns
        ``(expected, actual, affected)``: ``expected[t]`` = the exact
        post-cutover content of target ``t`` in the range (from the
        groups that AUTHORITATIVELY own each key under the live
        router), ``actual[t]`` = what ``t``'s table holds in the range
        today, ``affected`` = every group a key moves from or to."""
        lo, hi = self._rule.lo, self._rule.hi
        live, cand = self.kvs.router, self._cand
        expected: Dict[int, Dict[bytes, bytes]] = {}
        holds: Dict[int, Dict[bytes, bytes]] = {}
        affected = set()
        for g in range(self.G):
            lead = self.cluster.leader_hint(g)
            if lead < 0:
                return None     # leaderless — only a LEADER's fold is
                # guaranteed to cover the full committed frontier
            holds[g] = dict(self.kvs.groups[g].items_in_range(
                lead, lo, hi))
        for g, items in holds.items():
            for k, v in items.items():
                if live.group_of(k) != g:
                    continue        # stale seeded copy, not authority
                dst = cand.group_of(k)
                expected.setdefault(dst, {})[k] = v
                if dst != g:
                    affected.add(g)
                    affected.add(dst)
        # a target's actual range content = its own table walk (native
        # keys + seeded copies); include every group we ever touched
        # so stale copies on emptied targets still get deleted
        actual = {t: {k: v for k, v in holds.get(t, {}).items()}
                  for t in set(expected) | self._affected}
        return expected, actual, affected

    # holds-lock: _lock
    def _deltas(self, expected, actual) -> List[Tuple[int, str, bytes, bytes]]:
        """``(group, kind, key, val)`` records that make every
        target's range content equal its expected post-cutover
        content. Only targets are written — donors are never touched
        before cutover."""
        out: List[Tuple[int, str, bytes, bytes]] = []
        for t in set(expected) | set(actual):
            want = expected.get(t, {})
            have = actual.get(t, {})
            for k, v in want.items():
                if have.get(k) != v and self.kvs.router.group_of(k) != t:
                    out.append((t, "put", k, v))
            for k in have:
                if k not in want and self.kvs.router.group_of(k) != t:
                    out.append((t, "rm", k, b""))
        return out

    # holds-lock: _lock
    def _submit_deltas(self, deltas) -> None:
        first = not self.transitions_total and not self._last_digest
        n = 0
        for g, kind, k, v in deltas:
            self._req[g] += 1
            req = self._req[g]
            payload = encode_cmd(
                OP_PUT if kind == "put" else OP_RM, k, v
            ).astype("<i4").tobytes()
            self._records[(g, req)] = dict(
                kind=kind, key=k, payload=payload, index=-1, term=0,
                retry=self.cluster.step_index)
            self._terms.reset(g)
            lead = self.cluster.leader_hint(g)
            self.cluster.submit(g, lead if lead >= 0 else 0, payload,
                                conn=self._conn(g, req), req_id=req)
            n += 1
        tr = self._tracer()
        if tr is not None and self.window_trace is not None:
            # once=True: the FIRST seed pass marks the phase; catch-up
            # passes annotate cumulative record counts instead
            tr.phase(self.window_trace, "seed", once=True)
        self._trace(obs_trace.TOPOLOGY_SEEDED,
                    direction=self._direction, records=n,
                    step=self.cluster.step_index, initial=first)
        self._metric_inc("topology_seed_records_total", n)

    # holds-lock: _lock
    def _cutover(self) -> None:
        """The atomic swap, on the stepping thread with dispatches
        drained. Order is load-bearing and trace-proven: leases
        revoked on every affected group BEFORE the router mutates."""
        from rdma_paxos_tpu_torch.runtime.sim import require_drained
        with self.cluster._host_lock:
            require_drained(self.cluster._tickets, "topology_cutover")
        step = self.cluster.step_index
        leases = getattr(self.cluster, "leases", None)
        if leases is not None:
            for g in sorted(self._affected):
                leases.revoke_any(g, "topology_cutover")
        if self._direction == "split":
            version = self.kvs.router.install_rule(self._rule)
        else:
            version = self.kvs.router.remove_rule(self._rule)
        ep = self.epoch.bump()
        donors = sorted(self._affected - {self._rule.group}) \
            if self._direction == "split" else [self._rule.group]
        targets = sorted(self._affected - set(donors))
        tr = self._tracer()
        if tr is not None and self.window_trace is not None:
            tr.phase(self.window_trace, "cutover")
            tr.annotate(self.window_trace, epoch=ep,
                        router_version=version, donors=donors,
                        targets=targets)
        self._trace(obs_trace.TOPOLOGY_CUTOVER,
                    direction=self._direction, step=step, epoch=ep,
                    router_version=version, donors=donors,
                    targets=targets)
        self.transitions_total += 1
        self._metric_inc("topology_transitions_total",
                         direction=self._direction)
        self._metric_set("topology_epoch", ep)
        # driver hook: fail donor in-flight waiters (their entries may
        # commit in a group the new routing no longer serves for these
        # keys) and unpin their conns so retries re-route
        hook = getattr(self.cluster, "_on_topology_cutover", None)
        if hook is not None:
            hook(donors, targets)
        self._close(done=True)

    # holds-lock: _lock
    def _abandon(self, reason: str) -> None:
        self.abandoned_total += 1
        tr = self._tracer()
        if tr is not None and self.window_trace is not None:
            tr.annotate(self.window_trace, reason=reason)
        self._trace(obs_trace.TOPOLOGY_ABANDONED,
                    direction=self._direction, reason=reason,
                    step=self.cluster.step_index)
        self._metric_inc("topology_abandoned_total", reason=reason)
        self._close(done=False)

    # holds-lock: _lock
    def _close(self, *, done: bool) -> None:
        with self._gate_cv:
            self._frozen_range = None
            self._gate_cv.notify_all()
        self._metric_set("topology_frozen", 0)
        if done:
            self._trace(obs_trace.TOPOLOGY_DONE,
                        direction=self._direction,
                        step=self.cluster.step_index,
                        epoch=self.epoch.current())
        tr = self._tracer()
        if tr is not None and self.window_trace is not None:
            tr.end(self.window_trace,
                   status=("done" if done else "abandoned"))
        if self.window_trace is not None:
            # pointer swap, still under _lock: an in-flight TOPOLOGY
            # abort races the close and must still find the window it
            # was aborted by (coordinator falls back to this one)
            self.last_window_trace = self.window_trace
            self.window_trace = None
        self._phase = IDLE
        self._direction = None
        self._rule = None
        self._cand = None
        self._records.clear()
        self._affected = set()
        self._cooldown_until = (self.cluster.step_index
                                + self.cooldown_steps)

    # ---------------- export ----------------

    def status(self) -> dict:
        with self._lock:
            rule = self._rule
            out = dict(
                phase=self._phase,
                direction=self._direction,
                rule=(rule.to_dict() if rule is not None else None),
                epoch=self.epoch.current(),
                router_version=self.kvs.router.version,
                frozen=self.frozen(),
                records_outstanding=len(self._records),
                affected=sorted(self._affected),
                transitions_total=self.transitions_total,
                abandoned_total=self.abandoned_total,
                cooldown_until=self._cooldown_until,
                deadline=self._deadline,
                digests={str(t): d
                         for t, d in self._last_digest.items()},
            )
        # policy status OUTSIDE the controller lock (the policy lock
        # is outermost — taking it under ours would invert the order)
        pol = self.policy
        out["policy"] = pol.status() if pol is not None else None
        return out

    def _trace(self, kind: str, **fields) -> None:
        if self.obs is not None:
            self.obs.trace.record(kind, **fields)

    def _metric_inc(self, name: str, n: int = 1, **labels) -> None:
        if self.obs is not None:
            self.obs.metrics.inc(name, n, **labels)

    def _metric_set(self, name: str, v, **labels) -> None:
        if self.obs is not None:
            self.obs.metrics.set(name, v, **labels)
