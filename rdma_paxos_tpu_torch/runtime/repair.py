"""Self-healing repair pipeline — DIVERGENCE → quarantine →
digest-verified snapshot re-install → range-digest backfill →
re-admit.

The port's copy of the JAX package's ``runtime/repair.py``, over the
port's ``consensus/snapshot.py`` and range re-digest
(``runtime/sim.py:run_redigest``); ``tests/test_torch_repair.py`` holds
its state, timeline and ledger equal to the reference's.

The audit ledger (``obs/audit.py``) makes silent divergence a detected,
localized failure — it names the exact first ``(term, index)`` and the
minority replica set — but detection alone leaves a corrupted replica
voting, serving, and donating snapshots. The design's promise is that
replica failure is survived and repaired WITHOUT operator action
(leader election + snapshot recovery + live membership), and the
recovery path itself must be fast and verified. This module closes
that loop:

1. **Quarantine** — a new DIVERGENCE finding names a minority replica:
   it is cut from the hear-matrix (no votes, no window absorption —
   the peer-mask machinery partitions/crashes already use), folded
   into the engines' ``need_recovery`` set (replay to the app stops;
   the rebase min excludes it), excluded from client serving and
   leader placement by the drivers, and exported as
   ``replica_quarantined{replica=,group=}`` + a trace event.
2. **Digest-verified snapshot re-install** — the donor comes from the
   ledger's MAJORITY set (never the diverged minority);
   ``take_snapshot(digests=True)`` folds the donor's audit-chain
   position (absolute indices + layout epoch) into the snapshot and
   ``install_snapshot(ledger=...)`` REFUSES a donor whose digests
   contradict the ledger's majority — a corrupted donor is rejected
   at install time, never propagated; the controller retries with the
   next majority donor.
3. **Range-digest backfill** — the ``[lo, hi)`` re-digest pass
   (``consensus/step.py:build_redigest`` — the exact ``audit=`` fold)
   restores gap-free ledger coverage over the repaired range, so the
   cluster returns to *fully-audited* health, not just healed state;
   ``AuditLedger.mark_repaired`` closes the findings.
4. **Re-admit with hysteresis** — the replica rejoins consensus
   immediately (it must absorb windows to catch up) but serves
   clients again only after ``probation_steps`` clean audited steps;
   a repeat divergence during probation re-quarantines.
5. **Bounded retry/backoff** — a repair attempt that exhausts every
   donor backs off (linearly growing, in STEP-domain time so chaos
   replays are bit-reproducible) and after ``max_attempts`` escalates
   to a LATCHED page (``repair_escalated_total`` →
   ``repair_failed`` in ``obs/alerts.py:default_rules``) instead of
   looping forever.

Threading contract (the pipelined driver): :meth:`observe` runs after
every finished step — host bookkeeping only, safe on the readback
thread. :meth:`drive` performs the state surgery and runs ONLY on a
drained serial iteration (the drivers' ``_pipeline_ready`` returns
False while :meth:`needs_drain`, the same ``require_drained``/deferral
contract ``_drive_config_change`` uses), under the engine's host lock;
per-group quarantine never stalls healthy groups — their dispatches
resume the moment the one drained repair iteration returns. Every
write to the engine's state makes new tensors (``install_snapshot``)
or edits the host-side ``peer_mask``: step outputs alias the state.

Engine-agnostic: works on ``SimCluster`` (single group) and
``ShardedCluster`` (per group) through the shared snapshot/redigest
primitives; drivers can override the install with a hook that also
transfers stores/app state (``ClusterDriver._do_recover``).
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from rdma_paxos_tpu_torch.consensus.snapshot import (
    SnapshotVerifyError, install_snapshot, recover_vote, take_snapshot)
from rdma_paxos_tpu_torch.runtime.hostpath import stream_copy as _stream_copy

QUARANTINED = "quarantined"
PROBATION = "probation"
ESCALATED = "escalated"


class RepairController:
    """The quarantine→repair→backfill→re-admit state machine, driven
    from the cluster drivers' poll loops (or a chaos runner)."""

    def __init__(self, cluster, *, obs=None, probation_steps: int = 6,
                 max_attempts: int = 3, backoff_steps: int = 8,
                 min_verified: int = 1, install_hook=None,
                 post_install=None, storm_policy: bool = False,
                 storm_min: int = 3):
        if cluster.auditor is None:
            raise ValueError("repair requires an audit=True cluster "
                             "(the ledger is the donor-selection and "
                             "verification authority)")
        if getattr(cluster, "_fanout", "gather") == "psum":
            # quarantine isolation IS a peer-mask cut, and the psum
            # fan-out rejects any non-full mask at dispatch — the
            # first quarantine would kill the serving loop mid-heal.
            # Fail at construction, the way partitions/chaos do.
            raise ValueError(
                "repair requires fanout='gather' (quarantine cuts the "
                "hear-matrix; psum fan-out rejects non-full masks)")
        self.cluster = cluster
        self.led = cluster.auditor
        self.obs = obs
        self._sharded = np.asarray(cluster.applied).ndim == 2
        self.G = int(getattr(cluster, "G", 1))
        self.R = int(cluster.R)
        self.probation_steps = int(probation_steps)
        self.max_attempts = int(max_attempts)
        self.backoff_steps = int(backoff_steps)
        self.min_verified = int(min_verified)
        # driver hooks: install_hook(g, r, donor) REPLACES the
        # engine-level install (e.g. ClusterDriver._do_recover — store
        # transfer + app replay included; must raise
        # SnapshotVerifyError on a bad donor so donor retry works);
        # post_install(g, r, donor) runs AFTER the engine-level
        # install (e.g. the sharded driver's replay-cursor fixup);
        # on_quarantine(g, r) fires on each NEW quarantine, invoked
        # OUTSIDE the controller lock (the sharded driver fails the
        # held front-end's commit waiters there — a hook that takes
        # the driver lock must never nest inside ours, the reverse
        # edge already exists via the serving gates).
        self.install_hook = install_hook
        self.post_install = post_install
        self.on_quarantine = None
        self._lock = threading.RLock()
        # (g, r) -> dict(state=, attempts=, next_try=, clean=,
        #                finding=, last_step=)
        # guarded-by: _lock
        self.states: Dict[Tuple[int, int], dict] = {}
        # deterministic evidence: step-domain events only (no wall
        # clock) so same-seed chaos verdicts embed identical timelines.
        # Bounded like every other evidence surface (trace ring /
        # flight recorder): a long-lived flapping replica must not
        # grow an unbounded list that every health() poll then copies.
        self.timeline: collections.deque = collections.deque(
            maxlen=256)
        self.timeline_dropped = 0
        self._seen_findings = 0
        self.repairs_done = 0
        self.donors_rejected = 0
        self.escalations = 0
        # telemetry-triggered quarantine policy (opt-in): a firing
        # election_storm page (device-truth elections_started rate,
        # obs/device.py series) quarantines the storming replica
        # WITHOUT a digest finding — link cut + serving/lease/read
        # refusal + probation, but no snapshot re-install (its state
        # never diverged; the storm is a liveness hazard, not a
        # correctness one)
        self.storm_policy = bool(storm_policy)
        self.storm_min = int(storm_min)
        self._storm_prev: Dict[str, float] = {}
        self._storm_tick = 0
        self.policy_quarantines = 0

    # ------------------------------------------------------------------
    # helpers over the two engine shapes
    # ------------------------------------------------------------------

    def _key_of_recovery(self, g: int, r: int):
        return (g, r) if self._sharded else r

    def _rebased(self, g: int) -> int:
        rt = self.cluster.rebased_total
        return int(rt[g]) if self._sharded else int(rt)

    def _applied(self, g: int, r: int) -> int:
        a = self.cluster.applied
        return int(a[g, r]) if self._sharded else int(a[r])

    def _step_index(self) -> int:
        return int(self.cluster.step_index)

    def _cut_mask(self, g: int, r: int) -> None:
        pm = self.cluster.peer_mask
        if self._sharded:
            pm[g, r, :] = 0
            pm[g, :, r] = 0
            pm[g, r, r] = 1
        else:
            pm[r, :] = 0
            pm[:, r] = 0
            pm[r, r] = 1

    # holds-lock: _lock
    def _restore_mask(self, g: int, r: int) -> None:
        # restore hearing to every peer EXCEPT ones this controller
        # still holds — re-opening a link to a second, still-diverged
        # quarantined replica would break ITS isolation invariant.
        # Quarantine composes with the chaos link models (they refine
        # the base mask per step), but not with a concurrently
        # scripted base partition of the same replica; drivers never
        # do both.
        pm = self.cluster.peer_mask
        still_cut = {rr for (gg, rr), st in self.states.items()
                     if gg == g and rr != r
                     and st["state"] in (QUARANTINED, ESCALATED)}
        for p in range(self.R):
            if p in still_cut:
                continue
            if self._sharded:
                pm[g, r, p] = 1
                pm[g, p, r] = 1
            else:
                pm[r, p] = 1
                pm[p, r] = 1

    def _block_reads(self, g: int, r: int) -> None:
        """Bar ``(g, r)`` from read serving for the WHOLE hold
        (quarantine through probation): ``need_recovery`` alone does
        not cover policy holds (their replay keeps running) and is
        discarded at install time, before probation ends."""
        rb = getattr(self.cluster, "read_blocked", None)
        if rb is not None:
            rb.add(self._key_of_recovery(g, r))

    def _unblock_reads(self, g: int, r: int) -> None:
        rb = getattr(self.cluster, "read_blocked", None)
        if rb is not None:
            rb.discard(self._key_of_recovery(g, r))

    def _revoke_lease(self, g: int, r: int) -> None:
        """A held replica must not serve lease reads: revoke BEFORE
        serving gates react (runtime/reads.py — revocation arms the
        wait-out barrier so no successor lease activates early)."""
        lm = getattr(self.cluster, "leases", None)
        if lm is not None:
            lm.revoke(g, r, reason="quarantine")

    def _gauge(self, g: int, r: int, v: int) -> None:
        if self.obs is not None:
            self.obs.metrics.set("replica_quarantined", v,
                                 replica=r, group=g)

    def _trace(self, event: str, **fields) -> None:
        if self.obs is not None:
            self.obs.trace.record(event, **fields)

    def _mark(self, event: str, g: int, r: int, **extra) -> None:
        rec = dict(event=event, step=self._step_index(), group=g,
                   replica=r, **extra)
        if len(self.timeline) == self.timeline.maxlen:
            self.timeline_dropped += 1      # ring full: oldest evicted
        self.timeline.append(rec)
        self._trace(event, **{k: v for k, v in rec.items()
                              if k != "event"})

    # ------------------------------------------------------------------
    # observation (every finished step; readback-thread safe)
    # ------------------------------------------------------------------

    def observe(self) -> None:
        """Consume new ledger findings (quarantine newly implicated
        minority replicas) and advance probation hysteresis — host
        bookkeeping only; never touches device state."""
        # keep the storm-attribution baseline FRESH on a stride: the
        # deltas _storm_replicas reads must reflect recent elections,
        # not lifetime totals — an un-refreshed baseline would blame
        # whichever replica churned most EVER (e.g. early-run leader
        # churn) instead of the replica storming NOW. The stride keeps
        # the per-step registry snapshot off most observe passes.
        if self.storm_policy and self.obs is not None:
            self._storm_tick += 1
            if self._storm_tick % 8 == 0:
                with self._lock:
                    self._storm_refresh()
        newly_q: List[Tuple[int, int]] = []
        with self._lock:
            findings = self.led.findings
            fresh = findings[self._seen_findings:]
            self._seen_findings = len(findings)
            implicated: Set[Tuple[int, int]] = set()
            for f in fresh:
                if f.get("type", "DIVERGENCE") != "DIVERGENCE":
                    continue        # epoch refusals are config errors
                for r in f["got_replicas"]:
                    key = (int(f.get("group", 0)), int(r))
                    implicated.add(key)
                    if self._quarantine(key[0], key[1], f):
                        newly_q.append(key)
            # probation: N clean audited steps before serving again —
            # AND a closed audit trail (a backfill whose coverage was
            # still accruing re-checks here until it closes)
            step = self._step_index()
            for key, st in list(self.states.items()):
                if st["state"] != PROBATION:
                    continue
                if key in implicated:
                    continue        # _quarantine already re-flagged it
                if st.get("pending") is not None and \
                        self._try_close(key[0], key[1], st["pending"]):
                    st["pending"] = None
                # one clean unit per OBSERVED audit pass, not per
                # step-index delta: a K=8 fused burst is one audited
                # observation, and must not satisfy the whole
                # hysteresis in a single post-repair window
                if step > st["last_step"]:
                    st["clean"] += 1
                    st["last_step"] = step
                if st["clean"] >= self.probation_steps \
                        and st.get("pending") is None:
                    self._readmit(key)
        # hooks fire OUTSIDE the controller lock (see __init__)
        if self.on_quarantine is not None:
            for (g, r) in newly_q:
                try:
                    self.on_quarantine(g, r)
                except Exception:  # noqa: BLE001 — a failing hook
                    pass           # must never kill the observe pass

    # holds-lock: _lock
    def _quarantine(self, g: int, r: int, finding: dict) -> bool:
        """Returns True when ``(g, r)`` newly entered (or re-entered)
        quarantine this call."""
        key = (g, r)
        st = self.states.get(key)
        if st is not None and st["state"] == QUARANTINED:
            return False            # already isolated
        if st is not None and st["state"] == ESCALATED:
            return False            # latched — operator territory
        c = self.cluster
        with c._host_lock:
            c.need_recovery.add(self._key_of_recovery(g, r))
            self._block_reads(g, r)
            self._cut_mask(g, r)
        self._revoke_lease(g, r)
        attempts = st["attempts"] if st is not None else 0
        self.states[key] = dict(
            state=QUARANTINED, attempts=attempts,
            next_try=self._step_index(), clean=0, finding=dict(finding),
            last_step=self._step_index())
        self._gauge(g, r, 1)
        if self.obs is not None:
            self.obs.metrics.inc("replicas_quarantined_total",
                                 replica=r, group=g)
        self._mark("replica_quarantined", g, r,
                   index=finding.get("index"),
                   term=finding.get("term"),
                   requarantine=st is not None)
        return True

    # ------------------------------------------------------------------
    # repair drive (drained serial iterations only)
    # ------------------------------------------------------------------

    def needs_drain(self) -> bool:
        """True iff a repair action is due — the drivers' pipeline
        gates read this (same deferral contract as config changes)."""
        with self._lock:
            step = self._step_index()
            return any(st["state"] == QUARANTINED
                       and st["next_try"] <= step
                       for st in self.states.values())

    def drive(self) -> List[Tuple[int, int]]:
        """Attempt due repairs. Runs the state surgery, so callers
        must be on the drained serial path; with dispatches still in
        flight the call DEFERS (returns []) exactly like
        ``_drive_config_change``. Returns the (group, replica) keys
        repaired this call (chaos runners reset their invariant
        baselines for them)."""
        c = self.cluster
        topo = getattr(c, "topology", None)
        if topo is not None and topo.frozen():
            # a topology cutover is mid-freeze: repair's config
            # surgery must not interleave with the router swap — give
            # way for the (step-bounded) freeze. Symmetric rule: the
            # topology window abandons its freeze the moment repair
            # quarantines a replica in an affected group, so neither
            # side can wait the other out.
            return []
        with c._host_lock:
            if c._tickets:
                return []           # defer until the pipeline drains
        repaired: List[Tuple[int, int]] = []
        with self._lock:
            step = self._step_index()
            due = sorted(k for k, st in self.states.items()
                         if st["state"] == QUARANTINED
                         and st["next_try"] <= step)
            for key in due:
                if self._repair_one(key):
                    repaired.append(key)
        return repaired

    # holds-lock: _lock
    def _donor_candidates(self, g: int, r: int) -> List[int]:
        """Majority-set donor order: never the diverged minority (the
        ledger's implicated set), never another quarantined replica;
        most caught-up first (Raft's election ordering picks donors
        the same way)."""
        bad = {rr for rr in range(self.R)
               if (g, rr) in self.states}
        bad |= self.led.implicated_replicas(g)
        cands = [p for p in range(self.R) if p != r and p not in bad]
        return sorted(cands, key=lambda p: (-self._applied(g, p), p))

    # holds-lock: _lock
    def _repair_one(self, key: Tuple[int, int]) -> bool:
        g, r = key
        st = self.states[key]
        if st.get("policy"):
            # policy quarantine (no digest finding): the replica's
            # state never diverged, so there is nothing to re-install
            # or backfill — restore its links and let the clean-step
            # probation hysteresis gate re-admission (a repeat storm
            # during probation re-quarantines via on_alert)
            with self.cluster._host_lock:
                self._restore_mask(g, r)
            st.update(state=PROBATION, clean=0, pending=None,
                      last_step=self._step_index())
            self._mark("repair_policy_released", g, r,
                       reason=st["finding"].get("reason"))
            return True
        for donor in self._donor_candidates(g, r):
            try:
                snap_info = self._install_from(g, r, donor)
            except RuntimeError as exc:
                # SnapshotVerifyError = donor corrupted/unverifiable;
                # other RuntimeErrors (e.g. a driver install_hook's
                # store mismatch) also mean "this donor won't do" —
                # either way, try the next majority donor, never die
                self.donors_rejected += 1
                if self.obs is not None:
                    self.obs.metrics.inc("repair_donor_rejected_total",
                                         group=g)
                self._mark("repair_donor_rejected", g, r, donor=donor,
                           verify=isinstance(exc, SnapshotVerifyError),
                           error=str(exc)[:160])
                continue
            # success: backfill coverage, close findings, probation.
            # If the coverage verdict is not yet gap-free+majority
            # (the newest indices lag one lazy-push step behind the
            # followers' re-reports), the range stays PENDING and the
            # probation pass re-checks it every step — re-admission
            # requires BOTH the clean-step hysteresis AND the closed
            # audit trail.
            pending = self._backfill(g, r, donor, snap_info)
            st.update(state=PROBATION, clean=0, pending=pending,
                      last_step=self._step_index())
            self.repairs_done += 1
            if self.obs is not None:
                self.obs.metrics.inc("repairs_total", group=g)
            return True
        # no donor worked: back off; escalate past the retry budget
        st["attempts"] += 1
        if st["attempts"] >= self.max_attempts:
            st["state"] = ESCALATED
            self.escalations += 1
            if self.obs is not None:
                # the LATCHED page signal: counter_nonzero never
                # un-fires (obs/alerts.py default rule repair_failed)
                self.obs.metrics.inc("repair_escalated_total", group=g)
            self._mark("repair_escalated", g, r,
                       attempts=st["attempts"])
        else:
            st["next_try"] = (self._step_index()
                              + self.backoff_steps * st["attempts"])
            self._mark("repair_backoff", g, r, attempts=st["attempts"],
                       next_try=st["next_try"])
        return False

    def _install_from(self, g: int, r: int, donor: int) -> dict:
        """One digest-verified snapshot transfer donor→r; raises
        SnapshotVerifyError (propagated to donor retry) on a
        corrupted/unverifiable donor, BEFORE any state changes."""
        c = self.cluster
        reb = self._rebased(g)
        if self.install_hook is not None:
            self.install_hook(g, r, donor)
            snap_index = self._applied(g, r)
            audit_lo_raw = None       # hook path: derive from head
        else:
            grp = g if self._sharded else None
            snap = take_snapshot(
                c.state, donor, index=self._applied(g, donor),
                group=grp, digests=True, rebased_total=reb)
            vt, vf = recover_vote(c.state, r, group=grp)
            with c._host_lock:
                c.state = install_snapshot(
                    c.state, r, snap, voted_term=vt, voted_for=vf,
                    group=grp, ledger=self.led, ledger_group=g,
                    min_verified=self.min_verified)
                if self._sharded:
                    c.applied[g, r] = snap.index
                    c.replayed[g][r] = _stream_copy(
                        c.replayed[g][donor])
                    c.frames[g][r] = []
                else:
                    c.applied[r] = snap.index
                    c.replayed[r] = _stream_copy(c.replayed[donor])
                    c.frames[r] = []
            snap_index = snap.index
            # the verified chain may have been truncated from below
            # (slot recycled mid-capture): the backfill must cover
            # exactly the range the snapshot PROVED, not re-derive it
            # from a head that has moved since
            audit_lo_raw = (snap.audit_start - reb
                            if snap.audit_start >= 0 else None)
            if self.post_install is not None:
                self.post_install(g, r, donor)
        with c._host_lock:
            c.need_recovery.discard(self._key_of_recovery(g, r))
            self._restore_mask(g, r)
        # the re-installed replica's next reports legitimately differ
        # from its pre-repair memory — the self-recheck must not flag
        self.led.reset_replica(g, r)
        self._mark("repair_installed", g, r, donor=donor,
                   index=snap_index + reb)
        return dict(donor=donor, index=snap_index, rebased=reb,
                    audit_lo=audit_lo_raw)

    def _backfill(self, g: int, r: int, donor: int,
                  info: dict) -> Optional[dict]:
        """Range re-digest over the donor's physically-present
        committed range. The findings close (``mark_repaired``) ONLY
        once :meth:`AuditLedger.coverage` verdicts the range gap-free
        and majority-held — an immediate pass when the live windows
        already co-signed the whole range, else the range is returned
        as PENDING and the probation pass re-checks it every step
        (the newest indices lag the followers' re-reports by one
        lazy-push step; a genuinely un-coverable range keeps the
        findings open, the page latched, and re-admission blocked —
        the audit trail never claims closure it cannot prove)."""
        c = self.cluster
        reb = info["rebased"]
        hi_raw = info["index"]
        lo_raw = info.get("audit_lo")
        if lo_raw is None:
            # driver install_hook path (no snapshot in hand): the
            # donor's ring floor bounds the re-digestable range
            if self._sharded:
                head = int(c.state.head[g, donor])
            else:
                head = int(c.state.head[donor])
            lo_raw = max(head, 0)
        n = 0
        try:
            if hi_raw > lo_raw:
                if self._sharded:
                    n = c.redigest(g, donor, lo_raw, hi_raw)
                else:
                    n = c.redigest(donor, lo_raw, hi_raw)
        except RuntimeError as exc:
            # a slot recycled under the re-digest (or a transient
            # integrity failure) must degrade to an OPEN audit trail
            # — never crash the serving poll loop the drive() caller
            # sits on. The range stays pending-with-zero-coverage:
            # findings stay open, the divergence page stays latched,
            # the replica stays in probation for the operator.
            self._mark("repair_backfill_error", g, r, donor=donor,
                       lo=lo_raw + reb, hi=hi_raw + reb,
                       error=str(exc)[:160])
            return dict(lo=lo_raw + reb, hi=hi_raw + reb, donor=donor,
                        indices=0)
        lo_abs, hi_abs = lo_raw + reb, hi_raw + reb
        pend = dict(lo=lo_abs, hi=hi_abs, donor=donor, indices=n)
        if self._try_close(g, r, pend):
            return None
        self._mark("repair_backfill_pending", g, r, donor=donor,
                   lo=lo_abs, hi=hi_abs, indices=n)
        return pend

    def _try_close(self, g: int, r: int, pend: dict) -> bool:
        """Attempt audit-trail closure for a backfilled range: when
        coverage is gap-free + majority-held, ``mark_repaired`` closes
        the findings and the closure is recorded. False = still
        pending (re-checked from the probation pass)."""
        cov = self.led.coverage(g, pend["lo"], pend["hi"])
        if pend["indices"] == 0 or not cov["ok"]:
            return False
        rec = self.led.mark_repaired(
            g, r, pend["lo"], pend["hi"], donor=pend["donor"],
            index=pend["hi"], step=self._step_index())
        if self.obs is not None:
            self.obs.metrics.inc("repair_backfilled_indices_total",
                                 pend["indices"], group=g)
        self._mark("repair_backfilled", g, r, donor=pend["donor"],
                   lo=rec["lo"], hi=rec["hi"],
                   indices=pend["indices"])
        return True

    # holds-lock: _lock
    def _readmit(self, key: Tuple[int, int]) -> None:
        g, r = key
        del self.states[key]
        self._unblock_reads(g, r)
        self._gauge(g, r, 0)
        if self.obs is not None:
            self.obs.metrics.inc("repair_readmitted_total", group=g)
        self._mark("repair_readmitted", g, r,
                   probation=self.probation_steps)

    # ------------------------------------------------------------------
    # driver queries
    # ------------------------------------------------------------------

    def serving_blocked(self, g: int, r: int) -> bool:
        """True while ``(g, r)`` must not serve clients or hold
        leadership (quarantined, on probation, or escalated)."""
        with self._lock:
            return (g, r) in self.states

    def serving_blocked_any(self, r: int) -> bool:
        """True while replica ``r`` is held in ANY group — the sharded
        front-end admission gate (a held replica's replay for the held
        group is frozen, so sessions it admits could stall on acks)."""
        with self._lock:
            return any(rr == r for (_g, rr) in self.states)

    def owned(self) -> Set:
        """``need_recovery`` members this controller manages — the
        drivers' default auto-recovery must leave them alone (keys in
        the engine's own need_recovery shape)."""
        with self._lock:
            return {self._key_of_recovery(g, r)
                    for (g, r) in self.states}

    def blocked_replicas_locked(self, group: int) -> Set[int]:
        """Caller holds ``self._lock``."""
        return {r for (g, r) in self.states if g == group}

    def blocked_replicas(self, group: int = 0) -> Set[int]:
        with self._lock:
            return self.blocked_replicas_locked(group)

    def on_alert(self, name: str, severity: str) -> None:
        """Alert→action hook (``AlertEngine.add_hook``): a firing
        digest-divergence page triggers an immediate findings scan so
        quarantine never waits for the next step's observe pass; a
        firing election-storm page (with ``storm_policy=True``)
        quarantines the storming replica without a digest finding."""
        if name == "digest_divergence":
            self.observe()
        elif name == "election_storm" and self.storm_policy:
            self._storm_quarantine()

    def _storm_refresh(self) -> Dict[Tuple[int, int], float]:
        """Advance the per-series storm baseline and return the
        per-(group, replica) deltas since the previous refresh — read
        from the registry's
        ``device_elections_started_total{replica=,group=}`` series
        (the device-truth surface the election_storm rule fires on)."""
        from rdma_paxos_tpu_torch.obs.alerts import _split_key
        deltas: Dict[Tuple[int, int], float] = {}
        snap = self.obs.metrics.snapshot()["counters"]
        for key, total in snap.items():
            base, labels = _split_key(key)
            if base != "device_elections_started_total":
                continue
            delta = total - self._storm_prev.get(key, 0)
            self._storm_prev[key] = total
            if delta <= 0:
                continue
            gr = (int(labels.get("group", 0)),
                  int(labels.get("replica", -1)))
            if gr[1] >= 0:
                deltas[gr] = deltas.get(gr, 0) + delta
        return deltas

    def _storm_replicas(self) -> List[Tuple[int, int]]:
        """The replicas whose DEVICE election counter advanced most
        since the last baseline refresh (recent activity, not
        lifetime totals — observe() keeps the baseline fresh)."""
        if self.obs is None:
            return []
        deltas = self._storm_refresh()
        worst = max(deltas.values(), default=0)
        if worst < self.storm_min:
            return []
        return sorted(gr for gr, d in deltas.items() if d == worst)

    def _storm_quarantine(self) -> List[Tuple[int, int]]:
        held = []
        with self._lock:
            for (g, r) in self._storm_replicas():
                # never cut the group below a connected majority: the
                # digest path holds one implicated minority finding at
                # a time, and the policy path gets the same budget —
                # two rivals storming in lock-step must not combine
                # into a self-inflicted total outage
                already = len(self.blocked_replicas_locked(g))
                if already + 1 > (self.R - 1) // 2:
                    self._mark("storm_hold_refused", g, r,
                               held=already)
                    continue
                if self._policy_quarantine(g, r, "election_storm"):
                    held.append((g, r))
        if self.on_quarantine is not None:
            for (g, r) in held:        # hooks outside our lock
                try:
                    self.on_quarantine(g, r)
                except Exception:  # noqa: BLE001 — hooks never kill
                    pass           # the alert-evaluating poll loop
        return held

    # holds-lock: _lock
    def _policy_quarantine(self, g: int, r: int,
                           reason: str) -> bool:
        """Quarantine WITHOUT a digest finding (caller holds our
        lock): link cut + serving/lease refusal, but the replica's
        replay keeps running (its state is not suspect) and drive()
        releases it straight to probation — no install, no
        backfill."""
        if (g, r) in self.states:
            return False            # already held / escalated
        with self.cluster._host_lock:
            self._cut_mask(g, r)
            self._block_reads(g, r)
        self._revoke_lease(g, r)
        step = self._step_index()
        self.states[(g, r)] = dict(
            state=QUARANTINED, attempts=0, next_try=step, clean=0,
            finding=dict(type="POLICY", reason=reason),
            last_step=step, policy=True)
        self.policy_quarantines += 1
        self._gauge(g, r, 1)
        if self.obs is not None:
            self.obs.metrics.inc("replicas_policy_quarantined_total",
                                 replica=r, group=g)
        self._mark("replica_quarantined", g, r, policy=True,
                   reason=reason)
        return True

    def status(self) -> dict:
        """Deterministic (step-domain, no wall clock) state export for
        health snapshots, chaos verdicts, and reproducer artifacts."""
        with self._lock:
            return dict(
                active={f"{g}:{r}": dict(st, finding=None)
                        for (g, r), st in self.states.items()},
                repairs_done=self.repairs_done,
                donors_rejected=self.donors_rejected,
                escalations=self.escalations,
                policy_quarantines=self.policy_quarantines,
                probation_steps=self.probation_steps,
                max_attempts=self.max_attempts,
                timeline=[dict(t) for t in self.timeline],
                timeline_dropped=self.timeline_dropped,
            )
