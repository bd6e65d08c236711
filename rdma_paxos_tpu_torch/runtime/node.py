"""NodeDaemon — the per-host replica process for REAL multi-host clusters.

One of these runs on every host (the reference's per-machine app process
with ``interpose.so`` injected, ``benchmarks/run.sh:24-33``): it owns the
host's slice of the distributed consensus state (one replica, on the
card unless the caller passes ``device="cpu"``), the proxy socket its
interposed app connects to, the loopback replay engine, the stable
store, and the election timer.

Lock-step discipline: every loop iteration issues exactly ONE collective
call — the protocol step (or one fused burst/scan) — so all hosts stay
consistent regardless of how their local values differ; the
committed-window fetch is HOST-LOCAL (it reads only this replica's log)
and runs only on iterations where commit advanced. Hosts synchronize
through the step's collectives themselves (a host that runs ahead blocks
in the next step until peers arrive), exactly as the reference's
followers synchronize through RDMA completion semantics. A watchdog
stamps a warning into the replica log when one iteration stalls far
beyond the cadence — the symptom of a desynced or dead peer (the elastic
supervisor reacts by regenerating the world; see runtime/elastic.py).

The port of the JAX package's ``runtime/node.py`` over
:class:`~rdma_paxos_tpu_torch.runtime.host.HostReplicaDriver` (a gloo
world; a card's tensors cross it through host copies). The constructor
adds ``device`` and ``timeout`` (gloo's rendezvous and collective
bound, so a dead peer ends the loop with an exception). The ``RP_*``
switches are the reference's and must match on every host. Bursts
default on for the card and off for the CPU (the reference: on for the
TPU); ``RP_BURST`` overrides. ``restore_hardstate`` and
``install_genesis`` are local in the port; every daemon still calls
them at construction, in the reference's order. ``steps`` counts the
protocol steps dispatched (a burst or scan counts K). The reference
arms no runtime lock sanitizer here, and neither does the port.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from rdma_paxos_tpu_torch.config import (
    LogConfig, MAX_BURST_K, REBASE_STALL_STEPS, TimeoutConfig)
from rdma_paxos_tpu_torch.consensus.log import EntryType, M_GIDX
from rdma_paxos_tpu_torch.runtime import hostpath
from rdma_paxos_tpu_torch.runtime.driver import conn_origin
from rdma_paxos_tpu_torch.consensus.state import Role
from rdma_paxos_tpu_torch.obs import default as obs_default, trace as obs_trace
from rdma_paxos_tpu_torch.obs.metrics import LATENCY_BUCKETS_S
from rdma_paxos_tpu_torch.obs.spans import StepPhaseProfiler
from rdma_paxos_tpu_torch.proxy.proxy import (
    PendingEvent, ProxyServer, ReplayEngine, spec_send_refused_dirty)
from rdma_paxos_tpu_torch.proxy.stablestore import HardState, StableStore
from rdma_paxos_tpu_torch.runtime.host import HostReplicaDriver
from rdma_paxos_tpu_torch.runtime.timers import ElectionTimer
from rdma_paxos_tpu_torch.utils.codec import fragment
from rdma_paxos_tpu_torch.utils.debug import ReplicaLog


class NodeDaemon:
    def __init__(self, cfg: LogConfig, *, process_id: int,
                 num_processes: int, coordinator: str,
                 workdir: str, app_port: Optional[int] = None,
                 timeout_cfg: Optional[TimeoutConfig] = None,
                 group_size: Optional[int] = None, seed: int = 0,
                 host_id: Optional[int] = None,
                 genesis: Optional[dict] = None, gen: int = 0,
                 device=None, timeout: float = 60.0):
        self.cfg = cfg
        self.me = process_id
        # elastic generation number: namespaces this incarnation's
        # submit sequence (req stamps) and connection counters, so log
        # entries carried over from a PREVIOUS incarnation of this same
        # host can neither falsely ack this incarnation's inflight
        # events nor be mistaken for events this incarnation's app
        # already served (they must be REPLAYED into the rebuilt app)
        self.gen = gen
        # persistent host identity: stamps connection origins (conn_id >>
        # 24), so replay-vs-ack decisions survive slot renumbering across
        # elastic generations (process_id is the SLOT in this world; the
        # host_id is forever)
        self.host_id = process_id if host_id is None else host_id
        # RP_AUDIT=1 compiles the digest-chain step variant (must MATCH
        # on every host — the audit program is part of the collective
        # schedule) and records this replica's digest windows into a
        # local AuditLedger, dumped on a cadence to
        # <workdir>/replica<me>.audit.json; merge the per-host dumps
        # with `python -m rdma_paxos_tpu_torch.obs.audit report ...` for the
        # cross-replica first-divergence verdict. The local ledger
        # alone already catches post-commit corruption of THIS host's
        # log memory (re-reported windows are self-checked).
        self._audit = os.environ.get("RP_AUDIT") == "1"
        self.hd = HostReplicaDriver(
            cfg, process_id=process_id, num_processes=num_processes,
            coordinator=coordinator, group_size=group_size,
            audit=self._audit, device=device, timeout=timeout)
        if genesis is not None:
            # elastic world rebuild: every member installs the identical
            # donor-derived row (all daemons of the generation pass a
            # genesis or none do)
            self.hd.install_genesis(genesis)
        os.makedirs(workdir, exist_ok=True)
        self._lock = threading.Lock()
        self._is_leader = False
        self._submitq: List[Tuple[int, int, bytes, int]] = []
        self.inflight: collections.deque = collections.deque()
        self.submit_seq = 0   # per-incarnation; entries carry M_GEN so
                              # cross-incarnation req compares never happen
        self.applied = int(genesis["apply"]) if genesis is not None else 0
        self.needs_recovery = False   # force-pruned past our apply cursor
        # mis-speculation quarantine (same contract as ClusterDriver): a
        # SPECULATIVE app (shim HELLO flag) that consumed inputs failed
        # at deposition has diverged from the committed stream — the
        # store keeps persisting, the app gets nothing until rebuilt
        # (reset_app / generation bootstrap_from_store)
        self.app_dirty = False
        self.replicated_conns: set = set()
        self.passthrough_conns: set = set()
        self.sock_path = os.path.join(workdir, f"proxy{self.me}.sock")
        self.proxy = ProxyServer(self.sock_path, self.host_id,
                                 self._on_event,
                                 conn_ctr_start=(gen % 16) << 20)
        self.replay = (ReplayEngine("127.0.0.1", app_port)
                       if app_port else None)
        # stable files are keyed by the PERSISTENT host id: a restarted
        # host finds its own history regardless of which slot the new
        # generation assigns it
        self.store = StableStore(
            os.path.join(workdir, f"host{self.host_id}.db"))
        self.hard = HardState(
            os.path.join(workdir, f"host{self.host_id}.db.hs"))
        # a RESTARTED daemon restores its persisted election state so it
        # cannot double-vote in a term it voted in before the crash
        # (every daemon calls this during init, with zeros when no prior
        # state exists)
        hs = self.hard.load()
        self.hd.restore_hardstate(*(hs if hs is not None else (0, 0, -1)))
        # per-host daemon: structured signals go to the process-global
        # obs facade (one daemon per process in deployment, so no
        # cross-instance mixing); the greppable log file is preserved
        self.obs = obs_default()
        # step-phase attribution for the lock-step loop (host encode /
        # device dispatch / apply / ack release). On this multi-host
        # path hd.step's output readback already blocks on results, so
        # device_dispatch includes device time; RP_FENCE=1 opts into
        # the explicit fence anyway.
        self._phase_prof = StepPhaseProfiler(
            metrics=self.obs.metrics,
            fence=os.environ.get("RP_FENCE") == "1", replica=self.me)
        # total i32-rollover offset this incarnation applied: spans are
        # keyed by ABSOLUTE indices, invariant across rebases
        self._rebased_total = 0
        self.log = ReplicaLog(
            os.path.join(workdir, f"replica{self.me}.log"),
            replica=self.me, obs=self.obs)
        self.timer = ElectionTimer(timeout_cfg or TimeoutConfig(),
                                   seed=seed + process_id)
        if self._audit:
            from rdma_paxos_tpu_torch.obs.audit import AuditLedger
            self.auditor = AuditLedger(num_processes, obs=self.obs)
            self._audit_path = os.path.join(
                workdir, f"replica{self.me}.audit.json")
        else:
            self.auditor = None
            self._audit_path = None
        self._audit_write_period = 5.0
        self._audit_last_write = float("-inf")
        # ops plane (the per-host half of the fleet console's view):
        # time-series retention sampled on the alert cadence —
        # persisted as replica<me>.series.jsonl, so merging N hosts'
        # series is a file concat — feeding the window-domain SLO
        # rules (rate_window / burn_rate), plus the per-host health
        # snapshot file the console merges across hosts
        from rdma_paxos_tpu_torch.obs.health import HealthReporter
        from rdma_paxos_tpu_torch.obs.series import TimeSeriesStore
        self.series = TimeSeriesStore(
            path=os.path.join(workdir,
                              f"replica{self.me}.series.jsonl"),
            source=f"replica{self.me}")
        self._health = HealthReporter(workdir, period=1.0)
        # SLO alert rules over the process-global registry, evaluated
        # on a cadence from the lock-step loop (obs/alerts.py)
        from rdma_paxos_tpu_torch.obs.alerts import AlertEngine, default_rules
        self.alerts = AlertEngine(self.obs.metrics,
                                  rules=default_rules(),
                                  trace=self.obs.trace,
                                  series=self.series)
        self._alert_period = 1.0
        self._alert_last = float("-inf")
        self.iterations = 0       # the daemon's step-domain clock for
                                  # series points (one per iterate())
        self.steps = 0            # protocol steps dispatched (K a burst)
        # RP_METRICS_PORT: opt-in ops exporter (obs/export.py) —
        # /metrics /healthz /series /alerts on localhost; "0" binds
        # an ephemeral port (read it back from daemon.exporter.port).
        # Host-side only — the exporter never joins the collective
        # schedule, so hosts may disagree on it freely.
        self.exporter = None
        port = os.environ.get("RP_METRICS_PORT")
        if port is not None and port != "":
            from rdma_paxos_tpu_torch.obs.export import OpsExporter
            self.exporter = OpsExporter(
                registry=self.obs.metrics, health_fn=self.health,
                alerts=self.alerts, series=self.series,
                port=int(port)).start()
        # RP_GOVERNOR=1: the adaptive-dispatch governor's multi-host
        # half (runtime/governor.py:HintGovernor). Its decision —
        # burst / serial step / bounded admission coalesce — derives
        # ONLY from the gathered burst_hint (the PR 6 k_needed
        # contract), so every host derives the same collective program
        # schedule with zero extra collectives. Like RP_BURST/RP_SCAN
        # the env must MATCH on every host. Content (what the leader
        # actually packs) stays local and never changes program shape.
        self.governor = None
        if os.environ.get("RP_GOVERNOR") == "1":
            from rdma_paxos_tpu_torch.runtime.governor import HintGovernor
            self.governor = HintGovernor(cfg.batch_slots)
        # RP_CDC=1: change-data-capture export — every committed
        # client entry this daemon applies is appended to
        # <workdir>/replica<me>.cdc.jsonl in audit-chain coordinates
        # (term, absolute index) with the retained window digests, so
        # `python -m rdma_paxos_tpu_torch.streams verify` can prove the
        # export against the replica's audit dump. Host-side only —
        # never joins the collective schedule.
        self.cdc = None
        if os.environ.get("RP_CDC") == "1":
            from rdma_paxos_tpu_torch.streams.cdc import CDCWriter
            self.cdc = CDCWriter(
                os.path.join(workdir, f"replica{self.me}.cdc.jsonl"),
                auditor=self.auditor, obs=self.obs)
        self.last: Optional[Dict] = None
        self._rebase_warned = False
        # consecutive post-threshold iterations with the gathered
        # rebase_delta pinned at 0 (a heard-but-lagging row's low head
        # — the consensus/step.py liveness gap, ADVICE.md #3)
        self._rebase_stall_steps = 0
        self.rebase_stalled = 0

    # single multihost burst tier (see iterate) — identical on all
    # hosts; == config.MAX_BURST_K, which the rebase-headroom
    # validation in LogConfig accounts for
    BURST_K = MAX_BURST_K

    # consecutive zero-delta post-threshold iterations before the
    # stall is surfaced — shared with SimCluster
    # (config.REBASE_STALL_STEPS)
    REBASE_STALL_STEPS = REBASE_STALL_STEPS

    @property
    def scan_enabled(self) -> bool:
        """RP_SCAN=1 routes burst iterations through the K-window scan
        tier (``HostReplicaDriver.step_scan``): same fused protocol
        steps, but the readback is one consolidated scalar matrix plus
        this replica's replay window staged INSIDE the dispatch — the
        per-window ``fetch_local_window`` dispatches disappear. Like
        RP_BURST, the env must MATCH on every host (program schedule
        is collective); requires bursts (and their psum gate)."""
        return (self.burst_enabled
                and os.environ.get("RP_SCAN") == "1")

    @property
    def burst_enabled(self) -> bool:
        """Bursts amortize per-DISPATCH overhead — the card's ~530
        launches per step — and buy nothing on the CPU multi-process
        test harness, where per-collective cross-process syncs dominate
        and a fused K-step call costs the same collectives as K
        separate steps. Default: on for the card, off for the CPU;
        RP_BURST=1/0 overrides (must MATCH on all hosts — burst
        engagement is part of the collective schedule).

        Bursts additionally REQUIRE full connectivity: K is agreed via
        the gathered burst_hint (a max over the leaders each replica
        heard), so an asymmetric peer_mask lets hosts disagree on K and
        call different collective programs — a distributed hang, not a
        clean failure. psum fan-out is the full-connectivity
        configuration (HostReplicaDriver.step refuses psum with any
        masked peer), so bursts are gated on it; under fanout='gather'
        (the partition-simulation mode) bursts stay off regardless of
        device or RP_BURST."""
        if self.hd._fanout != "psum":
            return False
        env = os.environ.get("RP_BURST")
        if env is not None:
            return env == "1"
        return self.hd.device.type == "cuda"

    def prewarm_burst(self) -> None:
        """COLLECTIVE: one empty K-step burst before serving (every host
        calls this at the same point, right after construction) —
        harmless pre-election (no leader, nothing appends). The port
        compiles nothing here, but the burst advances the step schedule
        exactly as the reference's prewarm does. No-op when bursts are
        disabled."""
        if self.scan_enabled:
            self.hd.step_scan(self.BURST_K, [], apply_done=self.applied,
                              gen=self.gen)
            self.steps += self.BURST_K
        elif self.burst_enabled:
            self.hd.step_burst(self.BURST_K, [], apply_done=self.applied,
                               gen=self.gen)
            self.steps += self.BURST_K

    # ------------------------------------------------------------------

    def _on_event(self, etype: int, conn_id: int, payload: bytes):
        with self._lock:
            if etype == int(EntryType.CONNECT):
                port = (int.from_bytes(payload[4:6], "big")
                        if len(payload) >= 6 else 0)
                if (self.replay is not None
                        and port in self.replay.local_ports):
                    self.passthrough_conns.add(conn_id)
                    return None
                if self.app_dirty:
                    # a dirty (mis-speculated) app serves nothing —
                    # not even stale local reads
                    return -1
                if not self._is_leader:
                    return None
                self.replicated_conns.add(conn_id)
                payload = b""
            elif conn_id in self.passthrough_conns:
                if etype == int(EntryType.CLOSE):
                    self.passthrough_conns.discard(conn_id)
                return None
            elif conn_id not in self.replicated_conns:
                return None
            elif self.app_dirty:
                self.replicated_conns.discard(conn_id)
                return -1
            elif not self._is_leader:
                if etype == int(EntryType.CLOSE):
                    self.replicated_conns.discard(conn_id)
                    return None
                # refusal strands bytes a speculative app already
                # executed: quarantine (shared policy with ClusterDriver
                # — proxy.spec_send_refused_dirty)
                if spec_send_refused_dirty(etype, conn_id,
                                           self.replicated_conns,
                                           self.proxy, self.app_dirty):
                    self.app_dirty = True
                    self.log.info_wtime(
                        "APP DIRTY: speculated SEND refused at intake "
                        "(conn %d)" % conn_id)
                return -1
            if etype == int(EntryType.CLOSE):
                self.replicated_conns.discard(conn_id)
            frags = (fragment(payload, self.cfg.slot_bytes)
                     if etype == int(EntryType.SEND) else [payload])
            ev = PendingEvent(EntryType(etype), conn_id, payload)
            for f in frags:
                self.submit_seq += 1
                self._submitq.append((etype, conn_id, f, self.submit_seq))
            self.inflight.append((ev, self.submit_seq))
            self.obs.spans.begin(conn_id, self.submit_seq, self.me)
            return ev

    # ------------------------------------------------------------------

    def iterate(self) -> Dict:
        """One lock-step loop iteration (call in unison on every host).

        BURST MODE: the previous step's gathered ``burst_hint`` (the
        leader's submit backlog, identical on every host under full
        connectivity) lets all hosts agree — with no extra collective —
        to fuse the next K protocol steps into ONE dispatch. K is
        derived ONLY from the gathered hint (local state like ring
        occupancy differs across hosts and would desync the collective
        program); the leader clamps the batch CONTENT it actually packs
        by its local capacity, which never changes program shape."""
        B = self.cfg.batch_slots
        prof = self._phase_prof
        prof.start("host_encode")
        hint = (int(self.last["burst_hint"])
                if self.last is not None
                and self.last.get("burst_hint") is not None else 0)
        if not self.burst_enabled:
            hint = 0
        k_needed = -(-hint // B) if hint > 0 else 0
        # RP_GOVERNOR=1: burst / step / coalesce from the gathered
        # hint ONLY — all hosts run the same pure decision function
        # over the same gathered sequence, so the collective program
        # schedule stays agreed (tests pin the agreement). "coalesce"
        # = one serial heartbeat iteration that HOLDS the local batch
        # (admission wait, bounded by the governor), so the next
        # burst ships a fuller window.
        hold_batch = False
        if self.governor is not None and self.burst_enabled:
            tier = self.governor.decide(hint)
            self.obs.metrics.inc("dispatch_tier", tier=(
                "burst%d" % self.BURST_K if tier == "burst" else
                "serial"))
            if tier == "coalesce":
                k_needed = 0
                hold_batch = True
                self.obs.metrics.inc("governor_coalesce_total",
                                     replica=self.me)
        # fused bursts are the DEFAULT e2e path: ANY gathered backlog
        # rides the one fixed-K burst program (shallow content padded
        # with empty steps), so per-dispatch overhead is amortized the
        # moment traffic exists — the single-step path serves only
        # idle heartbeats and election iterations. The decision derives
        # ONLY from the gathered hint, so every host agrees.
        scan_rows = None            # (wd, wm) staged by the scan tier
        if k_needed >= 1:
            # ONE fixed burst tier (the reference compiles exactly one
            # multi-process burst program, at boot via prewarm_burst):
            # shallow bursts pad with empty steps, as there
            K = self.BURST_K
            with self._lock:
                # content clamp (local): ring free space so mid-burst
                # drops (which would reorder a connection's fragments
                # against later burst steps) cannot occur
                avail = ((self.cfg.n_slots - 1)
                         - (int(self.last["end"])
                            - int(self.last["head"])))
                take_n = min(len(self._submitq), max(avail, 0), K * B)
                take = self._submitq[:take_n]
                self._submitq = self._submitq[take_n:]
                qdepth = len(self._submitq)
            batches = [[(t, c, s, f) for (t, c, f, s)
                        in take[k * B:(k + 1) * B]] for k in range(K)]
            import time as _t
            _t0 = _t.monotonic()
            prof.stop("host_encode")
            prof.start("device_dispatch")
            if self.scan_enabled:
                # K-window scan tier: this replica's replay window
                # rides the dispatch — consumed by the apply loop
                # below before any standalone fetch
                res, scan_rows = self.hd.step_scan(
                    K, batches, apply_done=self.applied,
                    gen=self.gen, queue_depth=qdepth)
            else:
                res = self.hd.step_burst(K, batches,
                                         apply_done=self.applied,
                                         gen=self.gen,
                                         queue_depth=qdepth)
            prof.stop("device_dispatch")
            self.steps += K
            if os.environ.get("RP_BURST_DEBUG"):
                self.log.info_wtime(
                    "BURST K=%d take=%d dt=%.3fs" %
                    (K, len(take), _t.monotonic() - _t0))
            # every burst step carried the heartbeat; follower timers
            # are beaten below via hb_seen / leadership
        else:
            with self._lock:
                # a coalescing iteration holds the batch (admission
                # wait) — the heartbeat still ships, the entries ride
                # the next, fuller, burst
                take = [] if hold_batch else self._submitq[:B]
                if take:
                    self._submitq = self._submitq[B:]
                qdepth = len(self._submitq)
            # (etype, conn, req_seq, payload) rows for make_input
            batch = [(t, c, s, f) for (t, c, f, s) in take]

            fire = False
            if not self._is_leader and self.timer.expired():
                fire = True
                self.timer.beat()

            prof.stop("host_encode")
            prof.start("device_dispatch")
            res = self.hd.step(batch=batch, timeout_fired=fire,
                               apply_done=self.applied, gen=self.gen,
                               queue_depth=qdepth)
            prof.stop("device_dispatch")
            self.steps += 1
            take_n = len(take)
        if take and int(res["role"]) == int(Role.LEADER):
            # ring-full shortfall: the appended set is a PREFIX of the
            # submitted rows — requeue the rest in order (a deposed
            # host's remainder is dropped; its events fail below)
            acc = int(res["accepted"]) if res["accepted"] is not None else 0
            spans = self.obs.spans
            if spans.open_count and acc > 0:
                # the accepted prefix landed at absolute indices
                # [end-acc, end): stamp each sampled span's (term,
                # index) correlation key — this host only observes its
                # own commit/apply frontiers (merges align cross-host)
                end_abs = int(res["end"]) + self._rebased_total
                term = int(res["term"])
                for i, (_t_, c, _f, s) in enumerate(take[:acc]):
                    spans.stamp_append(c, s, term, end_abs - acc + i,
                                       self.me, replicas=(self.me,))
            if acc < take_n:
                with self._lock:
                    self._submitq = take[acc:] + self._submitq
        if self.auditor is not None \
                and res.get("audit_digest") is not None:
            # BEFORE the rollover below: the emitted indices are raw,
            # consistent with the current _rebased_total
            self._ingest_audit(res)
        self.hard.save(int(res["term"]), int(res["voted_term"]),
                       int(res["voted_for"]))
        was_leader = self._is_leader
        with self._lock:
            self._is_leader = int(res["role"]) == int(Role.LEADER)
        if res["became_leader"]:
            self.log.leader_elected(int(res["term"]))
        if res["hb_seen"] or self._is_leader:
            self.timer.beat()

        # window drain only when commit advanced — the scan tier's
        # staged rows serve the first window with ZERO extra
        # dispatches; any remainder falls back to the host-local
        # fetch (reads our own log shard, loops independently): a
        # burst can commit up to K*batch_slots entries in one
        # dispatch, so drain window-by-window until caught up
        commit = int(res["commit"])
        progressed = False
        releases = []
        released_upto = -1
        prof.start("apply")

        def own_of(conns, gens):
            # "our own event" means THIS incarnation's (M_GEN column
            # matches our generation): its app thread already consumed
            # the bytes live — ack it. An entry from a previous
            # incarnation of this host is replayed like a remote one:
            # the rebuilt app has never seen it.
            return ((conn_origin(conns) == self.host_id)
                    & (gens == self.gen))

        while self.applied < commit and not self.needs_recovery:
            n = min(commit - self.applied, self.cfg.window_slots)
            if scan_rows is not None and scan_rows[0] is not None:
                wd, wm = scan_rows      # staged at this apply cursor
                scan_rows = None
            else:
                wd, wm = self.hd.fetch_local_window(self.applied)
            if int(wm[0, M_GIDX]) != self.applied:
                # our slot was recycled (forced pruning left this host
                # behind): recycled bytes must never reach the app —
                # stop applying and wait for recovery (the elastic
                # supervisor rebuilds us from a donor snapshot)
                self.needs_recovery = True
                self.log.info_wtime(
                    "PRUNED past apply cursor %d — snapshot "
                    "recovery required" % self.applied)
                break
            progressed = True
            # vectorized window decode + batched persist/replay/ack
            # (the shared host data plane): one framed-store append,
            # one replay plan, one ack-frontier pop per window
            batch = hostpath.decode_batch(wm, wd, n,
                                          self._rebased_total)
            if batch is not None:
                self.store.append_framed(batch.frames())
                if self.cdc is not None:
                    # RP_CDC=1: export the committed client entries in
                    # audit coordinates before acks release (an
                    # exported record is always also in the store)
                    self.cdc.write_batch(batch)
                own = own_of(batch.conns, batch.gens)
                own_max, ops = hostpath.replay_plan(
                    batch, own,
                    want_ops=(self.replay is not None
                              and not self.app_dirty))
                if own_max >= 0:
                    with self._lock:
                        while (self.inflight
                               and self.inflight[0][1] <= own_max):
                            ev, _ = self.inflight.popleft()
                            releases.append(ev)
                    released_upto = max(released_upto, own_max)
                if self.replay is not None and not self.app_dirty:
                    # dirty app: persist only — replay resumes after
                    # the app is rebuilt from the committed store
                    for etype, conn, payload in ops:
                        self.replay.apply(etype, conn, payload)
            self.applied += n
        prof.stop("apply")
        if progressed:
            if self.replay is not None:
                self.replay.drain_responses()
            # persist BEFORE acking (the reference's persist_new_entries
            # precedes apply/ack): a client ack implies the event is in
            # this host's stable store
            self.store.sync()
        # span frontiers BEFORE the ack marks (a span's commit/apply
        # precede its ack causally — recording them after would invert
        # the critical-path timestamps): this host observes only its
        # own replica's frontiers, in ABSOLUTE indices, and must run
        # before the rebase below (res offsets and _rebased_total are
        # both still pre-rollover here); cross-host correlation happens
        # at merge time via (term, index)
        spans = self.obs.spans
        if spans.open_count:
            spans.commit_advance(self.me, commit + self._rebased_total)
            spans.apply_advance(self.me,
                                self.applied + self._rebased_total)
        prof.start("ack_release")
        import time as _time
        _now = _time.perf_counter()
        for ev in releases:
            ev.release(0)
            self.obs.metrics.observe(
                "commit_latency_seconds", _now - ev.t0,
                buckets=LATENCY_BUCKETS_S, replica=self.me)
        if releases:
            self.obs.trace.record(obs_trace.PROXY_ACK_RELEASE,
                                  replica=self.me,
                                  count=len(releases))
            self.obs.spans.ack_release(self.me, released_upto)
        prof.stop("ack_release")
        if not self._is_leader:
            with self._lock:
                if (self.inflight and self.proxy.spec_mode
                        and not self.app_dirty):
                    # a speculative app already EXECUTED the inputs being
                    # failed: quarantine until rebuilt (reset_app or the
                    # next generation's bootstrap_from_store)
                    self.app_dirty = True
                    self.log.info_wtime(
                        "APP DIRTY: %d speculated events failed at "
                        "deposition" % len(self.inflight))
                n_failed = len(self.inflight)
                while self.inflight:
                    ev, _ = self.inflight.popleft()
                    ev.release(-1)
                if n_failed:
                    # deposed with blocked waiters: their spans must
                    # close (failover), never leak
                    self.obs.spans.fail_open(self.me)
        # coordinated i32-offset rollover: the gathered rebase_delta is
        # identical on every host under full connectivity (psum fan-out
        # — the only configuration this daemon bursts or rebases in), so
        # every host applies the same subtraction in the same iteration.
        # The rebase program itself is elementwise (no collectives), so
        # no cross-host ordering hazard exists even in principle.
        rd = res.get("rebase_delta")
        if rd is not None and int(rd) > 0:
            if self.hd._fanout == "psum":
                delta = int(rd)
                self.hd.rebase(delta)
                self.applied -= delta
                self._rebased_total += delta
                self._rebase_stall_steps = 0     # re-arm stall detect
                self.obs.metrics.inc("rebases_total")
                self.obs.trace.record(obs_trace.REBASE_APPLIED,
                                      replica=self.me, delta=delta)
                self.log.info_wtime(
                    "REBASE: offsets dropped by %d (i32 rollover)"
                    % delta)
            elif not self._rebase_warned:
                # under gather fan-out the gathered delta is NOT
                # guaranteed identical across hosts (heard masks can
                # differ), so applying it could diverge offsets — but
                # silently discarding it would let the i32 ceiling
                # arrive unannounced. Warn loudly, once.
                self._rebase_warned = True
                self.log.info_wtime(
                    "WARNING: rebase_delta=%d ignored (fanout=%r is "
                    "not full-connectivity); offsets are approaching "
                    "the i32 ceiling with no rollover possible"
                    % (int(rd), self.hd._fanout))
        elif int(res["end"]) >= self.cfg.rebase_threshold:
            # end crossed the threshold but the gathered delta stayed 0
            # — a heard-but-lagging row (stalled learner) is pinning
            # the min head, and the rollover will never fire on its
            # own. Surface it so operators see the i32 ceiling
            # approaching in the psum path too (ADVICE.md #3).
            self._rebase_stall_steps += 1
            if self._rebase_stall_steps >= self.REBASE_STALL_STEPS:
                self.rebase_stalled += 1
                self.obs.metrics.inc("rebase_stalled")
                if self._rebase_stall_steps == self.REBASE_STALL_STEPS:
                    self.obs.trace.record(
                        obs_trace.REBASE_STALLED, replica=self.me,
                        end=int(res["end"]),
                        threshold=self.cfg.rebase_threshold,
                        steps=self._rebase_stall_steps)
                    self.log.info_wtime(
                        "REBASE STALLED: end=%d crossed threshold=%d "
                        "but rebase_delta stayed 0 for %d steps — a "
                        "lagging heard row is pinning the min head; "
                        "the i32 ceiling is approaching"
                        % (int(res["end"]), self.cfg.rebase_threshold,
                           self._rebase_stall_steps))
        # per-iteration host gauges (role/term/progress/headroom): the
        # structured twin of the log file, exported with every snapshot
        self.obs.metrics.set("replica_role", int(res["role"]),
                             replica=self.me)
        self.obs.metrics.set("replica_term", int(res["term"]),
                             replica=self.me)
        self.obs.metrics.set("commit_index", commit, replica=self.me)
        self.obs.metrics.set("rebase_headroom",
                             self.cfg.rebase_threshold
                             - int(res["end"]), replica=self.me)
        self.obs.metrics.set("cluster_leader", int(res["leader_id"]))
        with self._lock:
            self.obs.metrics.set("inflight_waiters", len(self.inflight),
                                 replica=self.me)
        self.iterations += 1
        self.last = res      # before the cadence block: health()
                             # must read THIS iteration's outputs
        import time as _tmono
        now = _tmono.monotonic()
        if now - self._alert_last >= self._alert_period:
            self._alert_last = now
            # series sampling shares the snapshot with the rule pass
            # (the drivers' cadence contract), then the per-host
            # health file refreshes — the surface the fleet console
            # and the elastic supervisor watch from outside
            snap = self.obs.metrics.snapshot()
            self.series.sample(snap, step=self.iterations)
            self.alerts.evaluate(snap=snap)
            try:
                self._health.write({self.me: self.health()})
            except OSError:
                pass     # observability I/O never kills the loop
        if (self._audit_path is not None and self.auditor is not None
                and now - self._audit_last_write
                >= self._audit_write_period):
            self._audit_last_write = now
            try:
                self.auditor.write_json(self._audit_path)
            except OSError:
                pass     # evidence I/O must never kill the data path
        return res

    def _ingest_audit(self, res: Dict) -> None:
        """Record this replica's digest windows (single step or every
        fused burst step) into the local ledger in ABSOLUTE indices."""
        led = self.auditor
        W = self.cfg.window_slots
        reb = self._rebased_total
        dig = res["audit_digest"]
        if dig.ndim == 1:
            rows = [(int(res["audit_start"]), int(res["commit"]),
                     dig, res["audit_term"])]
        else:                              # burst: [K, W] windows
            rows = [(int(res["audit_start"][k]),
                     int(res["audit_commit"][k]), dig[k],
                     res["audit_term"][k])
                    for k in range(dig.shape[0])]
        for start, commit, d, t in rows:
            n = commit - start
            if n <= 0:
                continue
            off = start - (commit - W)
            led.record_window(self.me, start + reb, d[off:off + n],
                              t[off:off + n], commit + reb)

    def health(self) -> Dict:
        """THIS host's replica health snapshot (the obs.health
        per-replica schema plus daemon extras) — written to
        ``replica<me>.health.json`` on the reporter cadence, served
        at ``/healthz`` when RP_METRICS_PORT is set, and merged
        across hosts by the fleet console (N daemon files = one
        cluster seen from N sides)."""
        from rdma_paxos_tpu_torch.obs.health import make_snapshot
        res = getattr(self, "last", None)
        with self._lock:
            inflight = len(self.inflight)
        return make_snapshot(
            replica=self.me,
            host_id=self.host_id,
            gen=self.gen,
            role=(int(res["role"]) if res is not None else -1),
            term=(int(res["term"]) if res is not None else 0),
            leader_id=(int(res["leader_id"]) if res is not None
                       else -1),
            commit=(int(res["commit"]) if res is not None else 0),
            apply=self.applied,
            end=(int(res["end"]) if res is not None else 0),
            head=(int(res["head"]) if res is not None else 0),
            log_headroom=(self.cfg.rebase_threshold
                          - (int(res["end"]) if res is not None
                             else 0)),
            inflight=inflight,
            app_dirty=self.app_dirty,
            needs_recovery=self.needs_recovery,
            rebase_stalled=self.rebase_stalled,
            store=self.store.stats(),
            alerts=self.alerts.state(),
            audit=(self.auditor.summary()
                   if self.auditor is not None else None),
        )

    def bootstrap_from_store(self) -> None:
        """Rebuild a FRESH local app instance by replaying the stable
        store's full event history into it. Call once at generation
        start, before the first ``iterate`` — the supervisor restarts
        the app, this fills it."""
        from rdma_paxos_tpu_torch.proxy.proxy import replay_store_into
        replay_store_into(self.store, self.replay)
        self.app_dirty = False

    def reset_app(self, app_port: Optional[int] = None) -> None:
        """Exit mis-speculation quarantine: the supervisor restarted the
        app FRESH; rebuild it from this host's own committed store and
        resume live replay."""
        if self.replay is not None:
            self.replay.close()
            self.replay = ReplayEngine(
                "127.0.0.1",
                app_port if app_port is not None else self.replay.addr[1])
        self.bootstrap_from_store()
        self.log.info_wtime("APP RESET: rebuilt from committed store")

    def dump_row(self) -> dict:
        """THIS replica's full consensus state row (host numpy) — what
        the supervisor persists at generation exit and serves to the next
        generation's members if elected donor."""
        return self.hd.export_local_row()

    def meta(self, row: Optional[dict] = None) -> Dict[str, int]:
        """Donor-election metadata: Raft's up-to-date ordering key plus
        progress offsets (the controller picks the donor by
        ``(last_log_term, end)`` — Leader Completeness). Pass a
        pre-exported ``row`` to avoid a second device read."""
        from rdma_paxos_tpu_torch.consensus.log import M_TERM
        if row is None:
            row = self.dump_row()
        end = int(row["end"])
        lterm = 0
        if end > 0:
            slot = (end - 1) & (self.cfg.n_slots - 1)
            lterm = int(row["log_buf"][slot,
                                       self.cfg.slot_words + M_TERM])
        # donor eligibility: a usable recovery point must PHYSICALLY
        # hold every entry from its host apply cursor onward (a
        # force-pruned laggard does not — installing its row would wedge
        # the whole new generation at the first M_GIDX check)
        usable = int(not self.needs_recovery
                     and self.applied >= int(row["head"])
                     and self.applied >= end - self.cfg.n_slots)
        return dict(term=int(row["term"]), last_log_term=lterm,
                    end=end, commit=int(row["commit"]),
                    apply=int(row["apply"]), applied=self.applied,
                    leader=int(self._is_leader), usable=usable)

    def run_iterations(self, n: int, period: float = 0.0,
                       watchdog_secs: float = 60.0) -> None:
        """Run exactly ``n`` lock-step iterations (every host must use the
        same ``n`` — collective programs must match across hosts). An
        iteration blocked in the step's collectives for more than
        ``watchdog_secs`` (compiles excluded by using the post-first-
        iteration baseline) logs a desync warning."""
        import time
        for i in range(n):
            t0 = time.monotonic()
            self.iterate()
            dt = time.monotonic() - t0
            if i > 0 and dt > watchdog_secs:
                self.log.info_wtime(
                    f"WATCHDOG: iteration blocked {dt:.1f}s — peer "
                    "desync or death suspected")
            if period:
                time.sleep(period)

    def close(self) -> None:
        if self.auditor is not None and self._audit_path is not None:
            try:
                self.auditor.write_json(self._audit_path)
            except OSError:
                pass
        if self.exporter is not None:
            self.exporter.close()
        try:
            # final health snapshot — the post-exit state the console
            # (and a postmortem bundle) reads after the process is gone
            self._health.write({self.me: self.health()})
        except OSError:
            pass
        if self.cdc is not None:
            self.cdc.close()
        self.series.close()
        self.proxy.close()
        if self.replay:
            self.replay.close()
        self.store.close()
        self.log.close()
