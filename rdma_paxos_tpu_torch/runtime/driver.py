"""ClusterDriver — the host polling loop gluing every layer together.

The port of the JAX package's ``runtime/driver.py``: the analog of the
reference's per-replica libev loop (``polling()``,
``dare_server.c:1004-1125``) plus the proxy callbacks, driving ALL
replicas of an in-process cluster whose engine runs on the card:

  interposed app ──UDS──▶ ProxyServer ──queue──▶ ClusterDriver.step()
        ▲                                            │ SimCluster (replica
        │ loopback TCP                               ▼  step on the card)
  ReplayEngine ◀──committed entries──┬── StableStore.append (persist)
                                     └── ack release (leader's blocked app)

Per iteration: drain shim events into leader batches → run the replica
step (one ``commit_window`` kernel launch per protocol step) → persist
newly applied entries → replay remote-origin entries into local apps →
release blocked app threads whose events committed → run election
timers (heartbeat = the step itself). With ``pipeline >= 2`` the stable
traffic path is double-buffered: a dispatch thread encodes and enqueues
while a readback thread finishes tickets and runs the post-step rules.
Both threads make the engine's card their current device and use its
current stream; the only host sync of a step is ``finish``'s readback.

The read path runs as in the JAX driver: ``leases=True`` (the default)
attaches ``runtime/reads.py``'s leader leases and read hub to the
engine, :meth:`read` queues a linearizable read that the readback
thread serves without a ring slot, and a step-down revokes the leader's
lease. A chaos ``link_model`` may be attached (the loop then never
idles: the drill owns its timing).

``txn=True`` runs the engine's serial steps with the cross-group
transaction lane, so a coordinator can be attached
(``txn.attach_coordinator`` over a ``ShardedKVS`` on the sharded
driver's cluster); while it has a transaction in flight
(``wants_serial``) the loop gives way from bursts and pipelining, keeps
stepping, and :meth:`health` carries its ``health()`` as ``txn``.

The alert and health plane runs as in the JAX driver: the registry is
sampled into ``series`` and the SLO rules of ``alerts`` are evaluated on
the ``alert_period`` cadence (:meth:`evaluate_alerts`; a newly firing
page on an audited cluster writes the audit artifact), the
``health_period`` cadence writes the health files under a workdir,
:meth:`health` is the live cluster document and :meth:`serve_metrics`
the localhost exporter (``/metrics`` ``/healthz`` ``/series``
``/alerts``). All of it is host work off the dispatch path and touches
no CUDA tensor. ``repair=True`` (with ``audit=True``) attaches the
self-healing controller (``runtime/repair.py``): quarantine on a digest
finding, a digest-verified install through :meth:`_do_recover`, the
range re-digest, probation and re-admission; its surgery runs on the
drained serial path, a held leader is deposed and a held replica
admits no client session. ``governor=True`` attaches the dispatch
governor (``runtime/governor.py``), whose decision caps the burst tier,
turns pipelining on and off, and adds a bounded admission wait; both
hang on the alert engine's hooks. ``scan=True`` runs the engine's scan
tier on the burst path. ``streams=True`` attaches the streams hub
(``streams/``: range scans, watch, and CDC export to
``<workdir>/cdc.jsonl`` unless ``streams_opts`` names a path); stop
fails its subscriptions and flushes its sink. An elastic-topology
controller on the engine (``topology.attach_topology``) runs its
passes on the drained serial path and holds pipelining while its
window is open.

Differences from the JAX driver, each failing loudly:

* Profiler captures (:meth:`start_profile`, :meth:`stop_profile`,
  ``profile_on_page``) run ``torch.profiler`` through
  ``obs/device.py:ProfilerSession``, bounded by the observe pass as in
  the JAX driver.
* ``audit=True`` and ``telemetry=True`` run as in the JAX driver: the
  engine's ledger and flight ring (dumped by
  :meth:`_dump_audit_artifact` into ``audit_artifact``) and its
  ``device_*`` counter series, ingested on the readback thread.
* Snapshot recovery (:meth:`recover_replica`, :meth:`reset_app`,
  :meth:`checkpoint_app` with ``app_snapshot=``, and the automatic
  recovery of a force-pruned replica) runs as in the JAX driver;
  ``_do_recover(ledger=...)`` is the digest-verified install the repair
  controller calls. Each install runs under the engine's host lock with
  no dispatch in flight. Unlike the JAX driver, :meth:`recover_replica`
  and :meth:`reset_app` return only once the fresh app has consumed its
  replayed history (the checkpoint's barrier), not as soon as it is
  delivered.
"""

from __future__ import annotations

import collections
import gc
import os
import queue as _queue
import shutil
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
from rdma_paxos_tpu_torch.consensus.log import EntryType
from rdma_paxos_tpu_torch.consensus.membership import MembershipManager
from rdma_paxos_tpu_torch.consensus.snapshot import (
    install_snapshot, recover_vote, take_snapshot)
from rdma_paxos_tpu_torch.consensus.state import ConfigState, Role
from rdma_paxos_tpu_torch.obs import Observability, trace as obs_trace
from rdma_paxos_tpu_torch.obs.alerts import AlertEngine, default_rules
from rdma_paxos_tpu_torch.obs.health import (
    HealthReporter, make_cluster_snapshot, make_snapshot)
from rdma_paxos_tpu_torch.obs.metrics import (
    BATCH_BUCKETS, LATENCY_BUCKETS_S, LATENCY_BUCKETS_US)
from rdma_paxos_tpu_torch.obs.series import TimeSeriesStore
from rdma_paxos_tpu_torch.obs.spans import StepPhaseProfiler, span_trace_id
from rdma_paxos_tpu_torch.obs.tracectx import health_blame as _health_blame
from rdma_paxos_tpu_torch.proxy.proxy import (
    PendingEvent, ProxyServer, ReplayEngine, replay_store_into,
    spec_send_refused_dirty)
from rdma_paxos_tpu_torch.proxy.stablestore import (
    HardState, StableStore, atomic_write)
from rdma_paxos_tpu_torch.runtime.hostpath import plan_segment
from rdma_paxos_tpu_torch.runtime.sim import SimCluster, require_drained
from rdma_paxos_tpu_torch.runtime.timers import ElectionTimer
from rdma_paxos_tpu_torch.utils.debug import ReplicaLog
from rdma_paxos_tpu_torch.utils.codec import fragment

# the origin replica lives in the conn id's bits 24+ (ProxyServer)
CONN_ORIGIN_SHIFT = 24

# StepPhaseProfiler phases of the driver's two threads beyond the
# engine's (obs/spans.py, and runtime/sim.py's finish_rules), so that
# every moment of both is named. Only intake_lock_wait and store_sync
# nest (in submit_pump, ack_release and apply_replay_ack); gc overlaps
# whatever its thread was doing.
PHASE_PIPELINE_WAIT = "pipeline_wait"    # dispatch: tickets in flight
PHASE_SUBMIT_PUMP = "submit_pump"        # dispatch: intake -> pending
PHASE_INTAKE_LOCK_WAIT = "intake_lock_wait"  # acquiring the intake lock
PHASE_IDLE_PARK = "idle_park"            # dispatch: parked, no work
PHASE_READBACK_IDLE = "readback_idle"    # readback: waiting for a ticket
PHASE_POST_STEP_RULES = "post_step_rules"  # _post_step's host rules
PHASE_CADENCE = "cadence"                # alerts, series, health files
PHASE_STORE_SYNC = "store_sync"          # the stable store's fdatasync
PHASE_GC = "gc"                          # one collection (gc.callbacks)


def conn_origin(conn_id):
    """Origin replica/host encoded in a connection id (scalar
    or elementwise on numpy columns) — the ONE place the
    encoding lives."""
    return conn_id >> CONN_ORIGIN_SHIFT


class _ReplicaRuntime:
    """Host-side per-replica resources."""

    def __init__(self, idx: int, sock_path: Optional[str],
                 app_port: Optional[int], store_path: Optional[str],
                 on_event, timeout_cfg: TimeoutConfig, seed: int,
                 log_path: Optional[str] = None, obs=None):
        self.idx = idx
        self.log = ReplicaLog(log_path, replica=idx, obs=obs)
        self.proxy = (ProxyServer(sock_path, idx, on_event, obs=obs)
                      if sock_path else None)
        self.app_port = app_port
        self.replay = (ReplayEngine("127.0.0.1", app_port)
                       if app_port else None)
        # a SPECULATIVE app (shim HELLO flag) consumed input that was
        # failed at deposition — its state may have diverged from the
        # committed stream. While dirty: committed entries still persist
        # to the store (the store is the source of truth), but nothing
        # is replayed into the app and new client sessions are severed.
        self.app_dirty = False
        self.last_sync = 0.0      # cadenced store fdatasync bookkeeping
        self.store = StableStore(store_path) if store_path else None
        # durable (term, voted_term, voted_for) — persisted every step the
        # pair changes (election safety across crashes)
        self.hard = HardState(store_path + ".hs") if store_path else None
        # PendingEvent FIFO awaiting commit, each stamped with its last
        # fragment's seq — every access must hold the driver lock (link
        # threads append, poll thread pops)
        self.inflight: collections.deque = collections.deque()
        self.submit_seq = 0       # monotone per-fragment sequence; stamped
                                  # into the entry's req_id so ack release
                                  # is exact across leadership churn
        self.replay_cursor = 0    # index into cluster.replayed[idx]
        self.replicated_conns: set = set()   # conns whose events replicate
        self.passthrough_conns: set = set()  # our own replay connections
        self.timer = ElectionTimer(timeout_cfg, seed=seed)
        # false-positive detection for the adaptive timeout (to_adjust_cb
        # analog): if the SAME leader heartbeats again shortly after we
        # fired, the timeout was premature -> widen it
        self.fired_leader = -1
        self.fired_countdown = 0


class ClusterDriver:
    def __init__(self, cfg: LogConfig, n_replicas: int, *,
                 workdir: Optional[str] = None,
                 app_ports: Optional[Sequence[Optional[int]]] = None,
                 timeout_cfg: Optional[TimeoutConfig] = None,
                 group_size: Optional[int] = None,
                 mode: str = "sim", seed: int = 0,
                 auto_evict: bool = False, fail_threshold: int = 100,
                 sync_period: float = 0.05, step_down_steps: int = 50,
                 app_snapshot=None, fanout: str = "gather",
                 obs: Optional[Observability] = None,
                 health_period: float = 0.5, link_model=None,
                 fence: bool = False, audit: bool = False,
                 alert_rules: Optional[Sequence[dict]] = None,
                 alert_period: float = 0.25, pipeline: int = 2,
                 telemetry: bool = False,
                 profile_on_page: float = 0.0,
                 repair: bool = False,
                 repair_opts: Optional[Dict] = None,
                 leases: bool = True,
                 lease_opts: Optional[Dict] = None,
                 series_capacity: int = 1280,
                 metrics_port: Optional[int] = None,
                 scan: bool = False,
                 txn: bool = False,
                 governor: bool = False,
                 governor_opts: Optional[Dict] = None,
                 idle_quiesce: bool = True,
                 idle_backoff_max: float = 0.05,
                 streams: bool = False,
                 streams_opts: Optional[Dict] = None,
                 device=None):
        self.cfg = cfg
        # scan=True engages the engine's K-window scan tier on the burst
        # path (runtime-mutable as driver.cluster.scan)
        self._scan = bool(scan)
        self.sync_period = sync_period
        self._workdir = workdir
        # observability: one registry + trace ring + span recorder per
        # driver (isolated by default — pass a shared facade to
        # aggregate across drivers). All of it is host-side.
        self.obs = obs if obs is not None else Observability()
        # step-phase wall-time attribution. fence keeps its default
        # (False) in production: fencing waits for the card right after
        # dispatch so device time lands in its own device_sync
        # histogram — a profiling mode that serializes the pipeline.
        self._phase_prof = StepPhaseProfiler(metrics=self.obs.metrics,
                                             fence=fence)
        self._health = (HealthReporter(workdir, period=health_period)
                        if workdir else None)
        # lost-majority step-down (the reference leader SUICIDES after
        # failing to reach a majority, dare_server.c:1213-1217): a
        # leader whose leadership_verified stays 0 for this many
        # consecutive steps stops SERVING — inflight commits are failed
        # and replicated sessions severed/refused — so a minority-side
        # leader's clients retry against the majority instead of
        # hanging. Service resumes if the leader re-verifies.
        self.step_down_steps = step_down_steps
        self.unverified = np.zeros(n_replicas, np.int64)
        self.stepped_down: set = set()
        self.R = n_replicas
        # fanout="psum" is the production full-connectivity
        # configuration (O(W) fan-out); the default stays "gather" so
        # partitions can be modeled. audit=True runs the digest-chain
        # step variants with the engine's ledger and flight ring;
        # telemetry=True the device-counter variants, ingested on the
        # readback thread into device_* series; txn=True the
        # transaction vote lane, so a coordinator can be attached
        self.cluster = self._make_cluster(cfg, n_replicas, group_size,
                                          mode, fanout, audit, telemetry,
                                          device, txn=bool(txn))
        self.cluster.obs = self.obs
        self.cluster.profiler = self._phase_prof
        # read scaling (runtime/reads.py): step-domain leader leases
        # renewed by the verified-quorum outputs every step already
        # carries, plus the queued read hub drained on the readback
        # thread between pipelined tickets. Host bookkeeping only —
        # reads never enter begin_*/finish, never consume ring slots
        if leases:
            from rdma_paxos_tpu_torch.runtime import reads as _reads
            _reads.attach(self.cluster, **(lease_opts or {}))
        # log-as-product streams (streams/): ordered range scans,
        # watch/subscribe with exactly-once resume, CDC export — one
        # tail-follower over the committed replay streams, observed at
        # the finish() tail. Host-side only. A workdir defaults the CDC
        # sink to <workdir>/cdc.jsonl when streams_opts doesn't name one.
        self.streams = None
        if streams:
            from rdma_paxos_tpu_torch import streams as _streams
            sopts = dict(streams_opts or {})
            if workdir and "cdc_path" not in sopts:
                sopts["cdc_path"] = os.path.join(workdir, "cdc.jsonl")
            if audit and "auditor" not in sopts:
                sopts["auditor"] = getattr(self.cluster, "auditor",
                                           None)
            self.streams = _streams.attach(self.cluster, obs=self.obs,
                                           **sopts)
        # chaos hook: a per-link fault model (chaos.faults.LinkModel)
        # driven from outside the poll loop — fault drills against a
        # live driver. With fanout="psum" any non-full mask is refused
        # at dispatch, so drills need the default "gather"
        if link_model is not None:
            link_model.obs = self.obs
            self.cluster.link_model = link_model
        # the card the engine's state lives on (with its index: a new
        # thread's current device is 0, so each loop thread binds it)
        self._state_device = self.cluster.state.term.device
        # time-series retention (obs/series.py): the registry sampled
        # into bounded per-series rings on the alert cadence — the
        # substrate of the window-domain rules (rate_window, burn_rate)
        # and of /series. With a workdir the samples persist as
        # append-only JSONL. Capacity must cover the LONGEST rule window
        # at this cadence (1280 x 0.25 s = 320 s > the 300 s slow burn
        # window).
        self.series = TimeSeriesStore(
            capacity=series_capacity,
            path=(os.path.join(workdir, "series.jsonl")
                  if workdir else None),
            source="driver")
        # SLO alert rules (obs/alerts.py) evaluated on a cadence from
        # the poll loop; firing state rides health documents and the
        # alert_firing{alert=...} gauges
        self.alerts = AlertEngine(
            self.obs.metrics,
            rules=(alert_rules if alert_rules is not None
                   else default_rules()),
            trace=self.obs.trace, series=self.series)
        self._alert_period = alert_period
        self._alert_last = float("-inf")
        self.exporter = None
        self._metrics_port = metrics_port
        # path of the last audit artifact written (_dump_audit_artifact)
        self.audit_artifact: Optional[str] = None
        # self-healing (runtime/repair.py): DIVERGENCE → quarantine →
        # digest-verified install from a ledger-majority donor →
        # range re-digest → probation re-admit. observe() runs per
        # finished step (readback thread); the state surgery only on
        # drained serial iterations (_drain_admin → repair.drive;
        # _pipeline_ready defers while a repair is due)
        self.repair = None
        if repair:
            if not audit:
                raise ValueError("repair=True requires audit=True "
                                 "(the ledger drives donor selection "
                                 "and install verification)")
            from rdma_paxos_tpu_torch.runtime.repair import RepairController
            self.repair = RepairController(self.cluster, obs=self.obs,
                                           **(repair_opts or {}))
            self._wire_repair()
            self.alerts.add_hook(self.repair.on_alert)
        # adaptive dispatch governor (runtime/governor.py): a step-domain
        # feedback controller on the readback thread that picks the
        # dispatch tier from the engine's ladder, engages pipelining and
        # applies a bounded admission wait — and sheds to serial the
        # moment the commit-latency burn-rate pager fires
        self.governor = None
        if governor:
            from rdma_paxos_tpu_torch.runtime.governor import attach_governor
            self.governor = attach_governor(
                self.cluster, obs=self.obs, alerts=self.alerts,
                **(governor_opts or {}))
            self.alerts.add_hook(self.governor.on_alert)
        # idle quiescence: when there is no standing backlog, no
        # blocked waiter, no election timer anywhere near due, and no
        # config work, the poll loop SKIPS the device dispatch entirely
        # and parks with an exponential backoff — any intake event
        # wakes the loop instantly.
        self._idle_quiesce = bool(idle_quiesce)
        self._idle_backoff_max = float(idle_backoff_max)
        self._idle_backoff = 0.001
        self._idle_guard = (timeout_cfg.elec_timeout_low * 0.25
                            if timeout_cfg is not None else 0.025)
        # bounded torch.profiler captures (obs/device.py:
        # ProfilerSession): started via start_profile() (operator /
        # bench) or automatically on the first page-severity alert when
        # profile_on_page > 0 (the capture duration in seconds); the
        # observe pass enforces the bound so an alert-triggered capture
        # can never run unbounded
        self.profile_session = None
        self._profile_on_page = float(profile_on_page)
        self._page_profiled = False
        # absolute (rebase-corrected) commit cursor per replica, for the
        # committed_entries_total counters / commit_advance traces
        self._prev_commit_abs = np.zeros(n_replicas, np.int64)
        self.timeout_cfg = timeout_cfg or TimeoutConfig()
        # failure detection / eviction (check_failure_count analog):
        # consecutive steps each member failed to ack the leader's window
        self.auto_evict = auto_evict
        self.fail_threshold = fail_threshold
        self.fail_count = np.zeros(n_replicas, np.int64)
        self._mm = MembershipManager(self.cluster)
        # last known membership view (device-state reads are unsafe —
        # and pipeline-serializing — while dispatches are in flight;
        # see _member_view_cached)
        self._member_cur = dict(bitmask_new=(1 << n_replicas) - 1,
                                epoch=0, cid_state=0)
        # (phase, new_mask, epoch, steps_left) — steps_left bounds a change
        # wedged by leader churn losing the CONFIG entry; on expiry the
        # phase resets so eviction/request can be re-issued
        self._config_phase: Optional[Tuple[str, int, int, int]] = None
        self.config_changes_abandoned = 0
        # app-state checkpoint hooks ``(dump_fn, restore_fn[, probe_fn])``:
        # dump_fn(sock) -> bytes over a raw app connection, restore_fn(
        # sock, blob) rebuilds the app from it, and probe_fn(sock) is a
        # processed-input barrier (ReplayEngine.barrier); without it a
        # checkpoint falls back to kernel-queue quiescence
        self.app_snapshot = app_snapshot
        # operator requests, executed inside the poll loop on a drained
        # serial iteration (never racing the stepping thread over
        # cluster state): (replica, donor, done_event, exception_box)
        # for a recovery, (replica, done_event, box) for an app reset or
        # a checkpoint; failures surface to the caller, never kill the
        # loop
        # guarded-by: _lock [writes]
        self._recover_req = None
        self._reset_req = None        # guarded-by: _lock [writes]
        # guarded-by: _lock [writes]
        self._ckpt_req: Optional[Tuple[int, threading.Event, list]] = None
        self._lock = threading.Lock()
        # per-replica queues of (etype, conn_id, fragment_bytes, seq)
        self._submitq: List[List[Tuple[int, int, bytes, int]]]
        self._submitq = [[] for _ in range(n_replicas)]  # guarded-by: _lock
        # advisory leader view: written under the lock on the readback
        # thread; lock-free reads (poll/app threads) tolerate one step
        # of staleness by design  # guarded-by: _lock [writes]
        self._leader_view = -1
        # stores consume the vectorized frame stream from the decode
        self.cluster.collect_frames = workdir is not None
        self.runtimes: List[_ReplicaRuntime] = []
        for r in range(n_replicas):
            sock = (os.path.join(workdir, f"proxy{r}.sock")
                    if workdir else None)
            store = (os.path.join(workdir, f"replica{r}.db")
                     if workdir else None)
            port = app_ports[r] if app_ports else None
            logp = (os.path.join(workdir, f"replica{r}.log")
                    if workdir else None)
            self.runtimes.append(_ReplicaRuntime(
                r, sock, port, store,
                self._make_handler(r), self.timeout_cfg, seed + r,
                log_path=logp, obs=self.obs))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.loop_error: Optional[BaseException] = None
        # event-driven stepping: link threads set this when work arrives
        # so an idle loop wakes instantly instead of polling
        self._wake = threading.Event()
        # pipelined dispatch: with pipeline >= 2 the run loop keeps up
        # to ``pipeline`` device dispatches in flight — the dispatch
        # thread encodes batch k+1 while batch k runs on the card, and
        # a dedicated READBACK thread finishes tickets and runs all
        # post-step host work. Elections, config changes and rebase
        # drains always drain the pipeline first and run through the
        # serial step(); the commit stream and ack stream are identical
        # to the serial driver's (tests pin it). Mutable at runtime.
        self.pipeline = max(int(pipeline), 0)
        self._pl_cv = threading.Condition()
        self._pl_pending = 0        # dispatched, not yet post-stepped
        self._pl_queue: _queue.Queue = _queue.Queue()
        self._rb_thread: Optional[threading.Thread] = None
        # opt-in ops exporter (obs/export.py) on a localhost port (0 =
        # ephemeral), beside the readback thread. Attached LAST: a
        # scrape may land the instant the socket binds, and health()
        # touches everything above.
        if self._metrics_port is not None:
            self.serve_metrics(self._metrics_port)

    def _make_cluster(self, cfg, n_replicas, group_size, mode, fanout,
                      audit, telemetry, device, txn=False):
        """Engine factory: the port's SimCluster on ``device`` (the card
        unless the caller names the CPU; with ``mode="spmd"`` a device
        list, one entry per replica)."""
        return SimCluster(cfg, n_replicas, group_size, mode=mode,
                          fanout=fanout, audit=audit, telemetry=telemetry,
                          scan=self._scan, txn=txn, device=device)

    def _wire_repair(self) -> None:
        """Single-group driver: repair installs ride :meth:`_do_recover`
        (store transfer and live-app delta replay included) with the
        ledger passed through, so the install is digest-verified end to
        end and a corrupted donor raises into the controller's
        donor-retry loop."""
        self.repair.install_hook = self._repair_install

    def _repair_install(self, g: int, r: int, donor: int) -> None:
        self._do_recover(r, donor, app_fresh=False,
                         ledger=self.repair.led,
                         min_verified=self.repair.min_verified)
        # the log and store are healed from a verified donor, but a LIVE
        # interposed app may already have executed bytes the corruption
        # reached before detection: quarantine it through the
        # mis-speculation machinery (the store keeps persisting; the
        # operator restarts the app and reset_app() rebuilds it)
        rt = self.runtimes[r]
        if rt.replay is not None and not rt.app_dirty:
            rt.app_dirty = True
            rt.log.info_wtime(
                "REPAIR: app quarantined pending reset_app (its state "
                "may derive from corrupted committed bytes)")

    def _repair_blocked(self, r: int, group: int = 0) -> bool:
        return (self.repair is not None
                and self.repair.serving_blocked(group, r))

    def _txn_live(self) -> bool:
        """A transaction is in flight: its votes and decision records
        ride serial dispatches only, so the loop gives way from bursts
        and pipelining and keeps stepping until it decides."""
        return self.cluster.txn is not None and self.cluster.txn.wants_serial()

    def _bind_device(self) -> None:
        """Make the engine's card the calling thread's current device
        (a new thread's current device is 0)."""
        if self._state_device.type == "cuda":
            torch.cuda.set_device(self._state_device)

    # ------------------------------------------------------------------
    # shim event intake (called from proxy link threads)
    # ------------------------------------------------------------------

    def _make_handler(self, r: int):
        def on_event(etype: int, conn_id: int, payload: bytes):
            """Returns None (pass through), an int status (<0 severs the
            connection), or a PendingEvent (block until committed)."""
            with self._lock:
                rt = self.runtimes[r]

                def refuse_send():
                    """Refuse with -1, quarantining a speculative app
                    whose delivered bytes this refusal strands (shared
                    policy: proxy.spec_send_refused_dirty)."""
                    if spec_send_refused_dirty(
                            etype, conn_id, rt.replicated_conns,
                            rt.proxy, rt.app_dirty):
                        rt.app_dirty = True
                        rt.log.info_wtime(
                            "APP DIRTY: speculated SEND refused at "
                            "intake (conn %d)" % conn_id)
                    self.obs.metrics.inc("events_refused_total",
                                         replica=r)
                    return -1

                if self.loop_error is not None or self._stop.is_set():
                    # no poll loop will ever release a commit wait: fail
                    # fast so the app severs and the client retries
                    return refuse_send()
                if etype == int(EntryType.CONNECT):
                    # our own replay connections (recognized by peer port)
                    # stay local; so do client connections on non-leaders
                    # (stale local reads — the reference's followers serve
                    # the same way, proxy.c:230-239 is_leader gate)
                    port = (int.from_bytes(payload[4:6], "big")
                            if len(payload) >= 6 else 0)
                    if (rt.replay is not None
                            and port in rt.replay.local_ports):
                        rt.passthrough_conns.add(conn_id)
                        return None
                    if rt.app_dirty:
                        # a dirty (mis-speculated) app must not serve
                        # clients — not even stale local reads
                        return -1
                    if not self._accepts_clients(r):
                        return None
                    if r in self.stepped_down:
                        # a stepped-down (majority-less) leader accepts
                        # no new sessions at all — the reference's
                        # suicided leader serves nothing
                        return -1
                    rt.replicated_conns.add(conn_id)
                    payload = b""
                elif conn_id in rt.passthrough_conns:
                    if etype == int(EntryType.CLOSE):
                        rt.passthrough_conns.discard(conn_id)
                    return None
                elif conn_id not in rt.replicated_conns:
                    return None          # never-replicated local session
                elif r in self.stepped_down:
                    # lost-majority step-down: refuse replicated service
                    # (a commit wait could never complete)
                    status = refuse_send()
                    rt.replicated_conns.discard(conn_id)
                    return status
                elif rt.app_dirty:
                    # a surviving replicated session on a replica whose
                    # app diverged must be severed even if this replica
                    # regained leadership
                    rt.replicated_conns.discard(conn_id)
                    return -1
                elif not self._accepts_clients(r):
                    # a REPLICATED session must never silently downgrade
                    # to unreplicated service after deposition: sever it
                    # so the client reconnects to the current leader
                    if etype == int(EntryType.CLOSE):
                        rt.replicated_conns.discard(conn_id)
                        return None
                    return refuse_send()
                if etype == int(EntryType.CLOSE):
                    rt.replicated_conns.discard(conn_id)
                return self._enqueue_locked(r, rt, etype, conn_id,
                                            payload)
        return on_event

    def _accepts_clients(self, r: int) -> bool:
        """Client-session admission: the single-group driver serves
        replicated sessions on the leader only (non-leaders give stale
        local reads, the reference's follower semantics) — and never on
        a replica the repair pipeline holds in quarantine or probation."""
        return self._leader_view == r and not self._repair_blocked(r)

    # holds-lock: _lock
    def _enqueue_locked(self, r: int, rt: _ReplicaRuntime, etype: int,
                        conn_id: int, payload: bytes):
        """Admit one gate-passed replicated event: fragment, stamp
        sequence numbers, queue for the next dispatch, and park the
        blocked app thread's PendingEvent (caller holds ``_lock``)."""
        frags = (fragment(payload, self.cfg.slot_bytes)
                 if etype == int(EntryType.SEND) else [payload])
        for f in frags:
            rt.submit_seq += 1
            self._submitq[r].append((etype, conn_id, f,
                                     rt.submit_seq))
        ev = PendingEvent(EntryType(etype), conn_id, payload,
                          rt.submit_seq)
        rt.inflight.append(ev)
        self.obs.metrics.inc("proxy_events_total", replica=r)
        self.obs.trace.record(obs_trace.PROXY_ENQUEUE,
                              replica=r, etype=etype,
                              conn=conn_id, frags=len(frags),
                              submit_seq=rt.submit_seq)
        # causal span birth: keyed (conn, final fragment seq) —
        # the exact pair the ack-release path matches on
        self.obs.spans.begin(conn_id, rt.submit_seq, r)
        self._wake.set()
        return ev

    # ------------------------------------------------------------------
    # the polling loop
    # ------------------------------------------------------------------

    def _drain_admin(self) -> None:
        """Serve pending operator requests (recovery, app reset,
        checkpoint) on the stepping thread, with the dispatch pipeline
        drained. Each slot is popped under the lock its writers publish
        under."""
        for slot, run in (("_recover_req", self._do_recover),
                          ("_reset_req", self._do_reset_app),
                          ("_ckpt_req", self._do_checkpoint)):
            with self._lock:
                req = getattr(self, slot)
                setattr(self, slot, None)
            if req is None:
                continue
            *args, done, box = req
            try:
                run(*args)
            except Exception as exc:  # noqa: BLE001 — reported to caller
                box.append(exc)
            finally:
                done.set()
        # self-healing: due repairs run HERE — the serial path, after the
        # dispatch loop drained every in-flight ticket (drive() itself
        # defers while anything is in flight)
        if self.repair is not None:
            self.repair.drive()
        # elastic topology: transition passes (seed/freeze/cutover) run
        # on the same drained serial path, after repair (repair gets
        # priority; the window defers or abandons around it)
        topo = getattr(self.cluster, "topology", None)
        if topo is not None:
            topo.drive()

    def _pump_submitq(self) -> None:
        """Move intake rows into the engine's pending queues — ONE
        locked extend per replica. Holds the engine's host lock too:
        the pipelined readback thread requeues ring-full shortfalls
        into the same lists concurrently."""
        prof = self._phase_prof
        prof.start(PHASE_SUBMIT_PUMP)
        prof.start(PHASE_INTAKE_LOCK_WAIT)
        with self._lock, self.cluster._host_lock:
            prof.stop(PHASE_INTAKE_LOCK_WAIT)
            for r in range(self.R):
                q = self._submitq[r]
                if q:
                    self.cluster.submit_many(
                        r, [(etype, conn, seq, frag)
                            for etype, conn, frag, seq in q])
                    q.clear()
        prof.stop(PHASE_SUBMIT_PUMP)

    def step(self) -> Dict:
        """One host-loop iteration (public for deterministic tests).
        Serial: dispatch + readback fused — the pipelined run loop
        splits the same work into begin_* on the dispatch thread and
        ``_post_step`` on the readback thread."""
        self._drain_admin()
        self._pump_submitq()

        # a flagged (force-pruned) leader never heals on its own: it
        # acks windows and heartbeats normally, so nothing deposes it.
        # The same goes for a leader the repair pipeline holds
        # (quarantine cuts its links, but it keeps self-claiming;
        # probation must not lead either). Actively depose it: fire an
        # election timeout on a healthy member each step until
        # leadership moves.
        depose = -1
        lead = self._leader_view
        if (lead >= 0
                and (lead in self.cluster.need_recovery
                     or self._repair_blocked(lead))):
            mask = self._mm.current(lead)["bitmask_new"]
            healthy = [r for r in range(self.R)
                       if (mask >> r) & 1 and r != lead
                       and r not in self.cluster.need_recovery
                       and not self._repair_blocked(r)]
            if healthy:
                depose = min(healthy)

        # pending work + known leader: drain through a multi-step burst
        # (one dispatch fuses up to K_TIERS[-1] protocol steps; no
        # election timeouts can fire inside — each burst step carries the
        # heartbeat). The single-step path serves elections, deposes,
        # and idle heartbeats. A governor's decision caps the burst at
        # its ladder rung, or routes the iteration through the serial
        # step (latency-bound regime, SLO shed).
        dec = (self.governor.decision if self.governor is not None
               else None)
        if (depose < 0
                and self._leader_view >= 0 and self.cluster.last is not None
                and self._backlog() and not self._txn_live()
                and (dec is None or dec.max_k > 1)):
            res = self.cluster.step_burst(
                max_k=dec.max_k if dec is not None else None)
        else:
            timeouts = []
            last = self.cluster.last
            for r, rt in enumerate(self.runtimes):
                if last is not None and last["role"][r] == int(Role.LEADER):
                    continue
                if rt.timer.expired() or r == depose:
                    timeouts.append(r)
                    rt.timer.beat()
                    self.obs.metrics.inc("election_timeouts_total",
                                         replica=r)
                    self.obs.trace.record(
                        obs_trace.ELECTION_START, replica=r,
                        depose=(r == depose),
                        term=(int(last["term"][r])
                              if last is not None else 0))
                    if r != depose:
                        # a deliberate deposition is not a mistimed
                        # timeout: it must not feed the adaptive
                        # false-positive widening
                        rt.fired_leader = (int(last["leader_id"][r])
                                           if last is not None else -1)
                        rt.fired_countdown = 50
            res = self.cluster.step(timeouts=timeouts)
        return self._post_step(res)

    def _backlog(self) -> int:
        """Entries awaiting dispatch in the engine's pending queues."""
        return max(len(q) for q in self.cluster.pending)

    def _update_leader_view(self, res) -> None:
        with self._lock:
            # multiple self-claimed leaders can coexist transiently (an
            # isolated deposed leader cannot hear the higher term); the
            # real one is the highest-term claimant — terms are unique per
            # leader by quorum election
            claims = [(int(res["term"][r]), r) for r in range(self.R)
                      if res["role"][r] == int(Role.LEADER)]
            self._leader_view = max(claims)[1] if claims else -1

    def _post_step(self, res) -> Dict:
        """Every post-readback host rule for one step's outputs: leader
        view, durable election state, timer beats, store/replay/ack
        release, detectors and observability export. Serial ``step()``
        runs it inline; the pipelined loop runs it on the READBACK
        thread. Timed as ``post_step_rules``, apart from the store,
        replay and ack release (``apply_replay_ack``) and the cadenced
        observability (``cadence``)."""
        prof = self._phase_prof
        prof.start(PHASE_POST_STEP_RULES)
        self._update_leader_view(res)

        for r, rt in enumerate(self.runtimes):
            if rt.hard is not None:
                rt.hard.save(int(res["term"][r]),
                             int(res["voted_term"][r]),
                             int(res["voted_for"][r]))
            if res["became_leader"][r]:
                rt.log.leader_elected(int(res["term"][r]))
            if res["hb_seen"][r] or res["role"][r] == int(Role.LEADER):
                rt.timer.beat()
            if rt.fired_countdown > 0:
                rt.fired_countdown -= 1
                if (res["hb_seen"][r] and rt.fired_leader >= 0
                        and int(res["leader_id"][r]) == rt.fired_leader):
                    # the leader we timed out on is alive: premature
                    # timeout -> widen adaptively (to_adjust_cb analog)
                    rt.timer.false_positive()
                    rt.fired_countdown = 0
            prof.stop(PHASE_POST_STEP_RULES)
            self._apply_new_entries(r, rt)
            prof.start(PHASE_POST_STEP_RULES)
            if res["role"][r] != int(Role.LEADER):
                with self._lock:
                    # lost leadership with blocked app threads: fail them
                    # so clients reconnect to the new leader. Fragments
                    # already replicated may still commit later;
                    # seq-stamped acks make those late applies no-ops.
                    self._fail_inflight_locked(rt, "deposition")

        self._step_down_detector(res)
        self._failure_detector(res)
        self._drive_config_change()
        # self-healing observation: consume new DIVERGENCE findings
        # (quarantine is host bookkeeping — safe on this, the readback,
        # thread) and advance probation; the surgery itself waits for a
        # drained serial iteration (_drain_admin)
        if self.repair is not None:
            self.repair.observe()
        # a replica force-pruned past its apply cursor (wedged app now
        # unwedged, or long stall) stopped replaying; heal it with a
        # donor snapshot, one per iteration. The donor is the leader,
        # which must itself be healthy (a flagged leader's store is
        # frozen: its snapshot would drop acked writes), and the leader
        # is never the recoveree (it recovers once deposed). Replicas
        # the repair controller owns are ITS to heal (ledger-verified
        # donor), not this default path's.
        lead = self._leader_view
        owned = self.repair.owned() if self.repair is not None else set()
        cands = self.cluster.need_recovery - {lead} - owned
        if (cands and lead >= 0
                and lead not in self.cluster.need_recovery):
            r = min(cands)
            # the host lock brackets every dispatch: holding it with no
            # ticket in flight proves the install races none (the
            # dispatch loop sees need_recovery and drains, so a deferred
            # recovery runs on the next drained iteration)
            with self.cluster._host_lock:
                snap = (None if self.cluster._tickets
                        else self._install_donor_snapshot(r, lead))
            if snap is not None:
                try:
                    self._load_donor_history(r, lead, snap,
                                             app_fresh=False)
                except RuntimeError as exc:
                    # unrecoverable in place (e.g. the donor compacted
                    # past this app's applied prefix): quarantine the app
                    # for an operator restart + reset_app rather than
                    # killing the poll loop or retrying forever
                    rt = self.runtimes[r]
                    rt.app_dirty = True
                    rt.log.info_wtime("AUTO-RECOVERY FAILED: %s" % exc)
                self.cluster.need_recovery.discard(r)
        self._observe_step(res)
        prof.stop(PHASE_POST_STEP_RULES)
        self._cadence_observe()
        return res

    # ------------------------------------------------------------------
    # observability (host-side only — see rdma_paxos_tpu_torch.obs)
    # ------------------------------------------------------------------

    def _observe_step(self, res) -> None:
        """Export the step's protocol-level signals: per-replica
        role/term/index gauges, rebase headroom against the i32
        ceiling, commit-advance counters + trace, batch-size histogram."""
        m = self.obs.metrics
        rebased = self.cluster.rebased_total
        for r in range(self.R):
            m.set("replica_role", int(res["role"][r]), replica=r)
            m.set("replica_term", int(res["term"][r]), replica=r)
            m.set("commit_index", int(res["commit"][r]), replica=r)
            m.set("apply_index", int(res["apply"][r]), replica=r)
            m.set("end_index", int(res["end"][r]), replica=r)
            m.set("rebase_headroom",
                  self.cfg.rebase_threshold - int(res["end"][r]),
                  replica=r)
            m.set("inflight_waiters", len(self.runtimes[r].inflight),
                  replica=r)
            acc = int(res["accepted"][r])
            if acc > 0:
                m.inc("accepted_entries_total", acc, replica=r)
                m.observe("step_batch_entries", acc,
                          buckets=BATCH_BUCKETS, replica=r)
                self.obs.trace.record(obs_trace.STEP_BATCH, replica=r,
                                      entries=acc)
            commit_abs = int(res["commit"][r]) + rebased
            delta = commit_abs - int(self._prev_commit_abs[r])
            if delta > 0:
                self._prev_commit_abs[r] = commit_abs
                m.inc("committed_entries_total", delta, replica=r)
                self.obs.trace.record(obs_trace.COMMIT_ADVANCE,
                                      replica=r, commit=commit_abs,
                                      delta=delta)
        # cluster-level leader view (the leaderless alert's input)
        m.set("cluster_leader", self._leader_view)

    def _cadence_observe(self) -> None:
        """The wall-cadenced observability work (alert evaluation and
        series sampling, profiler expiry, health files), shared by the
        per-step observe pass and the idle-quiescence branch, so a
        parked poll loop keeps its alerts and health files fresh while
        skipping dispatches. Timed as ``cadence``."""
        self._phase_prof.start(PHASE_CADENCE)
        now = time.monotonic()
        if now - self._alert_last >= self._alert_period:
            self._alert_last = now
            self.evaluate_alerts()
        self._poll_profile()
        if self._health is not None and self._health.due():
            try:
                # ONE health() pass feeds both files: the per-replica
                # snapshots and the cluster-level document
                h = self.health()
                self._health.write({rep["replica"]: rep
                                    for rep in h["replicas"]})
                self._health.write_cluster(h)
            except OSError:
                # observability I/O must never kill the data path: a
                # vanished workdir or a full disk costs the snapshot,
                # not the poll loop
                pass
        self._phase_prof.stop(PHASE_CADENCE)

    def _health_snapshots(self, res) -> Dict[int, Dict]:
        """Per-replica health dicts (the obs.health schema plus store /
        rebase extras) — written to ``replica<r>.health.json`` on the
        reporter cadence and aggregated live by :meth:`health`."""
        snaps = {}
        for r in range(self.R):
            rt = self.runtimes[r]
            snaps[r] = make_snapshot(
                replica=r,
                role=int(res["role"][r]),
                term=int(res["term"][r]),
                leader_id=int(res["leader_id"][r]),
                commit=int(res["commit"][r]),
                apply=int(res["apply"][r]),
                end=int(res["end"][r]),
                head=int(res["head"][r]),
                log_headroom=(self.cfg.rebase_threshold
                              - int(res["end"][r])),
                inflight=len(rt.inflight),
                app_dirty=rt.app_dirty,
                stepped_down=r in self.stepped_down,
                need_recovery=r in self.cluster.need_recovery,
                rebases=self.cluster.rebases,
                rebase_stalled=self.cluster.rebase_stalled,
                store=(rt.store.stats() if rt.store is not None
                       else None),
            )
        return snaps

    def evaluate_alerts(self) -> Dict:
        """One SLO-rule evaluation pass (also called on a cadence from
        the poll loop). A newly firing ``page``-severity alert on an
        audited cluster dumps the audit artifact (ledger, flight ring
        and obs dumps) for post-mortem, and — with ``profile_on_page``
        set — starts ONE bounded profiler capture so the pages' root
        cause is inspectable on the device timeline. The series store
        samples FIRST,
        from the same registry snapshot the rules then evaluate, so the
        window-domain rules always see the freshest point."""
        snap = self.obs.metrics.snapshot()
        if self.series is not None:
            self.series.sample(snap, step=int(self.cluster.step_index))
        out = self.alerts.evaluate(snap=snap)
        pages = [n for n in out["fired"]
                 if self.alerts.severity(n) == "page"]
        if pages and (self.cluster.auditor is not None
                      or self.cluster.flight is not None):
            self._dump_audit_artifact("alert: " + ",".join(pages))
        if (pages and self._profile_on_page > 0
                and not self._page_profiled):
            self._page_profiled = True      # one capture per process
            try:
                self.start_profile(seconds=self._profile_on_page)
                self.obs.trace.record(obs_trace.ALERT_FIRED,
                                      alert="profile_capture",
                                      severity="info",
                                      value=",".join(pages))
            except RuntimeError:
                pass        # another capture is active — keep serving
        return out

    # ------------------------------------------------------------------
    # bounded profiler captures (obs/device.py:ProfilerSession)
    # ------------------------------------------------------------------

    def start_profile(self, seconds: float = 5.0,
                      log_dir: Optional[str] = None):
        """Begin a bounded ``torch.profiler`` capture of the serving
        path; the poll loop stops it when ``seconds`` elapse (or call
        :meth:`stop_profile`). The capture's Chrome trace merges onto
        the span timeline via ``obs.device.merge_timeline``."""
        from rdma_paxos_tpu_torch.obs.device import ProfilerSession
        if self.profile_session is not None \
                and self.profile_session.active:
            raise RuntimeError("a profiler capture is already active")
        if log_dir is None:
            import tempfile
            log_dir = (os.path.join(self._workdir, "profile")
                       if self._workdir else
                       tempfile.mkdtemp(prefix="rp_profile_"))
        self.profile_session = ProfilerSession(
            log_dir, max_seconds=seconds).start()
        return self.profile_session

    def stop_profile(self):
        """Stop the active capture (idempotent); returns the session
        (trace files resolved) or None when none was started."""
        if self.profile_session is not None:
            self.profile_session.stop()
        return self.profile_session

    def _poll_profile(self) -> None:
        """Observe-pass hook: expire a bounded capture. Profiler I/O
        must never kill the data path."""
        s = self.profile_session
        if s is not None and s.active:
            try:
                s.maybe_stop()
            except Exception:  # noqa: BLE001 — evidence, not data path
                pass    # stop() already marked the session inactive

    def _dump_audit_artifact(self, reason: str) -> Optional[str]:
        """Write the audit artifact (ledger dump, flight ring, trace and
        metrics) to ``<workdir>/audit_dump.json`` (a temporary file
        without a workdir); returns its path, also kept in
        ``audit_artifact``, or None when the write failed (evidence I/O
        never kills the data path)."""
        from rdma_paxos_tpu_torch.obs.audit import write_audit_artifact
        path = (os.path.join(self._workdir, "audit_dump.json")
                if self._workdir else None)
        try:
            self.audit_artifact = write_audit_artifact(
                path, reason=reason, ledger=self.cluster.auditor,
                flight=self.cluster.flight, obs=self.obs,
                config=dict(n_replicas=self.R,
                            n_slots=self.cfg.n_slots,
                            slot_bytes=self.cfg.slot_bytes,
                            window_slots=self.cfg.window_slots))
        except OSError:
            return None
        self.obs.trace.record(obs_trace.AUDIT_DUMPED, reason=reason,
                              path=self.audit_artifact)
        return self.audit_artifact

    def health(self) -> Dict:
        """Aggregated cluster health (live — not from the files): the
        per-replica snapshots plus the cluster-level view, conforming to
        ``obs.health.CLUSTER_HEALTH_FIELDS`` (validate with
        ``obs.health.validate_cluster``). Safe to call from any thread;
        uses the last completed step's outputs."""
        res = self.cluster.last
        replicas = (self._health_snapshots(res) if res is not None
                    else {})
        return make_cluster_snapshot(
            leader=self.leader(),
            n_replicas=self.R,
            replicas=[replicas[r] for r in sorted(replicas)],
            rebases=self.cluster.rebases,
            rebase_stalled=self.cluster.rebase_stalled,
            loop_error=(repr(self.loop_error)
                        if self.loop_error else None),
            audit=(self.cluster.auditor.summary()
                   if self.cluster.auditor is not None else None),
            alerts=self.alerts.state(),
            audit_artifact=self.audit_artifact,
            repair=(self.repair.status()
                    if self.repair is not None else None),
            leases=(self.cluster.leases.status()
                    if self.cluster.leases is not None else None),
            reads=(self.cluster.reads.status()
                   if self.cluster.reads is not None else None),
            streams=(self.cluster.streams.status()
                     if self.cluster.streams is not None else None),
            governor=(self.governor.status()
                      if self.governor is not None else None),
            txn=(self.cluster.txn.health()
                 if self.cluster.txn is not None else None),
            blame=_health_blame(self.obs),
        )

    def serve_metrics(self, port: int = 0):
        """Start (or return) the opt-in localhost ops exporter:
        ``/metrics`` (Prometheus text), ``/metrics.json``, ``/healthz``
        (503 on a dead poll loop), ``/series``, ``/alerts``. ``port=0``
        binds an ephemeral port — read it back from
        ``driver.exporter.port``. Its serving threads read host state
        only (the registry, health(), the series rings), never a CUDA
        tensor."""
        if self.exporter is None:
            from rdma_paxos_tpu_torch.obs.export import OpsExporter
            self.exporter = OpsExporter(
                registry=self.obs.metrics, health_fn=self.health,
                alerts=self.alerts, series=self.series,
                port=port).start()
        return self.exporter

    # ------------------------------------------------------------------
    # failure detection + eviction (push-detection analog: WC failures
    # -> fail_count >= threshold -> CONFIG removal, dare_server.c:1189)
    # ------------------------------------------------------------------

    def _count_released(self, r: int, n: int, n_event: int) -> None:
        """Count ``n`` released commit waiters of replica ``r`` by how
        their completion was seen: ``event`` for the ``n_event`` a thread
        asked ``done`` of, ``callback`` for the rest (no Event made)."""
        if n_event:
            self.obs.metrics.inc("commit_waiters_released_total", n_event,
                                 replica=r, path="event")
        if n > n_event:
            self.obs.metrics.inc("commit_waiters_released_total",
                                 n - n_event, replica=r, path="callback")

    # holds-lock: _lock
    def _fail_inflight_locked(self, rt: _ReplicaRuntime,
                              site: str) -> None:
        """Fail every blocked commit waiter (caller holds the lock). A
        SPECULATIVE app already executed the inputs being failed, so its
        state may have diverged from the committed stream — quarantine
        it (app_dirty)."""
        if (rt.inflight and rt.proxy is not None
                and rt.proxy.spec_mode and not rt.app_dirty):
            rt.app_dirty = True
            rt.log.info_wtime(
                "APP DIRTY: %d speculated events failed at %s"
                % (len(rt.inflight), site))
        n = len(rt.inflight)
        n_event = 0
        while rt.inflight:
            n_event += rt.inflight.popleft().release(-1)
        if n:
            self._count_released(rt.idx, n, n_event)
            self.obs.metrics.inc("inflight_failed_total", n,
                                 replica=rt.idx)
            self.obs.trace.record(obs_trace.INFLIGHT_FAILED,
                                  replica=rt.idx, count=n, site=site)
            # close the failed waiters' spans with a terminal failover
            # status — nothing will ever ack them
            self.obs.spans.fail_open(rt.idx)

    def _step_down_detector(self, res) -> None:
        """Lost-majority step-down (dare_server.c:1213-1217 analog): a
        leader that cannot verify its authority against a majority for
        ``step_down_steps`` consecutive steps stops serving — blocked
        commit waiters fail (clients retry elsewhere) and replicated
        sessions are refused until it re-verifies or is deposed."""
        for r in range(self.R):
            is_lead = res["role"][r] == int(Role.LEADER)
            if is_lead and not res["leadership_verified"][r]:
                self.unverified[r] += 1
            else:
                self.unverified[r] = 0
                if r in self.stepped_down:
                    self.stepped_down.discard(r)
                    self.runtimes[r].log.info_wtime(
                        "REJOINED: leadership re-verified or deposed")
            if (is_lead and r not in self.stepped_down
                    and self.unverified[r] >= self.step_down_steps):
                self.stepped_down.add(r)
                rt = self.runtimes[r]
                # a majority-less leader must not serve lease reads
                # either: revoke before the serving gates react
                if self.cluster.leases is not None:
                    self.cluster.leases.revoke_all(r, "step_down")
                self.obs.metrics.inc("step_downs_total", replica=r)
                self.obs.trace.record(obs_trace.STEP_DOWN, replica=r,
                                      term=int(res["term"][r]),
                                      unverified=int(self.unverified[r]))
                rt.log.info_wtime(
                    "[T%d] LOST MAJORITY: stepping down after %d "
                    "unverified steps" % (int(res["term"][r]),
                                          int(self.unverified[r])))
                # replicated_conns is deliberately NOT cleared: removing
                # a session from the set would downgrade its next event
                # to unreplicated pass-through (acked lost write); the
                # stepped_down branch in on_event severs each surviving
                # session on its next event instead.
                with self._lock:
                    self._fail_inflight_locked(rt, "step-down")

    def _member_view_cached(self, lead: int) -> dict:
        """The current config view (bitmask/epoch/cid_state), refreshed
        from device state only while NOTHING is in flight (a device
        read under in-flight dispatches would serialize the pipeline).
        Config changes drain the pipeline (see _pipeline_ready), so the
        cache is stale at most for the duration of one drained
        transition."""
        with self.cluster._host_lock:
            if not self.cluster._tickets:
                self._member_cur = self._mm.current(lead)
        return self._member_cur

    def _failure_detector(self, res) -> None:
        lead = self._leader_view
        if lead < 0:
            self.fail_count[:] = 0
            return
        cur = self._member_view_cached(lead)
        mask = cur["bitmask_new"]
        acked = res["peer_acked"][lead]
        for r in range(self.R):
            if not (mask >> r) & 1 or r == lead:
                self.fail_count[r] = 0
                continue
            self.fail_count[r] = 0 if acked[r] else self.fail_count[r] + 1
        if not self.auto_evict or self._config_phase is not None:
            return
        dead = [r for r in range(self.R)
                if (mask >> r) & 1 and self.fail_count[r]
                >= self.fail_threshold]
        if dead:
            new_mask = mask
            for r in dead:
                new_mask &= ~(1 << r)
            # only evict a strict MINORITY: the survivors must form a
            # majority of the current group, else a transient partition
            # of live nodes would permanently shrink fault tolerance
            survivors = bin(new_mask).count("1")
            if survivors > bin(mask).count("1") // 2:
                self._mm.submit_transit(lead, mask, new_mask,
                                        cur["epoch"] + 1)
                self._config_phase = ("transit", new_mask,
                                      cur["epoch"] + 1, 500)
                self.obs.metrics.inc("evictions_total", len(dead))
                self.obs.trace.record(obs_trace.MEMBERSHIP_CHANGE,
                                      phase="evict_transit", dead=dead,
                                      new_mask=new_mask,
                                      epoch=cur["epoch"] + 1)

    def _drive_config_change(self) -> None:
        """Advance a two-phase (joint-consensus) config change one poll
        iteration at a time — the non-blocking version of
        MembershipManager.change for use inside the polling loop."""
        if self._config_phase is None:
            return
        # under pipelining this runs on the readback thread: a device
        # read of the config would race (and serialize) in-flight
        # dispatches, and a concurrent batch take would race
        # submit_stable. The engine host lock brackets every dispatch,
        # so holding it with tickets empty proves none is in flight —
        # and _pipeline_ready sees the phase and drains, so a deferred
        # iteration drives the change serially (TTL untouched).
        with self.cluster._host_lock:
            if self.cluster._tickets:
                return
            phase, new_mask, epoch, ttl = self._config_phase
            if ttl <= 0:
                # CONFIG entry lost (e.g. leader deposed before it
                # replicated): abandon so the failure detector /
                # operator can resubmit
                self._config_phase = None
                self.config_changes_abandoned += 1
                self.obs.metrics.inc("config_changes_abandoned_total")
                self.obs.trace.record(obs_trace.MEMBERSHIP_CHANGE,
                                      phase="abandoned",
                                      new_mask=new_mask, epoch=epoch)
                return
            self._config_phase = (phase, new_mask, epoch, ttl - 1)
            lead = self._leader_view
            if lead < 0:
                return
            cur = self._mm.current(lead)
            last = self.cluster.last
            committed = (last is not None and
                         int(last["commit"][lead])
                         >= int(last["end"][lead]))
            if phase == "transit":
                if (cur["epoch"] >= epoch
                        and cur["cid_state"] == int(ConfigState.TRANSIT)
                        and committed):
                    self._mm.submit_stable(lead, new_mask, epoch + 1)
                    self._config_phase = ("stable", new_mask,
                                          epoch + 1, ttl)
                    self.obs.trace.record(obs_trace.MEMBERSHIP_CHANGE,
                                          phase="stable_submitted",
                                          new_mask=new_mask,
                                          epoch=epoch + 1)
            elif phase == "stable":
                if (cur["epoch"] >= epoch
                        and cur["cid_state"] == int(ConfigState.STABLE)):
                    self._config_phase = None
                    self.obs.metrics.inc("config_changes_total")
                    self.obs.trace.record(obs_trace.MEMBERSHIP_CHANGE,
                                          phase="complete",
                                          new_mask=new_mask, epoch=epoch)

    def request_membership(self, new_mask: int) -> None:
        """Operator API: start a two-phase change to ``new_mask`` (join /
        upsize / downsize); the polling loop drives it to completion."""
        lead = self._leader_view
        if lead < 0:
            raise RuntimeError("no leader")
        cur = self._mm.current(lead)
        self._mm.submit_transit(lead, cur["bitmask_new"], new_mask,
                                cur["epoch"] + 1)
        self._config_phase = ("transit", new_mask, cur["epoch"] + 1, 500)
        self.obs.trace.record(obs_trace.MEMBERSHIP_CHANGE,
                              phase="transit_requested",
                              new_mask=new_mask, epoch=cur["epoch"] + 1)

    def _admin_request(self, slot: str, args: tuple, what: str,
                       timeout: float) -> None:
        """Publish one operator request into ``slot`` and wait for the
        poll loop to serve it (or serve it here when no loop runs);
        the request's exception is re-raised to the caller."""
        done = threading.Event()
        box: list = []
        with self._lock:
            if getattr(self, slot) is not None:
                raise RuntimeError(f"a {what} request is already pending")
            setattr(self, slot, args + (done, box))
        self._wake.set()
        if self._thread is None or not self._thread.is_alive():
            self.step()
        elif not done.wait(timeout):
            raise TimeoutError(f"{what} did not run (loop stalled?)")
        if box:
            raise box[0]

    def recover_replica(self, r: int, donor: Optional[int] = None,
                        timeout: float = 60.0) -> None:
        """Snapshot-recover replica ``r`` from ``donor`` (default: current
        leader): install the consensus determinant and transfer the event
        history into r's stable store (reset first — never duplicated).
        The app instance behind r must be fresh (restarted): its state is
        rebuilt by replaying the store, and the call returns once the app
        has consumed it. Executes inside the poll loop."""
        self._admin_request("_recover_req", (r, donor), "recovery",
                            timeout)

    def reset_app(self, r: int, timeout: float = 60.0) -> None:
        """Exit mis-speculation quarantine: the operator has restarted
        replica ``r``'s app FRESH; rebuild its state from r's own app
        checkpoint plus committed store (complete — persistence continued
        while dirty) and resume live replay; returns once the app has
        consumed that history. Executes inside the poll loop."""
        self._admin_request("_reset_req", (r,), "app reset", timeout)

    def checkpoint_app(self, r: int, timeout: float = 60.0) -> None:
        """Capture replica ``r``'s app state (follower only — a
        speculative leader's app runs AHEAD of commit) at its current
        store index, persist it, and compact the store prefix it covers.
        Executes inside the poll loop so the app/store pair is frozen at
        a consistent point."""
        self._admin_request("_ckpt_req", (r,), "checkpoint", timeout)

    def _ckpt_path(self, r: int) -> Optional[str]:
        if self._workdir is None:
            return None
        return os.path.join(self._workdir, f"replica{r}.ckpt")

    def _read_ckpt(self, r: int):
        """-> (index, blob) of replica ``r``'s app checkpoint, or None."""
        path = self._ckpt_path(r)
        if path is None or not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            raw = f.read()
        if len(raw) < 8:
            return None
        return struct.unpack("<Q", raw[:8])[0], raw[8:]

    def _do_checkpoint(self, r: int) -> None:
        rt = self.runtimes[r]
        if self.app_snapshot is None:
            raise RuntimeError("no app_snapshot hook configured")
        if rt.replay is None or rt.store is None:
            raise RuntimeError("replica has no app/store")
        if self._leader_view == r:
            raise RuntimeError(
                "checkpoint must come from a follower: a speculative "
                "leader's app state runs ahead of commit")
        if rt.app_dirty:
            raise RuntimeError("cannot checkpoint a dirty app")
        dump_fn = self.app_snapshot[0]
        # store[base, n) was DELIVERED to the app's replay sockets, but
        # delivery is not consumption: barrier first, or compact(n)
        # could drop records the checkpoint does not cover
        n = len(rt.store)
        if not self._await_replay_consumed(rt):
            raise RuntimeError(
                "app did not consume its replay stream (quiesce "
                "timeout); checkpoint aborted to protect compaction")
        with rt.replay.raw_conn() as s:
            blob = dump_fn(s)
        atomic_write(self._ckpt_path(r), struct.pack("<Q", n) + blob)
        rt.store.compact(n)
        self.obs.metrics.inc("checkpoints_total", replica=r)
        self.obs.trace.record(obs_trace.CHECKPOINT_TAKEN, replica=r,
                              record=n, blob_bytes=len(blob))
        rt.log.info_wtime(
            "CHECKPOINT: app state at record %d (%d bytes); store "
            "compacted" % (n, len(blob)))

    def _await_replay_consumed(self, rt: _ReplicaRuntime) -> bool:
        """Wait until ``rt``'s app has consumed every byte replayed into
        it: a protocol probe per replay connection when the
        ``app_snapshot`` hook has one (processed input), else kernel
        queue quiescence (read input). False when quiescence could not
        be verified."""
        probe_fn = (self.app_snapshot[2] if self.app_snapshot is not None
                    and len(self.app_snapshot) > 2 else None)
        if probe_fn is not None:
            rt.replay.barrier(probe_fn)
            return True
        return rt.replay.quiesce()

    def _rebuilt_app_ready(self, rt: _ReplicaRuntime, what: str) -> None:
        """The end of an operator rebuild of a fresh app: return only
        once the app has consumed its replayed history, so a caller's
        next request sees the rebuilt state (the JAX driver returns on
        delivery)."""
        if not self._await_replay_consumed(rt):
            rt.log.info_wtime("%s: the app's consumption of its replayed "
                              "history could not be verified" % what)

    def _restore_ckpt(self, rt: _ReplicaRuntime, ckpt) -> None:
        restore_fn = self.app_snapshot[1]
        with rt.replay.raw_conn() as s:
            restore_fn(s, ckpt[1])

    def _do_reset_app(self, r: int) -> None:
        rt = self.runtimes[r]
        if rt.replay is not None:
            rt.replay.close()
            rt.replay = ReplayEngine("127.0.0.1", rt.app_port)
        if rt.store is not None and rt.replay is not None:
            if rt.store.base > 0:
                # the compacted prefix is covered by this replica's own
                # app checkpoint: restore it, then replay the suffix
                ckpt = self._read_ckpt(r)
                if (ckpt is None or ckpt[0] != rt.store.base
                        or self.app_snapshot is None):
                    raise RuntimeError(
                        "store compacted to %d but no matching app "
                        "checkpoint to rebuild from" % rt.store.base)
                self._restore_ckpt(rt, ckpt)
            replay_store_into(rt.store, rt.replay, start=0)
            self._rebuilt_app_ready(rt, "APP RESET")
        rt.app_dirty = False
        rt.log.info_wtime("APP RESET: rebuilt from committed store")

    def _do_recover(self, r: int, donor: Optional[int],
                    app_fresh: bool = True, ledger=None,
                    min_verified: int = 1) -> None:
        """``app_fresh=False`` (the auto-recovery path) replays only the
        DELTA of the donor's history into r's still-running app — the
        app already executed its own store's prefix; a full replay would
        double-apply non-idempotent commands. ``ledger`` (an
        ``AuditLedger``) makes the transfer DIGEST-VERIFIED: the snapshot
        carries the donor's audit-chain position and the install refuses
        a donor contradicting the ledger majority, raising before any
        state (device, store or app) is touched."""
        donor = self._leader_view if donor is None else donor
        if donor < 0:
            raise RuntimeError("no donor available")
        with self.cluster._host_lock:
            require_drained(self.cluster._tickets, "_do_recover")
            snap = self._install_donor_snapshot(
                r, donor, ledger=ledger, min_verified=min_verified)
        self._load_donor_history(r, donor, snap, app_fresh)

    # holds-lock: _host_lock (the engine's, with no dispatch in flight)
    def _install_donor_snapshot(self, r: int, donor: int, *, ledger=None,
                                min_verified: int = 1):
        """The device half of a recovery: snapshot the donor, restore r's
        vote, install (digest-verified against ``ledger`` when given).
        The determinant and vote reads are host syncs, safe only with
        nothing in flight (the caller holds the engine's host lock,
        which brackets every dispatch, with no ticket)."""
        drt, rrt = self.runtimes[donor], self.runtimes[r]
        blob = drt.store.dump() if drt.store else b""
        # the blob matches the donor's HOST apply counter; the device
        # apply can lag it by one step's echo — snapshot at the host's
        snap = take_snapshot(self.cluster.state, donor, blob,
                             index=int(self.cluster.applied[donor]),
                             digests=ledger is not None,
                             rebased_total=self.cluster.rebased_total)
        # election durability: the newest vote among live peers' records
        # (read BEFORE the install wipes r's rows) and r's HardState
        # file; the current term is floored at all of them
        vt, vf = recover_vote(self.cluster.state, r)
        hs = rrt.hard.load() if rrt.hard is not None else None
        cur_term = 0
        if hs is not None:
            cur_term = hs[0]
            if hs[1] > vt:
                vt, vf = hs[1], hs[2]
        self.cluster.state = install_snapshot(
            self.cluster.state, r, snap,
            voted_term=vt, voted_for=vf, cur_term=cur_term,
            ledger=ledger, min_verified=min_verified)
        self.cluster.applied[r] = snap.index
        rrt.replay_cursor = len(self.cluster.replayed[r])
        # undrained frames predate the snapshot load: appending them to
        # the freshly loaded store would duplicate history
        self.cluster.frames[r] = []
        return snap

    def _load_donor_history(self, r: int, donor: int, snap,
                            app_fresh: bool) -> None:
        """The host half of a recovery: load the donor's store into r's,
        carry a compacted donor's app checkpoint over, and replay into
        r's app — all of it for a fresh app, only the records beyond its
        old store for a live one."""
        rrt = self.runtimes[r]
        if rrt.store is None or not snap.store_blob:
            return
        if app_fresh and rrt.replay is not None:
            # every replay socket of the old engine leads to the app
            # process the operator replaced
            rrt.replay.close()
            rrt.replay = ReplayEngine("127.0.0.1", rrt.app_port)
        old_len = len(rrt.store)
        rrt.store.reset()
        rrt.store.load(snap.store_blob)
        base = rrt.store.base
        if base > 0:
            # the donor's store was compacted behind its app checkpoint:
            # carry the checkpoint over so r (and any later reset of r)
            # can cover the missing prefix
            if self.app_snapshot is None:
                raise RuntimeError(
                    "donor %d store is compacted (base %d) but no "
                    "app_snapshot hook is configured to restore its "
                    "checkpoint" % (donor, base))
            ckpt = self._read_ckpt(donor)
            if ckpt is None or ckpt[0] != base:
                raise RuntimeError(
                    "donor %d store compacted to %d but no matching app "
                    "checkpoint" % (donor, base))
            shutil.copyfile(self._ckpt_path(donor), self._ckpt_path(r))
            if app_fresh:
                self._restore_ckpt(rrt, ckpt)
            elif old_len < base:
                raise RuntimeError(
                    "live app executed only %d records but the donor "
                    "history now starts at %d — restart the app and use "
                    "reset_app" % (old_len, base))
        # fresh app: rebuild checkpoint + full retained history; live app
        # (auto recovery): deliver only the records beyond the prefix it
        # already executed — its own old store, a prefix of the donor's
        replay_store_into(rrt.store, rrt.replay,
                          start=0 if app_fresh else old_len)
        if app_fresh and rrt.replay is not None:
            self._rebuilt_app_ready(rrt, "RECOVERY")

    def _apply_new_entries(self, r: int, rt: _ReplicaRuntime) -> None:
        stream = self.cluster.replayed[r]
        n = len(stream)
        if rt.replay_cursor >= n:
            return
        self._phase_prof.start("apply_replay_ack")
        # the engine's decode left the new entries as COLUMNAR batches
        # (hostpath.ReplayBatch): the replay/ack sweep below touches
        # Python O(1) per window, not O(1) per entry
        segs = stream.segments_from(rt.replay_cursor)
        rt.replay_cursor = n
        if rt.store is not None:
            # frames were assembled vectorized during the window decode
            # (SimCluster.collect_frames); one syscall appends the batch
            blobs = self.cluster.frames[r]
            if blobs:
                self.cluster.frames[r] = []
                for b in blobs:
                    rt.store.append_framed(b)
        # a dirty app's state diverged: keep persisting (the store stays
        # the complete committed stream) but feed the app nothing
        replaying = rt.replay is not None and not rt.app_dirty
        own_max = -1
        n_replayed = 0

        def own_of(conns, _gens):
            return conn_origin(conns) == r

        for seg in segs:
            seg_max, ops, n_rem = plan_segment(seg, own_of,
                                               want_ops=replaying)
            own_max = max(own_max, seg_max)
            n_replayed += n_rem
            if replaying:
                # remote SEND runs arrive coalesced per connection
                # (one loopback write per run — byte-stream identical
                # for the app); CONNECT/CLOSE apply individually
                for etype, conn, payload in ops:
                    rt.replay.apply(etype, conn, payload)
        if replaying:
            rt.replay.drain_responses()
        if rt.store is not None:
            # the WRITE precedes the ack (store_record runs inside the
            # reference's apply, db-interface.c:65-96), but fdatasync
            # runs on a cadence, not on the ack path: the reference's
            # durability contract is a quorum's memory plus an
            # OS-buffered store write
            now = time.monotonic()
            if now - rt.last_sync > self.sync_period:
                self._phase_prof.start(PHASE_STORE_SYNC)
                rt.store.sync()
                self._phase_prof.stop(PHASE_STORE_SYNC)
                rt.last_sync = now
        if replaying and n_replayed:
            self.obs.metrics.inc("replayed_entries_total",
                                 n_replayed, replica=r)
        if own_max >= 0:
            # ack release by sequence: every own-origin entry carries
            # the fragment seq in req_id (monotone in commit order), so
            # commits are matched exactly even across leadership churn
            self._phase_prof.start("ack_release")
            releases = []
            self._phase_prof.start(PHASE_INTAKE_LOCK_WAIT)
            with self._lock:
                self._phase_prof.stop(PHASE_INTAKE_LOCK_WAIT)
                while rt.inflight and rt.inflight[0].seq <= own_max:
                    releases.append(rt.inflight.popleft())
            # spans first so the latency observe below can attach the
            # SAMPLED releases' span ids as histogram exemplars
            sampled = {}
            if releases:
                self.obs.trace.record(obs_trace.PROXY_ACK_RELEASE,
                                      replica=r, count=len(releases),
                                      submit_seq=own_max)
                sampled = {req: conn for conn, req
                           in self.obs.spans.ack_release(r, own_max)}
            now = time.perf_counter()
            n_event = 0
            for ev in releases:
                n_event += ev.release(0)
                seq = ev.seq
                # intake→release is the client-visible commit latency
                # (the spin at proxy.c:160, measured instead of spun)
                self.obs.metrics.observe(
                    "commit_latency_seconds", now - ev.t0,
                    buckets=LATENCY_BUCKETS_S,
                    exemplar=(span_trace_id(sampled[seq], seq)
                              if seq in sampled else None),
                    replica=r)
            if releases:
                self._count_released(r, len(releases), n_event)
            self._phase_prof.stop("ack_release")
        self._phase_prof.stop("apply_replay_ack")

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def _handle_loop_crash(self, exc: BaseException) -> None:
        """A raised step must never silently kill the poll thread with
        app threads parked on commit waits: record it, fail every
        blocked event so the apps sever/retry, and stop the loop."""
        import traceback
        self.loop_error = exc
        traceback.print_exc()
        self.obs.metrics.inc("loop_errors_total")
        with self._lock:
            for rt in self.runtimes:
                self._fail_inflight_locked(rt, "poll-loop crash")
        if self._workdir is not None:
            # post-mortem: persist the protocol trace ring next to the
            # replica logs
            try:
                self.obs.trace.dump_on_failure(
                    os.path.join(self._workdir, "trace_dump.json"),
                    reason=f"poll-loop crash: {exc!r}")
            except OSError:
                pass

    def _busy(self) -> bool:
        with self._lock:
            return bool(any(self._submitq)
                        or any(len(q) for q in self.cluster.pending)
                        or self._waiter_count()
                        # queued reads need steps to confirm/serve —
                        # keep the loop running until they resolve
                        or (self.cluster.reads is not None
                            and self.cluster.reads.pending_count())
                        or self._txn_live())

    # holds-lock: _lock
    def _waiter_count(self) -> int:
        """Blocked commit waiters across replicas (caller holds
        ``_lock``)."""
        return sum(len(rt.inflight) for rt in self.runtimes)

    def _pipeline_ready(self) -> bool:
        """True iff the next iteration may DISPATCH WITHOUT FINISHING —
        the stable-leader traffic path where pipelining is a pure
        latency/throughput transform. Everything else (elections, admin
        requests, config changes, recovery flags, rebase drains, idle
        heartbeats) drains the pipeline and runs the serial ``step()``."""
        if (self._recover_req is not None or self._reset_req is not None
                or self._ckpt_req is not None):
            return False
        c = self.cluster
        if c.last is None or self._leader_view < 0:
            return False
        if c.need_recovery or self.stepped_down:
            return False
        # a membership change in flight polls device-side config state
        # every step — drive it through drained serial steps
        if self._config_phase is not None:
            return False
        # a due repair action needs the drained serial path (snapshot
        # install and redigest are state surgery); pipelining re-engages
        # the iteration after the repair completes
        if self.repair is not None and self.repair.needs_drain():
            return False
        # stop dispatching once the i32-rollover threshold is crossed:
        # the rebase is deferred until the pipeline drains, and the
        # headroom margin covers only boundedly many in-flight bursts
        if int(c.last["end"].max()) >= self.cfg.rebase_threshold:
            return False
        if self._txn_live():
            return False
        # an open topology transition window runs its passes on the
        # drained serial path every iteration (seed -> freeze ->
        # cutover): hold pipelining for the whole window
        topo = getattr(c, "topology", None)
        if topo is not None and topo.needs_drain():
            return False
        # the governor engages/disengages depth-D pipelining: until
        # backlog has STOOD for engage_evals (or while shedding), the
        # serial path acks a commit one dispatch sooner
        if (self.governor is not None
                and not self.governor.decision.pipeline):
            return False
        # pipelining pays off only while APPEND BATCHES flow (encode
        # k+1 while k runs); with just blocked waiters and an empty
        # queue the serial loop acks a commit one dispatch sooner
        with self._lock:
            if not (any(self._submitq) or self._backlog()):
                return False
        # any expired follower election timer needs the serial path
        # (bursts and pipelined steps never fire timeouts)
        last = c.last
        for r, rt in enumerate(self.runtimes):
            if (not self._role_is_leader(last, r)
                    and rt.timer.expired()):
                return False
        return True

    def _role_is_leader(self, res, r: int) -> bool:
        return bool(res["role"][r] == int(Role.LEADER))

    # ------------------------------------------------------------------
    # idle quiescence
    # ------------------------------------------------------------------

    def _repair_idle(self) -> bool:
        """True iff the repair pipeline has nothing in flight: no due
        drain, no owned recoveries, no replica held in quarantine or
        probation (held replicas need steps to advance their
        hysteresis)."""
        if self.repair is None:
            return True
        if self.repair.needs_drain() or self.repair.owned():
            return False
        return not self._repair_held_any()

    def _repair_held_any(self) -> bool:
        return bool(self.repair.blocked_replicas(0))

    def _idle_margin(self) -> float:
        """Seconds until the earliest follower election timer would
        fire. The idle loop must dispatch a heartbeat step well before
        that — each step carries the heartbeat, so stepping IS the
        beat."""
        last = self.cluster.last
        m = float("inf")
        for r, rt in enumerate(self.runtimes):
            if self._role_is_leader(last, r):
                continue
            m = min(m, rt.timer.remaining())
        return m

    def _can_idle_skip(self) -> bool:
        """True iff this iteration may skip the device dispatch
        entirely: a led, healthy, traffic-free cluster with no admin or
        config work due and every follower election timer comfortably far from
        firing. Conservative by construction — any doubt dispatches the
        step."""
        if not self._idle_quiesce:
            return False
        c = self.cluster
        if c.last is None or self._leader_view < 0:
            return False
        # chaos drills (an attached link model, or a sharded engine's
        # per-group ones) own their own timing
        if (getattr(c, "link_model", None) is not None
                or getattr(c, "link_models", None)):
            return False
        # an active profiler capture wants the serving path visible
        if self.profile_session is not None and self.profile_session.active:
            return False
        with self._lock:
            if (self._recover_req is not None
                    or self._reset_req is not None
                    or self._ckpt_req is not None):
                return False
        if self._config_phase is not None:
            return False
        if c.need_recovery or self.stepped_down:
            return False
        if not self._repair_idle():
            return False
        if self._busy():
            return False
        return self._idle_margin() > self._idle_guard

    def _idle_park(self) -> None:
        """One idle-quiescence beat: count the avoided dispatch, keep
        the cadenced observability fresh, and park with exponential
        backoff — bounded well inside the follower-timer margin, and
        broken instantly by any intake event (``_wake``)."""
        self.obs.metrics.inc("idle_dispatches_avoided_total")
        if self._idle_backoff <= 0.001:
            # once per quiescence episode, not per beat
            self.obs.trace.record(obs_trace.IDLE_QUIESCE)
        self._cadence_observe()
        wait = min(self._idle_backoff, self._idle_margin() / 2)
        self._idle_backoff = min(self._idle_backoff * 2,
                                 self._idle_backoff_max)
        self._phase_prof.start(PHASE_IDLE_PARK)
        self._wake.wait(timeout=max(wait, 0.0005))
        self._phase_prof.stop(PHASE_IDLE_PARK)
        self._wake.clear()

    def _drain_pipeline(self) -> bool:
        """Block until the readback thread retired every in-flight
        ticket (device outputs read AND post-step host rules run).
        True when drained; False when the loop died."""
        with self._pl_cv:
            while self._pl_pending:
                if self.loop_error is not None:
                    return False
                if (self._rb_thread is not None
                        and not self._rb_thread.is_alive()):
                    return False
                self._pl_cv.wait(timeout=0.05)
        return self.loop_error is None

    def _readback_loop(self) -> None:
        """Consumer half of the pipelined driver: finish tickets in
        dispatch (FIFO) order and run every post-step host rule —
        including observability export — OFF the dispatch path."""
        self._bind_device()
        prof = self._phase_prof
        while True:
            prof.start(PHASE_READBACK_IDLE)
            ticket = self._pl_queue.get()
            prof.stop(PHASE_READBACK_IDLE)
            if ticket is None:
                return
            try:
                res = self.cluster.finish(ticket)
                self._post_step(res)
            except Exception as exc:  # noqa: BLE001
                self._handle_loop_crash(exc)
                with self._pl_cv:
                    self._pl_pending = 0
                    self._pl_cv.notify_all()
                return
            with self._pl_cv:
                self._pl_pending -= 1
                self._pl_cv.notify_all()

    def _dispatch_loop(self, period: float) -> None:
        prof = self._phase_prof
        while not self._stop.is_set():
            if self.loop_error is not None:
                return
            if not (self.pipeline >= 2 and self._pipeline_ready()):
                # serial iteration (elections / config / recovery /
                # rebase / idle heartbeat): drain first — the engine's
                # FIFO finish contract forbids a fused step() while
                # tickets are in flight
                prof.start(PHASE_PIPELINE_WAIT)
                drained = self._drain_pipeline()
                prof.stop(PHASE_PIPELINE_WAIT)
                if not drained:
                    return
                if self._stop.is_set():
                    return
                # the idle-skip check and the step share one crash
                # handler: a raised skip-path bug must fail blocked
                # waiters loudly, never park the loop dead silently
                try:
                    if self._can_idle_skip():
                        self._idle_park()
                        continue
                    self._idle_backoff = 0.001  # re-arm the backoff
                    self.step()
                except Exception as exc:  # noqa: BLE001
                    self._handle_loop_crash(exc)
                    return
                if not self._busy() and period:
                    prof.start(PHASE_IDLE_PARK)
                    self._wake.wait(timeout=period)
                    prof.stop(PHASE_IDLE_PARK)
                self._wake.clear()
                continue
            # ---- pipelined fast path: encode + dispatch only ----
            with self._pl_cv:
                if self._pl_pending >= self.pipeline:
                    prof.start(PHASE_PIPELINE_WAIT)
                    self._pl_cv.wait(timeout=0.05)
                    prof.stop(PHASE_PIPELINE_WAIT)
                    continue
            self._pump_submitq()
            dec = (self.governor.decision if self.governor is not None
                   else None)
            if (dec is not None and dec.coalesce_us > 0
                    and self._backlog()):
                # bounded admission-coalescing wait (governor): at a high
                # arrival rate with a window still filling, a beat of
                # patience ships fuller windows — never while shedding
                time.sleep(dec.coalesce_us / 1e6)
                self.obs.metrics.observe(
                    "governor_coalesce_us", dec.coalesce_us,
                    buckets=LATENCY_BUCKETS_US)
                self._pump_submitq()
            try:
                # dec.max_k can flip to 1 (SLO shed) between
                # _pipeline_ready and here: honor it with a no-take
                # heartbeat dispatch, never a burst; the next iteration
                # sees pipelining disengaged and drains to the serial path
                if self._backlog() and (dec is None or dec.max_k > 1):
                    ticket = self.cluster.begin_burst(
                        max_k=dec.max_k if dec is not None else None)
                else:
                    # waiters with empty queues: quorum/commit trails
                    # the last append by a step — advance it (no batch
                    # take: pipelined appends ride capacity-clamped
                    # bursts only, so shortfall requeues cannot reorder
                    # against in-flight dispatches)
                    ticket = self.cluster.begin_step(take_batch=False)
            except Exception as exc:  # noqa: BLE001
                self._handle_loop_crash(exc)
                return
            with self._pl_cv:
                self._pl_pending += 1
            self._pl_queue.put(ticket)

    def run(self, period: float = 0.0) -> None:
        """Run the polling loop in background threads. While client work
        is pending or blocked app threads await commit, the loop
        free-runs (the reference's busy commit loop). When idle it
        PARKS for up to ``period`` seconds and wakes INSTANTLY when a
        link thread hands it an event.

        With ``pipeline >= 2`` (the default) the stable-leader traffic
        path runs DOUBLE-BUFFERED: the dispatch thread encodes and
        enqueues batch k+1 while batch k is still on the card, and the
        readback thread waits for outputs and runs the post-step host
        rules. ``pipeline=0`` (or 1) keeps the fully serial loop.
        While it runs, each collection of the cyclic garbage collector
        is timed as the ``gc`` phase."""
        self._pl_pending = 0
        if self._on_gc not in gc.callbacks:
            gc.callbacks.append(self._on_gc)
        self._rb_thread = threading.Thread(target=self._readback_loop,
                                           daemon=True)
        self._rb_thread.start()

        def loop():
            self._bind_device()
            try:
                self._dispatch_loop(period)
            finally:
                self._pl_queue.put(None)     # retire the readback side
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def _on_gc(self, phase: str, _info) -> None:
        """``gc.callbacks`` hook: one collection, on whichever thread
        ran it, as the ``gc`` phase — two clock reads and an ``acc``
        update (and a ring slice while events are on), never a
        histogram observation: young collections come by the
        thousand a second."""
        if phase == "start":
            self._phase_prof.start(PHASE_GC)
        else:
            self._phase_prof.stop(PHASE_GC, observe=False)

    def prewarm(self) -> None:
        """Build and load the CUDA kernels, allocate every staging tier,
        run each step variant once and record the stable step's CUDA
        graphs (a stacked engine on the card), so the first served step
        never pays for ``nvcc`` and no capture runs beside the driver's
        threads. A failure here is a loop crash: it is recorded in
        ``loop_error``, every waiter fails, and it raises."""
        try:
            self.cluster.prewarm()
        except Exception as exc:
            self._handle_loop_crash(exc)
            raise

    def stop(self, join_timeout: float = 5.0) -> None:
        # idempotent: tests may stop explicitly and again from fixture
        # teardown — the second call must not touch closed native handles
        if getattr(self, "_stopped", False):
            return
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)
        self._stop.set()
        self._wake.set()
        # the ops exporter and series log are independent of the poll
        # thread — close them first so a wedged loop still leaves a
        # flushed series.jsonl and a closed port behind
        if self.exporter is not None:
            self.exporter.close()
        if self.series is not None:
            self.series.close()
        with self._pl_cv:
            self._pl_cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
            if self._thread.is_alive():
                # a wedged poll thread (e.g. blocked inside a device
                # step) may still be touching the native handles:
                # closing them under it would be a use-after-free.
                # Leak them loudly instead; a later stop() retries.
                # But FIRST fail every blocked commit waiter (and
                # queued read): with _stop set no step will ever
                # release them.
                if self.cluster.reads is not None:
                    self.cluster.reads.fail_all(
                        "stop (wedged poll thread)")
                if self.cluster.streams is not None:
                    self.cluster.streams.fail_all(
                        "stop (wedged poll thread)")
                with self._lock:
                    n = sum(len(rt.inflight) for rt in self.runtimes)
                    for rt in self.runtimes:
                        self._fail_inflight_locked(
                            rt, "stop (wedged poll thread)")
                self.obs.trace.record(obs_trace.STOP_FORCED,
                                      released=n)
                if self._workdir is not None:
                    try:
                        self.obs.trace.dump_on_failure(
                            os.path.join(self._workdir,
                                         "trace_dump.json"),
                            reason="stop: wedged poll thread")
                    except OSError:
                        pass
                self.runtimes[0].log.info_wtime(
                    "STOP: poll thread did not exit within %gs; "
                    "released %d inflight waiters with -1; leaving "
                    "native handles open" % (join_timeout, n))
                return
        if self._rb_thread is not None:
            self._pl_queue.put(None)
            self._rb_thread.join(timeout=join_timeout)
        # release commit waiters that were already inflight at stop —
        # nothing will ever step again, so they must fail, not hang
        # (queued reads the same: no step will ever confirm them)
        if self.cluster.reads is not None:
            self.cluster.reads.fail_all("stop")
        # watchers and scans the same: the pump quiesces and every
        # blocked subscriber poll fails fast (clients resume elsewhere
        # with their tokens); flushes the CDC sink
        if self.cluster.streams is not None:
            self.cluster.streams.fail_all("stop")
        with self._lock:
            for rt in self.runtimes:
                self._fail_inflight_locked(rt, "stop")
        try:
            for rt in self.runtimes:
                # one replica's close failure must not leak the rest
                for res in (rt.proxy, rt.replay, rt.store, rt.log):
                    if res is None:
                        continue
                    try:
                        res.close()
                    except OSError:
                        pass
            # a device-list engine's worker threads (none when stacked)
            self.cluster.close()
        finally:
            # latch only after the cleanup actually ran
            self._stopped = True

    def leader(self) -> int:
        with self._lock:
            return self._leader_view

    # ------------------------------------------------------------------
    # the linearizable read queue (runtime/reads.py)
    # ------------------------------------------------------------------

    def read_replica(self, group: int = 0) -> int:
        """The replica a linearizable read should target: the group's
        lease-serving holder (zero-traffic path) when one exists, else
        the leader (read-index path), else replica 0 (the hub confirms
        before serving, so a bad default only costs latency)."""
        lm = self.cluster.leases
        r = lm.serving_holder(group) if lm is not None else -1
        if r < 0:
            r = self.leader()
        return r if r >= 0 else 0

    def read(self, fn=None, *, replica: Optional[int] = None,
             group: int = 0, timeout: float = 30.0):
        """Queue one linearizable read and block until it serves (or
        fails). ``fn()`` runs AT the linearization point — on the
        readback thread, against the serving replica's applied state —
        and its return value lands on the returned ticket. Reads never
        enter ``begin_*``/``finish`` and never consume ring slots; an
        idle loop is woken so the confirming step dispatches
        immediately."""
        hub = self.cluster.reads
        if hub is None:
            raise RuntimeError(
                "driver was built with leases=False — no read path")
        if replica is None:
            replica = self.read_replica(group)
        t = hub.submit(fn, replica=replica, group=group)
        self._wake.set()
        t.wait(timeout)
        return t

    def can_serve_read(self, r: int) -> bool:
        """Read-index check: True iff replica ``r`` verified its
        leadership against a majority on the latest step, so a read of
        state at its commit index is linearizable (the reference verifies
        before answering pending reads — ep_dp_reply_read_req,
        dare_ep_db.c:132-161)."""
        last = self.cluster.last
        return (last is not None
                and bool(last["leadership_verified"][r]))
