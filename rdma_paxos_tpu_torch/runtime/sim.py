"""In-process multi-replica cluster: R replicas stacked on one device
(``mode="sim"``), or one replica per entry of a device list
(``mode="spmd"``), with the host-side bookkeeping of the replicated
write path.

In spmd mode the replicas' rows live on their entries' devices and are
the state's authority; a :class:`~rdma_paxos_tpu_torch.parallel.mesh.
DeviceWorld` steps them (one worker thread per entry, each step's seams
explicit exchanges), and the step, burst, scan tier and replay fetch run
on the world with stacked inputs and outputs, so every host rule below
is the stacked engine's. ``cluster.state`` is then an assembled
read-only view; assigning it places each row on its device, and
``cluster.blocks`` are the rows themselves.

The port of ``rdma_paxos_tpu/runtime/sim.py:SimCluster``'s core: client
submission, partitions through per-replica ``peer_mask`` rows, the
ticket contract ``begin_step``/``begin_burst`` -> ``finish`` (serial
``step()``/``step_burst()`` are exactly ``finish(begin_*())``), the
staging pool, requeue of shortfalls, the committed-entry replay with
its slot-recycling integrity check, the coordinated i32 rebase, and the
surface the driver reads: ``max_inflight_dispatches``, the ``obs``
facade (rebase counters and trace events, span stamps) and the
``profiler`` phase hooks, and :meth:`SimCluster.prewarm`.

``audit=True`` runs the digest-chain step variants and feeds every
step's windows to an ``obs/audit.py`` ledger (``auditor``), with a
bounded flight ring of step inputs and outputs (``flight``) and the
range re-digest (:meth:`SimCluster.redigest`); ``telemetry=True`` runs
the counter-vector variants and accumulates them in
``device_counters``. Both are ingested in ``finish`` (the readback
thread under the pipelined driver), before the rollover.

Attachments, as on the JAX engine: a chaos ``link_model``
(``chaos/faults.py:LinkModel``) refines ``peer_mask`` at every dispatch
with the dispatch clock (``_dispatch_clock``: +1 per ``begin_step``,
+K per ``begin_burst``), and the psum fan-out check applies to that
effective mask; the read path (``runtime/reads.py``, attached by
``reads.attach``) observes leases and drains queued reads at the tail
of every ``finish``; a transaction coordinator (``txn``) is told of its
records' appends after the stamp loop and observes every ``finish``
last, right after an adaptive dispatch governor
(``runtime/governor.py:attach_governor``). A repair controller
(``runtime/repair.py``) bars replicas from read serving through
``read_blocked``. A streams hub (``streams/``, attached by
``streams.attach``) observes every ``finish`` after the read drain and
before the governor: it notes the committed frontiers and kicks its
watch pump, all host-side.

``txn=True`` runs the serial steps with the cross-group transaction
lane (``txn/lane.py``): the watch armed by :meth:`SimCluster.
set_txn_watch` (an absolute index and its term) goes to the card in
log-offset domain, and a serial ``finish`` reports each replica's vote
as ``res["txn_vote"]``; bursts and scans never carry the lane.

Every device result a finish needs (the audit windows and telemetry
vectors included) is read back in ONE transfer, and a replay sweep
fetches only as many rows as the furthest-behind replica decodes.

On the card a stacked engine replays its stable step from CUDA graphs
(``parallel/graph.py``) that :meth:`SimCluster.prewarm` records: the
serial stable step and each of a burst's K steps are one replay each,
the same kernels on the engine's own state. The election step, the scan
tier, CPU engines and device-list engines stay eager.
``graph_replays`` (by path) and ``eager_steps`` (by reason) count the
protocol steps each way, and so do ``step_graph_replays_total`` and
``step_eager_total`` in an attached registry.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rdma_paxos_tpu_torch.config import (
    LogConfig, REBASE_STALL_STEPS, resolve_device)
from rdma_paxos_tpu_torch.consensus.log import EntryType, M_GIDX, META_W
from rdma_paxos_tpu_torch.consensus.snapshot import rebase_offsets
from rdma_paxos_tpu_torch.consensus.state import Role, clone_state
from rdma_paxos_tpu_torch.consensus.step import (
    SCAN_KEYS, VARIANT_FIELDS, StepInput, build_redigest, fetch_window)
from rdma_paxos_tpu_torch.obs import device as obs_device
from rdma_paxos_tpu_torch.parallel.graph import StepGraph
from rdma_paxos_tpu_torch.parallel.mesh import (
    DeviceLayout, DeviceWorld, build_sim_burst, build_sim_scan,
    build_sim_step, build_spmd_burst, build_spmd_scan, build_spmd_step,
    join_state, make_replica_mesh, run_fetch, split_state, stack_states)
from rdma_paxos_tpu_torch.runtime import hostpath
from rdma_paxos_tpu_torch.runtime.hostpath import LazyReplayStream


def cap_tiers(k_tiers: Sequence[int],
              max_k: Optional[int]) -> Tuple[int, ...]:
    """The fused tiers bounded at ``max_k``; ``max_k <= 1`` is the
    serial step, not a burst tier, and is refused."""
    if max_k is None:
        return tuple(k_tiers)
    if int(max_k) < 2:
        raise ValueError(
            "max_k <= 1 is the serial step tier — dispatch step(), "
            "not a capped burst")
    return tuple(k for k in k_tiers if k <= int(max_k)) \
        or tuple(k_tiers[:1])


# Built device functions shared across engines, keyed like the JAX
# package's ``STEP_CACHE``. The port compiles nothing and each engine binds
# its own step functions, so the only entries are the re-digest passes of
# :func:`redigest_fn`: the dict spares rebuilding their closures.
STEP_CACHE: Dict[tuple, object] = {}


def redigest_fn(cfg: LogConfig, window_slots: int):
    """The range re-digest pass (``consensus/step.py:build_redigest``),
    built once per ``(cfg, window_slots)``. Its key carries a distinct
    ``"redigest"`` marker, and only :func:`run_redigest` builds one, so a
    repair-off cluster adds no key."""
    key = (cfg, "redigest", int(window_slots))
    fn = STEP_CACHE.get(key)
    if fn is None:
        fn = STEP_CACHE[key] = build_redigest(
            cfg, window_slots=window_slots)
    return fn


def run_redigest(cluster, buf_row, lo: int, hi: int, *, group: int,
                 rebased_total: int, replica: int) -> int:
    """Digest the committed entries ``[lo, hi)`` (raw offsets) of one
    replica's ring row ``buf_row`` and feed them to the cluster's ledger
    as BACKFILL windows (absolute indices; the ledger's frontier
    self-check is not consulted for out-of-order history). The stamped
    gidx column must equal the expected index for every digested entry:
    a recycled slot means the range is no longer physically present,
    and backfilling it would fabricate coverage. Returns the number of
    indices recorded. Needs the dispatches drained (the pass reads the
    ring an in-flight step writes in place) and ``lo >= head``."""
    require_drained(cluster._tickets, "redigest")
    if cluster.auditor is None:
        raise RuntimeError("redigest requires an audit=True cluster")
    lo, hi = int(lo), int(hi)
    if hi <= lo:
        return 0
    W = cluster._replay_W
    fn = redigest_fn(cluster.cfg, W)
    done = 0
    start = lo
    while start < hi:
        with cluster._host_lock:
            out = torch.stack(fn(buf_row, start))
        dig_trm_gix = out.cpu().numpy()             # one transfer
        dig = dig_trm_gix[0].view(np.uint32)
        trm, gix = dig_trm_gix[1], dig_trm_gix[2]
        n = min(hi - start, W)
        expect = np.arange(start, start + n, dtype=gix.dtype)
        if not np.array_equal(gix[:n], expect):
            bad = int(np.argmax(gix[:n] != expect))
            raise RuntimeError(
                "redigest integrity: slot of index %d holds gidx %d "
                "(recycled past the range) — cannot backfill" %
                (start + bad, int(gix[bad])))
        cluster.auditor.record_window(
            replica, start + rebased_total, dig[:n], trm[:n],
            start + n + rebased_total, group=group, backfill=True,
            step=cluster.step_index)
        done += n
        start += n
    return done


def cap_scan_tiers(cluster, K: int) -> None:
    """Cap an engine's fused tiers at ``K`` (the benches' ``--scan K``):
    K must be >= 2, the smallest fused tier; the burst and scan sizing
    then pick the smallest capped tier covering the backlog."""
    K = int(K)
    if K < 2:
        raise ValueError(
            "scan K must be >= 2 (the smallest fused tier)")
    cluster.K_TIERS = (tuple(t for t in cluster.K_TIERS if t <= K)
                       or cluster.K_TIERS[:1])


def engine_device(device, n_entries: int, axes: str, build):
    """An engine's device list (None: the machine's cards) as its
    layout, via ``build(devices)``; a single device is refused, so no
    list is ever implied."""
    if isinstance(device, DeviceLayout):
        return device
    if device is not None and not isinstance(device, (list, tuple)):
        raise ValueError(
            f"the {axes} engine takes a device list of {n_entries} "
            f"entries (e.g. ['cpu'] * {n_entries}), or None for the "
            f"machine's cards; got {device!r}")
    return build(device)


# the StepPhaseProfiler phase of finish()'s host rules outside
# quorum_wait and apply (stamping, requeue, rebase, span frontiers,
# leases, reads, governor, staging): opened and closed twice a finish
PHASE_FINISH_RULES = "finish_rules"


def _versions(state) -> tuple:
    return (state.log.buf._version,) + tuple(
        getattr(state, f.name)._version
        for f in dataclasses.fields(state) if f.name != "log")


def require_drained(tickets, site: str) -> None:
    """A serial step while dispatches are in flight would finish out of
    FIFO order: refuse up front."""
    if tickets:
        raise RuntimeError(
            "%s() with %d in-flight dispatch(es): finish the "
            "pipeline first" % (site, len(tickets)))


def requeue_shortfall(pending: List, take: List, acc: int) -> None:
    """The appended set is always a PREFIX of ``take``: requeue the
    remainder at the front of ``pending``, in order (in place)."""
    if acc < len(take):
        pending[:0] = take[acc:]


def clamp_burst_take(pending_len: int, end: int, head: int,
                     n_slots: int, max_take: int,
                     reserved: int = 0) -> int:
    """Never enqueue more than the ring can take without drops (a
    mid-burst drop would reorder a connection's fragments).
    ``reserved``: appends dispatched but not yet reflected in ``end``."""
    avail = (n_slots - 1) - (end - head) - reserved
    return min(pending_len, max(avail, 0), max_take)


def rebase_delta_of(heads: Sequence[int], n_slots: int) -> int:
    """The rollover delta: the minimum head rounded DOWN to a multiple
    of ``n_slots``; <= 0 means it cannot fire."""
    if not heads:
        return 0
    return min(heads) & ~(n_slots - 1)


def decode_window(wm: np.ndarray, wd: np.ndarray, n: int,
                  replayed: List, frames: Optional[List],
                  collect_frames: bool, rebase: int = 0) -> None:
    """Decode ``n`` fetched entries as one batch onto ``replayed`` (and
    the store-ready framed blob onto ``frames`` when collected)."""
    batch = hostpath.decode_batch(wm, wd, n, rebase)
    if batch is None:
        return
    hostpath.extend_stream(replayed, batch)
    if collect_frames:
        frames.append(batch.frames())


class StepTicket:
    """One dispatched-but-not-finished step or burst."""

    __slots__ = ("kind", "out", "taken", "timeouts", "K", "bufs",
                 "applied0", "graph")

    def __init__(self, kind: str, out, taken, timeouts, K: int, bufs,
                 applied0=None, graph=None):
        self.kind = kind          # "step" | "burst" | "scan"
        self.out = out
        self.taken = taken
        self.timeouts = timeouts
        self.K = K
        self.bufs = bufs
        self.applied0 = applied0  # scan: the replay rows start here
        # the StepGraph replayed (``out["packed"]``: its rows), or None
        self.graph = graph


class StagingPool:
    """Reusable host staging buffers for window encode; a released set
    has only the rows its user wrote zeroed."""

    def __init__(self):
        self._pools: Dict[tuple, List[dict]] = {}
        self._lock = threading.Lock()

    def acquire(self, key: tuple, make) -> dict:
        with self._lock:
            pool = self._pools.setdefault(key, [])
            if pool:
                return pool.pop()
        bufs = make()
        bufs["data_u8"] = bufs["data"].view(np.uint8)
        bufs["key"] = key
        return bufs

    def release(self, bufs: dict, dirty_rows) -> None:
        data, meta = bufs["data"], bufs["meta"]
        for idx, n in dirty_rows:
            if n > 0:
                data[idx][:n] = 0
                meta[idx][:n] = 0
        with self._lock:
            self._pools[bufs["key"]].append(bufs)


def pack_rows(bufs: dict, idx: tuple, take: Sequence[Tuple],
              slot_bytes: int) -> None:
    """Write (etype, conn, req, payload) rows into the staging buffers
    at ``idx`` (``(r,)`` or ``(k, r)``)."""
    hostpath.pack_window(bufs["data_u8"][idx], bufs["meta"][idx],
                         take, slot_bytes)


def assemble_frames(types, conns, lens, raw, idxs) -> bytes:
    """Store-ready framed blob ``([u32 len][u8 etype][u32 conn]
    [payload])*`` of the client entries at ``idxs`` of a decoded window
    (``raw``: its ``[n, slot_bytes]`` u8 rows; lengths clipped to the
    slot width), built by ``hostpath.frames_from_cols`` over the
    compacted payloads."""
    row = raw.shape[1]
    cl = np.minimum(lens[idxs].astype(np.int64), row)
    keep = np.arange(row, dtype=np.int64) < cl[:, None]
    blob = raw[idxs][keep].tobytes()
    offs = np.zeros(idxs.size + 1, np.int64)
    np.cumsum(cl, out=offs[1:])
    return hostpath.frames_from_cols(types[idxs], conns[idxs], cl,
                                     blob, offs)


class SimCluster:
    """R-replica protocol engine with host bookkeeping: stacked on one
    device (``mode="sim"``), or one replica per entry of a device list
    (``mode="spmd"``).

    ``mode="sim"`` runs on the card unless ``device="cpu"`` is passed;
    ``mode="spmd"`` takes a device list of R entries (``device=None``:
    the machine's cards, one per replica; a list may repeat a device,
    e.g. ``["cpu"] * 3``) and a :class:`~rdma_paxos_tpu_torch.parallel.
    mesh.DeviceWorld` steps each entry's row on its own thread. Either
    raises when a named card is absent; neither falls back."""

    # burst size tiers: the smallest tier >= the steps needed is used,
    # padded with zero-count steps
    K_TIERS = (2, 4, 8, 16)

    RES_KEYS = ("term", "role", "leader_id", "voted_term", "voted_for",
                "head", "apply", "commit", "end", "hb_seen",
                "became_leader", "acked", "accepted", "peer_acked",
                "leadership_verified", "rebase_delta")

    REBASE_STALL_STEPS = REBASE_STALL_STEPS

    def __init__(self, cfg: LogConfig, n_replicas: int,
                 group_size: Optional[int] = None, *,
                 mode: str = "sim",
                 fanout: str = "gather", stable_fast_path: bool = True,
                 scan: bool = False, device=None,
                 audit: bool = False, flight_capacity: int = 64,
                 telemetry: bool = False, txn: bool = False):
        if mode not in ("sim", "spmd"):
            raise ValueError(f"unknown mode {mode!r}")
        if fanout not in ("gather", "psum"):
            raise ValueError(f"unknown fanout {fanout!r}")
        self._mode = mode
        self._host_lock = threading.RLock()
        if mode == "spmd":
            # one replica row per entry of the device list, stepped by
            # the world's threads; the rows are the state's authority
            self.mesh = engine_device(
                device, n_replicas, "spmd",
                lambda d: make_replica_mesh(n_replicas, d))
            self.world = DeviceWorld(self.mesh)
            weakref.finalize(self, self.world.close)
            self.device = self.world.device
        else:
            self.mesh = self.world = None
            self.device = resolve_device(device)
        self._view = None
        self.cfg = cfg
        self.R = n_replicas
        self.group_size = group_size or n_replicas
        self.scan = bool(scan)
        self.scan_dispatches = 0
        self._fanout = fanout
        self._stable_fast_path = stable_fast_path
        # the step variants: audit=True adds the digest windows (fed to
        # the ledger, with a bounded flight ring of dispatches),
        # telemetry=True the device counter vectors (accumulated into
        # device_counters [R, T_N]), and txn=True the prepare votes of
        # the serial steps; all off, the steps are unchanged
        self._audit = bool(audit)
        self._telemetry = bool(telemetry)
        self._txn = bool(txn)
        # the armed prepare watch: an ABSOLUTE index (-1 = clear) and the
        # term it was appended under; begin_step converts the index to
        # the log-offset domain the card compares in
        self._txn_watch = -1
        self._txn_wterm = 0
        if audit:
            from rdma_paxos_tpu_torch.obs.audit import (
                AuditLedger, FlightRecorder)
            self.auditor = AuditLedger(n_replicas)
            self.flight = FlightRecorder(flight_capacity)
        else:
            self.auditor = None
            self.flight = None
        self.device_counters = (obs_device.zeros(n_replicas)
                                if telemetry else None)
        variants = dict(audit=self._audit, telemetry=self._telemetry)
        if self.world is None:
            self._steps = {e: build_sim_step(
                cfg, n_replicas, fanout=fanout, elections=e, txn=self._txn,
                **variants) for e in (True, False)}
            self._burst = build_sim_burst(cfg, n_replicas, fanout=fanout,
                                          **variants)
        else:
            self._steps = {e: self._on_world(build_spmd_step(
                cfg, n_replicas, self.mesh, fanout=fanout, elections=e,
                txn=self._txn, **variants)) for e in (True, False)}
            self._burst = self._on_world(build_spmd_burst(
                cfg, n_replicas, self.mesh, fanout=fanout, **variants))
        self._scans: Dict[int, object] = {}
        # the stable dispatches recorded as CUDA graphs ("step", "burst"):
        # by prewarm() on a stacked engine on the card, else none
        self._graphs: Dict[str, StepGraph] = {}
        # protocol steps replayed from a graph, by path, and run eagerly,
        # by reason ("elections": a timer fired; "no_capture": no graph)
        self.graph_replays = {"step": 0, "burst": 0}
        self.eager_steps = {"elections": 0, "no_capture": 0}
        # guarded-by: _host_lock [writes]
        self.state = stack_states(cfg, n_replicas, self.group_size,
                                  device=self.device)
        # the replay window is wider than the protocol window: a K-step
        # burst commits up to K*batch_slots entries at once
        self._replay_W = min(cfg.n_slots // 2,
                             max(4 * cfg.window_slots, 256))
        # host apply cursor — single-writer: advanced in place by the
        # finishing (readback) thread only; whole-array WRITES rebind
        # under the lock  # guarded-by: _host_lock [writes]
        self.applied = np.zeros(n_replicas, np.int64)
        self.peer_mask = np.ones((n_replicas, n_replicas), np.int32)
        # guarded-by: _host_lock
        self.pending: List[List[Tuple[int, int, int, bytes]]] = [
            [] for _ in range(n_replicas)]
        # pipelined dispatch (begin_*/finish): FIFO of in-flight tickets
        # guarded-by: _host_lock
        self._tickets: collections.deque = collections.deque()
        self._staging = StagingPool()
        self.inflight_dispatches = 0         # guarded-by: _host_lock
        # the witness that a pipelined driver really overlapped dispatches
        self.max_inflight_dispatches = 0     # guarded-by: _host_lock
        # published by pointer swap under the lock; lock-free READS see
        # a complete (stale at worst) result dict by design
        # guarded-by: _host_lock [writes]
        self.last: Optional[Dict[str, np.ndarray]] = None
        self.replayed: List[LazyReplayStream] = [
            LazyReplayStream() for _ in range(n_replicas)]
        self.collect_frames = False
        self.frames: List[List[bytes]] = [[] for _ in range(n_replicas)]
        # replicas force-pruned past their apply cursor: replay stops
        # (recycled slots must never reach the app) until recovery
        self.need_recovery: set = set()
        self._wedged: set = set()
        self.rebases = 0
        self.rebased_total = 0
        self.rebase_stall_steps = 0
        self.rebase_stalled = 0
        self.step_index = 0
        # host-side observability facade and step-phase profiler,
        # attached by the driver (or tests); never read by the step
        self.obs = None
        self.profiler = None
        # per-link fault model (chaos/faults.py), consulted at every
        # dispatch with the dispatch clock; host-side input data only
        self.link_model = None
        # read path (runtime/reads.py, attached via reads.attach):
        # leases observed and queued reads drained at the tail of every
        # finish() — the readback thread under the pipelined driver
        self.leases = None
        self.reads = None
        # cross-group 2PC coordinator (txn/coordinator.py, attached by
        # txn.attach_coordinator): told of its records' appends after
        # the stamp loop and observed at the very tail of every finish()
        self.txn = None
        # adaptive dispatch governor (runtime/governor.py, attached by
        # governor.attach_governor): observed at the tail of every
        # finish(), before the coordinator; the tier it picks is always
        # one of K_TIERS, so it builds no function the ungoverned engine
        # would not
        self.governor = None
        # replicas barred from SERVING reads by the repair pipeline
        # (digest quarantine and the storm policy, whose holds leave
        # replay running and so never enter need_recovery) — consulted
        # by the KVS serving gate and the read hub
        self.read_blocked: set = set()
        # log-as-product streams (streams/, attached by streams.attach):
        # observed at the finish() tail after the read drain and before
        # the governor (a deep watch backlog is demand the governor
        # counts); host bookkeeping only
        self.streams = None
        # dispatch-side logical clock: advances at begin_* (step_index
        # advances at finish) so an in-flight pipeline never feeds the
        # link model the same per-step randomness twice; serial callers
        # see the two clocks equal at every dispatch
        self._dispatch_clock = 0
        # runtime lock sanitizer (analysis/runtime_guard.py): under
        # RP_SANITIZE=1 the guarded-by declarations above become
        # per-access lock-ownership assertions — a latent unlocked
        # mutation fails the test at the exact access. No-op otherwise.
        from rdma_paxos_tpu_torch.analysis import runtime_guard
        runtime_guard.maybe_guard(self, "_host_lock", __file__)

    # ---------------- client-side API ----------------

    def submit(self, replica: int, payload: bytes,
               etype: EntryType = EntryType.SEND, conn: int = 1,
               req_id: int = 0) -> None:
        """Queue a client entry for the next step on ``replica`` (it
        enters the log only if that replica is leader)."""
        with self._host_lock:
            self.pending[replica].append(
                (int(etype), conn, req_id, payload))

    def submit_many(self, replica: int,
                    entries: Sequence[Tuple[int, int, int, bytes]]
                    ) -> None:
        with self._host_lock:
            self.pending[replica].extend(entries)

    def set_txn_watch(self, index: int, term: int) -> None:
        """Arm the prepare watch: every later serial step reports a
        per-replica vote on whether ABSOLUTE log index ``index`` is
        committed under ``term`` (txn=True clusters only). Sticky until
        :meth:`clear_txn_watch`."""
        if not self._txn:
            raise RuntimeError("set_txn_watch requires txn=True")
        self._txn_watch = int(index)
        self._txn_wterm = int(term)

    def clear_txn_watch(self) -> None:
        self._txn_watch = -1
        self._txn_wterm = 0

    def partition(self, groups: Sequence[Sequence[int]]) -> None:
        """Split the cluster: replicas hear only same-group peers."""
        if self._fanout == "psum":
            raise ValueError(
                "partitions cannot be modeled with fanout='psum'; "
                "build the cluster with fanout='gather'")
        self.peer_mask[:] = 0
        for g in groups:
            for i in g:
                for j in g:
                    self.peer_mask[i, j] = 1
        np.fill_diagonal(self.peer_mask, 1)

    def heal(self) -> None:
        self.peer_mask[:] = 1

    def wedge_apply(self, r: int) -> None:
        """Freeze replica ``r``'s apply progress (a wedged app)."""
        self._wedged.add(r)

    def unwedge_apply(self, r: int) -> None:
        self._wedged.discard(r)

    # ---------------- the state and the device list ----------------

    @property
    def state(self):
        """The engine's state. On a device list it is the stacked view
        assembled from the entries' rows (a copy, rebuilt after every
        change): read-only — a write into it raises at the next dispatch
        rather than being lost. Assigning ``cluster.state = st`` places
        every entry's part of ``st`` on its device (the JAX engine's
        ``device_put``); :attr:`blocks` are the rows themselves."""
        if self.world is None:
            return self._state
        with self._host_lock:
            if self._view is None:
                self._view = join_state(self.world.sharding, self._blocks,
                                        device=self.device)
                self._view_versions = _versions(self._view)
            return self._view

    @state.setter
    def state(self, st) -> None:
        if self.world is None:
            self._state = st
            return
        with self._host_lock:
            self._blocks = split_state(self.world.sharding, st)
            self._view = None

    @property
    def blocks(self) -> list:
        """A device list's per-entry state blocks, each on its device
        (``[1, ...]``; ``[Gl, 1, ...]`` on a 2-D layout): writes into
        them land in the engine's state."""
        with self._host_lock:
            self._drop_view()
            return self._blocks

    # holds-lock: _host_lock
    def _drop_view(self) -> None:
        v, self._view = self._view, None
        if v is not None and _versions(v) != self._view_versions:
            raise RuntimeError(
                "the assembled state of a device-list engine was written "
                "in place, and the write would be lost: assign "
                "cluster.state = ... or write cluster.blocks")

    def _guard_view(self) -> None:
        """Refuse a dispatch after a write into the assembled view,
        before any batch is taken."""
        if self.world is not None:
            with self._host_lock:
                self._drop_view()

    # holds-lock: _host_lock
    def _live(self):
        """What a dispatch steps: the stacked state, or the blocks."""
        if self.world is None:
            return self._state
        self._drop_view()
        return self._blocks

    # holds-lock: _host_lock
    def _store(self, st) -> None:
        if self.world is None:
            self._state = st
        else:
            self._blocks = st

    # holds-lock: _host_lock
    def _rewrite(self, fn) -> None:
        """``fn(state, i)`` over the stacked state (``i`` None) or over
        every entry's block on its device (entry ``i``), stored back."""
        if self.world is None:
            self._state = fn(self._state, None)
        else:
            self._drop_view()
            self._blocks = [fn(b, i) for i, b in enumerate(self._blocks)]

    def clone_live(self):
        """A copy of what a dispatch steps (prewarm and program reports
        run the step variants on it)."""
        with self._host_lock:
            if self.world is None:
                return clone_state(self._state)
            return [clone_state(b) for b in self._blocks]

    def _on_world(self, prog):
        """A device-list program bound to this engine's world: the
        ``fn(state, *inputs)`` signature of the stacked builders."""
        return functools.partial(prog, self.world)

    def _fetch(self, starts: torch.Tensor, rows: int):
        """The replay fetch: ``rows`` ring rows of every replica from
        ``starts`` (each entry reads its own ring on a device list)."""
        if self.world is None:
            return fetch_window(self._state.log, starts, window_slots=rows)
        return run_fetch(self.world, self._blocks, starts, rows)

    def ring(self, replica: int) -> torch.Tensor:
        """Replica ``replica``'s fused ring ``[n_slots, cols]``, in place
        on its device."""
        if self.world is None:
            return self._state.log.buf[replica]
        return self._blocks[replica].log.buf[0]

    def close(self) -> None:
        """Join a device list's worker threads (a no-op when stacked)."""
        if self.world is not None:
            self.world.close()

    # ---------------- stepping ----------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, copy=True)

    def _effective_mask(self) -> np.ndarray:
        """The step's hear-matrix: the base ``peer_mask``, refined by
        the attached link model at the dispatch clock."""
        if self.link_model is None:
            return self.peer_mask
        return self.link_model.effective_mask(self.peer_mask,
                                              self._dispatch_clock)

    def _check_dispatch(self, mask: np.ndarray) -> None:
        """Refuse a non-full effective mask under the psum fan-out."""
        if self._fanout == "psum" and not mask.all():
            raise ValueError(
                "psum fan-out requires full connectivity; use "
                "fanout='gather' to model partitions")

    def _step_bufs(self) -> dict:
        cfg, R, B = self.cfg, self.R, self.cfg.batch_slots
        return self._staging.acquire(
            ("step", R, B), lambda: dict(
                data=np.zeros((R, B, cfg.slot_words), np.int32),
                meta=np.zeros((R, B, META_W), np.int32)))

    def _burst_bufs(self, K: int) -> dict:
        cfg, R, B = self.cfg, self.R, self.cfg.batch_slots
        return self._staging.acquire(
            ("burst", K, R, B), lambda: dict(
                data=np.zeros((K, R, B, cfg.slot_words), np.int32),
                meta=np.zeros((K, R, B, META_W), np.int32)))

    # holds-lock: _host_lock
    def reserved_appends(self) -> np.ndarray:
        """Per-replica appends dispatched but not yet finished."""
        out = np.zeros(self.R, np.int64)
        for t in self._tickets:
            for r in range(self.R):
                out[r] += len(t.taken[r])
        return out

    # holds-lock: _host_lock
    def _enqueue(self, ticket: StepTicket) -> StepTicket:
        self._tickets.append(ticket)
        self.inflight_dispatches += 1
        self.max_inflight_dispatches = max(
            self.max_inflight_dispatches, self.inflight_dispatches)
        return ticket

    def begin_step(self, timeouts: Sequence[int] = (),
                   take_batch: bool = True) -> StepTicket:
        """Encode + dispatch one protocol step; returns the in-flight
        ticket (pass to :meth:`finish`, FIFO)."""
        timeouts = list(timeouts)
        self._guard_view()
        prof = self.profiler
        if prof is not None:
            prof.start("host_encode")
        cfg, R, B = self.cfg, self.R, self.cfg.batch_slots
        mask = self._effective_mask()
        self._check_dispatch(mask)
        bufs = self._step_bufs()
        count = np.zeros((R,), np.int32)
        with self._host_lock:
            taken = []
            for r in range(R):
                take = self.pending[r][:B] if take_batch else []
                if take:
                    self.pending[r] = self.pending[r][B:]
                taken.append(take)
            qdepth = np.array([len(q) for q in self.pending], np.int32)
            applied = self.applied.astype(np.int32)
        for r, take in enumerate(taken):
            if take:
                pack_rows(bufs, (r,), take, cfg.slot_bytes)
                count[r] = len(take)
        tmo = np.zeros((R,), np.int32)
        for r in timeouts:
            tmo[r] = 1
        host = dict(batch_data=bufs["data"], batch_meta=bufs["meta"],
                    batch_count=count, timeout_fired=tmo, peer_mask=mask,
                    apply_done=applied, queue_depth=qdepth)
        if self._txn:
            # the card compares log offsets: shift the armed ABSOLUTE
            # index by the rollovers applied so far
            watch = (self._txn_watch - self.rebased_total
                     if self._txn_watch >= 0 else -1)
            host["txn_watch"] = np.full((R,), watch, np.int32)
            host["txn_term"] = np.full((R,), self._txn_wterm, np.int32)
        # no timer fired => Phase B is a no-op: the stable step, replayed
        # from its graph where one was recorded
        stable = self._stable_fast_path and not timeouts
        graph = self._graphs.get("step") if stable else None
        if graph is None:
            inp = StepInput(**{k: self._dev(a) for k, a in host.items()})
        else:
            graph.stage(**host)
        fn = self._steps[not stable]
        if prof is not None:
            prof.stop("host_encode")
            prof.start("device_dispatch")
        with self._host_lock:
            if graph is None:
                st, out = fn(self._live(), inp)
                self._store(st)
            else:
                self._store(graph.bind(self._live()))
                out = {"packed": graph.replay()}
            ticket = self._enqueue(
                StepTicket("step", out, taken, timeouts, 1, bufs,
                           graph=graph))
        if prof is not None:
            prof.stop("device_dispatch")
        self._note_steps(graph, "step" if graph is not None else
                         "no_capture" if stable else "elections", 1)
        self._dispatch_clock += 1
        return ticket

    def _note_steps(self, graph, key: str, n: int) -> None:
        """Count the ``n`` protocol steps of a dispatch: replayed from
        ``graph`` (``key``: the path, ``step`` or ``burst``) or run
        eagerly (``key``: why), here and in an attached registry."""
        if graph is not None:
            self.graph_replays[key] += n
            name, label = "step_graph_replays_total", dict(path=key)
        else:
            self.eager_steps[key] += n
            name, label = "step_eager_total", dict(reason=key)
        if self.obs is not None:
            self.obs.metrics.inc(name, n, **label)

    def _tiers(self, max_k: Optional[int]) -> Tuple[int, ...]:
        return cap_tiers(self.K_TIERS, max_k)

    def _scan_slots(self, K: int) -> int:
        """The scan tier's staged replay width (a K-step scan advances
        commit by at most K * batch_slots)."""
        return min(self._replay_W,
                   max(K * self.cfg.batch_slots, self.cfg.window_slots))

    def _scan_fn(self, K: int):
        fn = self._scans.get(K)
        if fn is None:
            kw = dict(replay_slots=self._scan_slots(K), fanout=self._fanout,
                      audit=self._audit, telemetry=self._telemetry)
            fn = (build_sim_scan(self.cfg, self.R, **kw)
                  if self.world is None else self._on_world(
                      build_spmd_scan(self.cfg, self.R, self.mesh, **kw)))
            self._scans[K] = fn
        return fn

    def begin_burst(self, max_k: Optional[int] = None) -> StepTicket:
        """Encode + dispatch up to ``max(K_TIERS)`` fused stable steps,
        sized so the ring takes the whole burst without drops."""
        cfg, R, B = self.cfg, self.R, self.cfg.batch_slots
        if self.last is None:
            raise RuntimeError("burst requires a stepped cluster")
        self._guard_view()
        prof = self.profiler
        if prof is not None:
            prof.start("host_encode")
        mask = self._effective_mask()
        self._check_dispatch(mask)
        tiers = self._tiers(max_k)
        with self._host_lock:
            reserved = self.reserved_appends()
            last = self.last
            taken: List[List[Tuple[int, int, int, bytes]]] = []
            take_n = []
            for r in range(R):
                n = clamp_burst_take(
                    len(self.pending[r]), int(last["end"][r]),
                    int(last["head"][r]), cfg.n_slots,
                    tiers[-1] * B, int(reserved[r]))
                take_n.append(n)
                taken.append(self.pending[r][:n])
                self.pending[r] = self.pending[r][n:]
            qdepth = np.array([len(q) for q in self.pending], np.int32)
            applied = self.applied.astype(np.int32)
        k_needed = max(1, max(-(-n // B) for n in take_n))
        K = next(k for k in tiers if k >= k_needed)
        bufs = self._burst_bufs(K)
        count = np.zeros((K, R), np.int32)
        for r in range(R):
            n = take_n[r]
            for k in range(-(-n // B) if n else 0):
                pack_rows(bufs, (k, r), taken[r][k * B:(k + 1) * B],
                          cfg.slot_bytes)
            for k in range(K):
                count[k, r] = max(0, min(n - k * B, B))
        scan = self.scan
        graph = None if scan else self._graphs.get("burst")
        if graph is not None:
            graph.stage_steps(batch_data=bufs["data"],
                              batch_meta=bufs["meta"], batch_count=count)
            graph.stage(timeout_fired=np.zeros((R,), np.int32),
                        peer_mask=mask, apply_done=applied,
                        queue_depth=qdepth)
        fn = self._scan_fn(K) if scan else self._burst
        if prof is not None:
            prof.stop("host_encode")
            prof.start("device_dispatch")
        with self._host_lock:
            if graph is None:
                st, outs = fn(
                    self._live(), self._dev(bufs["data"]),
                    self._dev(bufs["meta"]), self._dev(count),
                    self._dev(mask), self._dev(applied),
                    self._dev(qdepth))
                self._store(st)
            else:
                self._store(graph.bind(self._live()))
                outs = {"packed": graph.replay_steps(K)}
            if scan:
                self.scan_dispatches += 1
            ticket = self._enqueue(StepTicket(
                "scan" if scan else "burst", outs, taken, (), K, bufs,
                applied0=applied if scan else None, graph=graph))
        if prof is not None:
            prof.stop("device_dispatch")
        self._note_steps(graph, "burst" if graph is not None else
                         "no_capture", K)
        self._dispatch_clock += K
        return ticket

    def _readback(self, ticket: StepTicket
                  ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """The finish's device results in ONE transfer: the result dict
        (the final step's scalars and ``peer_acked``; ``accepted``
        summed over a burst) and the variants' per-step arrays
        (``audit_*`` and ``telemetry``, ``[K, ...]`` for a burst or
        scan, the step's own otherwise; ``txn_vote`` of a serial step).
        Written over the trailing replica axes, so the sharded engine
        reads its ``[G, R]`` results with it too."""
        out = ticket.out
        fused = ticket.kind != "step"
        if ticket.kind == "scan":
            mat = torch.cat([out["scal"][-1], out["peer_acked"][-1]], -1)
            names = [k for k in SCAN_KEYS if k in self.RES_KEYS]
            idx = [SCAN_KEYS.index(k) for k in names]
            ncols = len(SCAN_KEYS)
            get = out.__getitem__
        else:
            names = [k for k in self.RES_KEYS
                     if k not in ("accepted", "peer_acked")]
            if ticket.kind == "burst":
                cols = [getattr(out, k)[-1] for k in names]
                cols.append(out.accepted.sum(0).to(torch.int32))
                pa = out.peer_acked[-1]
            else:
                cols = [getattr(out, k) for k in names] + [out.accepted]
                pa = out.peer_acked
            names.append("accepted")
            idx = list(range(len(names)))
            ncols = len(cols)
            mat = torch.cat([torch.stack(cols, -1), pa], -1)

            def get(k):
                return getattr(out, "commit" if k == "audit_commit" else k)
        extra = []
        if self._audit:
            extra += ["audit_start", "audit_digest", "audit_term"]
            if fused:
                extra.append("audit_commit")
        if self._telemetry:
            extra.append("telemetry")
        if self._txn and not fused:
            extra.append("txn_vote")
        parts = [mat] + [get(k) for k in extra]
        flat = (torch.cat([t.reshape(-1) for t in parts]) if extra
                else mat.reshape(-1)).cpu().numpy()
        arrs, off = [], 0
        for t in parts:
            n = t.numel()
            arrs.append(flat[off:off + n].reshape(tuple(t.shape)))
            off += n
        mat = arrs[0]
        res = {k: mat[..., i] for k, i in zip(names, idx)}
        res["peer_acked"] = mat[..., ncols:]
        return res, dict(zip(extra, arrs[1:]))

    def _graph_readback(self, ticket: StepTicket
                        ) -> Tuple[Dict[str, np.ndarray],
                                   Dict[str, np.ndarray]]:
        """:meth:`_readback` of a replayed ticket: its packed rows, one
        per protocol step, in ONE transfer, read as the same result dict
        and per-step arrays."""
        f = ticket.graph.unpack(ticket.out["packed"].cpu().numpy())
        res = {k: f[k][-1] for k in self.RES_KEYS
               if k not in ("accepted", "peer_acked")}
        res["accepted"] = f["accepted"].sum(0).astype(np.int32)
        res["peer_acked"] = f["peer_acked"][-1]
        extra = [k for k in VARIANT_FIELDS if k in f]
        if ticket.kind == "step":
            return res, {k: f[k][0] for k in extra}
        var = {k: f[k] for k in extra}
        if self._audit:
            var["audit_commit"] = f["commit"]
        return res, var

    def finish(self, ticket: StepTicket) -> Dict[str, np.ndarray]:
        """Block on ``ticket``'s outputs and run every post-step host
        rule (requeue, replay, rebase) — tickets finish in FIFO order."""
        if not (self._tickets and self._tickets[0] is ticket):
            raise RuntimeError(
                "tickets must finish in dispatch (FIFO) order")
        prof = self.profiler
        out = ticket.out
        if prof is not None:
            prof.sync(out)              # fenced device_sync (opt-in)
            prof.start("quorum_wait")
        res, var = (self._readback(ticket) if ticket.graph is None
                    else self._graph_readback(ticket))
        if prof is not None:
            prof.stop("quorum_wait")
            prof.start(PHASE_FINISH_RULES)
        fused = ticket.kind != "step"
        if self._audit:
            # ingest BEFORE _maybe_rebase: the windows carry raw
            # (pre-rollover) offsets, consistent with rebased_total; a
            # fused dispatch's K windows in order, so they tile the
            # committed prefix with no gap
            a_s, a_t = var["audit_start"], var["audit_term"]
            a_d = var["audit_digest"].view(np.uint32)
            if fused:
                a_c = var["audit_commit"]
                for k in range(a_s.shape[0]):
                    self._ingest_audit(a_s[k], a_d[k], a_t[k], a_c[k])
                a_s, a_d, a_t = a_s[-1], a_d[-1], a_t[-1]
            else:
                self._ingest_audit(a_s, a_d, a_t, res["commit"])
            res["audit_start"], res["audit_digest"] = a_s, a_d
            res["audit_term"] = a_t
        if self._telemetry:
            # device counters: a fused dispatch's vectors reduced (sum
            # counters, last quorum width, min headroom), folded into
            # the accumulator and exported to an attached registry
            tv = var["telemetry"].view(np.uint32).astype(np.int64)
            res["telemetry"] = obs_device.reduce_steps(tv) if fused else tv
            obs_device.accumulate(self.device_counters, res["telemetry"])
            obs_device.ingest(self.obs, res["telemetry"])
        if "txn_vote" in var:
            # serial dispatches only: bursts and scans carry no lane
            res["txn_vote"] = var["txn_vote"]
        txn_notes = []
        with self._host_lock:
            for r in range(self.R):
                take = ticket.taken[r]
                if take and res["role"][r] == int(Role.LEADER):
                    acc_r = int(res["accepted"][r])
                    self._stamp_appends(r, take, acc_r, res)
                    if self.txn is not None and acc_r > 0:
                        txn_notes.append(
                            (0, r, take[:acc_r], int(res["term"][r]),
                             int(res["end"][r]) + self.rebased_total))
                    requeue_shortfall(self.pending[r], take, acc_r)
        # outside _host_lock: note_appends takes the coordinator's lock,
        # which client threads hold while submitting (coordinator, then
        # cluster) — taking it here under _host_lock would invert that
        for note in txn_notes:
            self.txn.note_appends(*note)
        if prof is not None:
            prof.stop(PHASE_FINISH_RULES)
            prof.start("apply")
        self._replay_committed(
            res, scan_rows=((out["replay_data"], out["replay_meta"],
                             ticket.applied0)
                            if ticket.kind == "scan" else None))
        if prof is not None:
            prof.stop("apply")
            prof.start(PHASE_FINISH_RULES)
        if self._audit:
            self._record_flight(res, ticket.taken, ticket.timeouts,
                                burst_k=ticket.K)
        # the rollover rewrites offsets host-side: never under
        # dispatches still in flight (deferred until the pipeline drains)
        with self._host_lock:
            self._tickets.popleft()
            self.inflight_dispatches -= 1
            if not self._tickets:
                self._maybe_rebase(res)
            self.last = res
        self.step_index += ticket.K
        self._observe_spans(res)
        # read path: renew or revoke leases from this finished step's
        # verified-quorum outputs, then serve the due queued reads —
        # after the audit ingest and the rollover, between pipelined
        # tickets, never inside one
        if self.leases is not None:
            self.leases.observe(self, res)
        if self.reads is not None:
            self.reads.drain(self)
        if self.streams is not None:
            self.streams.observe(self, res)
        if self.governor is not None:
            self.governor.observe(self, res)
        if self.txn is not None:
            self.txn.observe(self, res)
        B = self.cfg.batch_slots
        if ticket.kind == "step":
            dirty = [((r,), len(t)) for r, t in enumerate(ticket.taken)]
        else:
            dirty = [((k, r), min(B, len(t) - k * B))
                     for r, t in enumerate(ticket.taken)
                     for k in range(-(-len(t) // B) if t else 0)]
        self._staging.release(ticket.bufs, dirty)
        if prof is not None:
            prof.stop(PHASE_FINISH_RULES)
        return res

    def drain(self) -> Optional[Dict[str, np.ndarray]]:
        """Finish every in-flight ticket in order."""
        res = None
        while self._tickets:
            res = self.finish(self._tickets[0])
        return res

    def step(self, timeouts: Sequence[int] = ()) -> Dict[str, np.ndarray]:
        require_drained(self._tickets, "step")
        return self.finish(self.begin_step(timeouts))

    def prewarm(self, tiers: Optional[Sequence[int]] = None) -> None:
        """Pay every first-use cost before serving: build and load the
        CUDA kernels (on the card), allocate the staging sets of the
        serial step and of every burst tier, run each step variant and
        burst tier once on a copy of the live state, and, on a stacked
        engine on the card, record the stable step's CUDA graphs."""
        from rdma_paxos_tpu_torch.consensus.step import make_step_input
        if self.device.type == "cuda":
            from rdma_paxos_tpu_torch.ops import quorum
            for name in ("commit_scan_launch", "commit_window_launch"):
                quorum._kernel(name)
        cfg, R, B = self.cfg, self.R, self.cfg.batch_slots
        tiers = tuple(tiers if tiers is not None else self.K_TIERS)
        held = [self._step_bufs()] + [self._burst_bufs(K) for K in tiers]
        for bufs in held:
            self._staging.release(bufs, ())
        inp = make_step_input(cfg, R, device=self.device)
        inp.peer_mask = self._dev(self.peer_mask)
        for fn in self._steps.values():
            fn(self.clone_live(), inp)
        z = inp.apply_done
        for K in tiers:
            fns = [self._burst] + ([self._scan_fn(K)] if self.scan else [])
            for fn in fns:
                fn(self.clone_live(),
                   torch.zeros((K, R, B, cfg.slot_words), dtype=torch.int32,
                               device=self.device),
                   torch.zeros((K, R, B, META_W), dtype=torch.int32,
                               device=self.device),
                   torch.zeros((K, R), dtype=torch.int32,
                               device=self.device),
                   inp.peer_mask, z, z)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            if self.world is None and not self._graphs:
                self._capture_graphs(
                    lambda: make_step_input(cfg, R, device=self.device),
                    build_sim_step(cfg, R, fanout=self._fanout,
                                   elections=False, audit=self._audit,
                                   telemetry=self._telemetry)
                    if self._txn else None)

    def _capture_graphs(self, make_input, burst_step) -> None:
        """Record the stable step as CUDA graphs over the live state:
        the serial step's, and a burst's (``burst_step``: the stable step
        without the transaction lane; None where that is the serial
        one). Once, from :meth:`prewarm`, before a driver's threads run;
        a failure raises."""
        fields = self.RES_KEYS + VARIANT_FIELDS
        steps = max(self.K_TIERS)
        with self._host_lock:
            inp = make_input()
            if self._txn:
                inp.txn_watch = torch.full_like(inp.batch_count, -1)
                inp.txn_term = torch.zeros_like(inp.batch_count)
            step = StepGraph(self._steps[False], self._state, inp, fields,
                             steps)
            burst = step if burst_step is None else StepGraph(
                burst_step, self._state, make_input(), fields, steps)
            self._graphs = {"step": step, "burst": burst}

    def step_burst(self, max_k: Optional[int] = None
                   ) -> Dict[str, np.ndarray]:
        """Drain the pending queues through up to ``max(K_TIERS)`` fused
        steps in one dispatch; returns the final step's outputs with
        ``accepted`` summed over the burst. Only while a leader is known
        (no election timeouts fire inside a burst)."""
        require_drained(self._tickets, "step_burst")
        return self.finish(self.begin_burst(max_k=max_k))

    # ---------------- rebase ----------------

    def _rebase_stalled_step(self, res) -> None:
        """One post-threshold step passed with the rollover delta
        pinned at 0 — count it, and surface the stall once it persists."""
        self.rebase_stall_steps += 1
        if self.rebase_stall_steps < self.REBASE_STALL_STEPS:
            return
        self.rebase_stalled += 1
        if self.obs is not None:
            from rdma_paxos_tpu_torch.obs import trace as _trace
            self.obs.metrics.inc("rebase_stalled")
            if self.rebase_stall_steps == self.REBASE_STALL_STEPS:
                heads = [int(res["head"][r]) for r in range(self.R)]
                self.obs.trace.record(
                    _trace.REBASE_STALLED,
                    end_max=int(res["end"].max()),
                    threshold=self.cfg.rebase_threshold,
                    min_head=min(heads), heads=heads,
                    steps=self.rebase_stall_steps)

    # holds-lock: _host_lock
    def _maybe_rebase(self, res) -> None:
        """Coordinated i32-offset rollover: once any end crosses the
        threshold, subtract the minimum head (over replicas not awaiting
        recovery), rounded down to a multiple of n_slots, from every
        offset and host apply cursor. ``res`` is adjusted in place."""
        if int(res["end"].max()) < self.cfg.rebase_threshold:
            return
        heads = [int(res["head"][r]) for r in range(self.R)
                 if r not in self.need_recovery]
        delta = rebase_delta_of(heads, self.cfg.n_slots)
        if delta <= 0:
            self._rebase_stalled_step(res)
            return
        self._rewrite(lambda st, i: rebase_offsets(st, delta))
        self.applied -= delta
        for k in ("head", "apply", "commit", "end"):
            res[k] = res[k] - delta
        # audit_start is an index too (the ledger already ingested the
        # pre-rollover windows)
        if "audit_start" in res:
            res["audit_start"] = res["audit_start"] - delta
        self.rebases += 1
        self.rebased_total += delta
        self.rebase_stall_steps = 0
        if self.obs is not None:
            from rdma_paxos_tpu_torch.obs import trace as _trace
            self.obs.metrics.inc("rebases_total")
            self.obs.metrics.inc("rebased_entries_total", delta)
            self.obs.trace.record(_trace.REBASE_APPLIED, delta=delta,
                                  rebases=self.rebases)

    # ---------------- audit (audit=True clusters) ----------------

    def redigest(self, replica: int, lo: int, hi: int) -> int:
        """Range re-digest backfill of replica ``replica``'s committed
        entries ``[lo, hi)`` (raw offsets) into the ledger; serial path
        only (see :func:`run_redigest`)."""
        return run_redigest(self, self.ring(replica), lo, hi,
                            group=0, rebased_total=self.rebased_total,
                            replica=replica)

    def _ingest_audit(self, starts, digests, terms, commits) -> None:
        """Feed one step's per-replica digest windows (``[R]`` starts and
        commits, ``[R, W]`` u32 digests and terms) to the ledger in
        ABSOLUTE indices (raw + rebased_total: callers run this before
        the rollover, so the two agree)."""
        led = self.auditor
        led.obs = self.obs              # pick up a late-attached facade
        W = self.cfg.window_slots
        reb = self.rebased_total
        s_l, c_l = starts.tolist(), commits.tolist()
        for r in range(self.R):
            start, commit = s_l[r], c_l[r]
            n = commit - start
            if n <= 0:
                continue
            off = start - (commit - W)
            led.record_window(r, start + reb, digests[r, off:off + n],
                              terms[r, off:off + n], commit + reb,
                              step=self.step_index)

    def _record_flight(self, res, taken, timeouts, burst_k: int = 1
                       ) -> None:
        """One flight-recorder entry per dispatch: its inputs (the
        per-replica batches), scalar outputs, host apply cursors and
        digest heads, in raw offsets with the rebased_total in force,
        so a dump is self-describing. Converted to plain JSON data only
        when dumped."""
        self.flight.record(dict(
            step=self.step_index, burst_k=burst_k,
            timeouts=[int(t) for t in timeouts],
            rebased_total=int(self.rebased_total),
            inputs=taken,
            outputs={k: res[k].copy()
                     for k in ("term", "role", "leader_id", "head",
                               "apply", "commit", "end", "accepted")},
            applied=self.applied.copy(),
            digests=dict(start=res["audit_start"].copy(),
                         commit=res["commit"].copy(),
                         window=res["audit_digest"])))

    # ---------------- span hooks ----------------

    def _span_recorder(self):
        from rdma_paxos_tpu_torch.obs.spans import active_recorder
        return active_recorder(self.obs)

    def _stamp_appends(self, r: int, take, acc: int, res) -> None:
        """The accepted PREFIX of ``take`` landed at absolute indices
        ``[end-acc, end)`` on leader ``r`` — stamp each sampled span
        with its ``(term, index)`` correlation key."""
        spans = self._span_recorder()
        if spans is None or not spans.open_count or acc <= 0:
            return
        end_abs = int(res["end"][r]) + self.rebased_total
        term = int(res["term"][r])
        replicas = range(self.R)
        for i, (_t, conn, req, _p) in enumerate(take[:acc]):
            spans.stamp_append(conn, req, term, end_abs - acc + i, r,
                               replicas=replicas)

    def _observe_spans(self, res) -> None:
        """Advance every replica's commit/apply span frontiers
        (absolute, rebase-corrected)."""
        spans = self._span_recorder()
        if spans is None or not spans.open_count:
            return
        rebased = self.rebased_total
        for r in range(self.R):
            spans.commit_advance(r, int(res["commit"][r]) + rebased)
            spans.apply_advance(r, int(self.applied[r]) + rebased)

    # ---------------- replay ----------------

    def _replay_committed(self, res, scan_rows=None) -> None:
        """Host apply loop: decode newly committed entries of every
        replica onto its replay stream. A fetched entry whose stamped
        M_GIDX is not the expected index means the slot was recycled
        (force-pruned past this replica): flag it for recovery and stop
        its replay."""
        W = self._replay_W
        if scan_rows is not None:
            wd_dev, wm_dev, applied0 = scan_rows
            staged = int(wm_dev.shape[-2])
            wd_all = wm_all = None
            for r in range(self.R):
                if r in self._wedged or r in self.need_recovery:
                    continue
                commit = int(res["commit"][r])
                off = int(self.applied[r]) - int(applied0[r])
                n = int(min(commit - self.applied[r], staged - off))
                if n <= 0 or off < 0:
                    continue
                if wd_all is None:
                    wd_all = wd_dev.cpu().numpy()
                    wm_all = wm_dev.cpu().numpy()
                wd = wd_all[r, off:off + n]
                wm = wm_all[r, off:off + n]
                if int(wm[0, M_GIDX]) != self.applied[r]:
                    self.need_recovery.add(r)
                    continue
                decode_window(wm, wd, n, self.replayed[r], self.frames[r],
                              self.collect_frames,
                              rebase=self.rebased_total)
                self.applied[r] += n
        while True:
            todo = [r for r in range(self.R)
                    if r not in self._wedged
                    and r not in self.need_recovery
                    and self.applied[r] < int(res["commit"][r])]
            if not todo:
                return
            rows = max(min(int(res["commit"][r]) - int(self.applied[r]), W)
                       for r in todo)
            starts = self._dev(self.applied.astype(np.int32))
            with self._host_lock:
                wd_t, wm_t = self._fetch(starts, rows)
            wd_all, wm_all = wd_t.cpu().numpy(), wm_t.cpu().numpy()
            for r in todo:
                n = int(min(int(res["commit"][r]) - self.applied[r], W))
                wd, wm = wd_all[r], wm_all[r]
                if n > 0 and int(wm[0, M_GIDX]) != self.applied[r]:
                    self.need_recovery.add(r)
                    continue
                decode_window(wm, wd, n, self.replayed[r], self.frames[r],
                              self.collect_frames,
                              rebase=self.rebased_total)
                self.applied[r] += n

    # ---------------- inspection ----------------

    def leader(self) -> int:
        if self.last is None:
            raise RuntimeError("leader() before the first step")
        ids = [r for r in range(self.R)
               if self.last["role"][r] == int(Role.LEADER)]
        return ids[0] if len(ids) == 1 else -1

    def run_until_elected(self, candidate: int, max_steps: int = 5) -> int:
        for _ in range(max_steps):
            res = self.step(timeouts=[candidate])
            if res["role"][candidate] == int(Role.LEADER):
                return candidate
        raise RuntimeError("election did not converge")
