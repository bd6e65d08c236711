"""Sharded multi-group consensus cluster — G independent consensus
groups of R replicas on one device, one pass of the step per protocol
step for all of them.

The port of ``rdma_paxos_tpu/shard/cluster.py:ShardedCluster`` on its
single-device engine (``mesh=None``). The G groups' state is one
``[G, R, ...]`` stack (:func:`~rdma_paxos_tpu_torch.parallel.mesh.
stack_group_states`, a clone per group), stepped by the group builders
of ``parallel/mesh.py``: every step of every group is one set of
launches with ONE ``commit_window`` launch over the N = G·R instances.
Host work (commit/apply frontiers, replay, requeue, rebase, leader
tracking) stays per group, and follows the JAX engine rule for rule:
the same ticket contract as ``SimCluster`` (``begin_step``/
``begin_burst`` -> ``finish``), per-group ``peer_mask``, partitions,
wedges and chaos link models (``link_models[g]``, refined at the
dispatch clock), the K tiers and the scan tier, one readback transfer
per finish for all groups, one replay fetch sweep over all G·R logs,
the per-group i32 rollover and its stall, the audit ledger keyed
``(group, term, index)``, telemetry ``[G, R, T_N]``, span stamps and the
``...{group=g}`` metric series, leader placement, the read path
(``runtime/reads.py``'s per-group leases and hub), and with ``txn=True``
the cross-group transaction lane: per-group prepare watches
(:meth:`ShardedCluster.set_txn_watch`, absolute indices converted per
group at dispatch), the ``[G, R]`` vote matrix of every serial step as
``res["txn_vote"]``, and an attached coordinator (``txn``) told of its
records' appends and observing every ``finish``.

Single-group is the G = 1 case of this machinery: its results equal
``SimCluster``'s bit for bit on the same inputs.

An adaptive dispatch governor (``runtime/governor.py:attach_governor``)
is observed at the tail of every ``finish``, with one ladder rung per
group (the dispatch runs the highest), and :meth:`ShardedCluster.health`
is the per-group health document with the serialized router and the
topology controller's status.

A streams hub (``streams.attach``) observes every ``finish`` after the
read drain, and an elastic-topology controller
(``topology.attach_topology``) is told of its seed records' appends
with the coordinator and observes every ``finish`` last. Both are host
work over the unchanged step.

With ``mesh=(group_shards, R)`` (or a :func:`~rdma_paxos_tpu_torch.
parallel.mesh.build_mesh_2d` layout) the engine runs over a device list
instead (the JAX mesh engine): each entry holds ``G / group_shards``
whole groups of one replica column (``[Gl, 1, ...]``), a
:class:`~rdma_paxos_tpu_torch.parallel.mesh.DeviceWorld` steps every
entry's block in one pass on its own thread, the step's seams run
between the R entries of one group shard and never across the group
axis, and the host bookkeeping is the stacked engine's on the stacked
inputs and outputs. ``device=`` is then the list (None: the machine's
cards); ``programs_used`` names the programs dispatched, one per
variant for any G on one layout.
"""

from __future__ import annotations

import collections
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rdma_paxos_tpu_torch.config import (
    LogConfig, REBASE_STALL_STEPS, resolve_device)
from rdma_paxos_tpu_torch.consensus.log import EntryType, M_GIDX, META_W
from rdma_paxos_tpu_torch.consensus.state import Role
from rdma_paxos_tpu_torch.consensus.step import StepInput
from rdma_paxos_tpu_torch.obs import device as obs_device
from rdma_paxos_tpu_torch.parallel.mesh import (
    DeviceLayout, DeviceWorld, build_mesh_2d, build_sim_group_burst,
    build_sim_group_scan, build_sim_group_step, build_spmd_group_burst,
    build_spmd_group_scan, build_spmd_group_step, group_sharding,
    stack_group_states)
from rdma_paxos_tpu_torch.runtime.hostpath import LazyReplayStream
from rdma_paxos_tpu_torch.runtime.sim import (
    SimCluster, StagingPool, StepTicket, clamp_burst_take,
    decode_window, engine_device, pack_rows, rebase_delta_of,
    require_drained, requeue_shortfall, run_redigest)
from rdma_paxos_tpu_torch.shard.router import KeyRouter

TimeoutsLike = Union[None, Dict[int, Sequence[int]],
                     Sequence[Tuple[int, int]]]


class ShardedCluster:
    """G-group × R-replica protocol engine, stacked on one device or
    over a ``(group_shards, R)`` device list (``mesh=``).

    Stacked, it runs on the card unless ``device="cpu"`` is passed; with
    ``mesh=`` it takes a device list (None: the machine's cards). Either
    raises when a named card is absent; neither falls back."""

    K_TIERS = SimCluster.K_TIERS
    RES_KEYS = SimCluster.RES_KEYS
    REBASE_STALL_STEPS = REBASE_STALL_STEPS

    def __init__(self, cfg: LogConfig, n_replicas: int, n_groups: int,
                 *, router: Optional[KeyRouter] = None,
                 fanout: str = "gather", stable_fast_path: bool = True,
                 group_size: Optional[int] = None, audit: bool = False,
                 flight_capacity: int = 64, mesh=None,
                 telemetry: bool = False, scan: bool = False,
                 txn: bool = False, device=None):
        if n_groups < 1:
            raise ValueError("n_groups must be >= 1")
        if fanout not in ("gather", "psum"):
            raise ValueError(f"unknown fanout {fanout!r}")
        self.cfg = cfg
        self.R = int(n_replicas)
        self.G = int(n_groups)
        self._host_lock = threading.RLock()
        self._view = None
        if mesh is not None:
            if isinstance(mesh, tuple):
                mesh = engine_device(
                    device, int(mesh[0]) * int(mesh[1]), "mesh",
                    lambda d: build_mesh_2d(*mesh, devices=d))
            elif not isinstance(mesh, DeviceLayout):
                raise TypeError(f"mesh must be a (group_shards, replicas) "
                                f"tuple or a DeviceLayout, got {mesh!r}")
            group_sharding(mesh)                 # the axis names
            shape = mesh.shape
            if shape[1] != self.R:
                raise ValueError(
                    f"mesh replica axis is {shape[1]} devices but the "
                    f"cluster has {self.R} replicas (one replica per "
                    f"device along the replica axis)")
            if self.G % shape[0]:
                raise ValueError(
                    f"group count {self.G} must divide evenly over "
                    f"{shape[0]} group shards")
            self.world = DeviceWorld(mesh)
            weakref.finalize(self, self.world.close)
            self.device = self.world.device
        else:
            self.world = None
            self.device = resolve_device(device)
        self.mesh = mesh
        self._mode = "sim" if mesh is None else "spmd-group"
        self.group_size = group_size or n_replicas
        self.router = router if router is not None else KeyRouter(self.G)
        self.scan = bool(scan)
        self.scan_dispatches = 0
        self._fanout = fanout
        self._stable_fast_path = stable_fast_path
        self._audit = bool(audit)
        self._telemetry = bool(telemetry)
        # the transaction lane: per-group prepare watches in the ABSOLUTE
        # index domain (begin_step subtracts each group's rebased_total),
        # voted on by the serial steps only
        self._txn = bool(txn)
        self._txn_watch = np.full((n_groups,), -1, np.int64)
        self._txn_wterm = np.zeros((n_groups,), np.int64)
        if audit:
            from rdma_paxos_tpu_torch.obs.audit import (
                AuditLedger, FlightRecorder)
            self.auditor = AuditLedger(self.R, self.G)
            self.flight = FlightRecorder(flight_capacity)
        else:
            self.auditor = None
            self.flight = None
        self.device_counters = (obs_device.zeros(self.G, self.R)
                                if telemetry else None)
        variants = dict(audit=self._audit, telemetry=self._telemetry)
        # the functions dispatched, each with its program key: one per
        # variant, whatever G (programs_used collects the keys)
        self.programs_used: set = set()
        self._keys: Dict[object, tuple] = {}
        self._steps = {e: self._program(
            "group", (e, self._txn), build_sim_group_step,
            build_spmd_group_step, elections=e, txn=self._txn, **variants)
            for e in (True, False)}
        self._burst = self._program(
            "group-burst", (), build_sim_group_burst, build_spmd_group_burst,
            **variants)
        self._scans: Dict[int, object] = {}
        # guarded-by: _host_lock [writes]
        self.state = stack_group_states(cfg, self.G, self.R,
                                        self.group_size, device=self.device)
        # protocol-step dispatches and replay fetch sweeps
        self.dispatches = 0
        self.fetch_dispatches = 0
        self._replay_W = min(cfg.n_slots // 2,
                             max(4 * cfg.window_slots, 256))
        G, R = self.G, self.R
        self.applied = np.zeros((G, R), np.int64)
        self.peer_mask = np.ones((G, R, R), np.int32)
        # guarded-by: _host_lock
        self.pending: List[List[list]] = [
            [[] for _ in range(R)] for _ in range(G)]
        self._tickets: collections.deque = collections.deque()
        self._staging = StagingPool()
        self.inflight_dispatches = 0
        self.max_inflight_dispatches = 0
        # dispatch-side clock: +1 per begin_step, +K per begin_burst
        # (every group's link model reads the same clock)
        self._dispatch_clock = 0
        self.replayed: List[List[LazyReplayStream]] = [
            [LazyReplayStream() for _ in range(R)] for _ in range(G)]
        self.last: Optional[Dict[str, np.ndarray]] = None
        self.need_recovery: set = set()     # {(g, r)} force-pruned past
        self._wedged: set = set()           # {(g, r)} frozen apply
        self.rebases = np.zeros(G, np.int64)
        self.rebased_total = np.zeros(G, np.int64)
        self.rebase_stall_steps = np.zeros(G, np.int64)
        self.rebase_stalled = np.zeros(G, np.int64)
        self._prev_commit_max = np.zeros(G, np.int64)
        # per-group chaos link models (g -> LinkModel), host-side input
        # rewrites at the dispatch clock
        self.link_models: Dict[int, object] = {}
        # read path (runtime/reads.py, attached by reads.attach): the
        # per-group leases and the hub, observed/drained at the tail of
        # every finish()
        self.leases = None
        self.reads = None
        # cross-group 2PC coordinator (txn/coordinator.py, attached by
        # txn.attach_coordinator): told of its records' appends after
        # the stamp loop and observed at the very tail of every finish()
        self.txn = None
        # adaptive dispatch governor (runtime/governor.py) — observed at
        # the tail of every finish(), per-GROUP tier decisions over the
        # shared ladder (the dispatch uses the max rung; the per-group
        # rungs ride the trace events), before the coordinator
        self.governor = None
        # log-as-product streams (streams/): observed at the finish()
        # tail after the read drain, before the governor
        self.streams = None
        # elastic-topology controller (topology/transition.py, attached
        # by attach_topology): told of its seed records' appends after
        # the stamp loop and observed at the very tail of every finish()
        self.topology = None
        # repair-held replicas barred from read serving ({(g, r)} — see
        # SimCluster.read_blocked)
        self.read_blocked: set = set()
        self.step_index = 0
        self.obs = None
        self.profiler = None
        self.collect_frames = False
        self.frames: List[List[List[bytes]]] = [
            [[] for _ in range(R)] for _ in range(G)]
        # runtime lock sanitizer: the guarded-by declarations live in
        # runtime/sim.py (the fields are name-shared across both
        # engines) — under RP_SANITIZE=1 they become lock-ownership
        # assertions here too. No-op otherwise.
        from rdma_paxos_tpu_torch.analysis import runtime_guard
        from rdma_paxos_tpu_torch.runtime import sim as _sim_mod
        runtime_guard.maybe_guard(self, "_host_lock",
                                  _sim_mod.__file__, __file__)

    # ---------------- client-side API ----------------

    def submit(self, group: int, replica: int, payload: bytes,
               etype: EntryType = EntryType.SEND, conn: int = 1,
               req_id: int = 0) -> None:
        """Queue a client entry for the next step on ``replica`` of
        ``group`` (it enters that group's log only if the replica is
        the group's leader)."""
        with self._host_lock:
            self.pending[group][replica].append(
                (int(etype), conn, req_id, payload))

    def submit_many(self, group: int, replica: int,
                    entries: Sequence[Tuple[int, int, int, bytes]]
                    ) -> None:
        with self._host_lock:
            self.pending[group][replica].extend(entries)

    def set_txn_watch(self, group: int, index: int, term: int) -> None:
        """Arm ``group``'s prepare watch: every later serial step reports
        the group's per-replica vote on whether ABSOLUTE log index
        ``index`` is committed under ``term`` (txn=True clusters only).
        Sticky until cleared."""
        if not self._txn:
            raise RuntimeError("set_txn_watch requires txn=True")
        self._txn_watch[group] = int(index)
        self._txn_wterm[group] = int(term)

    def clear_txn_watch(self, group: Optional[int] = None) -> None:
        if group is None:
            self._txn_watch[:] = -1
            self._txn_wterm[:] = 0
        else:
            self._txn_watch[group] = -1
            self._txn_wterm[group] = 0

    def partition(self, group: int,
                  groups_of_replicas: Sequence[Sequence[int]]) -> None:
        """Partition ONE consensus group's replicas (other groups'
        connectivity is untouched)."""
        if self._fanout == "psum":
            raise ValueError(
                "partitions cannot be modeled with fanout='psum'; "
                "build the cluster with fanout='gather'")
        self.peer_mask[group, :, :] = 0
        for grp in groups_of_replicas:
            for i in grp:
                for j in grp:
                    self.peer_mask[group, i, j] = 1
        np.fill_diagonal(self.peer_mask[group], 1)

    def heal(self, group: Optional[int] = None) -> None:
        if group is None:
            self.peer_mask[:] = 1
        else:
            self.peer_mask[group, :, :] = 1

    def wedge_apply(self, group: int, r: int) -> None:
        self._wedged.add((group, r))

    def unwedge_apply(self, group: int, r: int) -> None:
        self._wedged.discard((group, r))

    # ---------------- stepping ----------------

    # the single-group engine's helpers, which work on the [G, R] stack
    # as they are: host->device copies, the ticket FIFO, the tiers, the
    # scan tier's staged replay width, the one-transfer readback, the
    # drain and the span recorder
    _dev = SimCluster._dev
    _enqueue = SimCluster._enqueue
    # the state and the device list (see SimCluster.state)
    state = SimCluster.state
    blocks = SimCluster.blocks
    _drop_view = SimCluster._drop_view
    _guard_view = SimCluster._guard_view
    _live = SimCluster._live
    _store = SimCluster._store
    _rewrite = SimCluster._rewrite
    clone_live = SimCluster.clone_live
    _on_world = SimCluster._on_world
    _fetch = SimCluster._fetch
    close = SimCluster.close
    _tiers = SimCluster._tiers
    _scan_slots = SimCluster._scan_slots
    _readback = SimCluster._readback
    drain = SimCluster.drain
    _span_recorder = SimCluster._span_recorder

    def _effective_mask(self) -> np.ndarray:
        """``[G, R, R]`` hear-matrix: each group's base mask refined by
        that group's link model at the dispatch clock."""
        if not self.link_models:
            return self.peer_mask
        mask = self.peer_mask.copy()
        for g, lm in self.link_models.items():
            mask[g] = lm.effective_mask(mask[g], self._dispatch_clock)
        return mask

    def _check_dispatch(self, mask: np.ndarray) -> None:
        if self._fanout == "psum" and not mask.all():
            raise ValueError(
                "psum fan-out requires full connectivity; use "
                "fanout='gather' to model partitions")

    def _norm_timeouts(self, timeouts: TimeoutsLike) -> Dict[int, list]:
        if not timeouts:
            return {}
        if isinstance(timeouts, dict):
            return {int(g): list(rs) for g, rs in timeouts.items() if rs}
        out: Dict[int, list] = {}
        for g, r in timeouts:
            out.setdefault(int(g), []).append(int(r))
        return out

    def _step_bufs(self) -> dict:
        cfg, G, R, B = self.cfg, self.G, self.R, self.cfg.batch_slots
        return self._staging.acquire(
            ("gstep", G, R, B), lambda: dict(
                data=np.zeros((G, R, B, cfg.slot_words), np.int32),
                meta=np.zeros((G, R, B, META_W), np.int32)))

    def _burst_bufs(self, K: int) -> dict:
        cfg, G, R, B = self.cfg, self.G, self.R, self.cfg.batch_slots
        return self._staging.acquire(
            ("gburst", K, G, R, B), lambda: dict(
                data=np.zeros((K, G, R, B, cfg.slot_words), np.int32),
                meta=np.zeros((K, G, R, B, META_W), np.int32)))

    # holds-lock: _host_lock
    def reserved_appends(self) -> np.ndarray:
        """``[G, R]`` appends dispatched but not yet finished."""
        out = np.zeros((self.G, self.R), np.int64)
        for t in self._tickets:
            for g in range(self.G):
                for r in range(self.R):
                    out[g, r] += len(t.taken[g][r])
        return out

    def _program(self, kind: str, flags: tuple, sim_builder,
                 mesh_builder, **kw):
        """The stacked builder's function, or the device-list program
        bound to the world, registered with its program key (the layout,
        never G, on a device list)."""
        if self.world is None:
            fn = sim_builder(self.cfg, self.R, fanout=self._fanout, **kw)
            key = ("sim-" + kind, self.cfg, self.R, self._fanout, flags,
                   self._audit, self._telemetry)
        else:
            prog = mesh_builder(self.cfg, self.R, self.mesh,
                                fanout=self._fanout, **kw)
            fn, key = self._on_world(prog), prog.key
        self._keys[id(fn)] = key
        return fn

    def _scan_fn(self, K: int):
        fn = self._scans.get(K)
        if fn is None:
            slots = self._scan_slots(K)
            fn = self._program(
                "group-scan", (K, slots), build_sim_group_scan,
                build_spmd_group_scan, replay_slots=slots,
                audit=self._audit, telemetry=self._telemetry)
            self._scans[K] = fn
        return fn

    def ring(self, group: int, replica: int) -> torch.Tensor:
        """Group ``group``'s replica ``replica`` fused ring ``[n_slots,
        cols]``, in place on its device."""
        if self.world is None:
            return self._state.log.buf[group, replica]
        gl = self.G // self.mesh.shape[0]
        s, g = divmod(int(group), gl)
        return self._blocks[s * self.R + int(replica)].log.buf[g, 0]

    def prewarm(self, tiers: Optional[Sequence[int]] = None) -> None:
        """Pay every first-use cost before serving: build and load the
        CUDA kernels (on the card), allocate the staging sets, and run
        each step variant and burst tier once on a copy of the live
        state — one warm-up covers every group."""
        from rdma_paxos_tpu_torch.consensus.step import make_step_input
        if self.device.type == "cuda":
            from rdma_paxos_tpu_torch.ops import quorum
            for name in ("commit_scan_launch", "commit_window_launch"):
                quorum._kernel(name)
        cfg, G, R, B = self.cfg, self.G, self.R, self.cfg.batch_slots
        tiers = tuple(tiers if tiers is not None else self.K_TIERS)
        held = [self._step_bufs()] + [self._burst_bufs(K) for K in tiers]
        for bufs in held:
            self._staging.release(bufs, ())
        inp = make_step_input(cfg, R, n_groups=G, device=self.device)
        inp.peer_mask = self._dev(self.peer_mask)
        for fn in self._steps.values():
            fn(self.clone_live(), inp)
        z = inp.apply_done
        for K in tiers:
            fns = [self._burst] + ([self._scan_fn(K)] if self.scan else [])
            for fn in fns:
                fn(self.clone_live(),
                   torch.zeros((K, G, R, B, cfg.slot_words),
                               dtype=torch.int32, device=self.device),
                   torch.zeros((K, G, R, B, META_W), dtype=torch.int32,
                               device=self.device),
                   torch.zeros((K, G, R), dtype=torch.int32,
                               device=self.device),
                   inp.peer_mask, z, z)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def begin_step(self, timeouts: TimeoutsLike = (),
                   take_batch: bool = True) -> StepTicket:
        """Encode + dispatch one protocol step for EVERY group; returns
        the in-flight ticket (pass to :meth:`finish`, FIFO).
        ``timeouts`` fires election timers per group: a dict ``{group:
        [replica, ...]}`` or an iterable of ``(group, replica)``
        pairs."""
        cfg, G, R, B = self.cfg, self.G, self.R, self.cfg.batch_slots
        self._guard_view()
        prof = self.profiler
        if prof is not None:
            prof.start("host_encode")
        tmo = self._norm_timeouts(timeouts)
        mask = self._effective_mask()
        self._check_dispatch(mask)
        bufs = self._step_bufs()
        count = np.zeros((G, R), np.int32)
        qdepth = np.zeros((G, R), np.int32)
        with self._host_lock:
            taken: List[List[list]] = [[[] for _ in range(R)]
                                       for _ in range(G)]
            for g in range(G):
                for r in range(R):
                    take = (self.pending[g][r][:B] if take_batch else [])
                    if take:
                        self.pending[g][r] = self.pending[g][r][B:]
                    taken[g][r] = take
                    qdepth[g, r] = len(self.pending[g][r])
            applied = self.applied.astype(np.int32)
        for g in range(G):
            for r in range(R):
                take = taken[g][r]
                if take:
                    pack_rows(bufs, (g, r), take, cfg.slot_bytes)
                    count[g, r] = len(take)
        tmo_arr = np.zeros((G, R), np.int32)
        for g, rs in tmo.items():
            for r in rs:
                tmo_arr[g, r] = 1
        inp = StepInput(
            batch_data=self._dev(bufs["data"]),
            batch_meta=self._dev(bufs["meta"]),
            batch_count=self._dev(count), timeout_fired=self._dev(tmo_arr),
            peer_mask=self._dev(mask), apply_done=self._dev(applied),
            queue_depth=self._dev(qdepth))
        if self._txn:
            # the card compares log offsets: each armed ABSOLUTE index
            # shifted by its group's rollovers, repeated over the replicas
            watch = np.where(self._txn_watch >= 0,
                             self._txn_watch - self.rebased_total, -1)
            inp.txn_watch = self._dev(np.broadcast_to(
                watch[:, None], (G, R)).astype(np.int32))
            inp.txn_term = self._dev(np.broadcast_to(
                self._txn_wterm[:, None], (G, R)).astype(np.int32))
        # no timer fired in ANY group => Phase B is a no-op for every
        # group: the stable step
        fn = self._steps[not (self._stable_fast_path and not tmo)]
        if prof is not None:
            prof.stop("host_encode")
            prof.start("device_dispatch")
        with self._host_lock:
            st, out = fn(self._live(), inp)
            self._store(st)
            self.programs_used.add(self._keys[id(fn)])
            ticket = self._enqueue(
                StepTicket("step", out, taken, tmo, 1, bufs))
        if prof is not None:
            prof.stop("device_dispatch")
        self.dispatches += 1
        self._dispatch_clock += 1
        return ticket

    def begin_burst(self, max_k: Optional[int] = None) -> StepTicket:
        """Encode + dispatch up to ``max(K_TIERS)`` fused stable steps
        for every group, sized so each group's ring takes its share of
        the burst without drops (appends reserved by in-flight tickets
        subtracted)."""
        cfg, G, R, B = self.cfg, self.G, self.R, self.cfg.batch_slots
        if self.last is None:
            raise RuntimeError("burst requires a stepped cluster")
        self._guard_view()
        prof = self.profiler
        if prof is not None:
            prof.start("host_encode")
        mask = self._effective_mask()
        self._check_dispatch(mask)
        tiers = self._tiers(max_k)
        take_n = np.zeros((G, R), np.int64)
        qdepth = np.zeros((G, R), np.int32)
        taken: List[List[list]] = [[[] for _ in range(R)]
                                   for _ in range(G)]
        with self._host_lock:
            reserved = self.reserved_appends()
            last = self.last
            for g in range(G):
                for r in range(R):
                    n = clamp_burst_take(
                        len(self.pending[g][r]), int(last["end"][g, r]),
                        int(last["head"][g, r]), cfg.n_slots,
                        tiers[-1] * B, int(reserved[g, r]))
                    take_n[g, r] = n
                    taken[g][r] = self.pending[g][r][:n]
                    self.pending[g][r] = self.pending[g][r][n:]
                    qdepth[g, r] = len(self.pending[g][r])
            applied = self.applied.astype(np.int32)
        k_needed = max(1, int(-(-take_n.max() // B)))
        K = next(k for k in tiers if k >= k_needed)
        bufs = self._burst_bufs(K)
        count = np.zeros((K, G, R), np.int32)
        for g in range(G):
            for r in range(R):
                n = int(take_n[g, r])
                for k in range(-(-n // B) if n else 0):
                    pack_rows(bufs, (k, g, r),
                              taken[g][r][k * B:(k + 1) * B],
                              cfg.slot_bytes)
                for k in range(K):
                    count[k, g, r] = max(0, min(n - k * B, B))
        scan = self.scan
        fn = self._scan_fn(K) if scan else self._burst
        if prof is not None:
            prof.stop("host_encode")
            prof.start("device_dispatch")
        with self._host_lock:
            st, outs = fn(
                self._live(), self._dev(bufs["data"]),
                self._dev(bufs["meta"]), self._dev(count),
                self._dev(mask), self._dev(applied), self._dev(qdepth))
            self._store(st)
            self.programs_used.add(self._keys[id(fn)])
            if scan:
                self.scan_dispatches += 1
            ticket = self._enqueue(StepTicket(
                "scan" if scan else "burst", outs, taken, {}, K, bufs,
                applied0=applied if scan else None))
        if prof is not None:
            prof.stop("device_dispatch")
        self.dispatches += 1
        self._dispatch_clock += K
        return ticket

    def finish(self, ticket: StepTicket) -> Dict[str, np.ndarray]:
        """Block on ``ticket``'s outputs and run every post-step host
        rule — tickets finish in dispatch (FIFO) order."""
        if not (self._tickets and self._tickets[0] is ticket):
            raise RuntimeError(
                "tickets must finish in dispatch (FIFO) order")
        G, R, B = self.G, self.R, self.cfg.batch_slots
        prof = self.profiler
        out = ticket.out
        if prof is not None:
            prof.sync(out)
            prof.start("quorum_wait")
        res, var = self._readback(ticket)
        if prof is not None:
            prof.stop("quorum_wait")
        fused = ticket.kind != "step"
        if self._audit:
            # ingest BEFORE the rollover: raw offsets and each group's
            # rebased_total agree; a fused dispatch's K windows in order
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
            tv = var["telemetry"].view(np.uint32).astype(np.int64)
            res["telemetry"] = obs_device.reduce_steps(tv) if fused else tv
            obs_device.accumulate(self.device_counters, res["telemetry"])
            obs_device.ingest(self.obs, res["telemetry"])
        if "txn_vote" in var:
            # serial dispatches only: bursts and scans carry no lane
            res["txn_vote"] = var["txn_vote"]
        txn_notes = []
        with self._host_lock:
            for g in range(G):
                for r in range(R):
                    take = ticket.taken[g][r]
                    if take and res["role"][g, r] == int(Role.LEADER):
                        acc_gr = int(res["accepted"][g, r])
                        self._stamp_appends(g, r, take, acc_gr, res)
                        if ((self.txn is not None
                             or self.topology is not None)
                                and acc_gr > 0):
                            txn_notes.append(
                                (g, r, take[:acc_gr],
                                 int(res["term"][g, r]),
                                 int(res["end"][g, r])
                                 + int(self.rebased_total[g])))
                        requeue_shortfall(self.pending[g][r], take, acc_gr)
        # outside _host_lock (the coordinator's and the topology
        # controller's locks come first: see SimCluster.finish)
        for note in txn_notes:
            if self.txn is not None:
                self.txn.note_appends(*note)
            if self.topology is not None:
                self.topology.note_appends(*note)
        if prof is not None:
            prof.start("apply")
        self._replay_committed(
            res, scan_rows=((out["replay_data"], out["replay_meta"],
                             ticket.applied0)
                            if ticket.kind == "scan" else None))
        if prof is not None:
            prof.stop("apply")
        if self._audit:
            self._record_flight(res, ticket.taken, ticket.timeouts,
                                burst_k=ticket.K)
        with self._host_lock:
            self._tickets.popleft()
            self.inflight_dispatches -= 1
            # the per-group rollover rewrites offsets host-side:
            # deferred while dispatches are in flight
            if not self._tickets:
                self._maybe_rebase(res)
            self.last = res
        self.step_index += ticket.K
        self._observe(res)
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
        if self.topology is not None:
            self.topology.observe(self, res)
        if fused:
            dirty = [((k, g, r), min(B, len(t) - k * B))
                     for g in range(G) for r in range(R)
                     for t in (ticket.taken[g][r],)
                     for k in range(-(-len(t) // B) if t else 0)]
        else:
            dirty = [((g, r), len(ticket.taken[g][r]))
                     for g in range(G) for r in range(R)]
        self._staging.release(ticket.bufs, dirty)
        return res

    def step(self, timeouts: TimeoutsLike = ()) -> Dict[str, np.ndarray]:
        """One protocol step for EVERY group; returns ``[G, R]`` result
        arrays."""
        require_drained(self._tickets, "step")
        return self.finish(self.begin_step(timeouts))

    def step_burst(self, max_k: Optional[int] = None
                   ) -> Dict[str, np.ndarray]:
        """Drain every group's pending queues through up to
        ``max(K_TIERS)`` fused steps in one dispatch (only while every
        trafficked group has a known leader)."""
        require_drained(self._tickets, "step_burst")
        return self.finish(self.begin_burst(max_k=max_k))

    # ---------------- host apply / rebase ----------------

    def _replay_committed(self, res, scan_rows=None) -> None:
        """Per-group host apply loop. Every group's and replica's window
        rides ONE fetch sweep over all G·R logs (``fetch_window`` on the
        ``[G, R]`` stack, as the single-group engine fetches its ``[R]``),
        sized by the furthest-behind replica. A fetched entry whose
        stamped gidx is not the expected index means the slot was
        recycled: flag ``(g, r)`` for recovery and stop its replay. A
        scan ticket's in-dispatch rows are consumed first."""
        W = self._replay_W
        t_group: Dict[int, int] = {}
        if scan_rows is not None:
            wd_dev, wm_dev, applied0 = scan_rows
            staged = int(wm_dev.shape[-2])
            wd_all = wm_all = None
            for g in range(self.G):
                for r in range(self.R):
                    if ((g, r) in self._wedged
                            or (g, r) in self.need_recovery):
                        continue
                    commit = int(res["commit"][g, r])
                    off = int(self.applied[g, r]) - int(applied0[g, r])
                    n = int(min(commit - self.applied[g, r],
                                staged - off))
                    if n <= 0 or off < 0:
                        continue
                    if wd_all is None:
                        wd_all = wd_dev.cpu().numpy()
                        wm_all = wm_dev.cpu().numpy()
                    t0 = time.perf_counter_ns()
                    wd = wd_all[g, r, off:off + n]
                    wm = wm_all[g, r, off:off + n]
                    if int(wm[0, M_GIDX]) != self.applied[g, r]:
                        self.need_recovery.add((g, r))
                        continue
                    decode_window(wm, wd, n, self.replayed[g][r],
                                  self.frames[g][r], self.collect_frames,
                                  rebase=int(self.rebased_total[g]))
                    self.applied[g, r] += n
                    t_group[g] = (t_group.get(g, 0)
                                  + time.perf_counter_ns() - t0)
        while True:
            todo = [(g, r) for g in range(self.G) for r in range(self.R)
                    if (g, r) not in self._wedged
                    and (g, r) not in self.need_recovery
                    and self.applied[g, r] < int(res["commit"][g, r])]
            if not todo:
                break
            rows = max(min(int(res["commit"][g, r])
                           - int(self.applied[g, r]), W)
                       for g, r in todo)
            starts = self._dev(self.applied.astype(np.int32))
            with self._host_lock:
                wd_t, wm_t = self._fetch(starts, rows)
            self.fetch_dispatches += 1
            wd_all, wm_all = wd_t.cpu().numpy(), wm_t.cpu().numpy()
            for g, r in todo:
                t0 = time.perf_counter_ns()
                n = int(min(int(res["commit"][g, r]) - self.applied[g, r],
                            W))
                wd, wm = wd_all[g, r], wm_all[g, r]
                if n > 0 and int(wm[0, M_GIDX]) != self.applied[g, r]:
                    self.need_recovery.add((g, r))
                    continue
                decode_window(wm, wd, n, self.replayed[g][r],
                              self.frames[g][r], self.collect_frames,
                              rebase=int(self.rebased_total[g]))
                self.applied[g, r] += n
                t_group[g] = (t_group.get(g, 0)
                              + time.perf_counter_ns() - t0)
        if (t_group and self.obs is not None
                and self.profiler is not None):
            from rdma_paxos_tpu_torch.obs.metrics import LATENCY_BUCKETS_US
            for g, ns in sorted(t_group.items()):
                self.obs.metrics.observe(
                    "step_phase_us", ns / 1e3,
                    buckets=LATENCY_BUCKETS_US, phase="apply", group=g)

    def _rebase_stalled_step(self, g: int, res) -> None:
        self.rebase_stall_steps[g] += 1
        if self.rebase_stall_steps[g] < self.REBASE_STALL_STEPS:
            return
        self.rebase_stalled[g] += 1
        if self.obs is not None:
            from rdma_paxos_tpu_torch.obs import trace as _trace
            self.obs.metrics.inc("rebase_stalled", group=g)
            if self.rebase_stall_steps[g] == self.REBASE_STALL_STEPS:
                heads = [int(res["head"][g, r]) for r in range(self.R)]
                self.obs.trace.record(
                    _trace.REBASE_STALLED, group=g,
                    end_max=int(res["end"][g].max()),
                    threshold=self.cfg.rebase_threshold,
                    min_head=min(heads), heads=heads,
                    steps=int(self.rebase_stall_steps[g]))

    # holds-lock: _host_lock
    def _maybe_rebase(self, res) -> None:
        """Per-group coordinated i32 rollover: each group whose max end
        crossed ``rebase_threshold`` drops every offset of ITS replicas
        by its own min head (over replicas not awaiting recovery),
        rounded down to a multiple of n_slots; other groups' offsets are
        untouched. ``res`` is adjusted in place."""
        ends = res["end"].max(axis=1)                       # [G]
        if ends.max() < self.cfg.rebase_threshold:
            return
        deltas = np.zeros(self.G, np.int64)
        for g in range(self.G):
            if ends[g] < self.cfg.rebase_threshold:
                continue
            heads = [int(res["head"][g, r]) for r in range(self.R)
                     if (g, r) not in self.need_recovery]
            delta = rebase_delta_of(heads, self.cfg.n_slots)
            if delta <= 0:
                self._rebase_stalled_step(g, res)
                continue
            deltas[g] = delta
        if not deltas.any():
            return
        self._apply_rebase(deltas)
        for g in np.nonzero(deltas)[0]:
            d = int(deltas[g])
            self.applied[g] -= d
            for k in ("head", "apply", "commit", "end"):
                res[k][g] = res[k][g] - d
            if "audit_start" in res:
                res["audit_start"][g] = res["audit_start"][g] - d
            self.rebases[g] += 1
            self.rebased_total[g] += d
            self.rebase_stall_steps[g] = 0
            if self.obs is not None:
                from rdma_paxos_tpu_torch.obs import trace as _trace
                self.obs.metrics.inc("rebases_total", group=int(g))
                self.obs.metrics.inc("rebased_entries_total", d,
                                     group=int(g))
                self.obs.trace.record(_trace.REBASE_APPLIED,
                                      group=int(g), delta=d,
                                      rebases=int(self.rebases[g]))

    # holds-lock: _host_lock
    def _apply_rebase(self, deltas: np.ndarray) -> None:
        """Per-group offset subtraction, the grouped form of
        ``consensus.snapshot.rebase_offsets`` (each delta <= its group's
        min head, a multiple of n_slots): the stamped gidx column in
        place, the offsets into fresh tensors — on a device list, each
        entry's block on its device with its groups' deltas."""
        import dataclasses

        d_gr = self._dev(np.repeat(deltas[:, None], self.R, 1)
                         .astype(np.int32))                      # [G, R]

        def rebase(state, i):
            d = (d_gr if i is None
                 else self.world.sharding.block(d_gr, i))
            state.log.buf[..., state.log.slot_words + M_GIDX] -= d[..., None]
            return dataclasses.replace(
                state,
                head=state.head - d, apply=state.apply - d,
                commit=state.commit - d, end=state.end - d,
                cfg_src=torch.where(state.cfg_src >= 0, state.cfg_src - d,
                                    state.cfg_src))
        self._rewrite(rebase)

    # ---------------- audit ----------------

    def redigest(self, group: int, replica: int, lo: int, hi: int) -> int:
        """Range re-digest backfill of ONE group's replica (raw offsets
        of that group); serial path only (see ``run_redigest``)."""
        return run_redigest(
            self, self.ring(group, replica), lo, hi, group=group,
            rebased_total=int(self.rebased_total[group]), replica=replica)

    def _ingest_audit(self, starts, digests, terms, commits) -> None:
        """Per-group digest windows to the ledger, keyed by group and
        absolute index (each group's own ``rebased_total``)."""
        led = self.auditor
        led.obs = self.obs
        W = self.cfg.window_slots
        for g in range(self.G):
            reb = int(self.rebased_total[g])
            s_l = starts[g].tolist()
            c_l = commits[g].tolist()
            for r in range(self.R):
                start, commit = s_l[r], c_l[r]
                n = commit - start
                if n <= 0:
                    continue
                off = start - (commit - W)
                led.record_window(r, start + reb,
                                  digests[g, r, off:off + n],
                                  terms[g, r, off:off + n],
                                  commit + reb, group=g,
                                  step=self.step_index)

    def _record_flight(self, res, taken, tmo, burst_k: int = 1) -> None:
        """One flight-recorder entry per dispatch, widened by the group
        axis; arrays are copied (the rollover rewrites ``res`` rows in
        place afterwards)."""
        self.flight.record(dict(
            step=self.step_index, burst_k=burst_k,
            timeouts={int(g): [int(r) for r in rs]
                      for g, rs in dict(tmo).items()},
            rebased_total=self.rebased_total.copy(),
            inputs=taken,
            outputs={k: res[k].copy()
                     for k in ("term", "role", "leader_id", "head",
                               "apply", "commit", "end", "accepted")},
            applied=self.applied.copy(),
            digests=dict(start=res["audit_start"].copy(),
                         commit=res["commit"].copy(),
                         window=res["audit_digest"])))

    # ---------------- observability ----------------

    def _span_rep(self, g: int, r: int) -> int:
        """Namespaced span replica id (``g * R + r``): per-group
        frontiers must not collide in the recorder's per-replica
        heaps."""
        return g * self.R + r

    def _stamp_appends(self, g: int, r: int, take, acc: int, res) -> None:
        """The accepted prefix of ``take`` landed at absolute indices
        ``[end-acc, end)`` on group ``g``'s leader ``r``: stamp each
        sampled span with its ``(group, term, index)`` key."""
        spans = self._span_recorder()
        if spans is None or not spans.open_count or acc <= 0:
            return
        end_abs = int(res["end"][g, r]) + int(self.rebased_total[g])
        term = int(res["term"][g, r])
        replicas = [self._span_rep(g, rr) for rr in range(self.R)]
        for i, (_t, conn, req, _p) in enumerate(take[:acc]):
            spans.stamp_append(conn, req, term, end_abs - acc + i,
                               self._span_rep(g, r), replicas=replicas,
                               group=g)

    def _observe(self, res) -> None:
        """Per-group metric gauges/counters (``...{group=g}`` series)
        and the span commit/apply frontiers. Host-side only."""
        spans = self._span_recorder()
        if spans is not None and spans.open_count:
            for g in range(self.G):
                rebased = int(self.rebased_total[g])
                for r in range(self.R):
                    rep = self._span_rep(g, r)
                    spans.commit_advance(
                        rep, int(res["commit"][g, r]) + rebased)
                    spans.apply_advance(
                        rep, int(self.applied[g, r]) + rebased)
        if self.obs is None:
            return
        m = self.obs.metrics
        for g in range(self.G):
            rebased = int(self.rebased_total[g])
            cmax = int(res["commit"][g].max()) + rebased
            m.set("shard_term", int(res["term"][g].max()), group=g)
            m.set("shard_commit", cmax, group=g)
            m.set("shard_apply", int(self.applied[g].min()) + rebased,
                  group=g)
            m.set("shard_leader", self.leader_hint(g), group=g)
            delta = cmax - int(self._prev_commit_max[g])
            if delta > 0:
                m.inc("shard_committed_entries_total", delta, group=g)
            self._prev_commit_max[g] = cmax

    def health(self) -> dict:
        """Aggregated sharded-cluster health: one snapshot per group
        (per-replica offsets/roles, rebase counters, recovery flags)
        plus the serialized ROUTER — the full routing table rides the
        health document so any observer reconstructs the exact
        key→group mapping without code."""
        from rdma_paxos_tpu_torch.obs.health import make_snapshot
        res = self.last
        groups = []
        for g in range(self.G):
            fields = dict(
                group=g,
                leader=self.leader_hint(g),
                rebases=int(self.rebases[g]),
                rebased_total=int(self.rebased_total[g]),
                rebase_stalled=int(self.rebase_stalled[g]),
                need_recovery=sorted(r for (gg, r) in self.need_recovery
                                     if gg == g),
                applied=[int(a) for a in self.applied[g]],
            )
            if res is not None:
                for k in ("role", "term", "commit", "apply", "end",
                          "head"):
                    fields[k] = [int(v) for v in res[k][g]]
                fields["log_headroom"] = int(
                    self.cfg.rebase_threshold - res["end"][g].max())
            groups.append(make_snapshot(**fields))
        return dict(schema=1, n_groups=self.G, n_replicas=self.R,
                    dispatches=self.dispatches,
                    engine=self._mode,
                    mesh=(None if self.mesh is None else dict(
                        layout="%dx%d" % self.mesh.shape,
                        group_shards=int(self.mesh.shape[0]),
                        devices=[str(d) for d in self.mesh.entries])),
                    router=self.router.to_dict(), groups=groups,
                    audit=(self.auditor.summary()
                           if self.auditor is not None else None),
                    leases=(self.leases.status()
                            if self.leases is not None else None),
                    topology=(self.topology.status()
                              if self.topology is not None else None))

    # ---------------- leadership ----------------

    def leader(self, group: int) -> int:
        """Group ``group``'s leader iff exactly one replica claims it,
        else -1."""
        if self.last is None:
            raise RuntimeError("leader() before the first step")
        ids = [r for r in range(self.R)
               if self.last["role"][group, r] == int(Role.LEADER)]
        return ids[0] if len(ids) == 1 else -1

    def leader_hint(self, group: int) -> int:
        """Highest-term self-claimed leader of ``group`` (terms are
        unique per leader), or -1."""
        if self.last is None:
            return -1
        claims = [(int(self.last["term"][group, r]), r)
                  for r in range(self.R)
                  if int(self.last["role"][group, r]) == int(Role.LEADER)]
        return max(claims)[1] if claims else -1

    def leaders(self) -> List[int]:
        return [self.leader_hint(g) for g in range(self.G)]

    def run_until_elected(self, group: int, candidate: int,
                          max_steps: int = 5) -> int:
        for _ in range(max_steps):
            res = self.step(timeouts={group: [candidate]})
            if res["role"][group, candidate] == int(Role.LEADER):
                return candidate
        raise RuntimeError(f"election did not converge in group {group}")

    def place_leaders(self, policy: str = "round_robin",
                      max_steps: int = 12) -> List[int]:
        """Elect a leader in EVERY group, spread across the R replicas:
        ``round_robin`` (group g targets replica ``g % R``) or
        ``least_loaded`` (existing leaders counted first, then greedy
        in group order). Elections of different groups ride the same
        dispatches. Returns the per-group targets."""
        if policy == "round_robin":
            targets = [g % self.R for g in range(self.G)]
        elif policy == "least_loaded":
            load = [0] * self.R
            targets = [-1] * self.G
            for g in range(self.G):
                cur = self.leader_hint(g) if self.last is not None else -1
                if cur >= 0:
                    targets[g] = cur
                    load[cur] += 1
            for g in range(self.G):
                if targets[g] < 0:
                    t = int(np.argmin(load))
                    targets[g] = t
                    load[t] += 1
        else:
            raise ValueError(f"unknown placement policy: {policy!r}")
        for _ in range(max_steps):
            pending = {g: [targets[g]] for g in range(self.G)
                       if self.last is None
                       or self.leader(g) != targets[g]}
            if not pending:
                return targets
            self.step(timeouts=pending)
        undone = [g for g in range(self.G)
                  if self.leader(g) != targets[g]]
        if undone:
            raise RuntimeError(
                f"leader placement did not converge for groups {undone}")
        return targets
