"""In-process multi-replica cluster: R replicas stacked on one device,
with the host-side bookkeeping of the replicated write path.

The port of ``rdma_paxos_tpu/runtime/sim.py:SimCluster``'s core: client
submission, partitions through per-replica ``peer_mask`` rows, the
ticket contract ``begin_step``/``begin_burst`` -> ``finish`` (serial
``step()``/``step_burst()`` are exactly ``finish(begin_*())``), the
staging pool, requeue of shortfalls, the committed-entry replay with
its slot-recycling integrity check, and the coordinated i32 rebase.
The JAX engine's attachments (observability, spans, link model, leases,
reads, streams, governor, txn, audit, telemetry) come in later slices.

Every device result a finish needs is read back in ONE transfer, and a
replay sweep fetches only as many rows as the furthest-behind replica
decodes.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from rdma_paxos_tpu_torch.config import (
    LogConfig, REBASE_STALL_STEPS, resolve_device)
from rdma_paxos_tpu_torch.consensus.log import EntryType, M_GIDX, META_W
from rdma_paxos_tpu_torch.consensus.snapshot import rebase_offsets
from rdma_paxos_tpu_torch.consensus.state import Role
from rdma_paxos_tpu_torch.consensus.step import (
    SCAN_KEYS, StepInput, fetch_window)
from rdma_paxos_tpu_torch.parallel.mesh import (
    build_sim_burst, build_sim_scan, build_sim_step, stack_states)
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
    replayed.append_batch(batch)
    if collect_frames:
        frames.append(batch.frames())


class StepTicket:
    """One dispatched-but-not-finished step or burst."""

    __slots__ = ("kind", "out", "taken", "timeouts", "K", "bufs",
                 "applied0")

    def __init__(self, kind: str, out, taken, timeouts, K: int, bufs,
                 applied0=None):
        self.kind = kind          # "step" | "burst" | "scan"
        self.out = out
        self.taken = taken
        self.timeouts = timeouts
        self.K = K
        self.bufs = bufs
        self.applied0 = applied0  # scan: the replay rows start here


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


class SimCluster:
    """R-replica protocol engine on one device with host bookkeeping.

    Runs on the card unless ``device="cpu"`` is passed; raises when no
    card is present and none was named."""

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
                 fanout: str = "gather", stable_fast_path: bool = True,
                 scan: bool = False, device=None,
                 audit: bool = False, telemetry: bool = False,
                 txn: bool = False):
        if audit or telemetry or txn:
            raise NotImplementedError(
                "audit=, telemetry= and txn= clusters are not ported")
        if fanout not in ("gather", "psum"):
            raise ValueError(f"unknown fanout {fanout!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.R = n_replicas
        self.group_size = group_size or n_replicas
        self.scan = bool(scan)
        self.scan_dispatches = 0
        self._fanout = fanout
        self._stable_fast_path = stable_fast_path
        self._steps = {e: build_sim_step(cfg, n_replicas, fanout=fanout,
                                         elections=e)
                       for e in (True, False)}
        self._burst = build_sim_burst(cfg, n_replicas, fanout=fanout)
        self._scans: Dict[int, object] = {}
        # guarded-by: _host_lock [writes]
        self.state = stack_states(cfg, n_replicas, self.group_size,
                                  device=self.device)
        # the replay window is wider than the protocol window: a K-step
        # burst commits up to K*batch_slots entries at once
        self._replay_W = min(cfg.n_slots // 2,
                             max(4 * cfg.window_slots, 256))
        self.applied = np.zeros(n_replicas, np.int64)
        self.peer_mask = np.ones((n_replicas, n_replicas), np.int32)
        # guarded-by: _host_lock
        self.pending: List[List[Tuple[int, int, int, bytes]]] = [
            [] for _ in range(n_replicas)]
        self._tickets: collections.deque = collections.deque()
        self._staging = StagingPool()
        self._host_lock = threading.RLock()
        self.inflight_dispatches = 0
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

    # ---------------- stepping ----------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, copy=True)

    def _check_mask(self) -> None:
        if self._fanout == "psum" and not self.peer_mask.all():
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

    def _enqueue(self, ticket: StepTicket) -> StepTicket:
        self._tickets.append(ticket)
        self.inflight_dispatches += 1
        return ticket

    def begin_step(self, timeouts: Sequence[int] = (),
                   take_batch: bool = True) -> StepTicket:
        """Encode + dispatch one protocol step; returns the in-flight
        ticket (pass to :meth:`finish`, FIFO)."""
        timeouts = list(timeouts)
        cfg, R, B = self.cfg, self.R, self.cfg.batch_slots
        self._check_mask()
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
        inp = StepInput(
            batch_data=self._dev(bufs["data"]),
            batch_meta=self._dev(bufs["meta"]),
            batch_count=self._dev(count), timeout_fired=self._dev(tmo),
            peer_mask=self._dev(self.peer_mask),
            apply_done=self._dev(applied), queue_depth=self._dev(qdepth))
        # no timer fired => Phase B is a no-op: the stable step
        fn = self._steps[not (self._stable_fast_path and not timeouts)]
        with self._host_lock:
            self.state, out = fn(self.state, inp)
            return self._enqueue(
                StepTicket("step", out, taken, timeouts, 1, bufs))

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
            fn = build_sim_scan(self.cfg, self.R,
                                replay_slots=self._scan_slots(K),
                                fanout=self._fanout)
            self._scans[K] = fn
        return fn

    def begin_burst(self, max_k: Optional[int] = None) -> StepTicket:
        """Encode + dispatch up to ``max(K_TIERS)`` fused stable steps,
        sized so the ring takes the whole burst without drops."""
        cfg, R, B = self.cfg, self.R, self.cfg.batch_slots
        if self.last is None:
            raise RuntimeError("burst requires a stepped cluster")
        self._check_mask()
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
        fn = self._scan_fn(K) if scan else self._burst
        with self._host_lock:
            self.state, outs = fn(
                self.state, self._dev(bufs["data"]),
                self._dev(bufs["meta"]), self._dev(count),
                self._dev(self.peer_mask), self._dev(applied),
                self._dev(qdepth))
            if scan:
                self.scan_dispatches += 1
            return self._enqueue(StepTicket(
                "scan" if scan else "burst", outs, taken, (), K, bufs,
                applied0=applied if scan else None))

    def _readback(self, ticket: StepTicket) -> Dict[str, np.ndarray]:
        """The finish's device results in ONE transfer."""
        out = ticket.out
        if ticket.kind == "scan":
            mat = torch.cat([out["scal"][-1], out["peer_acked"][-1]], 1)
            mat = mat.cpu().numpy()
            ns = len(SCAN_KEYS)
            res = {k: mat[:, i] for i, k in enumerate(SCAN_KEYS)
                   if k in self.RES_KEYS}
            res["peer_acked"] = mat[:, ns:]
            return res
        keys = [k for k in self.RES_KEYS
                if k not in ("accepted", "peer_acked")]
        if ticket.kind == "burst":
            cols = [getattr(out, k)[-1] for k in keys]
            cols.append(out.accepted.sum(0).to(torch.int32))
            pa = out.peer_acked[-1]
        else:
            cols = [getattr(out, k) for k in keys] + [out.accepted]
            pa = out.peer_acked
        mat = torch.cat([torch.stack(cols, 1), pa], 1).cpu().numpy()
        res = {k: mat[:, i] for i, k in enumerate(keys + ["accepted"])}
        res["peer_acked"] = mat[:, len(cols):]
        return res

    def finish(self, ticket: StepTicket) -> Dict[str, np.ndarray]:
        """Block on ``ticket``'s outputs and run every post-step host
        rule (requeue, replay, rebase) — tickets finish in FIFO order."""
        if not (self._tickets and self._tickets[0] is ticket):
            raise RuntimeError(
                "tickets must finish in dispatch (FIFO) order")
        res = self._readback(ticket)
        with self._host_lock:
            for r in range(self.R):
                take = ticket.taken[r]
                if take and res["role"][r] == int(Role.LEADER):
                    requeue_shortfall(self.pending[r], take,
                                      int(res["accepted"][r]))
        out = ticket.out
        self._replay_committed(
            res, scan_rows=((out["replay_data"], out["replay_meta"],
                             ticket.applied0)
                            if ticket.kind == "scan" else None))
        # the rollover rewrites offsets host-side: never under
        # dispatches still in flight (deferred until the pipeline drains)
        with self._host_lock:
            self._tickets.popleft()
            self.inflight_dispatches -= 1
            if not self._tickets:
                self._maybe_rebase(res)
            self.last = res
        self.step_index += ticket.K
        B = self.cfg.batch_slots
        if ticket.kind == "step":
            dirty = [((r,), len(t)) for r, t in enumerate(ticket.taken)]
        else:
            dirty = [((k, r), min(B, len(t) - k * B))
                     for r, t in enumerate(ticket.taken)
                     for k in range(-(-len(t) // B) if t else 0)]
        self._staging.release(ticket.bufs, dirty)
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

    def step_burst(self, max_k: Optional[int] = None
                   ) -> Dict[str, np.ndarray]:
        """Drain the pending queues through up to ``max(K_TIERS)`` fused
        steps in one dispatch; returns the final step's outputs with
        ``accepted`` summed over the burst. Only while a leader is known
        (no election timeouts fire inside a burst)."""
        require_drained(self._tickets, "step_burst")
        return self.finish(self.begin_burst(max_k=max_k))

    # ---------------- rebase ----------------

    def _rebase_stalled_step(self) -> None:
        self.rebase_stall_steps += 1
        if self.rebase_stall_steps >= self.REBASE_STALL_STEPS:
            self.rebase_stalled += 1

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
            self._rebase_stalled_step()
            return
        self.state = rebase_offsets(self.state, delta)
        self.applied -= delta
        for k in ("head", "apply", "commit", "end"):
            res[k] = res[k] - delta
        self.rebases += 1
        self.rebased_total += delta
        self.rebase_stall_steps = 0

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
                wd_t, wm_t = fetch_window(self.state.log, starts,
                                          window_slots=rows)
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
