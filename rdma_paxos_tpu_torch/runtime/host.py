"""One consensus replica per process — the reference's deployment of one
process per machine (``benchmarks/run.sh`` starting N replicas over
ssh), on ``torch.distributed``.

The mapping of the reference's transports:

  IB multicast bootstrap (mcast JOIN,     ``init_process_group``: a TCP
  ud_exchange_rc_info 3-way handshake)    rendezvous at the coordinator
                                          ``host:port``
  RC QP data plane (one-sided writes)     the replica step's five
                                          collectives over the world's
                                          gloo process group
                                          (``parallel/mesh.py``)

Every process runs the SAME step functions in the same order; per-process
*values* differ — each feeds its replica's ``[1, ...]`` input row (client
batches from its local proxy, its own election timer) and reads back its
replica's outputs. The collectives inside the step synchronise the
processes, so their polling loops stay in lock-step.

This is the port of the JAX package's ``runtime/host.py``. The state row
lives on the card (``device=None``) or, when the caller passes
``device="cpu"``, on the CPU; a card's tensors cross the world through
explicit host copies (``ReplicaWorld.staging``), so every exchange waits
for the card. Usage (per process)::

    hd = HostReplicaDriver(cfg, process_id=i, num_processes=N,
                           coordinator="host0:9900")
    hd.step(batch=[...], timeout_fired=..., apply_done=...)  # every rank
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from rdma_paxos_tpu_torch.config import LogConfig, resolve_device
from rdma_paxos_tpu_torch.consensus.log import Log, META_W
from rdma_paxos_tpu_torch.consensus.snapshot import export_row, rebase_offsets
from rdma_paxos_tpu_torch.consensus.state import STATE_FIELDS
from rdma_paxos_tpu_torch.consensus.step import (
    SCAN_KEYS, StepInput, fetch_window)
from rdma_paxos_tpu_torch.obs.audit import AUDIT_KEYS
from rdma_paxos_tpu_torch.parallel.mesh import (
    build_spmd_burst, build_spmd_scan, build_spmd_step, local_state,
    make_replica_world)
from rdma_paxos_tpu_torch.runtime.hostpath import pack_window

# per-replica scalar outputs extracted from a step/burst (ONE list so the
# single-step and burst paths can never drift)
OUT_KEYS = ("term", "role", "leader_id", "voted_term", "voted_for",
            "head", "apply", "commit", "end", "hb_seen", "became_leader",
            "acked", "accepted", "leadership_verified", "burst_hint",
            "rebase_delta")

I32 = torch.int32


class HostReplicaDriver:
    """Per-process runtime for one replica of a multi-process group.

    ``initialize_distributed=True`` joins the world: a gloo
    ``init_process_group`` with ``coordinator`` (``"host:port"``) as its
    TCP rendezvous, bounded by ``timeout`` seconds. The world's backend
    and staging are fixed then and printed."""

    def __init__(self, cfg: LogConfig, *, process_id: int,
                 num_processes: int, coordinator: str,
                 group_size: Optional[int] = None,
                 initialize_distributed: bool = True,
                 fanout: str = "psum", audit: bool = False,
                 device=None, timeout: float = 60.0):
        self.device = resolve_device(device)
        if initialize_distributed:
            import torch.distributed as dist
            dist.init_process_group(
                "gloo", init_method=f"tcp://{coordinator}",
                world_size=num_processes, rank=process_id,
                timeout=datetime.timedelta(seconds=timeout))
        self.cfg = cfg
        self.me = process_id
        self.R = num_processes
        self.world = make_replica_world(self.R, device=self.device)
        if self.world.rank != self.me:
            raise ValueError(f"process_id {self.me} is rank "
                             f"{self.world.rank} of the world")
        print(self.world.describe(), flush=True)
        # real deployments run full-connectivity worlds: the O(W) psum
        # fan-out is sound there (see replica_step's fanout docstring)
        self._fanout = fanout
        # audit=True runs the digest-chain variant: each process
        # extracts ITS replica's digest windows; cross-process
        # comparison merges the per-replica audit dumps
        self._audit = audit
        self._step = build_spmd_step(cfg, self.R, self.world,
                                     fanout=fanout, audit=audit)
        # the fused burst and the K-window scan tier (built on first
        # use; K follows the [K, ...] input shape)
        self._burst = None
        self._scan = None
        self.state = local_state(cfg, self.R, group_size or self.R,
                                 device=self.device)
        # persistent staging buffers for window encode, repacked in
        # place each iteration with only the previously-dirty rows
        # zeroed; safe because step()/step_burst() read their outputs
        # before returning — no dispatch is in flight at the next pack
        B = cfg.batch_slots
        self._stage = dict(
            data=np.zeros((B, cfg.slot_words), np.int32),
            meta=np.zeros((B, META_W), np.int32), dirty=0)
        self._kstage: Dict[int, dict] = {}   # K -> burst staging set

    # ------------------------------------------------------------------

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32)).to(self.device)

    def install_genesis(self, row: dict) -> None:
        """Install a pre-synchronised state row (``consensus/snapshot.
        genesis_row``) as this process's replica — the elastic-rebuild
        boot path; every process installs the SAME row (all fetched it
        from the generation's donor). Local: no collective."""
        fields = {}
        for k in STATE_FIELDS:
            if k == "log":
                continue
            cur = getattr(self.state, k)
            fields[k] = torch.as_tensor(
                np.asarray(row[k]).astype(np.int64)).to(
                    device=self.device, dtype=cur.dtype)[None].clone()
        buf = torch.as_tensor(np.asarray(row["log_buf"], np.int32))
        fields["log"] = Log(buf.to(self.device)[None].clone())
        self.state = type(self.state)(**fields)

    def restore_hardstate(self, term: int, voted_term: int,
                          voted_for: int) -> None:
        """Install this process's persisted election state (its
        HardState file) into its replica's row — election safety across
        restarts: a recovered daemon must never re-grant a vote it
        already cast. Local: no collective (pass zeros when there is no
        persisted state)."""
        st = self.state
        t, vt, vf = (torch.tensor([v], dtype=I32, device=self.device)
                     for v in (term, voted_term, voted_for))
        self.state = dataclasses.replace(
            st, term=torch.maximum(st.term, t),
            voted_for=torch.where(vt > st.voted_term, vf, st.voted_for),
            voted_term=torch.maximum(st.voted_term, vt))

    def make_input(self, batch: Sequence[Tuple[int, int, int, bytes]] = (),
                   timeout_fired: bool = False, apply_done: int = 0,
                   peer_mask: Optional[np.ndarray] = None,
                   gen: int = 0, queue_depth: int = 0) -> StepInput:
        """This replica's ``[1, ...]`` step input row; ``peer_mask`` is
        its row ``[R]`` of the world's link matrix (who it hears)."""
        B = self.cfg.batch_slots
        st = self._stage
        if st["dirty"]:
            st["data"][:st["dirty"]] = 0
            st["meta"][:st["dirty"]] = 0
        data, meta = st["data"], st["meta"]
        st["dirty"] = self._pack_batch(batch, data, meta, gen)
        if peer_mask is not None and self._fanout == "psum":
            # the psum fan-out is sound only under full connectivity: a
            # partition mask could leave two self-claimed leaders whose
            # windows SUM instead of being selected — reject loudly
            # (use fanout="gather" to model partitions)
            if not np.all(np.asarray(peer_mask) != 0):
                raise ValueError(
                    "psum fan-out requires an all-ones peer_mask; "
                    "build the driver with fanout='gather' to model "
                    "partitions")
        pm = (np.ones(self.R, np.int32) if peer_mask is None
              else np.asarray(peer_mask).astype(np.int32))
        return StepInput(
            batch_data=self._dev(data[None]),
            batch_meta=self._dev(meta[None]),
            batch_count=self._dev([min(len(batch), B)]),
            timeout_fired=self._dev([int(timeout_fired)]),
            peer_mask=self._dev(pm[None]),
            apply_done=self._dev([apply_done]),
            queue_depth=self._dev([queue_depth]))

    def _pack_batch(self, batch, data: np.ndarray, meta: np.ndarray,
                    gen: int) -> int:
        """Fill one ``[B, ...]`` data/meta pair from ``(etype, conn, req,
        payload)`` rows through the shared vectorised host data plane
        (``hostpath.pack_window``), stamping ``gen`` into ``M_GEN``.
        Returns the number of rows written (the caller's dirty count;
        rows are assumed pre-zeroed)."""
        du8 = data.view(np.uint8).reshape(data.shape[0], -1)
        return pack_window(du8, meta, list(batch)[:data.shape[0]],
                           self.cfg.slot_bytes, gen=gen)

    def step(self, **kw) -> Dict[str, np.ndarray]:
        """One collective protocol step; every process must call this in
        the same loop iteration. Returns THIS replica's scalar outputs
        (and its digest windows when auditing)."""
        inp = self.make_input(**kw)
        self.state, out = self._step(self.state, inp)
        row = torch.stack([getattr(out, k).to(I32) for k in OUT_KEYS]
                          )[:, 0].cpu().numpy()
        res = {k: row[i] for i, k in enumerate(OUT_KEYS)}
        if self._audit:
            for k in AUDIT_KEYS:
                res[k] = getattr(out, k)[0].cpu().numpy()
        return res

    def _kinputs(self, K: int, batches, gen: int):
        """The ``[K, 1, ...]`` burst inputs from up to K client batches
        (repacked in the K-deep staging set)."""
        cfg, B = self.cfg, self.cfg.batch_slots
        st = self._kstage.get(K)
        if st is None:
            st = self._kstage[K] = dict(
                data=np.zeros((K, B, cfg.slot_words), np.int32),
                meta=np.zeros((K, B, META_W), np.int32),
                dirty=[0] * K)
        data, meta, dirty = st["data"], st["meta"], st["dirty"]
        for k, n in enumerate(dirty):
            if n:
                data[k, :n] = 0
                meta[k, :n] = 0
                dirty[k] = 0
        count = np.zeros((K,), np.int32)
        for k, batch in enumerate(list(batches)[:K]):
            dirty[k] = self._pack_batch(batch, data[k], meta[k], gen)
            count[k] = min(len(batch), B)
        return (self._dev(data[:, None]), self._dev(meta[:, None]),
                self._dev(count[:, None]))

    def _burst_fn(self):
        if self._burst is None:
            self._burst = build_spmd_burst(
                self.cfg, self.R, self.world, fanout=self._fanout,
                audit=self._audit)
        return self._burst

    def step_burst(self, K: int,
                   batches: Sequence[Sequence[Tuple[int, int, int,
                                                    bytes]]] = (),
                   apply_done: int = 0, gen: int = 0,
                   queue_depth: int = 0) -> Dict[str, np.ndarray]:
        """K fused protocol steps in ONE collective call. EVERY process
        must call this in the same iteration with the SAME K (derived
        from the gathered ``burst_hint`` — identical on all processes
        under full connectivity). ``batches``: up to K client batches
        for this process (empty on followers). ``queue_depth``: backlog
        REMAINING beyond this burst — it rides every burst step's
        gather so the final ``burst_hint`` sustains back-to-back bursts.
        No election timeouts fire inside a burst. Returns this replica's
        final-step outputs plus ``accepted`` summed over the burst (and
        every fused step's digest windows when auditing)."""
        assert K > 0, K
        datas, metas, counts = self._kinputs(K, batches, gen)
        self.state, outs = self._burst_fn()(
            self.state, datas, metas, counts,
            self._dev(np.ones((1, self.R))), self._dev([apply_done]),
            self._dev([queue_depth]))
        rows = torch.stack([getattr(outs, k).to(I32) for k in OUT_KEYS]
                           )[:, :, 0].cpu().numpy()          # [keys, K]
        res = {k: rows[i, -1] for i, k in enumerate(OUT_KEYS)}
        res["accepted"] = rows[OUT_KEYS.index("accepted")].sum()
        if self._audit:
            # the windows of EVERY fused step, in order, so the digest
            # chain tiles through bursts; audit_commit carries each
            # step's commit frontier
            for k in AUDIT_KEYS + ("commit",):
                res["audit_commit" if k == "commit" else k] = (
                    getattr(outs, k)[:, 0].cpu().numpy())
        return res

    def _scan_fn(self):
        if self._scan is None:
            self._scan = build_spmd_scan(
                self.cfg, self.R, self.world,
                replay_slots=self.cfg.window_slots,
                fanout=self._fanout, audit=self._audit)
        return self._scan

    def step_scan(self, K: int,
                  batches: Sequence[Sequence[Tuple[int, int, int,
                                                   bytes]]] = (),
                  apply_done: int = 0, gen: int = 0,
                  queue_depth: int = 0
                  ) -> Tuple[Dict[str, np.ndarray],
                             Tuple[np.ndarray, np.ndarray]]:
        """The K-window scan tier of :meth:`step_burst`: K fused protocol
        steps whose readback is ONE consolidated scalar matrix — plus
        this replica's replay window (``window_slots`` rows from
        ``apply_done`` on, read from the POST-scan log inside the same
        call), so the apply loop needs no ``fetch_local_window`` for
        entries the scan already staged. Same schedule contract as
        bursts. Returns ``(res, (wdata, wmeta))``; ``res`` matches
        :meth:`step_burst`'s (``accepted`` summed, audit windows per
        fused step when auditing)."""
        assert K > 0, K
        datas, metas, counts = self._kinputs(K, batches, gen)
        self.state, outs = self._scan_fn()(
            self.state, datas, metas, counts,
            self._dev(np.ones((1, self.R))), self._dev([apply_done]),
            self._dev([queue_depth]))
        scal = outs["scal"][-1, 0].cpu().numpy()
        res: Dict[str, np.ndarray] = {
            k: scal[i] for i, k in enumerate(SCAN_KEYS)}
        if self._audit:
            for k in AUDIT_KEYS + ("audit_commit",):
                res[k] = outs[k][:, 0].cpu().numpy()
        return res, (outs["replay_data"][0].cpu().numpy(),
                     outs["replay_meta"][0].cpu().numpy())

    def rebase(self, delta: int) -> None:
        """Apply the coordinated i32-offset rollover to this replica's
        row (see ``consensus/snapshot.rebase_offsets``). Elementwise, no
        collective: processes apply it independently once they agree on
        ``delta`` (the step's gathered ``rebase_delta``, identical on
        every process under full connectivity)."""
        self.state = rebase_offsets(self.state, int(delta))

    def export_local_row(self) -> dict:
        """THIS replica's full state row as host numpy (a local read, no
        collective), keyed like ``snapshot.export_row``. The donor half
        of an elastic world rebuild."""
        return export_row(self.state, 0)

    def fetch_local_window(self, start: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Read ``window_slots`` entries beginning at ``start`` from THIS
        replica's log. Local (no collective): call freely, on any
        process, only when needed."""
        wd, wm = fetch_window(self.state.log,
                              self._dev([start]),
                              window_slots=self.cfg.window_slots)
        return wd[0].cpu().numpy(), wm[0].cpu().numpy()
