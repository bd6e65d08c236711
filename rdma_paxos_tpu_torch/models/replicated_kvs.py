"""Standalone-DARE mode: the device KVS served directly over consensus.

PUT/RM/merge commands ride SEND entries through the replicated log;
every replica folds its committed stream into its own device-resident
:mod:`rdma_paxos_tpu_torch.models.kvs` table, one command at a time in
log order. Session-stamped commands ``(client_id, req_id)`` apply
exactly once (the ``dare_ep_db`` ``last_req_id`` analog,
``dare_ep_db.h:20-30``): the dedup registry is folded deterministically
from the committed stream, so every replica — and any future leader —
skips a retransmit identically. Linearizable GETs are served by a
replica that verified its leadership on the latest step (read-index)
and has applied up to its commit index; weak GETs by any replica.

A committed transaction record (``TXN_CMD_W`` words) raises: the
transaction lane is a later slice of the port, and skipping its records
would silently drop writes.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from rdma_paxos_tpu_torch.consensus.log import EntryType
from rdma_paxos_tpu_torch.models.kvs import (
    CMD_W, KEY_W, OP_GET, OP_PUT, OP_RM, KVState, apply_cmd, decode_val,
    encode_cmd, lookup, make_kvs)

# width of a 2PC transaction record: [txn_op, tid, arg, kvs command]
TXN_CMD_W = 3 + CMD_W


class ReplicatedKVS:
    """KVS service over a :class:`~rdma_paxos_tpu_torch.runtime.sim.
    SimCluster` (duck-typed: ``R``, ``submit``, ``replayed``, ``last``,
    ``applied``, ``need_recovery``, ``device``)."""

    def __init__(self, cluster, cap: int = 4096):
        self.c = cluster
        self.device = cluster.device
        self.tables: List[KVState] = [make_kvs(cap, device=self.device)
                                      for _ in range(cluster.R)]
        self._cursor = [0] * cluster.R
        # per-replica endpoint registry: client_id -> highest applied
        # req_id, folded from the committed stream
        self.last_req: List[dict] = [dict() for _ in range(cluster.R)]
        self.deduped: List[int] = [0] * cluster.R

    def rebuild(self, r: int) -> None:
        """Crash-restart of replica ``r``'s app: discard its table and
        dedup registry and refold from the replay stream."""
        self.tables[r] = make_kvs(int(self.tables[r].cap),
                                  device=self.device)
        self._cursor[r] = 0
        self.last_req[r] = dict()
        self.deduped[r] = 0

    def _fold(self, r: int) -> None:
        """Fold newly committed commands into replica r's table."""
        stream = self.c.replayed[r]
        n = len(stream)
        if self._cursor[r] >= n:
            return
        rows = []
        for seg in stream.segments_from(self._cursor[r]):
            rows.extend(seg.tuples() if hasattr(seg, "tuples") else seg)
        self._cursor[r] = n
        cmds = []
        for etype, conn, req, payload in rows:
            if etype != int(EntryType.SEND):
                continue
            if len(payload) == TXN_CMD_W * 4:
                raise NotImplementedError(
                    "committed transaction record: the txn lane is not "
                    "ported")
            if len(payload) != CMD_W * 4:
                continue                      # not a KVS command: skip
            if req > 0 and conn > 0:
                if req <= self.last_req[r].get(conn, 0):
                    self.deduped[r] += 1
                    continue
                self.last_req[r][conn] = req
            cmds.append(np.frombuffer(payload, "<i4"))
        if not cmds:
            return
        # one transfer for the fold; applied one command at a time
        words = torch.from_numpy(np.stack(cmds)).to(self.device)
        for i in range(words.shape[0]):
            self.tables[r], _ = apply_cmd(self.tables[r], words[i])

    # ------------------------------------------------------------------

    def put(self, leader: int, key: bytes, val: bytes, *,
            client_id: int = 0, req_id: int = 0) -> None:
        self.c.submit(leader, encode_cmd(OP_PUT, key, val).tobytes(),
                      conn=client_id, req_id=req_id)

    def remove(self, leader: int, key: bytes, *,
               client_id: int = 0, req_id: int = 0) -> None:
        self.c.submit(leader, encode_cmd(OP_RM, key).tobytes(),
                      conn=client_id, req_id=req_id)

    def merge(self, leader: int, op: int, key: bytes, val: bytes, *,
              client_id: int = 0, req_id: int = 0) -> None:
        """Submit one mergeable write (OP_INCR/OP_SADD/OP_MAX)."""
        self.c.submit(leader, encode_cmd(op, key, val).tobytes(),
                      conn=client_id, req_id=req_id)

    def session(self, client_id: int) -> "ClientSession":
        return ClientSession(self, client_id)

    def serving_path(self, r: int) -> str:
        """``"read_index"`` when replica ``r`` may serve a linearizable
        read now (it verified leadership on the latest step and its
        apply cursor covers its commit index), ``"quarantined"`` when
        it awaits recovery, else ``"refused"``."""
        if r in self.c.need_recovery:
            return "quarantined"
        last = self.c.last
        if (last is not None
                and int(self.c.applied[r]) >= int(last["commit"][r])
                and last["leadership_verified"][r]):
            return "read_index"
        return "refused"

    def get(self, r: int, key: bytes, *,
            linearizable: bool = False) -> Optional[bytes]:
        """Read from replica ``r``'s table; a linearizable read is
        refused (None) unless :meth:`serving_path` is ``read_index``."""
        if linearizable and self.serving_path(r) != "read_index":
            return None
        return self.get_many(r, [key])[0]

    def serve_local(self, r: int, key: bytes) -> Optional[bytes]:
        """Bare local table read (fold + lookup), no gate."""
        return self.get_many(r, [key])[0]

    def get_many(self, r: int, keys) -> List[Optional[bytes]]:
        """Local reads of ``keys`` from replica ``r``'s table in one
        lookup; gating is the caller's job."""
        if not keys:
            return []
        self._fold(r)
        kw = np.stack([encode_cmd(OP_GET, k)[1:1 + KEY_W] for k in keys])
        vals = lookup(self.tables[r],
                      torch.from_numpy(kw).to(self.device)).cpu().numpy()
        return [decode_val(v) or None for v in vals]


class ClientSession:
    """A client endpoint that may retransmit requests; every mutation
    is stamped ``(client_id, req_id)`` and applies exactly once. At most
    ONE request outstanding: retransmit the same req_id until it
    commits before issuing the next."""

    def __init__(self, kvs: ReplicatedKVS, client_id: int):
        if client_id <= 0:
            raise ValueError("client_id must be positive")
        self.kvs = kvs
        self.client_id = client_id
        self.req_id = 0

    def put(self, leader: int, key: bytes, val: bytes) -> int:
        """Submit a PUT; returns its req_id (keep it to retransmit)."""
        self.req_id += 1
        self.kvs.put(leader, key, val, client_id=self.client_id,
                     req_id=self.req_id)
        return self.req_id

    def remove(self, leader: int, key: bytes) -> int:
        self.req_id += 1
        self.kvs.remove(leader, key, client_id=self.client_id,
                        req_id=self.req_id)
        return self.req_id

    def merge(self, leader: int, op: int, key: bytes, val: bytes) -> int:
        self.req_id += 1
        self.kvs.merge(leader, op, key, val, client_id=self.client_id,
                       req_id=self.req_id)
        return self.req_id

    def retransmit_put(self, leader: int, key: bytes, val: bytes,
                       req_id: int) -> None:
        """Resend an earlier PUT verbatim (safe any number of times)."""
        self.kvs.put(leader, key, val, client_id=self.client_id,
                     req_id=req_id)
