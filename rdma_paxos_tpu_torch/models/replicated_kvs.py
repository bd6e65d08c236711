"""Standalone-DARE mode: the device KVS served directly over consensus.

PUT/RM/merge commands ride SEND entries through the replicated log;
every replica folds its committed stream into its own device-resident
:mod:`rdma_paxos_tpu_torch.models.kvs` table, one command at a time in
log order. Session-stamped commands ``(client_id, req_id)`` apply
exactly once (the ``dare_ep_db`` ``last_req_id`` analog,
``dare_ep_db.h:20-30``): the dedup registry is folded deterministically
from the committed stream, so every replica — and any future leader —
skips a retransmit identically. Linearizable GETs are served by a
replica that holds a valid leader lease (``cluster.leases``, attached
by ``runtime/reads.py``) or verified its leadership on the latest step
(read-index), and has applied up to its commit index; weak GETs by any
replica. An attached ``chaos.history.HistoryRecorder`` (``history``)
records every client-visible operation for the linearizability checker.

Committed transaction records (``TXN_CMD_W`` words, ``txn/records.py``)
fold as in the JAX package's ``_fold_txn``: a PREPARE stages its write
per tid, a COMMIT applies the tid's staged writes, an ABORT drops them,
a MERGE applies at once; records dedup per tid. A fold builds one list
of command words in commit order — plain commands and the writes a
txn record releases interleaved as they committed — and applies it in
that order, so a COMMIT's writes land between the commands around it.
"""

from __future__ import annotations

import collections
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from rdma_paxos_tpu_torch.consensus.log import EntryType
from rdma_paxos_tpu_torch.models.kvs import (
    CMD_W, KEY_W, OP_GET, OP_PUT, OP_RM, KVState, apply_cmd, decode_val,
    encode_cmd, lookup, make_kvs)
from rdma_paxos_tpu_torch.txn.records import (
    TXN_ABORT, TXN_CMD_W, TXN_COMMIT, TXN_MERGE, TXN_PREPARE, decode_record)

# capacity of the per-replica ring of finished (decided or complete)
# transaction ids: duplicate txn records (decisions and merges are
# retried under their ORIGINAL stamp across failover) trail their first
# committed copy by at most the retry patience plus a couple of
# confirmation dispatches, all of them serial while the transaction is
# live (the coordinator's wants_serial gate), so the stream gap between
# a record and its last duplicate is a few hundred entries — orders of
# magnitude under this bound
TXN_DONE_CAP = 65536


class ReplicatedKVS:
    """KVS service over a :class:`~rdma_paxos_tpu_torch.runtime.sim.
    SimCluster` (duck-typed: ``R``, ``submit``, ``replayed``, ``last``,
    ``applied``, ``need_recovery``, ``device``)."""

    def __init__(self, cluster, cap: int = 4096):
        self.c = cluster
        # consensus group this instance serves (set by ShardedKVS):
        # labels the dedup metric series
        self.group: Optional[int] = None
        self.device = cluster.device
        self.tables: List[KVState] = [make_kvs(cap, device=self.device)
                                      for _ in range(cluster.R)]
        self._cursor = [0] * cluster.R
        # per-replica endpoint registry: client_id -> highest applied
        # req_id, folded from the committed stream
        self.last_req: List[dict] = [dict() for _ in range(cluster.R)]
        self.deduped: List[int] = [0] * cluster.R
        # optional chaos.history.HistoryRecorder: when attached, every
        # client-visible operation (session PUT/RM, weak and
        # linearizable GETs, retransmits) is recorded as invoke/ok/fail
        # events for the linearizability checker
        self.history = None
        # txn staging and exactly-once, folded deterministically from the
        # committed stream like last_req: per replica, tid -> {"reqs":
        # stamped reqs folded so far, "staged": buffered command words}
        # for live tids only; a finished tid moves to the bounded
        # done-ring (a set plus its FIFO) and its entry here is dropped
        self._txn_buf: List[dict] = [dict() for _ in range(cluster.R)]
        self._txn_done: List[set] = [set() for _ in range(cluster.R)]
        self._txn_done_fifo: List[collections.deque] = [
            collections.deque() for _ in range(cluster.R)]
        self.txn_applied: List[int] = [0] * cluster.R
        self.txn_discarded: List[int] = [0] * cluster.R

    def _spans(self):
        """The cluster's span recorder when causal tracing is on —
        session mutations are span births keyed (client_id, req_id),
        the stamp that rides the entry's M_CONN/M_REQID columns."""
        from rdma_paxos_tpu_torch.obs.spans import active_recorder
        return active_recorder(getattr(self.c, "obs", None))

    def _span_rep(self, r: int) -> int:
        """Span-track replica id for local replica ``r``, in the
        namespace the cluster's append/commit/apply stamps use."""
        f = getattr(self.c, "span_replica", None)
        return f(r) if f is not None else r

    def rebuild(self, r: int) -> None:
        """Crash-restart of replica ``r``'s app: discard its table, dedup
        registry and txn staging and refold from the replay stream."""
        self.tables[r] = make_kvs(int(self.tables[r].cap),
                                  device=self.device)
        self._cursor[r] = 0
        self.last_req[r] = dict()
        self.deduped[r] = 0
        self._txn_buf[r] = dict()
        self._txn_done[r] = set()
        self._txn_done_fifo[r] = collections.deque()
        self.txn_applied[r] = 0
        self.txn_discarded[r] = 0

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
                # a txn record: the writes it releases join the list here,
                # in commit order (dedup per tid, in _fold_txn)
                cmds.extend(self._fold_txn(r, conn, req, payload))
                continue
            if len(payload) != CMD_W * 4:
                continue                      # not a KVS command: skip
            if req > 0 and conn > 0:
                if req <= self.last_req[r].get(conn, 0):
                    self.deduped[r] += 1
                    obs = getattr(self.c, "obs", None)
                    if obs is not None:
                        labels = dict(replica=r)
                        if self.group is not None:
                            labels["group"] = self.group
                        obs.metrics.inc("kvs_deduped_total", **labels)
                    continue
                self.last_req[r][conn] = req
            cmds.append(np.frombuffer(payload, "<i4"))
        if not cmds:
            return
        # one transfer for the fold; applied one command at a time
        words = torch.from_numpy(np.stack(cmds)).to(self.device)
        for i in range(words.shape[0]):
            self.tables[r], _ = apply_cmd(self.tables[r], words[i])

    def _txn_retire(self, r: int, tid: int) -> None:
        """Move ``tid`` to replica ``r``'s done-ring: late duplicates
        (retried decisions and merges) and stragglers of a finished
        transaction are dropped without per-record registry residue."""
        done = self._txn_done[r]
        if tid in done:
            return
        done.add(tid)
        fifo = self._txn_done_fifo[r]
        fifo.append(tid)
        while len(fifo) > TXN_DONE_CAP:
            done.discard(fifo.popleft())

    def _fold_txn(self, r: int, conn: int, req: int,
                  payload: bytes) -> List[np.ndarray]:
        """Fold one committed txn record (``txn/records.py`` layout) and
        return the command words it releases, for the caller to apply
        at this record's place in commit order: PREPARE stages its
        embedded write per tid (releases nothing), COMMIT releases the
        tid's staged writes in staging order, ABORT drops them, MERGE
        releases its own write at once and retires the tid once its last
        merge record lands. Exactly-once is per tid: stamped duplicates
        dedup against the live tid's req set or the done-ring, not the
        session ``last_req`` registry, and a record of an already
        finished tid (a retried duplicate, or a PREPARE landing after its
        transaction's decision) is dropped. Deterministic over the
        committed stream, so every replica — and any rebuild — derives
        the same table (the JAX package's ``_fold_txn``)."""
        txn_op, tid, arg, cmd_words = decode_record(payload)
        if tid in self._txn_done[r]:
            self.deduped[r] += 1
            return []
        stamped = req > 0 and conn > 0
        buf = self._txn_buf[r]
        out: List[np.ndarray] = []
        if txn_op in (TXN_PREPARE, TXN_MERGE):
            ent = buf.setdefault(tid, {"reqs": set(), "staged": []})
            if stamped:
                if req in ent["reqs"]:
                    self.deduped[r] += 1
                    return out
                ent["reqs"].add(req)
            if txn_op == TXN_PREPARE:
                ent["staged"].append(cmd_words)
                return out
            out.append(cmd_words)
            self.txn_applied[r] += 1
            if stamped and len(ent["reqs"]) == arg:
                # the coordinator submits exactly ``arg`` merge records
                # here: all folded, the tid is complete
                del buf[tid]
                self._txn_retire(r, tid)
        elif txn_op == TXN_COMMIT:
            ent = buf.pop(tid, None)
            out.extend(ent["staged"] if ent else ())
            self.txn_applied[r] += len(out)
            self._txn_retire(r, tid)
        elif txn_op == TXN_ABORT:
            ent = buf.pop(tid, None)
            self.txn_discarded[r] += len(ent["staged"]) if ent else 0
            self._txn_retire(r, tid)
        return out

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
        """The linearizable serving gate. Once replica ``r``'s apply
        cursor covers its commit index: ``"lease"`` when it holds a
        valid leader lease, else ``"read_index"`` when it verified
        leadership on the latest step. ``"quarantined"`` when it awaits
        recovery or is barred from serving, else ``"refused"``."""
        if (r in getattr(self.c, "need_recovery", ())
                or r in getattr(self.c, "read_blocked", ())):
            return "quarantined"
        lm = getattr(self.c, "leases", None)
        g = self.group if self.group is not None else 0
        last = self.c.last
        # a wedged apply keeps acking windows, so leadership_verified —
        # and the lease — stay live while applied freezes below commit
        applied = getattr(self.c, "applied", None)
        caught_up = (last is not None and applied is not None
                     and int(applied[r]) >= int(last["commit"][r]))
        if caught_up and lm is not None and lm.valid(g, r):
            return "lease"
        if caught_up and last["leadership_verified"][r]:
            return "read_index"
        return "refused"

    def get(self, r: int, key: bytes, *,
            linearizable: bool = False) -> Optional[bytes]:
        """Read from replica ``r``'s table. A linearizable read serves
        through the lease or read-index path of :meth:`serving_path`
        and is refused (None, recorded as a FAIL — it definitively did
        not happen) otherwise; each served one is counted per path."""
        t0 = time.monotonic() if linearizable else None
        op_id = (self.history.invoke("get", key, replica=r,
                                     weak=not linearizable)
                 if self.history is not None else None)
        path = None
        if linearizable:
            path = self.serving_path(r)
            if path in ("quarantined", "refused"):
                if op_id is not None:
                    self.history.fail(
                        op_id, reason=("quarantined"
                                       if path == "quarantined"
                                       else "leadership_unverified"))
                return None
        v = self.get_many(r, [key])[0]
        if path is not None:
            from rdma_paxos_tpu_torch.runtime.reads import count_read
            count_read(getattr(self.c, "obs", None), path, r,
                       group=self.group, t0=t0)
        if op_id is not None:
            self.history.ok(op_id, v)
        return v

    def serve_local(self, r: int, key: bytes) -> Optional[bytes]:
        """Bare local table read (fold + lookup) with no gate and no
        accounting — the serve callback of hub-queued reads, whose
        linearization point the ``ReadHub`` establishes first."""
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

    def items_in_range(self, r: int, lo: bytes,
                       hi: Optional[bytes]) -> List[Tuple[bytes, bytes]]:
        """Every live ``(key, value)`` pair in ``[lo, hi)`` (byte-
        lexicographic; ``hi=None`` = unbounded) from replica ``r``'s
        folded table, sorted by key — the topology transition's
        donor-side enumeration primitive and the input to its range
        digest. One readback of the table's three tensors, then a host
        walk; keys come back canonicalized modulo trailing NULs, as in
        the JAX package. Words are encoded ``<i4``, the JAX table's
        width, so the range digests agree."""
        self._fold(r)
        kv = self.tables[r]
        used = kv.used.cpu().numpy()
        keys = kv.keys.cpu().numpy().astype("<i4")
        vals = kv.vals.cpu().numpy().astype("<i4")
        out: List[Tuple[bytes, bytes]] = []
        for slot in np.nonzero(used)[0]:
            kb = keys[slot].tobytes().rstrip(b"\x00")
            if kb < lo or (hi is not None and kb >= hi):
                continue
            out.append((kb, vals[slot].tobytes().rstrip(b"\x00")))
        out.sort()
        return out

    def submit_get(self, leader: int, key: bytes, *, client_id: int,
                   req_id: int) -> None:
        """The reads-through-log baseline: a stamped ``OP_GET`` entry
        rides the replicated log like a write (the dedup registry marks
        its ``req_id``, so completion is observable via ``last_req``)."""
        self.c.submit(leader, encode_cmd(OP_GET, key).tobytes(),
                      conn=client_id, req_id=req_id)


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

    def _begin(self, op: str, leader: int, key: bytes,
               val: Optional[bytes] = None) -> None:
        """Record a new request's invocation (history) and open its
        span, keyed by the session stamp."""
        if self.kvs.history is not None:
            self.kvs.history.invoke(op, key, val, client=self.client_id,
                                    req_id=self.req_id, replica=leader)
        spans = self.kvs._spans()
        if spans is not None:
            spans.begin(self.client_id, self.req_id,
                        self.kvs._span_rep(leader), phase="submit")

    def put(self, leader: int, key: bytes, val: bytes) -> int:
        """Submit a PUT; returns its req_id (keep it to retransmit)."""
        self.req_id += 1
        self._begin("put", leader, key, val)
        self.kvs.put(leader, key, val, client_id=self.client_id,
                     req_id=self.req_id)
        return self.req_id

    def remove(self, leader: int, key: bytes) -> int:
        self.req_id += 1
        self._begin("rm", leader, key)
        self.kvs.remove(leader, key, client_id=self.client_id,
                        req_id=self.req_id)
        return self.req_id

    def merge(self, leader: int, op: int, key: bytes, val: bytes) -> int:
        self.req_id += 1
        self._begin("merge", leader, key, val)
        self.kvs.merge(leader, op, key, val, client_id=self.client_id,
                       req_id=self.req_id)
        return self.req_id

    def retransmit_put(self, leader: int, key: bytes, val: bytes,
                       req_id: int) -> None:
        """Resend an earlier PUT verbatim (safe any number of times);
        recorded as a retransmit of the same logical command."""
        if self.kvs.history is not None:
            op_id = self.kvs.history.op_id_for(self.client_id, req_id)
            if op_id is not None:
                self.kvs.history.retransmit(op_id, replica=leader)
        spans = self.kvs._spans()
        if spans is not None:
            spans.begin(self.client_id, req_id,
                        self.kvs._span_rep(leader), phase="submit")
        self.kvs.put(leader, key, val, client_id=self.client_id,
                     req_id=req_id)
