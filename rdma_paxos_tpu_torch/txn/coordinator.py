"""Host 2PC coordinator over the in-dispatch commit lane.

The port's copy of the JAX package's ``txn/coordinator.py`` (host-only),
over the port's ``ShardedCluster``/``ShardedKVS``. Its traces, spans and
``txn_*`` counters are recorded as in the reference (the traces on the
``obs`` facade's ``tracectx``, through ``obs/tracectx.py:active_tracer``).

The classic coordinator pays a network round-trip per 2PC phase. Here
every group advances in ONE compiled dispatch, so the phases collapse
onto the dispatch cadence:

* **prepare** — one PREPARE record per staged write is submitted to
  each participant group's leader (stamped ``(conn, req)``, the
  session exactly-once rule). The dispatch that replicates them also
  evaluates each group's armed prepare watch (``txn/lane.py``) and
  reports the stacked ``[G, R]`` vote matrix in the SAME readback.
* **decide** — a PREPARED vote from any replica is definitive (the
  vote rule requires the watched index be COMMITTED under the watched
  term, i.e. majority-replicated); a CONFLICT vote is a definitive
  overwrite-under-failover. All groups prepared ⟹ COMMIT records are
  submitted; the next dispatch replicates them. Hence a cross-group
  commit costs ~2 protocol dispatches end to end.
* **abort** — deterministic, host-decided: step-domain timeout, lock
  conflict at admission, or participant-leader deposition (observed
  from the step outputs — the same signal the drivers' failover hooks
  key on). ABORT records release the groups' staged buffers; until a
  decision record commits, NOTHING touches any table
  (``models/replicated_kvs.py`` stages per tid), so aborted
  transactions leave no partial writes by construction.

Mergeable-only transactions (``txn/merge.py``) skip all of the above:
their writes commit as independent per-group MERGE records, applied
the moment they fold (no staging, no votes, no decision round).

Concurrency: participant locks are keyed ``(group, key)`` — a
conflicting admission aborts immediately (no waiting ⟹ no deadlock).
The commit lane arms ONE watch per group, so 2PC transactions admit
serially (queued FIFO); mergeable transactions never queue.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from rdma_paxos_tpu_torch.obs.spans import active_recorder
from rdma_paxos_tpu_torch.obs.tracectx import active_tracer
from rdma_paxos_tpu_torch.topology import epoch as _epoch
from rdma_paxos_tpu_torch.txn import merge as _merge
from rdma_paxos_tpu_torch.txn import records as _records
from rdma_paxos_tpu_torch.txn.lane import TXN_CONFLICT, TXN_PREPARED

# txn states
PREPARING = "preparing"      # prepare records out, votes pending
COMMITTING = "committing"    # commit records out, awaiting commit
ABORTING = "aborting"        # abort records out, awaiting commit
COMMITTED = "committed"      # terminal
ABORTED = "aborted"          # terminal
MERGING = "merging"          # fast path: merge commands out


class Txn:
    """One transaction's host bookkeeping (coordinator-internal; the
    client-facing view is
    :class:`rdma_paxos_tpu_torch.txn.api.TxnHandle`)."""

    def __init__(self, tid: int, writes_by_group: Dict[int, list],
                 read_keys: Sequence[bytes], deadline: int,
                 fast: bool):
        self.tid = tid
        self.writes_by_group = writes_by_group
        self.read_keys = list(read_keys)
        self.deadline = deadline
        self.fast = fast
        self.state = MERGING if fast else PREPARING
        self.reason: Optional[str] = None
        # per-group: prepares appended so far / (index, term) of the
        # LAST appended prepare (the group's watch target)
        self.prep_appended: Dict[int, int] = {}
        self.watch: Dict[int, Tuple[int, int]] = {}
        # groups whose watch was armed THIS finish (note_appends runs
        # in the stamp loop, observe at the tail — same result dict):
        # eligible for same-finish host resolution
        self.watch_fresh: Dict[int, bool] = {}
        self.prepared: set = set()
        # decision/merge records: (g, req) -> absolute index once
        # appended (-1 = submitted, not yet appended)
        self.record_index: Dict[Tuple[int, int], int] = {}
        # term the record was appended under — a placement is only
        # proof of commit while the group's term is unchanged
        self.record_term: Dict[Tuple[int, int], int] = {}
        self.record_payload: Dict[Tuple[int, int], bytes] = {}
        # (g, req) -> step of the last (re)submission: decided records
        # are retried with patience until appended (dedup keeps the
        # retries exactly-once), surviving leader failover
        self.record_retry: Dict[Tuple[int, int], int] = {}
        self.reads: Dict[bytes, Optional[bytes]] = {}
        # trace-plane bookkeeping: the txn-level trace id (None when
        # tracing is off), the (group, req) keys of every record span
        # this txn opened and has not yet closed (prepare + decision/
        # merge — the coordinator OWNS their closure), and the
        # per-group prepare reqs so a group's prepare spans close the
        # moment it votes PREPARED
        self.trace_id: Optional[str] = None
        self.span_keys: set = set()
        self.prep_reqs: Dict[int, List[int]] = {}
        # routing snapshot at admission: the router version the
        # key→group mapping was computed under, and every (group, key)
        # placement it produced — an elastic cutover bumps the version
        # and the coordinator aborts any undecided txn whose placement
        # moved (reason ``topology``) rather than lock/commit against
        # a group the new routing never serves
        self.router_version = 0
        self.admitted: List[Tuple[int, bytes]] = []

    @property
    def groups(self) -> Sequence[int]:
        return sorted(self.writes_by_group)

    @property
    def done(self) -> bool:
        return self.state in (COMMITTED, ABORTED)

    @property
    def committed(self) -> bool:
        return self.state == COMMITTED

    def participant_mask(self) -> int:
        mask = 0
        for g in self.writes_by_group:
            mask |= 1 << g
        return mask


class TxnCoordinator:
    """Attached to a :class:`~rdma_paxos_tpu_torch.shard.kvs.ShardedKVS`
    (``attach_coordinator``): drives begin/prepare/commit/abort off the
    cluster's finish() tail — ``note_appends`` learns each record's
    ``(term, index)`` from the stamp loop, ``observe`` reads the vote
    matrix, advances timeouts, and detects participant deposition."""

    def __init__(self, kvs, *, client_id: int = 1 << 20,
                 timeout_steps: int = 64):
        self.kvs = kvs
        self.cluster = kvs.shard
        self.G = self.cluster.G
        if not getattr(self.cluster, "_txn", False):
            raise ValueError(
                "attach_coordinator requires a txn=True cluster "
                "(the commit lane rides the txn= step variant)")
        self.client_id = client_id
        self.timeout_steps = int(timeout_steps)
        self.committed_total = 0
        self.aborted_total: Dict[str, int] = collections.Counter()
        # ---- coordinator-lock discipline ----
        # participant locks: (group, key) -> owning tid
        # guarded-by: _lock [writes]
        self._locks: Dict[Tuple[int, bytes], int] = {}
        # live transactions by tid  # guarded-by: _lock [writes]
        self._txns: Dict[int, Txn] = {}
        # (group, req) -> tid for in-flight stamped records
        # guarded-by: _lock [writes]
        self._outstanding: Dict[Tuple[int, int], int] = {}
        # FIFO of admitted-but-waiting 2PC txns (one armed watch per
        # group ⟹ serial 2PC)  # guarded-by: _lock [writes]
        self._queue: collections.deque = collections.deque()
        # the 2PC txn currently owning the commit lane (or None)
        # guarded-by: _lock [writes]
        self._active_2pc: Optional[int] = None
        # per-group stamped-request counter  # guarded-by: _lock [writes]
        self._req = [0] * self.G
        # per-group term each leader was last seen under (deposition
        # detection — the shared epoch machinery, one copy for txn AND
        # topology)  # guarded-by: _lock [writes]
        self._terms = _epoch.TermWatch(self.G)
        self._next_tid = 1                  # guarded-by: _lock [writes]
        self._lock = threading.RLock()
        from rdma_paxos_tpu_torch.analysis import runtime_guard
        runtime_guard.maybe_guard(self, "_lock", __file__)

    # ---------------- trace plane ----------------

    def _tracer(self):
        """The cluster's TraceContext iff tracing is enabled. Safe to
        call (and to use) under ``_lock``: the trace store is
        leaf-locked and this coordinator NEVER takes the topology
        controller's lock (drive() holds that lock while calling our
        ``wants_serial`` — the reverse order would deadlock ABBA; the
        window-trace handoff below is a lock-free attribute read)."""
        return active_tracer(getattr(self.cluster, "obs", None))

    # holds-lock: _lock
    def _close_record_spans(self, txn: Txn, keys, *, ok: bool,
                            status: str = "aborted") -> None:
        """Close record spans this txn opened — DONE when the record
        reached its outcome, else a terminal status carrying the abort
        reason (the fail_open discipline of the span recorder: spans
        terminate, never leak)."""
        spans = active_recorder(getattr(self.cluster, "obs", None))
        for (g, req) in list(keys):
            if spans is not None:
                if ok:
                    spans.ack_key(self._conn(g, req), req)
                else:
                    spans.fail_key(self._conn(g, req), req,
                                   status=status)
            txn.span_keys.discard((g, req))

    # holds-lock: _lock
    def _close_prep_spans(self, txn: Txn, g: int) -> None:
        self._close_record_spans(
            txn, [(g, r) for r in txn.prep_reqs.get(g, ())], ok=True)

    # ---------------- admission ----------------

    def begin(self, writes: Sequence[Tuple[int, bytes, bytes]],
              reads: Sequence[bytes] = ()) -> Txn:
        """Admit a transaction: ``writes`` are ``(op, key, val)``
        triples (op = OP_PUT/OP_RM or a mergeable code), ``reads`` are
        keys to fetch at the serialization point. Lock conflicts abort
        immediately (reason ``conflict``). Mergeable-only write sets
        take the fast path; otherwise the txn joins the 2PC lane."""
        topo = getattr(self.cluster, "topology", None)
        if topo is not None:
            # freeze gate (OUTSIDE the coordinator lock — it blocks):
            # keys in a migrating range queue here until the cutover
            # unfreezes them, so no txn admits against a mapping that
            # is about to flip. The router-version stamp below is the
            # backstop for the freeze starting after this gate passes.
            for _op, key, _val in writes:
                topo.gate_key(key)
            for key in reads:
                topo.gate_key(key)
        by_group: Dict[int, list] = {}
        for op, key, val in writes:
            by_group.setdefault(self.kvs.group_of(key), []).append(
                (op, key, val))
        fast = _merge.mergeable_plan(writes)
        with self._lock:
            tid = self._next_tid
            self._next_tid += 1
            txn = Txn(tid, by_group, reads,
                      self.cluster.step_index + self.timeout_steps,
                      fast)
            tr = self._tracer()
            if tr is not None:
                txn.trace_id = tr.begin("txn", txn=tid,
                                        groups=list(txn.groups),
                                        fast=bool(fast))
            locked: List[Tuple[int, bytes]] = []
            ok = True
            for g, ws in by_group.items():
                for _op, key, _val in ws:
                    locked.append((g, key))
            for key in reads:
                locked.append((self.kvs.group_of(key), key))
            for lk in locked:
                if self._locks.get(lk, tid) != tid:
                    ok = False
                    break
                self._locks[lk] = tid
            if not ok:
                for lk in locked:
                    if self._locks.get(lk) == tid:
                        del self._locks[lk]
                txn.state = ABORTED
                txn.reason = "conflict"
                self._count_abort("conflict")
                if tr is not None and txn.trace_id is not None:
                    tr.end(txn.trace_id, status="aborted",
                           reason="conflict")
                return txn
            txn.router_version = getattr(self.kvs.router, "version", 0)
            txn.admitted = locked
            self._txns[tid] = txn
            if fast:
                if tr is not None and txn.trace_id is not None:
                    tr.phase(txn.trace_id, "merge")
                self._submit_merge(txn)
            elif self._active_2pc is None:
                self._active_2pc = tid
                self._submit_prepares(txn)
            else:
                if tr is not None and txn.trace_id is not None:
                    # queued behind the commit lane: the interval up
                    # to promotion's "prepare" phase is the blame
                    # report's txn_lock component
                    tr.phase(txn.trace_id, "lock_wait")
                self._queue.append(tid)
        return txn

    # ---------------- record submission ----------------

    def _conn(self, g: int, req: int) -> int:
        """PER-RECORD conn id: ``(client_id + req)`` pushed through the
        shared ShardedKVS group-namespacing. Client sessions dedup via
        the per-conn HIGH-WATER registry, which assumes FIFO per conn —
        the coordinator cannot promise that (records of concurrent
        transactions commit out of order across failover), so txn
        records dedup PER TID inside ``_fold_txn`` instead and never
        touch ``last_req``; the unique ``(conn, req)`` stamp remains
        the key the stamp loop (``note_appends``), spans, and the
        serializability checker's stream dedup all match records by.
        ``client_id`` (1<<20 by default) keeps the range far above real
        clients; ``req`` is unique per group so the mapping stays
        injective."""
        return self.kvs.conn_for(self.client_id + req, g)

    # holds-lock: _lock
    def _submit_record(self, txn: Txn, g: int, payload: bytes,
                      track: bool = False) -> int:
        """Submit one stamped record to ``g``'s current leader; spans
        ride the same (conn, req) key the stamp loop correlates."""
        self._req[g] += 1
        req = self._req[g]
        self._outstanding[(g, req)] = txn.tid
        if track:
            txn.record_index[(g, req)] = -1
            txn.record_payload[(g, req)] = payload
            txn.record_retry[(g, req)] = self.cluster.step_index
        lead = self.cluster.leader_hint(g)
        lead = lead if lead >= 0 else 0
        spans = active_recorder(getattr(self.cluster, "obs", None))
        if spans is not None:
            spans.begin(self._conn(g, req), req,
                        self.cluster._span_rep(g, lead),
                        phase="submit")
            txn.span_keys.add((g, req))
            tr = self._tracer()
            if tr is not None and txn.trace_id is not None:
                # child link: the record's span key joins it to the
                # txn-level trace on the merged timeline
                tr.link(txn.trace_id, self._conn(g, req), req, g)
        self.cluster.submit(g, lead, payload, conn=self._conn(g, req),
                            req_id=req)
        return req

    # holds-lock: _lock
    def _submit_prepares(self, txn: Txn) -> None:
        tr = self._tracer()
        if tr is not None and txn.trace_id is not None:
            tr.phase(txn.trace_id, "prepare")
        for g in txn.groups:
            txn.prep_appended[g] = 0
            for op, key, val in txn.writes_by_group[g]:
                req = self._submit_record(
                    txn, g, _records.encode_prepare(txn.tid, op, key,
                                                    val))
                txn.prep_reqs.setdefault(g, []).append(req)
            self._terms.reset(g)        # set at first prepare append
        if tr is not None and txn.trace_id is not None:
            tr.phase(txn.trace_id, "vote_wait")

    # holds-lock: _lock
    def _submit_merge(self, txn: Txn) -> None:
        # MERGE records (not plain commands): the fold applies them
        # immediately — still coordination-free — but dedups them per
        # tid and retires the tid's memory when the ``len(ws)``-th
        # record lands, so retried merges stay exactly-once WITHOUT
        # leaving a permanent per-record conn entry in ``last_req``
        for g in txn.groups:
            ws = txn.writes_by_group[g]
            for op, key, val in ws:
                self._submit_record(
                    txn, g,
                    _records.encode_merge(txn.tid, len(ws), op, key,
                                          val),
                    track=True)

    # holds-lock: _lock
    def _submit_decision(self, txn: Txn, commit: bool) -> None:
        mask = txn.participant_mask()
        reason = {"conflict": _records.ABORT_CONFLICT,
                  "timeout": _records.ABORT_TIMEOUT,
                  "failover": _records.ABORT_FAILOVER,
                  "topology": _records.ABORT_TOPOLOGY}.get(
                      txn.reason or "", 0)
        for g in txn.groups:
            payload = (_records.encode_commit(txn.tid, mask) if commit
                       else _records.encode_abort(txn.tid, reason))
            self._submit_record(txn, g, payload, track=True)
            self.cluster.clear_txn_watch(g)

    # ---------------- cluster hooks ----------------

    def note_appends(self, g: int, r: int, take: Sequence[tuple],
                     term: int, end_abs: int) -> None:
        """Stamp-loop hook (cluster.finish, invoked AFTER the host
        lock is released — this method takes the coordinator lock,
        which client threads hold while submitting, so calling it
        under the host lock would deadlock ABBA): the accepted prefix
        ``take`` landed at absolute indices ``[end_abs - len(take),
        end_abs)`` on ``g``'s leader ``r`` — match the coordinator's
        stamped records to learn each one's ``(term, index)`` and arm
        the group watch when the last prepare of a group is placed."""
        with self._lock:
            if not self._outstanding:
                return
            base = end_abs - len(take)
            for i, (_et, c, req, _p) in enumerate(take):
                if c != self._conn(g, req):
                    continue
                tid = self._outstanding.get((g, req))
                if tid is None:
                    continue
                txn = self._txns.get(tid)
                if txn is None:
                    continue
                index = base + i
                if (g, req) in txn.record_index:
                    # decision/merge record placed: completion is its
                    # index entering the group's commit frontier
                    # while the append term still rules
                    txn.record_index[(g, req)] = index
                    txn.record_term[(g, req)] = term
                    del self._outstanding[(g, req)]
                elif txn.state == PREPARING:
                    txn.prep_appended[g] += 1
                    self._terms.note(g, term)
                    del self._outstanding[(g, req)]
                    if (txn.prep_appended[g]
                            == len(txn.writes_by_group[g])):
                        # last prepare of g placed: watch it — votes
                        # ride the NEXT dispatch, but this dispatch's
                        # own readback may already prove the commit
                        # (observe's same-finish resolution)
                        txn.watch[g] = (index, term)
                        txn.watch_fresh[g] = True
                        self.cluster.set_txn_watch(g, index, term)

    def observe(self, cluster, res) -> None:
        """finish()-tail hook: consume the vote matrix, detect
        participant deposition, advance step-domain timeouts, and
        complete decided transactions whose records committed."""
        with self._lock:
            if not self._txns:
                return
            commit_abs = _epoch.commit_frontier(
                res, self.cluster.rebased_total)
            votes = res.get("txn_vote")
            rv = getattr(self.kvs.router, "version", 0)
            for txn in list(self._txns.values()):
                if (txn.state == PREPARING
                        and rv != txn.router_version
                        and any(self.kvs.group_of(k) != g
                                for g, k in txn.admitted)):
                    # an elastic cutover moved a participant key's
                    # group mid-flight: its staged prepares sit in a
                    # group the new routing never serves — abort
                    # deterministically (backstop; the freeze gate and
                    # the cutover's wants_serial() give-way make this
                    # rare)
                    self._abort(txn, "topology")
                if txn.state == PREPARING:
                    self._observe_preparing(txn, res, votes,
                                            commit_abs)
                if txn.state in (COMMITTING, ABORTING, MERGING):
                    self._observe_decided(txn, res, commit_abs)
                if (not txn.done and txn.state != COMMITTING
                        and cluster.step_index > txn.deadline):
                    # commit decisions are durable once made — only
                    # undecided (or merging/aborting) txns time out,
                    # and a merge past deadline keeps retrying via
                    # resubmission (its writes are already decided)
                    if txn.state in (PREPARING,):
                        self._abort(txn, "timeout")

    # holds-lock: _lock
    def _observe_preparing(self, txn: Txn, res, votes,
                           commit_abs) -> None:
        # deposition: a participant's leader advanced past the term
        # its prepares were appended under — the prepare may be
        # overwritten; abort deterministically (the vote lane's
        # CONFLICT is the committed-overwrite backstop)
        term_now = _epoch.term_now(res)
        for g in txn.prep_appended:
            if g in txn.prepared:
                # PREPARED is a quorum fact (committed under the
                # watched term) — a later term change cannot revoke
                # it, so a failover here must not abort the txn
                continue
            if self._terms.deposed(g, term_now[g]):
                self._abort(txn, "failover")
                return
        for g, (idx, wterm) in list(txn.watch.items()):
            if g in txn.prepared:
                continue
            if txn.watch_fresh.pop(g, False):
                # same-finish resolution: the prepare landed in THIS
                # dispatch under ``wterm``; if this finish's commit
                # frontier already covers it and the term is
                # unchanged, nothing can have overwritten it — the
                # common case resolves without waiting a dispatch for
                # the vote lane (⟹ cross-group commit ≈ 2 dispatches)
                if (_epoch.placement_status(idx, wterm, commit_abs[g],
                                            term_now[g])
                        == _epoch.COMPLETE):
                    txn.prepared.add(g)
                    self._close_prep_spans(txn, g)
                    self.cluster.clear_txn_watch(g)
                    continue
            if votes is None:
                continue
            row = votes[g]
            if (row == TXN_CONFLICT).any():
                self._abort(txn, "conflict")
                return
            if (row == TXN_PREPARED).any():
                txn.prepared.add(g)
                self._close_prep_spans(txn, g)
                self.cluster.clear_txn_watch(g)
        if txn.prepared == set(txn.groups):
            # serialization point: all participants hold the staged
            # writes durably — fetch the read set under the locks
            # through the LINEARIZABLE serving gate (lease/read-index
            # + apply-frontier), so captured reads cannot miss writes
            # committed by non-transactional clients. If a read key's
            # group cannot serve linearizably this step, retry next
            # observe — the step-domain deadline is the backstop.
            reads = {}
            for key in txn.read_keys:
                served, val = self._read_serialization_point(key)
                if not served:
                    return
                reads[key] = val
            txn.reads = reads
            txn.state = COMMITTING
            tr = self._tracer()
            if tr is not None and txn.trace_id is not None:
                tr.phase(txn.trace_id, "decide")
            self._submit_decision(txn, commit=True)

    # holds-lock: _lock
    def _read_serialization_point(self, key) -> Tuple[bool, Optional[bytes]]:
        """One read-set fetch at the serialization point: ``(served,
        value)``. The gate check (``serving_path``) then the bare
        table read (``serve_local``) is the ReadHub's linearization
        recipe — unlike ``kvs.get``, a ``None`` value here is
        unambiguously 'key absent', never 'gate refused'."""
        g = self.kvs.group_of(key)
        lm = getattr(self.cluster, "leases", None)
        r = lm.serving_holder(g) if lm is not None else -1
        if r < 0:
            r = self.cluster.leader_hint(g)
        if r < 0:
            return False, None
        kv = self.kvs.groups[g]
        if kv.serving_path(r) not in ("lease", "read_index"):
            return False, None
        return True, kv.serve_local(r, key)

    # retry patience before a decided record not yet appended is
    # resubmitted (shared epoch constant — topology seeding uses the
    # same patience for ITS stamped records)
    RETRY_STEPS = _epoch.RETRY_STEPS

    # holds-lock: _lock
    def _observe_decided(self, txn: Txn, res, commit_abs) -> None:
        term_now = _epoch.term_now(res)
        for (g, req), idx in list(txn.record_index.items()):
            st = _epoch.placement_status(
                idx, txn.record_term.get((g, req), 0), commit_abs[g],
                term_now[g])
            if st == _epoch.COMPLETE:
                del txn.record_index[(g, req)]
                txn.record_term.pop((g, req), None)
                txn.record_payload.pop((g, req), None)
                txn.record_retry.pop((g, req), None)
                self._close_record_spans(txn, [(g, req)], ok=True)
            elif st == _epoch.INVALIDATED:
                # forget the placement and retry under the SAME stamp:
                # if it DID commit, dedup makes the retry a no-op
                txn.record_index[(g, req)] = -1
                txn.record_retry[(g, req)] = self.cluster.step_index
            elif idx < 0:
                lead = self.cluster.leader_hint(g)
                if (lead >= 0 and self.cluster.step_index
                        > txn.record_retry[(g, req)] + self.RETRY_STEPS):
                    payload = txn.record_payload[(g, req)]
                    self._outstanding[(g, req)] = txn.tid
                    txn.record_retry[(g, req)] = self.cluster.step_index
                    self.cluster.submit(g, lead, payload,
                                        conn=self._conn(g, req),
                                        req_id=req)
        if not txn.record_index:
            self._finalize(txn)

    # ---------------- decisions ----------------

    # holds-lock: _lock
    def _abort(self, txn: Txn, reason: str) -> None:
        txn.reason = reason
        txn.state = ABORTING
        self._count_abort(reason)
        tr = self._tracer()
        if tr is not None and txn.trace_id is not None:
            tr.phase(txn.trace_id, "abort")
            tr.annotate(txn.trace_id, reason=reason)
            if reason == "topology":
                # blame the transition window: re-parent the txn trace
                # under the topology trace whose freeze made the
                # mapping move. Lock-free pointer read — taking the
                # controller's _lock here would invert drive()'s
                # topo-then-txn lock order (ABBA).
                topo = getattr(self.cluster, "topology", None)
                win = (getattr(topo, "window_trace", None)
                       or getattr(topo, "last_window_trace", None))
                if win is not None:
                    tr.set_parent(txn.trace_id, win)
        # close every span this txn still holds open — the abort
        # reason rides on the span so a mid-prepare abort never leaks
        # an open span
        self._close_record_spans(txn, list(txn.span_keys), ok=False,
                                 status="aborted:" + reason)
        # drop any still-outstanding prepare stamps
        for key, tid in list(self._outstanding.items()):
            if tid == txn.tid and key not in txn.record_index:
                del self._outstanding[key]
        for g in list(txn.watch):
            self.cluster.clear_txn_watch(g)
        txn.watch.clear()
        if txn.prep_appended:
            self._submit_decision(txn, commit=False)

    # holds-lock: _lock
    def _finalize(self, txn: Txn) -> None:
        if txn.state == COMMITTING:
            txn.state = COMMITTED
            self.committed_total += 1
            obs = getattr(self.cluster, "obs", None)
            if obs is not None:
                obs.metrics.inc("txn_committed_total")
        elif txn.state == ABORTING:
            txn.state = ABORTED
        elif txn.state == MERGING:
            # fast path: every merge command committed — convergent by
            # commutativity, atomic in the no-torn-intermediate sense
            txn.state = COMMITTED
            self.committed_total += 1
            obs = getattr(self.cluster, "obs", None)
            if obs is not None:
                obs.metrics.inc("txn_committed_total")
        # safety net: any span key still open (decision records of an
        # aborted txn, crash-interrupted prepares) closes here, then
        # the txn-level trace ends with the terminal state
        ok = txn.state == COMMITTED
        self._close_record_spans(
            txn, list(txn.span_keys), ok=ok,
            status="aborted:" + (txn.reason or "unknown"))
        tr = self._tracer()
        if tr is not None and txn.trace_id is not None:
            tr.end(txn.trace_id,
                   status=("committed" if ok else "aborted"))
        self._release(txn)

    # holds-lock: _lock
    def _count_abort(self, reason: str) -> None:
        self.aborted_total[reason] += 1
        obs = getattr(self.cluster, "obs", None)
        if obs is not None:
            obs.metrics.inc("txn_aborted_total", reason=reason)

    # holds-lock: _lock
    def _release(self, txn: Txn) -> None:
        for lk, tid in list(self._locks.items()):
            if tid == txn.tid:
                del self._locks[lk]
        self._txns.pop(txn.tid, None)
        for key, tid in list(self._outstanding.items()):
            if tid == txn.tid:
                del self._outstanding[key]
        if self._active_2pc == txn.tid:
            self._active_2pc = None
            while self._queue:
                nxt = self._txns.get(self._queue.popleft())
                if nxt is not None and not nxt.done:
                    self._active_2pc = nxt.tid
                    # the timeout budget covers the 2PC rounds, not
                    # the FIFO wait — restart it at promotion or a
                    # queued txn aborts 'timeout' the moment (or soon
                    # after) its prepares finally go out
                    nxt.deadline = (self.cluster.step_index
                                    + self.timeout_steps)
                    self._submit_prepares(nxt)
                    break

    # ---------------- driver surface ----------------

    def wants_serial(self) -> bool:
        """True while any transaction is in flight: the commit lane
        (votes, decision records) rides SERIAL dispatches only, so the
        drivers hold bursts/pipelining — the same give-way rule
        elections and repair already follow."""
        with self._lock:
            return bool(self._txns)

    def health(self) -> dict:
        with self._lock:
            return dict(
                active=len(self._txns),
                queued=len(self._queue),
                locks=len(self._locks),
                committed_total=self.committed_total,
                aborted_total=dict(self.aborted_total))


def attach_coordinator(kvs, *, client_id: int = 1 << 20,
                       timeout_steps: int = 64) -> TxnCoordinator:
    """Build a coordinator over ``kvs`` (a ShardedKVS on a txn=True
    cluster) and attach it at ``cluster.txn`` — the finish() tail and
    stamp loop start feeding it, and the drivers' give-way gates see
    it through the same attach point."""
    coord = TxnCoordinator(kvs, client_id=client_id,
                           timeout_steps=timeout_steps)
    kvs.shard.txn = coord
    return coord
