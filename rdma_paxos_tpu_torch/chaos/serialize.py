"""Cross-group strict-serializability checker for the txn subsystem.

The port's copy of the JAX package's ``chaos/serialize.py`` (standard library
and numpy only).

The per-key Wing–Gong checker (:mod:`chaos.linearize`) verdicts
single-key client histories; cross-group transactions add claims it
cannot see: a transaction's writes land in SEVERAL groups' logs and
must be atomic (all groups or none) and serializable (some total order
consistent with every group's commit order). This checker reads the
claims straight from the replicated evidence — the per-group committed
replay streams, where 2PC records (``txn/records.py``) are ordinary
log entries:

* **decision uniqueness** — no tid carries both COMMIT and ABORT
  records anywhere, and at most one decision per (group, tid) after
  the session dedup rule;
* **atomicity** — a COMMIT record's participant bitmask names the
  groups that must ALL carry a COMMIT for that tid; an aborted (or
  undecided) tid must have NO commit anywhere, so staged writes can
  never partially apply (the fold only applies at its group's COMMIT);
* **staging discipline** — a group's COMMIT for tid is preceded in
  that group's log by at least one PREPARE of tid (something was
  actually staged to apply);
* **serializability** — the precedence relation "A's commit precedes
  B's commit in some group's log" over committed tids must be ACYCLIC:
  a cycle means two groups applied overlapping transactions in
  opposite orders and no serial schedule explains both. Acyclicity
  yields the witness total order (a topological sort). Strictness
  (real-time order) follows because edges come from positions in the
  committed logs themselves.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Sequence, Tuple

from rdma_paxos_tpu_torch.consensus.log import EntryType
from rdma_paxos_tpu_torch.txn.records import (
    TXN_ABORT, TXN_CMD_W, TXN_COMMIT, TXN_PREPARE, decode_record)


def extract_txn_events(stream) -> List[Tuple[int, int, int, int]]:
    """Ordered ``(pos, txn_op, tid, arg)`` events of one replica's
    replay stream, (conn, req)-deduplicated exactly like the
    state-machine fold (a coordinator retransmit appears once)."""
    events = []
    seen_req: Dict[int, int] = {}
    pos = 0
    for etype, conn, req, payload in stream:
        pos += 1
        if etype != int(EntryType.SEND):
            continue
        if len(payload) != TXN_CMD_W * 4:
            continue
        if req > 0 and conn > 0:
            if req <= seen_req.get(conn, 0):
                continue
            seen_req[conn] = req
        txn_op, tid, arg, _cmd = decode_record(payload)
        events.append((pos, txn_op, tid, arg))
    return events


def check_txn_streams(streams: Sequence) -> Dict:
    """Verdict the strict-serializability claims over per-group
    committed streams (``streams[g]`` = one replica's replay stream of
    group ``g`` — any replica works, committed prefixes agree).
    Returns ``{ok, violations, committed, aborted, order}`` where
    ``order`` is the witness serial order of committed tids."""
    G = len(streams)
    violations: List[dict] = []
    per_group = [extract_txn_events(s) for s in streams]
    commits: Dict[int, Dict[int, int]] = collections.defaultdict(dict)
    prepares: Dict[int, Dict[int, int]] = collections.defaultdict(dict)
    masks: Dict[int, int] = {}
    aborted: set = set()
    for g, events in enumerate(per_group):
        for pos, txn_op, tid, arg in events:
            if txn_op == TXN_PREPARE:
                prepares[tid].setdefault(g, pos)
            elif txn_op == TXN_COMMIT:
                if g in commits[tid]:
                    violations.append(dict(
                        kind="duplicate_commit", tid=tid, group=g))
                commits[tid][g] = pos
                masks.setdefault(tid, arg)
                if arg != masks[tid]:
                    violations.append(dict(
                        kind="mask_mismatch", tid=tid, group=g))
            elif txn_op == TXN_ABORT:
                aborted.add(tid)
    for tid in sorted(commits):
        if tid in aborted:
            violations.append(dict(kind="commit_and_abort", tid=tid))
        mask = masks.get(tid, 0)
        members = {g for g in range(G) if mask & (1 << g)}
        missing = members - set(commits[tid])
        if missing:
            violations.append(dict(
                kind="partial_commit", tid=tid,
                missing_groups=sorted(missing)))
        extra = set(commits[tid]) - members
        if extra:
            violations.append(dict(
                kind="commit_outside_mask", tid=tid,
                groups=sorted(extra)))
        for g, cpos in commits[tid].items():
            ppos = prepares.get(tid, {}).get(g)
            if ppos is None or ppos >= cpos:
                violations.append(dict(
                    kind="commit_without_prepare", tid=tid, group=g))
    # precedence graph over committed tids: edge a -> b when a's
    # commit precedes b's in some group's log
    committed = sorted(commits)
    edges: Dict[int, set] = {t: set() for t in committed}
    for g, events in enumerate(per_group):
        seq = [tid for _pos, op, tid, _a in events
               if op == TXN_COMMIT and tid in edges]
        for i, a in enumerate(seq):
            for b in seq[i + 1:]:
                if a != b:
                    edges[a].add(b)
    # Kahn's algorithm: a completed topological sort IS the witness
    # serial order; leftovers form the cycle
    indeg = {t: 0 for t in committed}
    for a, outs in edges.items():
        for b in outs:
            indeg[b] += 1
    ready = sorted(t for t, d in indeg.items() if d == 0)
    order: List[int] = []
    while ready:
        t = ready.pop(0)
        order.append(t)
        for b in sorted(edges[t]):
            indeg[b] -= 1
            if indeg[b] == 0:
                ready.append(b)
        ready.sort()
    if len(order) != len(committed):
        violations.append(dict(
            kind="serialization_cycle",
            tids=sorted(set(committed) - set(order))))
    return dict(ok=not violations, violations=violations,
                committed=committed, aborted=sorted(aborted),
                order=order)
