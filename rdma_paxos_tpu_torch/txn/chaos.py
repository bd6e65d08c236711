"""Txn nemesis — coordinator-leader crash mid-prepare, proven atomic
(the port of the JAX package's ``txn/chaos.py``, on the port's engine:
``device=None`` means the card, tests pass ``device="cpu"``; with the
same seed and options it gives the JAX runner's verdict and history).

The shard nemesis (:mod:`rdma_paxos_tpu_torch.shard.chaos`) proves
faults stay inside their group; the txn nemesis proves the cross-group
claims survive the same fault. It drives a ``txn=True``
:class:`~rdma_paxos_tpu_torch.shard.cluster.ShardedCluster` with a mixed
workload — single-key session puts (per-key Wing–Gong history),
2PC cross-group transactions on fresh key pairs, mergeable INCR
transactions on per-group counters — then fail-stops the leader of the
target group EXACTLY while a 2PC transaction's PREPAREs are in flight
to it, re-elects, heals, settles, and verdicts:

* **strict serializability** over the per-group committed streams
  (:func:`~rdma_paxos_tpu_torch.chaos.serialize.check_txn_streams`):
  commit atomicity against the participant masks, no commit+abort
  tids, acyclic cross-group precedence;
* **no partial writes**: every aborted transaction's (key, unique
  value) pairs are invisible everywhere; every committed one's are
  visible (fresh keys per txn — nothing overwrites them);
* **mergeable convergence**: each group's counter lands between the
  committed and attempted INCR sums (undecided tail may or may not
  have folded — exactly the retransmit-until-committed contract);
* the existing bars stay green: per-group I1–I5 invariants +
  convergence, and the single-key Wing–Gong history;
* the crash-straddling transaction **aborts deterministically**
  (failover or step-domain timeout — never a partial commit).

Determinism: all randomness derives from the seed; time is the
logical step counter — same seed, same verdict.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from rdma_paxos_tpu_torch.chaos.faults import LinkModel
from rdma_paxos_tpu_torch.chaos.history import HistoryRecorder
from rdma_paxos_tpu_torch.chaos.invariants import (
    InvariantChecker, InvariantViolation)
from rdma_paxos_tpu_torch.chaos.linearize import check_history
from rdma_paxos_tpu_torch.chaos.runner import DEFAULT_KV_CFG
from rdma_paxos_tpu_torch.chaos.serialize import check_txn_streams
from rdma_paxos_tpu_torch.config import LogConfig
from rdma_paxos_tpu_torch.models.kvs import OP_INCR
from rdma_paxos_tpu_torch.shard.chaos import keys_for_groups
from rdma_paxos_tpu_torch.shard.cluster import ShardedCluster
from rdma_paxos_tpu_torch.shard.kvs import ShardedKVS
from rdma_paxos_tpu_torch.txn.coordinator import attach_coordinator
from rdma_paxos_tpu_torch.txn.merge import decode_merge_val


class TxnNemesisRunner:
    """One seeded coordinator-leader-crash run over a fresh txn=True
    sharded cluster."""

    def __init__(self, cfg: Optional[LogConfig] = None,
                 n_replicas: int = 3, n_groups: int = 3, *,
                 seed: int = 0, steps: int = 48, crash_step: int = 16,
                 reelect_after: int = 4, target_group: int = 0,
                 settle_steps: int = 20, txn_every: int = 4,
                 timeout_steps: int = 12, obs=None, device=None):
        self.cfg = cfg or DEFAULT_KV_CFG
        self.R, self.G = int(n_replicas), int(n_groups)
        self.seed = int(seed)
        self.steps = int(steps)
        self.crash_step = int(crash_step)
        self.reelect_after = int(reelect_after)
        self.target = int(target_group)
        self.settle_steps = int(settle_steps)
        self.txn_every = int(txn_every)
        self.shard = ShardedCluster(self.cfg, self.R, self.G, txn=True,
                                    device=device)
        if obs is None:
            from rdma_paxos_tpu_torch.obs import Observability
            obs = Observability()
        self.obs = obs
        self.shard.obs = obs
        self.kv = ShardedKVS(self.shard, cap=256)
        self.coord = attach_coordinator(self.kv,
                                        timeout_steps=timeout_steps)
        self.link = LinkModel(self.R, seed=seed)
        self.shard.link_models[self.target] = self.link
        self.checkers = [InvariantChecker(self.R)
                         for _ in range(self.G)]
        # key pools: session keys (reused, Wing–Gong checked), fresh
        # 2PC keys (one per txn per group — visibility is unambiguous),
        # one counter key per group (mergeable INCR target)
        n_txn = self.steps // max(1, self.txn_every) + 2
        self.keys = keys_for_groups(self.kv.router, 2)
        self.txn_keys = keys_for_groups(self.kv.router, n_txn,
                                        prefix=b"txk")
        self.ctr_keys = [ks[0] for ks in
                         keys_for_groups(self.kv.router, 1,
                                         prefix=b"ctr")]
        self._txn_used = [0] * self.G
        self.rng = random.Random(f"txn-nemesis:{seed}")
        self._vn = 0
        self.history = HistoryRecorder()
        for g in range(self.G):
            self.kv.groups[g].history = self.history
        self.sess = self.kv.session(1)
        self._out: List[Optional[dict]] = [None] * self.G
        self.write_patience = 14
        # launched transactions: (handle, kind, {key: val}|{g: incr})
        self.launched: List[dict] = []
        self._merge_attempt = [0] * self.G

    # ------------------------------------------------------------------

    def _fresh_pair(self, ga: int, gb: int):
        ka = self.txn_keys[ga][self._txn_used[ga]]
        kb = self.txn_keys[gb][self._txn_used[gb]]
        self._txn_used[ga] += 1
        self._txn_used[gb] += 1
        return ka, kb

    def _launch_txn(self, t: int, idx: int) -> None:
        """Alternate 2PC put-pairs and mergeable INCR pairs across a
        rotating pair of groups — every launch is recorded with its
        expected effect for the post-run visibility audit."""
        ga, gb = idx % self.G, (idx + 1) % self.G
        if ga == gb:
            gb = (gb + 1) % self.G
        if idx % 2 == 0:
            ka, kb = self._fresh_pair(ga, gb)
            va, vb = b"T%d.a" % idx, b"T%d.b" % idx
            h = self.kv.transact([("put", ka, va), ("put", kb, vb)])
            self.launched.append(dict(handle=h, kind="2pc",
                                      writes={ka: va, kb: vb},
                                      launched_at=t))
        else:
            h = self.kv.transact([("incr", self.ctr_keys[ga], 1),
                                  ("incr", self.ctr_keys[gb], 1)])
            self._merge_attempt[ga] += 1
            self._merge_attempt[gb] += 1
            self.launched.append(dict(handle=h, kind="merge",
                                      groups=(ga, gb), launched_at=t))

    def _crash_straddler(self, t: int) -> None:
        """THE scenario: a 2PC transaction with the target group as a
        participant, admitted the same step its leader fail-stops —
        its PREPARE is in flight to a replica that never answers."""
        gb = (self.target + 1) % self.G
        ka, kb = self._fresh_pair(self.target, gb)
        h = self.kv.transact([("put", ka, b"straddle.a"),
                              ("put", kb, b"straddle.b")])
        self.launched.append(dict(handle=h, kind="straddler",
                                  writes={ka: b"straddle.a",
                                          kb: b"straddle.b"},
                                  launched_at=t))

    def _issue(self, t: int) -> None:
        """Closed-loop session write per group (the shard nemesis'
        client contract: one outstanding, retransmit-on-failover,
        patience→ambiguous)."""
        for g in range(self.G):
            lead = self.shard.leader_hint(g)
            out = self._out[g]
            if out is not None:
                if t - out["issued"] > self.write_patience:
                    self.history.timeout(out["op_id"])   # fate unknown
                    self._out[g] = None
                elif lead >= 0 and lead != out["to"]:
                    out["to"] = lead
                    self.sess.retransmit_put(out["key"], out["val"],
                                             out["req_id"],
                                             leader=lead)
                out = self._out[g]
            if out is None and lead >= 0:
                key = self.rng.choice(self.keys[g])
                self._vn += 1
                val = b"v%d" % self._vn
                _, rid = self.sess.put(key, val, leader=lead)
                op_id = self.history.op_id_for(
                    self.sess.conn_for(g), rid)
                self._out[g] = dict(key=key, val=val, req_id=rid,
                                    op_id=op_id, to=lead, issued=t)

    def _observe_clients(self, t: int) -> None:
        for g in range(self.G):
            out = self._out[g]
            if out is None:
                continue
            lead = self.shard.leader_hint(g)
            if lead < 0:
                continue
            self.kv.groups[g]._fold(lead)
            marks = self.kv.groups[g].last_req[lead]
            if marks.get(self.sess.conn_for(g), 0) >= out["req_id"]:
                self.history.ok(out["op_id"])
                self._out[g] = None

    def _check(self, res, t: int, violations: List[dict]) -> None:
        for g in range(self.G):
            try:
                self.checkers[g].check_step(
                    {k: res[k][g] for k in ("commit", "role", "term",
                                            "head", "apply", "end")},
                    step=t,
                    rebased_total=int(self.shard.rebased_total[g]))
            except InvariantViolation as v:
                d = v.as_dict()
                d["group"] = g
                violations.append(d)

    def _audit_effects(self) -> List[dict]:
        """Post-settle visibility audit: committed 2PC writes visible,
        aborted/undecided ones invisible — on FRESH keys, so there is
        no overwrite ambiguity (no partial writes, directly)."""
        bad: List[dict] = []
        for rec in self.launched:
            if rec["kind"] == "merge":
                continue
            h = rec["handle"]
            for key, val in rec["writes"].items():
                got = self.kv.get(key)
                if h.committed and got != val:
                    bad.append(dict(kind="committed_write_missing",
                                    tid=h.tid, key=key.decode()))
                if not h.committed and got == val:
                    bad.append(dict(kind="partial_write_visible",
                                    tid=h.tid, key=key.decode(),
                                    state=h.state))
        return bad

    def _merge_summary(self) -> Dict:
        """Per-group counter value vs the committed / attempted INCR
        sums — the mergeable fast path's convergence window."""
        committed = [0] * self.G
        for rec in self.launched:
            if rec["kind"] == "merge" and rec["handle"].committed:
                for g in rec["groups"]:
                    committed[g] += 1
        values, ok = [], True
        for g in range(self.G):
            raw = self.kv.get(self.ctr_keys[g])
            v = decode_merge_val(OP_INCR, raw) if raw else 0
            values.append(v)
            if not (committed[g] <= v <= self._merge_attempt[g]):
                ok = False
        return dict(ok=ok, values=values, committed=committed,
                    attempted=list(self._merge_attempt))

    def run(self) -> Dict:
        violations: List[dict] = []
        self.shard.place_leaders()
        crashed = -1
        timeouts: Dict[int, list] = {}
        for t in range(self.steps):
            self.history.set_clock(t)
            timeouts = {}
            if t == self.crash_step:
                self._crash_straddler(t)
                crashed = self.shard.leader_hint(self.target)
                self.link.down.add(crashed)     # fail-stop, silent
            elif (t % self.txn_every == 0
                    and t < self.steps - self.txn_every):
                self._launch_txn(t, t // self.txn_every)
            if crashed >= 0 and t == self.crash_step + self.reelect_after:
                cand = next(r for r in range(self.R) if r != crashed)
                timeouts[self.target] = [cand]
            self._issue(t)
            res = self.shard.step(timeouts=timeouts)
            self._observe_clients(t)
            self._check(res, t, violations)
        self.link.down.discard(crashed)
        self.link.heal()
        for t in range(self.steps, self.steps + self.settle_steps):
            self.history.set_clock(t)
            self._issue(t)
            res = self.shard.step()
            self._observe_clients(t)
            self._check(res, t, violations)
        self.history.set_clock(self.steps + self.settle_steps)
        for op_id in self.history.pending():
            self.history.timeout(op_id)
        for g in range(self.G):
            try:
                self.checkers[g].check_convergence(
                    self.shard.replayed[g])
            except InvariantViolation as v:
                d = v.as_dict()
                d["group"] = g
                violations.append(d)
        # strict serializability straight off the committed evidence:
        # per group, the longest replica stream (committed prefixes of
        # a converged group agree — length only differs by lag)
        streams = [max(self.shard.replayed[g], key=len)
                   for g in range(self.G)]
        ser = check_txn_streams(streams)
        effects = self._audit_effects()
        merge = self._merge_summary()
        linz = check_history(self.history.ops())
        straddler = next(r["handle"] for r in self.launched
                         if r["kind"] == "straddler")
        txns = dict(
            launched=len(self.launched),
            committed=sum(r["handle"].committed
                          for r in self.launched),
            aborted=sum(r["handle"].done
                        and not r["handle"].committed
                        for r in self.launched),
            undecided=sum(not r["handle"].done
                          for r in self.launched),
            abort_reasons=sorted({r["handle"].abort_reason
                                  for r in self.launched
                                  if r["handle"].done
                                  and not r["handle"].committed
                                  and r["handle"].abort_reason}),
            straddler=dict(state=straddler.state,
                           reason=straddler.abort_reason))
        new_leader = self.shard.leader_hint(self.target)
        ok = (not violations and ser["ok"] and not effects
              and merge["ok"] and linz["ok"] is True
              and txns["undecided"] == 0
              and straddler.done and not straddler.committed
              and new_leader >= 0 and new_leader != crashed)
        return dict(
            ok=ok, seed=self.seed, steps=self.steps,
            target_group=self.target, crashed_leader=crashed,
            new_leader=new_leader,
            invariant_violations=violations,
            serializability=ser,
            effect_violations=effects,
            merge=merge,
            linearizability=dict(ok=linz["ok"],
                                 violations=linz["violations"],
                                 undecided=linz["undecided"],
                                 ops=linz["ops"]),
            txns=txns,
            coordinator=self.coord.health(),
        )


def run_txn_chaos(seed: int = 0, **kw) -> Dict:
    """One seeded txn-nemesis run; same seed, same verdict."""
    return TxnNemesisRunner(seed=seed, **kw).run()
