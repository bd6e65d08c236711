"""Shard nemesis — fault isolation across consensus groups, proven
(the port of the JAX package's ``shard/chaos.py``, on the port's
engine: ``device=None`` means the card, tests pass ``device="cpu"``;
with the same seed and options it gives the JAX runner's verdict,
history and ledger).

The single-group :class:`~rdma_paxos_tpu_torch.chaos.runner.NemesisRunner`
answers "does one group survive faults?"; the sharded layer must also
answer "does a fault in one group stay IN that group?". This runner
drives a :class:`~rdma_paxos_tpu_torch.shard.cluster.ShardedCluster` +
:class:`~rdma_paxos_tpu_torch.shard.kvs.ShardedKVS` workload, crashes the
leader of ONE target group mid-run (fail-stop via the chaos
subsystem's :class:`~rdma_paxos_tpu_torch.chaos.faults.LinkModel`, attached
to that group only), re-elects after a timeout, and verdicts:

* the existing **I1–I5 protocol invariants hold PER GROUP** — one
  :class:`~rdma_paxos_tpu_torch.chaos.invariants.InvariantChecker` per
  group over that group's ``[R]`` result slices, convergence checked
  over that group's replay streams;
* the untouched groups' **commit frontiers keep strictly advancing
  through the victim group's outage** (fault isolation — the whole
  point of per-group fault domains);
* the victim group **recovers** (new leader, frontier advances again)
  without any other group noticing.

Determinism: all randomness derives from the run seed; time is the
logical step counter — same seed, same verdict (the chaos
subsystem's reproducibility contract).
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
from rdma_paxos_tpu_torch.config import LogConfig
from rdma_paxos_tpu_torch.shard.cluster import ShardedCluster
from rdma_paxos_tpu_torch.shard.kvs import ShardedKVS


def keys_for_groups(router, per_group: int,
                    prefix: bytes = b"key") -> List[List[bytes]]:
    """Deterministically enumerate ``prefix%d`` keys until every group
    owns ``per_group`` of them — the seeded workload's routing table."""
    out: List[List[bytes]] = [[] for _ in range(router.n_groups)]
    i = 0
    while any(len(ks) < per_group for ks in out):
        key = prefix + b"%d" % i
        g = router.group_of(key)
        if len(out[g]) < per_group:
            out[g].append(key)
        i += 1
        if i > 100000:
            raise RuntimeError("router starved a group of keys")
    return out


class ShardNemesisRunner:
    """One seeded leader-crash run over a fresh sharded cluster."""

    def __init__(self, cfg: Optional[LogConfig] = None,
                 n_replicas: int = 3, n_groups: int = 4, *,
                 seed: int = 0, steps: int = 60, crash_step: int = 20,
                 reelect_after: int = 4, target_group: int = 0,
                 settle_steps: int = 12, keys_per_group: int = 2,
                 obs=None, audit: bool = True, leases: bool = True,
                 read_patience: int = 12, device=None):
        self.cfg = cfg or DEFAULT_KV_CFG
        self.R, self.G = int(n_replicas), int(n_groups)
        self.seed = int(seed)
        self.steps = int(steps)
        self.crash_step = int(crash_step)
        self.reelect_after = int(reelect_after)
        self.target = int(target_group)
        self.settle_steps = int(settle_steps)
        # audit at 100% by default: a passing shard nemesis also proves
        # bit-identical per-group replicated state through the outage
        self.shard = ShardedCluster(self.cfg, self.R, self.G,
                                    audit=audit, device=device)
        if obs is None:
            # runner-owned facade: the read-path accounting
            # (reads_served_total{path=}) and lease timeline need a
            # registry/trace ring to land in
            from rdma_paxos_tpu_torch.obs import Observability
            obs = Observability()
        self.obs = obs
        self.shard.obs = obs
        self.kv = ShardedKVS(self.shard, cap=256)
        # the fault domain is ONE group: the link model is attached to
        # the target group only — other groups' masks are never touched
        self.link = LinkModel(self.R, seed=seed)
        self.shard.link_models[self.target] = self.link
        self.checkers = [InvariantChecker(self.R)
                         for _ in range(self.G)]
        self.keys = keys_for_groups(self.kv.router, keys_per_group)
        self.rng = random.Random(f"shard-nemesis:{seed}")
        self._vn = 0
        # client-visible contract checking: every session write and
        # every linearizable read (lease AND read-index paths,
        # runtime/reads.py) is recorded into ONE history the per-key
        # Wing–Gong checker verdicts — the sharded analog of the
        # single-group NemesisRunner's acceptance bar
        self.history = HistoryRecorder()
        for g in range(self.G):
            self.kv.groups[g].history = self.history
        if leases:
            from rdma_paxos_tpu_torch.runtime import reads as reads_mod
            reads_mod.attach(self.shard)
        self.read_patience = int(read_patience)
        self.rng_reads = random.Random(f"shard-reads:{seed}")
        self.sess = self.kv.session(1)
        # per-group outstanding session write (the one-outstanding
        # protocol contract, per group): {key,val,req_id,op_id,to,
        # issued}
        self._out: List[Optional[dict]] = [None] * self.G
        self.write_patience = 14

    # ------------------------------------------------------------------

    def _frontiers(self) -> List[int]:
        """Per-group ABSOLUTE max commit frontier (rebase-corrected)."""
        res = self.shard.last
        return [int(res["commit"][g].max())
                + int(self.shard.rebased_total[g])
                for g in range(self.G)]

    def _issue(self, t: int, down) -> None:
        """Closed-loop SESSION write per group (one outstanding, the
        protocol contract; retransmit-on-failover, patience→ambiguous)
        plus the read-scaling mix — every operation lands in the
        checked history. Crashed-leader submissions land on an
        isolated claimant and stall — exactly the client experience
        of an outage."""
        for g in range(self.G):
            lead = self.shard.leader_hint(g)
            out = self._out[g]
            if out is not None:
                if t - out["issued"] > self.write_patience:
                    self.history.timeout(out["op_id"])   # fate unknown
                    self._out[g] = None
                elif lead >= 0 and lead != out["to"]:
                    # failover: retransmit the SAME req_id to the new
                    # leader (the dedup registry applies it once)
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
        self._issue_reads(t, down)

    def _issue_reads(self, t: int, down) -> None:
        """Per-group lease reads at the group's serving holder and
        read-index reads queued at a random live replica — the fan-out
        ``place_leaders`` + per-group leases buy, checked
        linearizable."""
        hub = getattr(self.shard, "reads", None)
        if hub is None:
            return
        rr = self.rng_reads
        lm = self.shard.leases
        for g in range(self.G):
            if rr.random() < 0.5:
                target = lm.serving_holder(g) if lm is not None else -1
                if target < 0:
                    target = self.shard.leader_hint(g)
                if target >= 0 and target not in down:
                    self.kv.groups[g].get(target,
                                          rr.choice(self.keys[g]),
                                          linearizable=True)
            if rr.random() < 0.5:
                live = [r for r in range(self.R) if r not in down]
                if live:
                    f = rr.choice(live)
                    key = rr.choice(self.keys[g])
                    op_id = self.history.invoke("get", key, replica=f)

                    def done(status, value, _op=op_id):
                        if status == "ok":
                            self.history.ok(_op, value)
                        else:
                            self.history.fail(_op,
                                              reason="read_unserved")

                    hub.submit(
                        lambda g=g, f=f, k=key:
                        self.kv.groups[g].serve_local(f, k),
                        replica=f, group=g,
                        patience=self.read_patience, step0=t,
                        on_done=done)

    def _observe_clients(self, t: int) -> None:
        """Post-step completion sweep: a group's outstanding session
        write is acked once the leader's fold marks its req_id
        committed (the client-visible observation point)."""
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

    def run(self) -> Dict:
        violations: List[dict] = []
        self.shard.place_leaders()
        crashed = -1
        down: set = set()
        timeouts: Dict[int, list] = {}
        f_at_crash: List[int] = []
        f_at_heal: List[int] = []
        for t in range(self.steps):
            self.history.set_clock(t)
            timeouts = {}
            if t == self.crash_step:
                crashed = self.shard.leader_hint(self.target)
                self.link.down.add(crashed)        # fail-stop, silent
                down = {crashed}
                f_at_crash = self._frontiers()
            if crashed >= 0 and t == self.crash_step + self.reelect_after:
                # a surviving member's election timer fires
                cand = next(r for r in range(self.R)
                            if r != crashed)
                timeouts[self.target] = [cand]
            self._issue(t, down)
            res = self.shard.step(timeouts=timeouts)
            self._observe_clients(t)
            self._check(res, t, violations)
        f_at_heal = self._frontiers()
        # settle: the crashed replica rejoins (state intact — a long
        # isolation, the fail-stop model crash_replica uses) and every
        # group converges
        self.link.down.discard(crashed)
        self.link.heal()
        down = set()
        for t in range(self.steps, self.steps + self.settle_steps):
            self.history.set_clock(t)
            self._issue(t, down)
            res = self.shard.step()
            self._observe_clients(t)
            self._check(res, t, violations)
        f_end = self._frontiers()
        # run end: fail still-queued reads, ambiguate unresolved writes
        self.history.set_clock(self.steps + self.settle_steps)
        if self.shard.reads is not None:
            self.shard.reads.fail_all("run end")
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
        others = [g for g in range(self.G) if g != self.target]
        others_advanced = all(f_at_heal[g] > f_at_crash[g]
                              for g in others)
        target_recovered = (f_end[self.target]
                            > f_at_crash[self.target])
        new_leader = self.shard.leader_hint(self.target)
        audit_summary = (self.shard.auditor.summary()
                         if self.shard.auditor is not None else None)
        audit_ok = (audit_summary is None
                    or audit_summary["findings"] == 0)
        linz = check_history(self.history.ops())
        ok = (not violations and others_advanced and target_recovered
              and new_leader >= 0 and new_leader != crashed
              and audit_ok and linz["ok"] is True)
        verdict = dict(
            ok=ok, seed=self.seed, steps=self.steps,
            target_group=self.target, crashed_leader=crashed,
            new_leader=new_leader,
            invariant_violations=violations,
            audit=audit_summary,
            linearizability=dict(ok=linz["ok"],
                                 violations=linz["violations"],
                                 undecided=linz["undecided"],
                                 ops=linz["ops"]),
            frontiers=dict(at_crash=f_at_crash, at_heal=f_at_heal,
                           at_end=f_end),
            others_advanced=others_advanced,
            target_recovered=target_recovered,
        )
        if self.shard.reads is not None:
            from rdma_paxos_tpu_torch.runtime.reads import read_counts
            verdict["reads"] = dict(
                read_counts(self.shard.obs),
                hub=self.shard.reads.status(),
                leases=self.shard.leases.status())
        return verdict
