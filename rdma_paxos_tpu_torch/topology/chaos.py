"""Topology nemesis — a split mid-leader-crash plus a merge, proven
linearizable.

The port's copy of the JAX package's ``topology/chaos.py``, over the
port's engine (``device=None`` means the card; tests pass
``device="cpu"``). The same seed gives the JAX runner's verdict.

The shard nemesis proves faults stay inside their group; the txn
nemesis proves cross-group atomicity survives them. This runner
proves the NEW claim: an elastic transition window that a fault lands
in the middle of never costs a linearizability violation — the window
either completes (seed records epoch-retried under the new term) or
abandons (nothing served ever moved), and either verdict is
deterministic per seed.

One seeded run over a governed sharded cluster with leases attached:

* closed-loop session writes per group (per-key Wing–Gong history),
  the target group's range carrying the hot keys;
* a **split** of the hot group's upper key half is proposed
  mid-workload, and the hot group's LEADER is fail-stopped while the
  window is open (seed records in flight) — re-elected a few steps
  later, the window finishes under the new term;
* after settling, a **merge** returns the range to its ring owners;
* the verdict demands: zero per-group invariant violations, a clean
  Wing–Gong history, both transitions completed (or a deterministic
  abandon — asserted exactly), and the lease fence PROVEN from the
  trace ring: every affected group has LEASE_REVOKED
  (reason=topology_cutover) sequenced BEFORE its TOPOLOGY_CUTOVER
  event and LEASE_GRANTED after it.

Single-threaded embedding contract: the runner both steps the
cluster and issues writes, so it must never call a blocking put on a
frozen range — it consults ``TopologyController.would_block`` and
defers the write instead (the gate exists for multi-threaded
drivers). A retransmit whose key's group moved at cutover is retired
as ambiguous (fate unknown) and a FRESH write issued — the dedup
stream is per-(conn, group), so a verbatim resend into a different
group would be a new op wearing an old op's id.

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
from rdma_paxos_tpu_torch.config import LogConfig
from rdma_paxos_tpu_torch.obs import trace as obs_trace
from rdma_paxos_tpu_torch.runtime import reads as _reads
from rdma_paxos_tpu_torch.runtime.governor import attach_governor
from rdma_paxos_tpu_torch.shard.chaos import keys_for_groups
from rdma_paxos_tpu_torch.shard.cluster import ShardedCluster
from rdma_paxos_tpu_torch.shard.kvs import ShardedKVS
from rdma_paxos_tpu_torch.shard.router import RangeRule
from rdma_paxos_tpu_torch.topology import attach_topology


class TopologyNemesisRunner:
    """One seeded split-mid-crash + merge run over a fresh governed
    sharded cluster."""

    def __init__(self, cfg: Optional[LogConfig] = None,
                 n_replicas: int = 3, n_groups: int = 3, *,
                 seed: int = 0, steps: int = 120, split_step: int = 24,
                 crash_step: int = 25, reelect_after: int = 4,
                 merge_step: int = 72, target_group: int = 0,
                 settle_steps: int = 24, governor: bool = True,
                 obs=None, device=None):
        self.cfg = cfg or DEFAULT_KV_CFG
        self.R, self.G = int(n_replicas), int(n_groups)
        self.seed = int(seed)
        self.steps = int(steps)
        self.split_step = int(split_step)
        self.crash_step = int(crash_step)
        self.reelect_after = int(reelect_after)
        self.merge_step = int(merge_step)
        self.target = int(target_group)
        self.settle_steps = int(settle_steps)
        self.shard = ShardedCluster(self.cfg, self.R, self.G,
                                    device=device)
        if obs is None:
            from rdma_paxos_tpu_torch.obs import Observability
            obs = Observability()
        self.obs = obs
        self.shard.obs = obs
        self.kv = ShardedKVS(self.shard, cap=256)
        _reads.attach(self.shard)
        self.ctl = attach_topology(self.kv, obs=obs,
                                   cooldown_steps=8)
        self.governor = (attach_governor(self.shard, obs=obs)
                         if governor else None)
        self.link = LinkModel(self.R, seed=seed)
        self.shard.link_models[self.target] = self.link
        self.checkers = [InvariantChecker(self.R)
                         for _ in range(self.G)]
        # hot keys: a larger pool in the target group (its upper half
        # is what the split carves out)
        self.keys = keys_for_groups(self.kv.router, 4)
        self.keys[self.target] = keys_for_groups(
            self.kv.router, 8, prefix=b"hot")[self.target]
        self.rng = random.Random(f"topology-nemesis:{seed}")
        self._vn = 0
        self.history = HistoryRecorder()
        for g in range(self.G):
            self.kv.groups[g].history = self.history
        self.sess = self.kv.session(1)
        self._out: List[Optional[dict]] = [None] * self.G
        self.write_patience = 14
        self._rule = None       # the installed split rule (for merge)

    # ------------------------------------------------------------------

    def _split_range(self):
        """Deterministic hot range: the upper half of the target
        group's (sorted) key pool, carved into the next group."""
        hks = sorted(self.keys[self.target])
        lo = hks[len(hks) // 2]
        hi = hks[-1] + b"\x00"
        dst = (self.target + 1) % self.G
        return lo, hi, dst

    def _issue(self, t: int) -> None:
        """Closed-loop session write per ORIGINAL group slot (one
        outstanding each): retransmit on failover, patience →
        ambiguous, frozen-range writes deferred, moved-group
        retransmits retired as ambiguous + reissued fresh."""
        for g in range(self.G):
            out = self._out[g]
            if out is not None:
                cur_g = self.kv.group_of(out["key"])
                if t - out["issued"] > self.write_patience:
                    self.history.timeout(out["op_id"])   # fate unknown
                    self._out[g] = None
                elif cur_g != out["group"]:
                    # the key's group moved at cutover while this op
                    # was in flight: its donor-log fate rode the
                    # seeded transfer — ambiguous, never resent
                    # verbatim into the new group's dedup stream
                    self.history.timeout(out["op_id"])
                    self._out[g] = None
                else:
                    lead = self.shard.leader_hint(cur_g)
                    if lead >= 0 and lead != out["to"]:
                        out["to"] = lead
                        self.sess.retransmit_put(
                            out["key"], out["val"], out["req_id"],
                            leader=lead)
            if self._out[g] is None:
                key = self.rng.choice(self.keys[g])
                if self.ctl.would_block(key):
                    continue        # frozen range — defer, don't wedge
                kg = self.kv.group_of(key)
                lead = self.shard.leader_hint(kg)
                if lead < 0:
                    continue
                self._vn += 1
                val = b"v%d" % self._vn
                _, rid = self.sess.put(key, val, leader=lead)
                op_id = self.history.op_id_for(
                    self.sess.conn_for(kg), rid)
                self._out[g] = dict(key=key, val=val, req_id=rid,
                                    op_id=op_id, to=lead, issued=t,
                                    group=kg)

    def _observe_clients(self, t: int) -> None:
        for g in range(self.G):
            out = self._out[g]
            if out is None:
                continue
            gg = out["group"]       # the log it was submitted into
            lead = self.shard.leader_hint(gg)
            if lead < 0:
                continue
            self.kv.groups[gg]._fold(lead)
            marks = self.kv.groups[gg].last_req[lead]
            if marks.get(self.sess.conn_for(gg), 0) >= out["req_id"]:
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

    def _lease_fence_proof(self) -> Dict:
        """Reconstruct the fence ordering from the trace ring: for
        EVERY cutover, every affected group must show LEASE_REVOKED
        (reason=topology_cutover) with a ring seq BEFORE the cutover's
        and LEASE_GRANTED after it."""
        evs = self.obs.trace.events()
        cutovers = [e for e in evs if e.kind == obs_trace.TOPOLOGY_CUTOVER]
        missing: List[dict] = []
        for cut in cutovers:
            affected = set(cut.fields.get("donors", ())) \
                | set(cut.fields.get("targets", ()))
            for g in sorted(affected):
                revoked = any(
                    e.seq < cut.seq
                    and e.kind == obs_trace.LEASE_REVOKED
                    and e.fields.get("group") == g
                    and e.fields.get("reason") == "topology_cutover"
                    for e in evs)
                granted = any(
                    e.seq > cut.seq
                    and e.kind == obs_trace.LEASE_GRANTED
                    and e.fields.get("group") == g
                    for e in evs)
                if not revoked:
                    missing.append(dict(cutover_seq=cut.seq, group=g,
                                        missing="revoke_before"))
                if not granted:
                    missing.append(dict(cutover_seq=cut.seq, group=g,
                                        missing="grant_after"))
        return dict(ok=not missing and bool(cutovers),
                    cutovers=len(cutovers), missing=missing)

    def _tick(self, t: int, violations: List[dict],
              timeouts: Optional[Dict[int, list]] = None) -> None:
        self.history.set_clock(t)
        self._issue(t)
        res = self.shard.step(timeouts=timeouts or {})
        self._observe_clients(t)
        self._check(res, t, violations)
        # the drained-serial pass the drivers' _drain_admin runs: in
        # this lockstep harness every step boundary is drained
        self.ctl.drive()

    def run(self) -> Dict:
        violations: List[dict] = []
        self.shard.place_leaders()
        crashed = -1
        for t in range(self.steps):
            timeouts: Dict[int, list] = {}
            if t == self.split_step:
                lo, hi, dst = self._split_range()
                assert self.ctl.propose_split(lo, hi, dst)
                self._rule = RangeRule(lo, hi, dst)
            if t == self.crash_step:
                crashed = self.shard.leader_hint(self.target)
                if crashed >= 0:
                    self.link.down.add(crashed)     # fail-stop, silent
            if (crashed >= 0
                    and t == self.crash_step + self.reelect_after):
                cand = next(r for r in range(self.R) if r != crashed)
                timeouts[self.target] = [cand]
            if t == self.merge_step:
                if self._rule in self.kv.router.overrides:
                    self.ctl.propose_merge(self._rule)
            self._tick(t, violations, timeouts)
        if crashed >= 0:
            self.link.down.discard(crashed)
        self.link.heal()
        for t in range(self.steps, self.steps + self.settle_steps):
            self._tick(t, violations)
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
        linz = check_history(self.history.ops())
        fence = self._lease_fence_proof()
        topo = self.ctl.status()
        new_leader = self.shard.leader_hint(self.target)
        ok = (not violations and linz["ok"] is True
              and fence["ok"]
              and topo["transitions_total"] == 2
              and topo["abandoned_total"] == 0
              and topo["phase"] == "idle"
              and not self.kv.router.overrides
              and new_leader >= 0 and new_leader != crashed)
        return dict(
            ok=ok, seed=self.seed, steps=self.steps,
            target_group=self.target, crashed_leader=crashed,
            new_leader=new_leader,
            invariant_violations=violations,
            linearizability=dict(ok=linz["ok"],
                                 violations=linz["violations"],
                                 undecided=linz["undecided"],
                                 ops=linz["ops"]),
            lease_fence=fence,
            topology=dict(
                transitions=topo["transitions_total"],
                abandoned=topo["abandoned_total"],
                epoch=topo["epoch"],
                router_version=topo["router_version"],
                overrides=len(self.kv.router.overrides)),
            governor=(self.governor.status()
                      if self.governor is not None else None),
        )


def run_topology_chaos(seed: int = 0, **kw) -> Dict:
    """One seeded topology-nemesis run; same seed, same verdict."""
    return TopologyNemesisRunner(seed=seed, **kw).run()
