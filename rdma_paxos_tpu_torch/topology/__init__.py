"""Elastic topology control plane — online group split/merge.

The port's copy of the JAX package's ``topology`` package.

The router's group count is frozen at construction (G is baked into
the stacked ``[G, R, ...]`` device state and ONE dispatch steps all of
it), so a hot group used to be a permanent throughput ceiling. This
package lifts that ceiling WITHOUT touching the device: a "split"
carves the hot key range out of its group via a router range-override
rule (the operator escape hatch ``shard/router.py`` documents for
exactly this), a "merge" removes the rule — splits reshape host-side
routing, never the step, so step outputs and the ops per ``step()``
stay equal with topology attached (pinned by test).

Three pieces, mirroring the reconfigurable-commit framing
(arXiv:1906.01365) and DXRAM's load-directed shard migration
(arXiv:1807.03562):

* :mod:`~rdma_paxos_tpu_torch.topology.epoch` — the term-watch/
  completion-proof machinery shared with the txn coordinator:
  deposition detection, record-term completion proofs,
  forget-and-retry under the same stamp. One copy, two users.
* :mod:`~rdma_paxos_tpu_torch.topology.transition` — the two-router
  transition window: live range keys are seeded into their new owner
  groups through exactly-once stamped PUTs with epoch-proofed
  completion, digests verified donor-vs-target, writes to the
  migrating range frozen (queued, step-domain deadline) only for the
  final cutover, leases on affected groups revoked before the router
  swap and re-granted after. Merge is the same window run in reverse.
* :mod:`~rdma_paxos_tpu_torch.topology.policy` — the load-driven loop:
  per-group committed-work shares (device-truth commit frontiers)
  export as gauges, a stock ``AlertEngine`` rule fires on sustained
  skew, and the ``add_hook`` policy proposes split/merge with
  hysteresis and a cooldown — the ``RepairController.on_alert`` /
  governor-shed pattern.

Every transition is an epoch bump fenced through the drained-serial
path repair already uses: the controller's ``needs_drain()`` gates
the drivers' pipelining, ``drive()`` runs on the stepping thread with
zero dispatches in flight.
"""

from __future__ import annotations

from rdma_paxos_tpu_torch.topology.epoch import (
    COMPLETE, INVALIDATED, PENDING, RETRY_STEPS, EpochClock, TermWatch,
    commit_frontier, placement_status, term_now)

__all__ = ["COMPLETE", "INVALIDATED", "PENDING", "RETRY_STEPS",
           "EpochClock", "TermWatch", "attach_topology",
           "commit_frontier", "placement_status", "term_now"]


def attach_topology(kvs, *, policy=None, obs=None, alerts=None,
                    **opts) -> "TopologyController":
    """Build a :class:`TopologyController` over ``kvs`` (a
    ``ShardedKVS``) and hang it on ``cluster.topology`` — the finish()
    tail starts feeding it, the drivers' drain gates see it through
    the same attach point leases/repair/governor use. ``policy=True``
    (or a prebuilt :class:`~rdma_paxos_tpu_torch.topology.policy.
    TopologyPolicy`) attaches the load loop; with ``alerts=`` its
    skew rules are registered and the proposal hook is wired."""
    from rdma_paxos_tpu_torch.topology.transition import (
        TopologyController)
    ctl = TopologyController(kvs, obs=obs, **opts)
    kvs.shard.topology = ctl
    if policy:
        from rdma_paxos_tpu_torch.topology.policy import TopologyPolicy
        if policy is True:
            policy = TopologyPolicy(ctl)
        else:
            policy.bind(ctl)
        ctl.policy = policy
        if alerts is not None:
            for rule in policy.stock_rules():
                if rule["name"] not in {r["name"] for r in alerts.rules}:
                    alerts.add_rule(rule)
            alerts.add_hook(policy.on_alert)
    return ctl
