"""Elastic topology: only the epoch machinery the transaction
coordinator shares with it is ported (:mod:`~rdma_paxos_tpu_torch.
topology.epoch`). The transition window, the load policy and
``attach_topology`` come with ROADMAP Queue 1, item 13."""

from rdma_paxos_tpu_torch.topology.epoch import (
    COMPLETE, INVALIDATED, PENDING, RETRY_STEPS, EpochClock, TermWatch,
    commit_frontier, placement_status, term_now)

__all__ = ["COMPLETE", "INVALIDATED", "PENDING", "RETRY_STEPS",
           "EpochClock", "TermWatch", "commit_frontier",
           "placement_status", "term_now"]
