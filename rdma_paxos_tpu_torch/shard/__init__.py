"""Sharded multi-group consensus — the layer above the single-group
stack that partitions a keyspace across G independent consensus groups.

* :mod:`~rdma_paxos_tpu_torch.shard.router` — deterministic key→group
  mapping (FNV-1a hash ring + range overrides), a copy of the JAX
  package's router.
* :mod:`~rdma_paxos_tpu_torch.shard.cluster` — :class:`ShardedCluster`:
  G × R state stacked ``[G, R, ...]`` on one device, every group
  stepped by one pass of the step (one ``commit_window`` launch over
  G·R instances); per-group host bookkeeping and fault domains; leader
  placement.
* :mod:`~rdma_paxos_tpu_torch.shard.kvs` — :class:`ShardedKVS` +
  :class:`ShardedSession`: routed puts/gets/removes, per-group dedup
  sequence numbers, per-group leader failover.
* :mod:`~rdma_paxos_tpu_torch.shard.chaos` — ``ShardNemesisRunner``:
  crash one group's leader and prove the other groups never notice.
"""

from rdma_paxos_tpu_torch.shard.cluster import ShardedCluster
from rdma_paxos_tpu_torch.shard.kvs import ShardedKVS, ShardedSession
from rdma_paxos_tpu_torch.shard.router import KeyRouter, RangeRule, fnv1a32

__all__ = ["ShardedCluster", "ShardedKVS", "ShardedSession",
           "KeyRouter", "RangeRule", "fnv1a32"]
