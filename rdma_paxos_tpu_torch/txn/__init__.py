"""Cross-group atomic transactions over the sharded consensus engine
(the port of the JAX package's ``txn`` package).

* :mod:`rdma_paxos_tpu_torch.txn.lane` — the vote constants and the
  prepare-vote rule of the ``txn=`` step variant, on torch tensors
  (the only module ``consensus/step.py`` imports from this package).
* :mod:`rdma_paxos_tpu_torch.txn.records` — the record format
  (PREPARE/COMMIT/ABORT/MERGE, ``TXN_CMD_W`` words) the coordinator
  writes and the KVS fold and the serializability checker read.
* :mod:`rdma_paxos_tpu_torch.txn.coordinator` — the host 2PC state
  machine (begin/prepare/commit/abort, step-domain timeouts,
  participant locks, abort on leader failover).
* :mod:`rdma_paxos_tpu_torch.txn.api` — ``transact()``, the client
  surface ``ShardedKVS`` exposes.
* :mod:`rdma_paxos_tpu_torch.txn.merge` — the mergeable-op fast path
  (INCR / add-to-set / max-register commit as independent per-group
  entries, no prepare).
* :mod:`rdma_paxos_tpu_torch.txn.chaos` — the seeded coordinator-crash
  nemesis runner (strict serializability under a leader crash).

Host symbols resolve lazily, so importing the package (as the step
does for the lane) never pulls the host modules.
"""

from __future__ import annotations

import importlib

_LAZY = {
    "TXN_NONE": "lane", "TXN_PENDING": "lane",
    "TXN_PREPARED": "lane", "TXN_CONFLICT": "lane",
    "prepare_vote": "lane",
    "Txn": "coordinator", "TxnCoordinator": "coordinator",
    "attach_coordinator": "coordinator",
    "TxnHandle": "api", "transact": "api",
    "MERGE_FNS": "merge", "is_mergeable": "merge",
    "mergeable_plan": "merge",
    "TxnNemesisRunner": "chaos", "run_txn_chaos": "chaos",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
