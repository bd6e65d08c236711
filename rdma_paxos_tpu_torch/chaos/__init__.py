"""Chaos subsystem: deterministic fault injection + client-visible
linearizability checking — the chaos judge of the port.

The port's copy of the JAX package's ``chaos`` package: the same seed
gives the JAX runner's verdict, history and audit ledger, bit for bit
(``tests/test_torch_chaos.py``). Six parts, all host-side, all
seed-deterministic:

* :mod:`~rdma_paxos_tpu_torch.chaos.faults` — a seeded fault-schedule
  DSL (nemesis) plus the pluggable per-link model ``SimCluster``
  consults at every dispatch: asymmetric link breaks, message
  drop/delay/duplication, crash-restart with volatile-state wipe +
  snapshot/StableStore-style recovery, and election-timeout jitter.
* :mod:`~rdma_paxos_tpu_torch.chaos.history` — a client-operation
  history recorder (invoke/ok/fail/timeout events over logical step
  time, JSONL dump) hooked into ``ReplicatedKVS``/``ClientSession``,
  including weak reads and retransmits.
* :mod:`~rdma_paxos_tpu_torch.chaos.linearize` — a per-key-partitioned
  Wing–Gong linearizability checker with memoization (porcupine-style)
  over the KVS register model; timed-out ops are ambiguous (may or may
  not have taken effect).
* :mod:`~rdma_paxos_tpu_torch.chaos.invariants` — the I1–I5 protocol
  safety invariants.
* :mod:`~rdma_paxos_tpu_torch.chaos.runner` — the nemesis runner
  composing workload generator + fault schedule + invariants + the
  checker; any violation dumps a self-contained reproducer artifact
  (seed, schedule JSON, history JSONL, obs trace ring, metrics
  snapshot) via :mod:`~rdma_paxos_tpu_torch.chaos.artifact`.
* :mod:`~rdma_paxos_tpu_torch.chaos.serialize` — the cross-group
  strict-serializability checker over committed 2PC records.

Nothing here runs inside the replica step: the link model only
rewrites the ``peer_mask`` INPUT the step already takes.
"""

from __future__ import annotations

from rdma_paxos_tpu_torch.chaos.artifact import load_reproducer, write_reproducer
from rdma_paxos_tpu_torch.chaos.faults import (
    FaultSchedule, HardStateTracker, LinkModel, StepTimerModel,
    crash_replica, generate_schedule, restart_replica)
from rdma_paxos_tpu_torch.chaos.history import HistoryRecorder
from rdma_paxos_tpu_torch.chaos.invariants import (
    InvariantChecker, InvariantViolation)
from rdma_paxos_tpu_torch.chaos.linearize import check_history, check_key

__all__ = [
    "FaultSchedule", "HardStateTracker", "HistoryRecorder",
    "InvariantChecker", "InvariantViolation", "LinkModel",
    "StepTimerModel", "check_history", "check_key", "crash_replica",
    "generate_schedule", "load_reproducer", "restart_replica",
    "write_reproducer",
]
