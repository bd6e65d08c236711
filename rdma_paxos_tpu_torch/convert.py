"""Carry state between the JAX package and the port, as numpy.

The port never imports the JAX package: these functions read any
object (or mapping) with the right field names, so a caller holding a
JAX ``ReplicaState``/``KVState``/``SimCluster`` passes it straight in
(``np.asarray`` reads a JAX array without importing JAX here). Field
dtypes follow the JAX package: every field int32 except the u32 member
bitmasks ``bitmask_*``/``ccfg_*`` (int64 in the port).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

from rdma_paxos_tpu_torch.consensus.log import Log
from rdma_paxos_tpu_torch.consensus.snapshot import Snapshot
from rdma_paxos_tpu_torch.consensus.state import (
    STATE_FIELDS, U32_FIELDS, U32_MASK, ReplicaState)
from rdma_paxos_tpu_torch.models.kvs import KVState
from rdma_paxos_tpu_torch.runtime.hostpath import LazyReplayStream

KV_FIELDS = ("keys", "vals", "used")


def _get(tree, name):
    return tree[name] if isinstance(tree, Mapping) else getattr(tree, name)


def to_numpy(x) -> np.ndarray:
    """A torch tensor or any array-like (a JAX array too) as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def replica_state_from_jax(np_tree, device) -> ReplicaState:
    """A (stacked or single) ``ReplicaState`` from the JAX layout: an
    object or mapping with the JAX field names, ``log`` holding the
    fused ring (as ``log.buf`` or the array itself)."""
    fields = {}
    for k in STATE_FIELDS:
        v = _get(np_tree, k)
        if k == "log":
            v = v if isinstance(v, (np.ndarray, torch.Tensor)) \
                else _get(v, "buf")
        a = to_numpy(v)
        dtype = np.int64 if k in U32_FIELDS else np.int32
        t = torch.from_numpy(np.array(a, dtype=dtype)).to(device)
        fields[k] = Log(t) if k == "log" else t
    return ReplicaState(**fields)


def replica_state_to_numpy(state) -> Dict[str, np.ndarray]:
    """Field -> numpy array in the JAX dtypes (``log`` is the fused
    ring); accepts the port's state or a JAX one."""
    out = {}
    for k in STATE_FIELDS:
        v = _get(state, k)
        a = to_numpy(v.buf if k == "log" else v)
        out[k] = a.astype(np.uint32 if k in U32_FIELDS else np.int32)
    return out


def kv_state_from_jax(np_tree, device) -> KVState:
    return KVState(**{k: torch.from_numpy(
        np.array(to_numpy(_get(np_tree, k)), dtype=np.int32)).to(device)
        for k in KV_FIELDS})


def kv_state_to_numpy(kv) -> Dict[str, np.ndarray]:
    return {k: to_numpy(_get(kv, k)).astype(np.int32) for k in KV_FIELDS}


SNAPSHOT_FIELDS = tuple(f.name for f in dataclasses.fields(Snapshot))


def snapshot_to_numpy(snap) -> dict:
    """A recovery ``Snapshot`` of either package as plain fields:
    Python ints (the member masks unsigned), the store blob as bytes and
    the digest chain (if any) as a u32 array. ``Snapshot(**out)`` of
    either package rebuilds it, so a snapshot taken by one engine
    installs into the other."""
    out = {}
    for k in SNAPSHOT_FIELDS:
        v = _get(snap, k)
        if k == "store_blob":
            out[k] = bytes(v)
        elif k == "audit_digests":
            out[k] = None if v is None else np.array(to_numpy(v),
                                                     np.uint32)
        else:
            out[k] = int(v)
    for k in ("bitmask_old", "bitmask_new"):
        out[k] &= U32_MASK
    return out


def snapshot_from_jax(snap) -> Snapshot:
    """The port's ``Snapshot`` from a JAX one (or any object or mapping
    with its field names)."""
    return Snapshot(**snapshot_to_numpy(snap))


def sim_snapshot(cluster) -> dict:
    """A ``SimCluster``'s device state plus host cursors (either
    package's engine, drained): what :func:`sim_restore` loads."""
    if cluster._tickets:
        raise RuntimeError("snapshot with dispatches in flight")
    return dict(
        state=replica_state_to_numpy(cluster.state),
        applied=np.array(cluster.applied, np.int64),
        peer_mask=np.array(cluster.peer_mask, np.int32),
        pending=[list(q) for q in cluster.pending],
        replayed=[list(s) for s in cluster.replayed],
        last=(None if cluster.last is None
              else {k: np.array(v) for k, v in cluster.last.items()}),
        need_recovery=set(cluster.need_recovery),
        wedged=set(cluster._wedged),
        rebases=int(cluster.rebases),
        rebased_total=int(cluster.rebased_total),
        rebase_stall_steps=int(cluster.rebase_stall_steps),
        step_index=int(cluster.step_index),
    )


def sim_restore(cluster, snap: dict) -> None:
    """Load :func:`sim_snapshot` output into the port's ``SimCluster``
    (same geometry), on the cluster's device."""
    if cluster._tickets:
        raise RuntimeError("restore with dispatches in flight")
    with cluster._host_lock:
        cluster.state = replica_state_from_jax(snap["state"],
                                               cluster.device)
        cluster.applied = np.array(snap["applied"], np.int64)
        cluster.peer_mask = np.array(snap["peer_mask"], np.int32)
        cluster.pending = [list(q) for q in snap["pending"]]
        cluster.replayed = [LazyReplayStream(s) for s in snap["replayed"]]
        cluster.last = (None if snap["last"] is None
                        else {k: np.array(v)
                              for k, v in snap["last"].items()})
        cluster.need_recovery = set(snap["need_recovery"])
        cluster._wedged = set(snap["wedged"])
        cluster.rebases = snap["rebases"]
        cluster.rebased_total = snap["rebased_total"]
        cluster.rebase_stall_steps = snap["rebase_stall_steps"]
        cluster.step_index = snap["step_index"]
