"""Per-replica consensus state (the reference's SID fields, vote record,
log offsets and membership config — ``dare_server.h:46-72``,
``dare_log.h:77-103``, ``dare_config.h:17-44``).

The u32 member bitmasks (``bitmask_*``, ``ccfg_*``) are held as int64
tensors carrying the unsigned value: torch on the CPU has no uint32
``+``/``>>``, and int64 holds every u32 value exactly, so shifts and
masks give XLA's u32 results. Everything else is int32, like the JAX
package — offsets in particular stay i32 (the rebase contract depends
on it).
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from rdma_paxos_tpu_torch.consensus.log import Log, make_log


class Role(enum.IntEnum):
    NONE = 0
    FOLLOWER = 1
    CANDIDATE = 2
    LEADER = 3


class ConfigState(enum.IntEnum):
    STABLE = 0
    TRANSIT = 1
    EXTENDED = 2


U32_MASK = 0xFFFFFFFF


@dataclasses.dataclass
class ReplicaState:
    """Everything one replica carries between steps; batched states give
    every field a leading replica axis (``log.buf [R, n_slots, cols]``,
    ``vote_rec_* [R, R]``, scalars ``[R]``)."""

    log: Log
    term: torch.Tensor
    role: torch.Tensor
    leader_id: torch.Tensor
    voted_term: torch.Tensor
    voted_for: torch.Tensor
    vote_rec_term: torch.Tensor
    vote_rec_for: torch.Tensor
    head: torch.Tensor
    apply: torch.Tensor
    commit: torch.Tensor
    end: torch.Tensor
    cid_state: torch.Tensor
    bitmask_old: torch.Tensor   # int64 holding a u32
    bitmask_new: torch.Tensor   # int64 holding a u32
    epoch: torch.Tensor
    cfg_src: torch.Tensor
    cfg_src_term: torch.Tensor
    ccfg_old: torch.Tensor      # int64 holding a u32
    ccfg_new: torch.Tensor      # int64 holding a u32
    ccfg_cid: torch.Tensor
    ccfg_epoch: torch.Tensor


# field order of the JAX pytree (log first), shared by the converters
STATE_FIELDS = tuple(f.name for f in dataclasses.fields(ReplicaState))
U32_FIELDS = ("bitmask_old", "bitmask_new", "ccfg_old", "ccfg_new")


def make_replica_state(cfg, group_size: int, n_replicas: int | None = None,
                       *, role: Role = Role.FOLLOWER,
                       device) -> ReplicaState:
    """One replica's initial state (no replica axis)."""
    R = n_replicas if n_replicas is not None else group_size

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    mask = torch.tensor((1 << group_size) - 1, dtype=torch.int64,
                        device=device)
    return ReplicaState(
        log=make_log(cfg, device),
        term=i32(0),
        role=i32(int(role)),
        leader_id=i32(-1),
        voted_term=i32(0),
        voted_for=i32(-1),
        vote_rec_term=torch.zeros((R,), dtype=torch.int32, device=device),
        vote_rec_for=torch.full((R,), -1, dtype=torch.int32,
                                device=device),
        head=i32(0),
        apply=i32(0),
        commit=i32(0),
        end=i32(0),
        cid_state=i32(int(ConfigState.STABLE)),
        bitmask_old=mask.clone(),
        bitmask_new=mask.clone(),
        epoch=i32(0),
        cfg_src=i32(-1),
        cfg_src_term=i32(0),
        ccfg_old=mask.clone(),
        ccfg_new=mask.clone(),
        ccfg_cid=i32(int(ConfigState.STABLE)),
        ccfg_epoch=i32(0),
    )


def map_state(fn, state: ReplicaState) -> ReplicaState:
    """Apply ``fn`` to every tensor of ``state`` (the log's ring too)."""
    kw = {k: fn(getattr(state, k)) for k in STATE_FIELDS if k != "log"}
    return ReplicaState(log=Log(fn(state.log.buf)), **kw)


def clone_state(state: ReplicaState) -> ReplicaState:
    return map_state(torch.clone, state)
