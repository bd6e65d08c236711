"""Snapshot-side state transforms. Only the coordinated i32 rollover is
ported in this slice; take/verify/install come with recovery."""

from __future__ import annotations

import dataclasses

import torch

from rdma_paxos_tpu_torch.consensus.log import M_GIDX
from rdma_paxos_tpu_torch.consensus.state import ReplicaState


def rebase_offsets(state_b: ReplicaState, delta: int) -> ReplicaState:
    """Subtract ``delta`` from every log offset of every replica (and
    the stamped M_GIDX column of every slot) — the coordinated i32
    rollover. ``delta`` must be a multiple of n_slots and <= min head;
    offsets are relative everywhere in the protocol, so a uniform
    subtraction is invisible to consensus. In place on the ring."""
    d = int(delta)
    state_b.log.buf[..., state_b.log.slot_words + M_GIDX] -= d
    return dataclasses.replace(
        state_b,
        head=state_b.head - d,
        apply=state_b.apply - d,
        commit=state_b.commit - d,
        end=state_b.end - d,
        cfg_src=torch.where(state_b.cfg_src >= 0, state_b.cfg_src - d,
                            state_b.cfg_src),
    )
