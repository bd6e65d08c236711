"""Snapshot-based recovery — the joiner/straggler catch-up path — and the
coordinated i32 rollover.

Reference (§3.5 of SURVEY.md): a joiner RDMA-reads a donor's serialized
BerkeleyDB record stream plus the determinant of the last applied entry
(``snapshot_t``, ``dare_log.h:105-112``; ``rc_recover_sm``
``dare_ibv_rc.c:603-710``; ``proxy_apply_db_snapshot`` ``proxy.c:306-339``),
then RDMA-reads the log tail (``rc_recover_log`` ``:726-856``).

Here, as in the JAX package, the app/event state travels as the stable
store's dump blob (host side); the install sets the replica's log offsets
to the snapshot determinant ``(index, term)`` — the Raft InstallSnapshot
pair — and stamps the determinant term into the slot of ``index-1`` so
the AppendEntries prev-term check passes and ordinary window replication
takes over from there. The install is an in-place update of the batched
state on its own device: the replica's ring row is wiped where it lies
(80 MiB at the reference's log size), and the scalar fields are written
by indexing; the only host reads are :func:`take_snapshot`'s determinant
elements and :func:`recover_vote`'s vote records.

Not ported yet: the audit digest chain (``verify_snapshot`` and
``obs/audit.py``; ROADMAP Queue 1, item 9) and the group axis (item 11).
``take_snapshot(digests=True)``, ``install_snapshot(ledger=...)`` and
``group=`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rdma_paxos_tpu_torch.consensus.log import (
    EntryType, M_GIDX, M_TERM, M_TYPE, META_W)
from rdma_paxos_tpu_torch.consensus.state import (
    STATE_FIELDS, U32_FIELDS, U32_MASK, ConfigState, ReplicaState, Role)
from rdma_paxos_tpu_torch.obs import trace as obs_trace
from rdma_paxos_tpu_torch.obs.metrics import default_registry
from rdma_paxos_tpu_torch.obs.trace import default_ring

DIGESTS_LATER = ("the audit digest chain is not ported yet "
                 "(ROADMAP Queue 1, item 9)")
GROUPS_LATER = ("the group axis (sharded [G, R] state) is not ported yet "
                "(ROADMAP Queue 1, item 11)")


class SnapshotVerifyError(RuntimeError):
    """The snapshot's digest chain contradicts the audit ledger's
    majority digests: the DONOR is corrupted (or unverifiable)."""


class SnapshotEpochError(SnapshotVerifyError):
    """The snapshot's digests were computed under a different digest
    LAYOUT: incomparable, not unequal."""


def _row_idx(group, r):
    """State-row index tuple: ``(r,)`` on the [R]-batched state. The
    group axis (``(group, r)``) comes with the sharded engine."""
    if group is not None:
        raise NotImplementedError("group=: " + GROUPS_LATER)
    return (int(r),)


@dataclasses.dataclass
class Snapshot:
    """Host-transferable snapshot: consensus determinant + event history.

    The config fields are the donor's COMMITTED-config checkpoint
    (``ccfg_*``), not its live adopted config: a live-but-uncommitted
    CONFIG entry has ``gidx >= commit >= apply = index``, so the
    recovered replica re-absorbs it through window replication if it
    survives, and must not inherit it if it is truncated cluster-wide.
    ``bitmask_*`` are unsigned (u32) values. The audit-chain fields
    stay at their defaults until the digest chain is ported (item 9)."""

    index: int            # last applied entry index + 1 (= donor apply)
    term: int             # term of entry index-1 (prev-check anchor)
    store_blob: bytes     # serialized stable store (full event history)
    epoch: int            # committed membership epoch at the donor
    bitmask_old: int
    bitmask_new: int
    cid_state: int
    digest_epoch: int = 0
    audit_start: int = -1
    audit_digests: Optional[np.ndarray] = None


def take_snapshot(state_b: ReplicaState, donor: int,
                  store_blob: bytes = b"",
                  index: Optional[int] = None, *,
                  group: Optional[int] = None,
                  digests: bool = False,
                  rebased_total: int = 0) -> Snapshot:
    """Capture a snapshot from replica ``donor`` of a batched state.

    ``index`` overrides the determinant index: pass the donor's HOST
    apply counter when ``store_blob`` was produced by the host (the
    device-side ``apply`` can lag it by one step's echo). The
    determinant term is ONE element of the fused ring,
    ``buf[donor, slot, slot_words + M_TERM]``: the ring never travels
    to the host. ``rebased_total`` only places a digest chain, which
    this port does not build yet."""
    if digests:
        raise NotImplementedError("take_snapshot(digests=True): "
                                  + DIGESTS_LATER)
    idx = _row_idx(group, donor)
    log = state_b.log
    if index is None:
        index = int(state_b.apply[idx])
    index = int(index)
    # one transfer for the committed-config checkpoint and the
    # determinant term (the anchor slot is read even when index is 0;
    # the term is then 0)
    slot = (max(index, 1) - 1) & (log.n_slots - 1)
    vals = torch.stack([
        log.buf[idx + (slot, log.slot_words + M_TERM)].long(),
        state_b.ccfg_epoch[idx].long(), state_b.ccfg_old[idx].long(),
        state_b.ccfg_new[idx].long(), state_b.ccfg_cid[idx].long(),
    ]).tolist()
    term, epoch, bm_old, bm_new, cid = vals
    snap = Snapshot(index=index, term=term if index > 0 else 0,
                    store_blob=store_blob, epoch=epoch,
                    bitmask_old=bm_old & U32_MASK,
                    bitmask_new=bm_new & U32_MASK, cid_state=cid)
    default_registry().inc("snapshots_taken_total")
    default_ring().record(obs_trace.SNAPSHOT_TAKEN, replica=donor,
                          index=snap.index, term=snap.term,
                          store_bytes=len(store_blob))
    return snap


def _install(state_b: ReplicaState, idx, index: int, term: int,
             cur_term: int, voted_term: int, voted_for: int, epoch: int,
             bm_old: int, bm_new: int, cid: int) -> ReplicaState:
    """The install body of the JAX ``_install_body``: wipe the row's
    fused ring IN PLACE, stamp the determinant term at the slot of
    ``index-1``, and set the row's offsets, election state and config.
    The [R] scalar fields are written into fresh copies (a step's
    outputs may alias the state's tensors)."""
    log = state_b.log
    row = log.buf[idx]
    row.zero_()
    anchor = max(index - 1, 0) & (log.n_slots - 1)
    row[anchor, log.slot_words + M_TERM] = term if index > 0 else 0
    bm_old &= U32_MASK
    bm_new &= U32_MASK
    sets = dict(head=index, apply=index, commit=index, end=index,
                term=cur_term, role=int(Role.FOLLOWER), leader_id=-1,
                voted_term=voted_term, voted_for=voted_for,
                # a fresh process has no memory of peers' votes
                vote_rec_term=0, vote_rec_for=-1,
                epoch=epoch, bitmask_old=bm_old, bitmask_new=bm_new,
                cid_state=cid,
                cfg_src=-1,      # cache backed by the checkpoint below
                cfg_src_term=0,
                # the snapshot's config IS the donor's committed-config
                # checkpoint: the wiped log holds no CONFIG entry, so the
                # first derivation falls back here
                ccfg_old=bm_old, ccfg_new=bm_new, ccfg_cid=cid,
                ccfg_epoch=epoch)
    out = {}
    for k, v in sets.items():
        t = getattr(state_b, k).clone()
        t[idx] = v
        out[k] = t
    return dataclasses.replace(state_b, **out)


def recover_vote(state_b: ReplicaState, r: int, peers=None, *,
                 group: Optional[int] = None) -> tuple:
    """Read replica ``r``'s replicated vote back from peers' vote records
    — the ``rc_get_replicated_vote`` analog (``dare_ibv_rc.c:394-473``).
    Returns the newest ``(voted_term, voted_for)`` any queried peer
    retains for ``r`` (query BEFORE installing a snapshot into ``r``).
    ``peers`` defaults to everyone except ``r``: a crashed replica's own
    record is exactly what the crash lost."""
    _row_idx(group, r)
    rec_t, rec_f = state_b.vote_rec_term, state_b.vote_rec_for
    if peers is None:
        peers = [p for p in range(rec_t.shape[0]) if p != r]
    sel = list(peers)
    if not sel:
        return 0, -1
    both = torch.stack([rec_t[sel, r], rec_f[sel, r]]).cpu().numpy()
    i = int(both[0].argmax())
    return int(both[0, i]), int(both[1, i])


def install_snapshot(state_b: ReplicaState, r: int, snap: Snapshot, *,
                     voted_term: int = 0, voted_for: int = -1,
                     cur_term: int = 0, group: Optional[int] = None,
                     ledger=None, ledger_group: Optional[int] = None,
                     min_verified: int = 1) -> ReplicaState:
    """Install ``snap`` into replica ``r`` of a batched state: the
    replica resumes as a follower at the determinant; ordinary
    replication catches it up from there. The event-history blob is
    the host's concern (StableStore.load + app replay).

    ``voted_term``/``voted_for``/``cur_term`` restore election
    durability across the crash (HardState file + :func:`recover_vote`):
    the current term is floored at the snapshot term and the recovered
    vote term, so a recovered replica never re-grants a vote it cast.

    A member mask with bit 31 installs as its u32 bit pattern (the JAX
    package's install raises ``OverflowError`` on such a mask)."""
    if ledger is not None:
        raise NotImplementedError(
            "install_snapshot(ledger=...): the digest-verified install "
            "needs the audit chain and the repair pipeline (ROADMAP "
            "Queue 1, items 9 and 12)")
    idx = _row_idx(group, r)
    eff_term = max(int(snap.term), int(cur_term), int(voted_term))
    out = _install(state_b, idx, int(snap.index), int(snap.term),
                   eff_term, int(voted_term), int(voted_for),
                   int(snap.epoch), int(snap.bitmask_old),
                   int(snap.bitmask_new), int(snap.cid_state))
    # recorded AFTER the install, so a raising install is never
    # reported as an installed snapshot
    default_registry().inc("snapshots_installed_total")
    default_ring().record(obs_trace.SNAPSHOT_INSTALLED, replica=int(r),
                          index=snap.index, term=snap.term,
                          epoch=snap.epoch)
    return out


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


def export_row(state_b: ReplicaState, r: int) -> dict:
    """Replica ``r``'s full state row as host numpy, in the JAX dtypes
    (u32 member masks) — the transfer unit of cross-generation
    recovery. Keys are ReplicaState field names; the log travels as
    ``log_buf``."""
    out = {"log_buf": state_b.log.buf[r].cpu().numpy()}
    for k in STATE_FIELDS:
        if k == "log":
            continue
        a = getattr(state_b, k)[r].cpu().numpy()
        out[k] = a.astype(np.uint32 if k in U32_FIELDS else np.int32)
    return out


def genesis_row(donor_row: dict, *, group_mask: int, epoch: int,
                n_replicas: int, term: Optional[int] = None) -> dict:
    """Sanitize a donor row into the shared GENESIS state of a new
    generation: the log and offsets carry over, retained CONFIG entries
    are re-typed NOOP, the new world's config becomes both the live
    bitmasks and the committed checkpoint, ``term`` is bumped past every
    survivor's (caller passes the gathered max), votes reset, and every
    role resets to follower."""
    row = {k: np.array(v, copy=True) for k, v in donor_row.items()}
    buf = row["log_buf"]
    slot_words = buf.shape[-1] - META_W
    types = buf[:, slot_words + M_TYPE]
    types[types == int(EntryType.CONFIG)] = int(EntryType.NOOP)
    new_term = (int(row["term"]) if term is None else int(term)) + 1
    i32, u32 = np.int32, np.uint32
    mask = u32(group_mask)
    row.update(
        term=i32(new_term), role=i32(int(Role.FOLLOWER)),
        leader_id=i32(-1),
        voted_term=i32(0), voted_for=i32(-1),
        vote_rec_term=np.zeros(n_replicas, i32),
        vote_rec_for=np.full(n_replicas, -1, i32),
        cid_state=i32(int(ConfigState.STABLE)),
        bitmask_old=mask, bitmask_new=mask, epoch=i32(epoch),
        cfg_src=i32(-1),
        cfg_src_term=i32(0),
        ccfg_old=mask, ccfg_new=mask,
        ccfg_cid=i32(int(ConfigState.STABLE)), ccfg_epoch=i32(epoch),
    )
    return row
