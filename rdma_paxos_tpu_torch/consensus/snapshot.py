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
elements (and, with ``digests=True``, the donor's committed rows) and
:func:`recover_vote`'s vote records.

The audit chain binds a snapshot to the ledger: ``take_snapshot(
digests=True)`` digests the donor's physically present committed prefix
on the host with the step's fold (``consensus/step.py:digest_fold_np``),
and ``install_snapshot(ledger=...)`` runs :func:`verify_snapshot` before
it touches any state, refusing a donor that contradicts the ledger's
majority digests. ``group=`` selects one consensus group's replica row
of a sharded ``[G, R]`` state (``ShardedCluster``); on an unsharded
``[R]`` state it raises, as does its absence on a sharded one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rdma_paxos_tpu_torch.config import DIGEST_EPOCH
from rdma_paxos_tpu_torch.consensus.log import (
    EntryType, M_GIDX, M_TERM, M_TYPE, META_W)
from rdma_paxos_tpu_torch.consensus.state import (
    STATE_FIELDS, U32_FIELDS, U32_MASK, ConfigState, ReplicaState, Role)
from rdma_paxos_tpu_torch.consensus.step import digest_fold_np
from rdma_paxos_tpu_torch.obs import trace as obs_trace
from rdma_paxos_tpu_torch.obs.metrics import default_registry
from rdma_paxos_tpu_torch.obs.trace import default_ring


class SnapshotVerifyError(RuntimeError):
    """The snapshot's digest chain contradicts the audit ledger's
    majority digests: the DONOR is corrupted (or unverifiable). Raised
    by :func:`install_snapshot` before any state is touched."""


class SnapshotEpochError(SnapshotVerifyError):
    """The snapshot's digests were computed under a different digest
    LAYOUT (``config.DIGEST_EPOCH``): incomparable, not unequal."""


def _row_idx(group, r):
    """State-row index tuple: ``(r,)`` on the [R]-batched SimCluster
    state, ``(group, r)`` on the [G, R]-batched sharded state — the one
    place the snapshot path widens by the group axis."""
    return (int(r),) if group is None else (int(group), int(r))


def _state_idx(state_b: ReplicaState, group, r):
    """:func:`_row_idx`, refusing a ``group`` that does not match the
    state's rank (an index of the wrong rank would select a ring slot
    or a whole group instead of one replica's row)."""
    sharded = state_b.term.dim() == 2
    if sharded != (group is not None):
        raise ValueError(
            "group=%r on a %s state" % (
                group, "sharded [G, R]" if sharded else "[R]-batched"))
    return _row_idx(group, r)


@dataclasses.dataclass
class Snapshot:
    """Host-transferable snapshot: consensus determinant + event history.

    The config fields are the donor's COMMITTED-config checkpoint
    (``ccfg_*``), not its live adopted config: a live-but-uncommitted
    CONFIG entry has ``gidx >= commit >= apply = index``, so the
    recovered replica re-absorbs it through window replication if it
    survives, and must not inherit it if it is truncated cluster-wide.
    ``bitmask_*`` are unsigned (u32) values.

    ``digest_epoch``/``audit_start``/``audit_digests`` are the audit
    chain position (``take_snapshot(digests=True)``): one u32 digest per
    physically present committed entry ``[audit_start, audit_start +
    len)`` in ABSOLUTE indices, with the fold of the step's audit
    windows; 0, -1 and None otherwise."""

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
    ``buf[donor, slot, slot_words + M_TERM]``: without ``digests`` the
    ring never travels to the host.

    ``digests=True`` folds the donor's audit chain position into the
    snapshot: the rows of its physically present committed prefix
    ``[head, index)`` come to the host in one transfer and are digested
    there with the step's fold, stamped in ABSOLUTE indices
    (``rebased_total`` added) with ``config.DIGEST_EPOCH``. Entries whose
    stamped gidx disagrees with the expected index (a recycled slot)
    truncate the chain from below."""
    idx = _state_idx(state_b, group, donor)
    log = state_b.log
    if index is None:
        index = int(state_b.apply[idx])
    index = int(index)
    # one transfer for the committed-config checkpoint, the head and the
    # determinant term (the anchor slot is read even when index is 0;
    # the term is then 0)
    slot = (max(index, 1) - 1) & (log.n_slots - 1)
    vals = torch.stack([
        log.buf[idx + (slot, log.slot_words + M_TERM)].long(),
        state_b.ccfg_epoch[idx].long(), state_b.ccfg_old[idx].long(),
        state_b.ccfg_new[idx].long(), state_b.ccfg_cid[idx].long(),
        state_b.head[idx].long(),
    ]).tolist()
    term, epoch, bm_old, bm_new, cid, head = vals
    digest_epoch, a_start, a_dig = 0, -1, None
    if digests:
        lo = max(head, 0)
        g = torch.arange(lo, max(index, lo), device=log.buf.device)
        rows = log.buf[idx][g & (log.n_slots - 1)].cpu().numpy()
        sw = log.slot_words
        good = rows[:, sw + M_GIDX] == np.arange(lo, lo + len(rows))
        # truncate from below past any recycled slot: the chain must be
        # contiguous up to the determinant
        first_good = (len(good) - int(np.argmin(good[::-1]))
                      if good.size and not good.all() else 0)
        rows = rows[first_good:]
        lo += first_good
        digest_epoch = DIGEST_EPOCH
        a_start = lo + int(rebased_total)
        a_dig = (digest_fold_np(rows) if len(rows)
                 else np.zeros(0, np.uint32))
    snap = Snapshot(index=index, term=term if index > 0 else 0,
                    store_blob=store_blob, epoch=epoch,
                    bitmask_old=bm_old & U32_MASK,
                    bitmask_new=bm_new & U32_MASK, cid_state=cid,
                    digest_epoch=digest_epoch, audit_start=a_start,
                    audit_digests=a_dig)
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
    record is exactly what the crash lost. ``group`` selects one
    consensus group's records on the sharded state."""
    _state_idx(state_b, group, r)
    rec_t, rec_f = state_b.vote_rec_term, state_b.vote_rec_for
    if group is not None:
        rec_t, rec_f = rec_t[int(group)], rec_f[int(group)]
    if peers is None:
        peers = [p for p in range(rec_t.shape[0]) if p != r]
    sel = list(peers)
    if not sel:
        return 0, -1
    both = torch.stack([rec_t[sel, r], rec_f[sel, r]]).cpu().numpy()
    i = int(both[0].argmax())
    return int(both[0, i]), int(both[1, i])


def verify_snapshot(snap: Snapshot, ledger, *, group: int = 0,
                    min_verified: int = 1) -> int:
    """Check ``snap``'s digest chain against ``ledger``'s MAJORITY-held
    digests (``obs/audit.py:AuditLedger``): every snapshot index the
    ledger retains with a replica-majority mask must carry the identical
    digest. Returns the number of verified indices; raises
    :class:`SnapshotVerifyError` on any contradiction (the donor is
    corrupted) or when fewer than ``min_verified`` indices could be
    checked (an unverifiable donor is refused, not trusted), and
    :class:`SnapshotEpochError` on a digest-layout mismatch. Indices the
    ledger holds with only minority backing are skipped: a first report
    may have come from the diverged minority itself."""
    if snap.audit_digests is None or snap.audit_start < 0:
        raise SnapshotVerifyError(
            "snapshot carries no digest chain (take_snapshot("
            "digests=True) required for a verified install)")
    if snap.digest_epoch != ledger.digest_epoch:
        raise SnapshotEpochError(
            "snapshot digest epoch %d vs ledger epoch %d: layouts are "
            "incomparable — finish the rolling digest upgrade first"
            % (snap.digest_epoch, ledger.digest_epoch))
    maj = ledger.majority
    verified = 0
    chain = np.asarray(snap.audit_digests)
    # one bulk ledger read for the whole chain (per-index locking would
    # contend with the readback thread for the whole walk)
    entries = ledger.digest_range(group, snap.audit_start,
                                  snap.audit_start + len(chain))
    for i, (d, ent) in enumerate(zip(chain, entries)):
        if ent is None:
            continue
        _t, dd, mask = ent
        if bin(mask).count("1") < maj:
            continue
        if int(d) != dd:
            raise SnapshotVerifyError(
                "donor digest 0x%08x contradicts the ledger majority "
                "0x%08x at absolute index %d (group %d): corrupted "
                "donor rejected at install time"
                % (int(d), dd, snap.audit_start + i, group))
        verified += 1
    if verified < int(min_verified):
        raise SnapshotVerifyError(
            "only %d of the snapshot's %d chain indices are "
            "majority-covered by the ledger (need >= %d): donor is "
            "unverifiable" % (verified, len(snap.audit_digests),
                              min_verified))
    return verified


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

    ``ledger`` (an ``AuditLedger``) makes the install DIGEST-VERIFIED:
    :func:`verify_snapshot` runs first, and a contradicting (corrupted)
    or unverifiable donor raises before any state is touched.

    A member mask with bit 31 installs as its u32 bit pattern (the JAX
    package's install raises ``OverflowError`` on such a mask)."""
    idx = _state_idx(state_b, group, r)
    if ledger is not None:
        lg = group if ledger_group is None else ledger_group
        verify_snapshot(snap, ledger, group=(lg or 0),
                        min_verified=min_verified)
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
    ``log_buf``. Copies, on the CPU too: the step updates the ring in
    place."""
    out = {"log_buf": state_b.log.buf[r].to("cpu", copy=True).numpy()}
    for k in STATE_FIELDS:
        if k == "log":
            continue
        a = getattr(state_b, k)[r].to("cpu", copy=True).numpy()
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
