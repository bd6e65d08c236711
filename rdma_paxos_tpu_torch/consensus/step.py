"""The replica step — the DARE protocol for R replicas as one batched
tensor program.

The JAX package writes the step for ONE replica against a named axis
(``lax.all_gather`` / ``psum`` across replicas, run under ``vmap`` or
``shard_map``). Here the replica axis is an explicit leading dimension:
every per-replica scalar is an ``[R]`` tensor, and each collective
becomes a read of the stacked ``[R, ...]`` tensor that every receiver
filters through its own ``peer_mask`` row (``heard [R, R]``: receiver
i, sender j). A ``psum`` is a sum over the sender dimension. The phases
and their reference mechanisms are those of
``rdma_paxos_tpu/consensus/step.py:replica_step``:

A control gather · B one-round election (removed in the stable step) ·
C leader append · D window fan-out · E term-gated absorb · CONFIG
derivation · F ack gather + quorum commit scan · G apply echo, pruning,
committed-config checkpoint. F and G's commit-crossing window search
are one call, ``ops/quorum.py:commit_window`` (one CUDA kernel that
reads the ring in place on the card).

The same function steps G independent groups of R replicas at once
(the JAX ``group_step``, there ``replica_step`` under two ``vmap`` calls):
every state and input tensor then carries a leading group axis
(``[G, R, ...]``), every cross-replica read and reduction runs over the
trailing replica axes only — no value ever crosses the group axis — and
the per-instance ring work runs on the N = G·R instances as rows. One
step of all G groups is one set of launches, with one ``commit_window``
launch over N = G·R instances.

Three optional variants add outputs and change nothing else:
``audit=True`` emits the digest chain of the committed window (one u32
:func:`digest_fold` checksum per entry of ``[commit - W, commit)``, read
by ``obs/audit.py``), ``telemetry=True`` the ``[R, T_N]`` device
counter vector (read by ``obs/device.py``), and ``txn=True`` the
``[R]`` prepare vote of the cross-group transaction lane
(``txn/lane.py``, read by ``txn/coordinator.py``). With all three off
the step launches exactly what it launched before they existed, and the
optional ``StepOutput`` fields are None.

The same function also runs ONE replica per process (the JAX step under
``shard_map`` across hosts, ``runtime/host.py``): given an ``exchange``
(``parallel/mesh.py:ReplicaWorld``), the local state is one replica
``[1, ...]``, ``me`` is the rank, ``heard`` the rank's ``peer_mask`` row
``[1, R]``, and each of the JAX step's five collectives — the control
gather, the vote gather, the window scalars, the window data (a sum of
the single leader's window under ``fanout="psum"``, a gather under
``"gather"``) and the acks — is one exchange seam (:func:`_senders`,
:func:`_window_fanout`) that returns all R senders' messages from the
local one. On the stacked path the seams are the identity (the stacked
tensors already hold every sender) and the step dispatches exactly the
ops it did before the seams existed; the choice is made in Python, not
by a tensor op.

The state is updated in place (the JAX step donates it) and returned.
The stacked step never synchronises with the host: every decision is a
tensor select, so it queues on the card without stalls. The
process-group step synchronises with the host at each exchange (the
world's collectives run on the host's gloo backend). The CONFIG full-ring
rescan is computed for every replica and selected where the cached
source entry was invalidated — the result the JAX ``lax.cond`` gives,
without a host round trip.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from rdma_paxos_tpu_torch.consensus.log import (
    EntryType, M_GIDX, M_TERM, M_TYPE, META_W, absorb_window,
    append_batch, extract_window, gather_rows, last_term, slot_of,
    term_at)
from rdma_paxos_tpu_torch.consensus.state import (
    ConfigState, ReplicaState, Role, U32_MASK)
from rdma_paxos_tpu_torch.ops.quorum import (
    I32_MIN, commit_window, lex_argmax)
from rdma_paxos_tpu_torch.txn.lane import prepare_vote

I32 = torch.int32
I32_MAX = (1 << 31) - 1

# telemetry counter-vector columns (``telemetry=True`` steps emit one
# u32 vector per replica per step; the host consumer is obs/device.py,
# which mirrors this layout and is not imported here). Counters are
# per-step counts the host accumulates; the last two are gauges.
(T_ELECTIONS, T_VOTES_GRANTED, T_VOTES_DENIED, T_ACCEPTED,
 T_COMMITTED, T_UNHEARD, T_QUORUM_W, T_HEADROOM, T_N) = range(9)

# control-gather columns
(C_TERM, C_ROLE, C_END, C_COMMIT, C_LTERM, C_APPLY, C_TMO,
 C_VTERM, C_VFOR, C_QDEP, C_HEAD, C_N) = range(12)
# window-message scalar columns
S_VALID, S_WSTART, S_WCOUNT, S_TERM, S_PREV, S_COMMIT, S_HEAD, S_N = range(8)


@dataclasses.dataclass
class StepInput:
    """Host->device inputs of one step, ``[R, ...]`` (``[G, R, ...]``
    for a group step)."""

    batch_data: torch.Tensor    # [R, B, slot_words] i32
    batch_meta: torch.Tensor    # [R, B, META_W] i32
    batch_count: torch.Tensor   # [R] i32
    timeout_fired: torch.Tensor  # [R] i32
    peer_mask: torch.Tensor     # [R, R] i32 — row i: who replica i hears
    apply_done: torch.Tensor    # [R] i32
    queue_depth: torch.Tensor   # [R] i32
    # txn=True only: each group's armed prepare watch in LOG-OFFSET
    # domain (the host subtracts its rebase total; -1 = no watch) and
    # the term it was appended under, [R] i32 each
    txn_watch: Optional[torch.Tensor] = None
    txn_term: Optional[torch.Tensor] = None


@dataclasses.dataclass
class StepOutput:
    """Device->host results of one step, ``[R]`` (``peer_acked [R,
    R]``), with the group axis in front for a group step."""

    term: torch.Tensor
    role: torch.Tensor
    leader_id: torch.Tensor
    voted_term: torch.Tensor
    voted_for: torch.Tensor
    head: torch.Tensor
    apply: torch.Tensor
    commit: torch.Tensor
    end: torch.Tensor
    hb_seen: torch.Tensor
    became_leader: torch.Tensor
    acked: torch.Tensor
    accepted: torch.Tensor
    peer_acked: torch.Tensor
    leadership_verified: torch.Tensor
    burst_hint: torch.Tensor
    rebase_delta: torch.Tensor
    # audit=True only: the first digested index [R] i32, and per entry
    # of the window [commit - W, commit) its digest (the u32 as its i32
    # bit pattern) and term, [R, W] each
    audit_start: Optional[torch.Tensor] = None
    audit_digest: Optional[torch.Tensor] = None
    audit_term: Optional[torch.Tensor] = None
    # telemetry=True only: [R, T_N] counter vector (u32 as i32 bits)
    telemetry: Optional[torch.Tensor] = None
    # txn=True only: [R] i32 prepare vote (txn/lane.py constants) for the
    # group's armed watch, against each replica's post-absorb log
    txn_vote: Optional[torch.Tensor] = None


# the fields every step emits, and those only a variant's step emits
# (None otherwise)
OUTPUT_FIELDS = tuple(f.name for f in dataclasses.fields(StepOutput)
                      if f.default is dataclasses.MISSING)
VARIANT_FIELDS = tuple(f.name for f in dataclasses.fields(StepOutput)
                       if f.default is None)


def make_step_input(cfg, n_replicas: int, *, device,
                    n_groups: Optional[int] = None) -> StepInput:
    """An idle (no client traffic, no timeout) input for R replicas (of
    each of ``n_groups`` groups, which adds the leading group axis)."""
    rs = (n_replicas,) if n_groups is None else (n_groups, n_replicas)

    def z(*shape):
        return torch.zeros(rs + shape, dtype=I32, device=device)
    return StepInput(
        batch_data=z(cfg.batch_slots, cfg.slot_words),
        batch_meta=z(cfg.batch_slots, META_W),
        batch_count=z(), timeout_fired=z(),
        peer_mask=torch.ones(rs + (n_replicas,), dtype=I32, device=device),
        apply_done=z(), queue_depth=z())


def _members(bitmask: torch.Tensor, n: int) -> torch.Tensor:
    """``[..., R] u32-in-int64`` bitmasks -> ``[..., R, n]`` 0/1 i32
    membership."""
    r = torch.arange(n, device=bitmask.device)
    return ((bitmask[..., None] >> r) & 1).to(I32)


def _u32(words: torch.Tensor) -> torch.Tensor:
    """i32 words reinterpreted as u32, held in int64."""
    return words.to(torch.int64) & U32_MASK


def _maj(members: torch.Tensor) -> torch.Tensor:
    return (members.sum(-1) // 2 + 1).to(I32)


def _pick(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per instance, ``t[i, idx[i]]`` for ``t [..., R, n, ...]`` and
    ``idx [..., R]`` (clamped >= 0), the instances as N rows."""
    N = idx.numel()
    tf = t.reshape(N, *t.shape[idx.dim():])
    r = torch.arange(N, device=t.device)
    out = tf[r, torch.clamp(idx, min=0).long().reshape(-1)]
    return out.view(*idx.shape, *out.shape[1:])


def _senders(ex, *local: torch.Tensor) -> tuple:
    """Exchange seam: every sender's copy of each local message. On the
    stacked path (``ex`` None) the stacked tensors already hold all R
    senders, so the messages come back as they are (no op dispatched);
    on the process-group path each ``[1, ...]`` message becomes the
    ``[R, ...]`` gather over the world's ranks."""
    return local if ex is None else ex.all_gather(local)


def _window_fanout(ex, fanout: str, contrib: torch.Tensor,
                   wdata: torch.Tensor, wmeta: torch.Tensor,
                   dsafe: torch.Tensor):
    """Exchange seam of the window data: per receiver, the dominant
    leader's window rows. ``"psum"`` sums the contributor-masked windows
    over the senders (exact: at most one contributes); ``"gather"``
    selects sender ``dsafe`` of the gathered windows. On the process-
    group path the sum is the world's int64 all-reduce and the gather
    its all-gather."""
    c = contrib[..., None, None]
    if fanout == "psum":
        if ex is not None:
            return ex.all_sum((wdata * c, wmeta * c))
        m_data = (wdata * c).sum(-3, dtype=torch.int64).to(I32)
        m_meta = (wmeta * c).sum(-3, dtype=torch.int64).to(I32)
        return (m_data[..., None, :, :].expand(wdata.shape),
                m_meta[..., None, :, :].expand(wmeta.shape))
    if ex is not None:
        g_data, g_meta = ex.all_gather((wdata * c, wmeta * c))
        return _from_sender(g_data, dsafe), _from_sender(g_meta, dsafe)
    return _from_sender(wdata * c, dsafe), _from_sender(wmeta * c, dsafe)


def _from_sender(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per receiver, the sender ``idx`` row of ``t``: ``out[..., i, ...]
    = t[..., idx[..., i], ...]`` for ``t [..., R, ...]`` and ``idx
    [..., R]`` (int64, >= 0) — within each group, never across."""
    d = idx.dim() - 1
    ix = idx.view(*idx.shape, *([1] * (t.dim() - idx.dim())))
    return torch.gather(t, d, ix.expand(*idx.shape, *t.shape[d + 1:]))


# the audit fold's constants (FNV-1a prime and offset basis, then a
# murmur3-style finalizer); every one is below 2**32, and the multipliers
# below 2**30, so a u32 times one of them fits in int64
FNV_PRIME = 0x01000193
FNV_BASIS = 0x811C9DC5
FIN_MUL1 = 0x2C1B3C6D
FIN_MUL2 = 0x297A2D39

_FOLD_WEIGHTS: dict = {}


def _fold_weights(n_cols: int, device) -> Tuple[torch.Tensor, torch.Tensor,
                                                int]:
    """The fold's per-column weights ``p**(n-1-k) mod 2**32`` split in
    16-bit halves (``[n_cols]`` int64 each, 0 on the gidx column) and
    the basis term ``basis * p**n mod 2**32``, ``n`` folded columns.
    Cached per width and device, so a step copies nothing to the card."""
    key = (n_cols, str(device))
    w = _FOLD_WEIGHTS.get(key)
    if w is None:
        gidx_col = n_cols - META_W + M_GIDX
        cols = [c for c in range(n_cols) if c != gidx_col]
        n = len(cols)
        pw = np.zeros(n_cols, np.int64)
        for j, c in enumerate(cols):
            pw[c] = pow(FNV_PRIME, n - 1 - j, 1 << 32)
        lo = torch.from_numpy(pw & 0xFFFF).to(device)
        hi = torch.from_numpy(pw >> 16).to(device)
        w = (lo, hi, FNV_BASIS * pow(FNV_PRIME, n, 1 << 32) % (1 << 32))
        _FOLD_WEIGHTS[key] = w
    return w


def digest_fold(rows: torch.Tensor) -> torch.Tensor:
    """The audit digest of fused slot rows ``[..., slot_words + META_W]``
    (i32 bit patterns): an FNV-1a mul-add over every column except
    M_GIDX (the i32 rollover rewrites gidx in place; position binding
    comes from the ledger's absolute index), then a murmur3-style
    finalizer so a low-order flip diffuses. Returns the u32 digests in
    int64, ``[...]``.

    Bit-equal to the JAX ``digest_fold`` (and :func:`digest_fold_np`),
    whose column loop is ``acc = acc * p + c`` mod 2**32. Unrolled, the
    accumulator before the finalizer is ``basis * p**n + sum_k c_k *
    p**(n-1-k)`` mod 2**32. With each power split as ``P = Ph * 2**16 +
    Pl``, ``c * P mod 2**32 = c * Pl + ((c * Ph) mod 2**16) * 2**16``:
    the ``c * Pl`` terms (< 2**48 each) and the shifted high halves
    (< 2**32 each) sum exactly in int64, so the whole row folds in a
    handful of launches instead of three per column. The layout version
    is ``config.DIGEST_EPOCH``; bump it whenever this fold changes."""
    lo_w, hi_w, base = _fold_weights(rows.shape[-1], rows.device)
    u = rows.to(torch.int64) & U32_MASK
    acc = ((u * lo_w).sum(-1) + (((u * hi_w) & 0xFFFF) << 16).sum(-1)
           + base) & U32_MASK
    acc = acc ^ (acc >> 15)
    acc = (acc * FIN_MUL1) & U32_MASK
    acc = acc ^ (acc >> 12)
    acc = (acc * FIN_MUL2) & U32_MASK
    return acc ^ (acc >> 15)


def digest_fold_np(rows: np.ndarray) -> np.ndarray:
    """The host form of :func:`digest_fold`: the reference's column
    loop in numpy u32 arithmetic (``rows [N, slot_words + META_W]``, any
    integer dtype, taken as u32 bit patterns) -> ``[N]`` u32. Used by
    the host-side snapshot code in ``consensus/snapshot.py`` for a
    snapshot's digest chain, and by the tests as an independent check
    of the device form."""
    rows = np.asarray(rows).astype(np.uint32)
    u32 = np.uint32
    acc = np.full((rows.shape[0],), FNV_BASIS, u32)
    gidx_col = rows.shape[1] - META_W + M_GIDX
    for c in range(rows.shape[1]):
        if c != gidx_col:
            acc = acc * u32(FNV_PRIME) + rows[:, c]
    acc = acc ^ (acc >> u32(15))
    acc = acc * u32(FIN_MUL1)
    acc = acc ^ (acc >> u32(12))
    acc = acc * u32(FIN_MUL2)
    return acc ^ (acc >> u32(15))


def build_redigest(cfg, *, window_slots: int):
    """``fn(buf_row, start) -> (digests, terms, gidx)``: the audit fold
    over ``[start, start + window_slots)`` of ONE replica's fused ring
    row ``[n_slots, cols]`` — the backfill pass that returns a range to
    audited coverage after a re-install. Exactly the ``audit=`` window
    fold, so backfilled digests compare with live windows. All three
    results are ``[window_slots]`` i32 (the digests as u32 bit
    patterns); the caller checks the stamped gidx column against the
    expected indices and clips to the committed range."""
    W = int(window_slots)
    sw = cfg.slot_words

    def fn(buf_row: torch.Tensor, start: int):
        g = int(start) + torch.arange(W, dtype=I32, device=buf_row.device)
        rows = buf_row[slot_of(g, cfg.n_slots).long()]
        return (digest_fold(rows).to(I32), rows[:, sw + M_TERM],
                rows[:, sw + M_GIDX])
    return fn


def replica_step(state: ReplicaState, inp: StepInput, *, cfg,
                 n_replicas: int, fanout: str = "gather",
                 elections: bool = True, audit: bool = False,
                 telemetry: bool = False, txn: bool = False,
                 exchange=None) -> Tuple[ReplicaState, StepOutput]:
    """One protocol step of all R replicas (see the module docstring),
    or with ``exchange`` (a ``parallel/mesh.py:ReplicaWorld``) of this
    process's one replica, ``state`` and ``inp`` shaped ``[1, ...]``.

    ``fanout="gather"`` selects the dominant leader's window row per
    receiver (split-brain safe under partitions); ``"psum"`` sums the
    leader windows over senders, sound only under full connectivity.
    ``elections=False`` is the stable step: Phase B removed, identical
    results whenever no election timer fired. ``audit=``,
    ``telemetry=`` and ``txn=`` add their optional outputs (see the
    module docstring)."""
    if fanout not in ("gather", "psum"):
        raise ValueError(f"unknown fanout {fanout!r}")
    R, W = n_replicas, cfg.window_slots
    dev = state.term.device
    rs = tuple(state.term.shape)                 # [R], or [G, R]
    log = state.log
    ex = exchange
    if ex is None:
        me = torch.arange(R, dtype=I32, device=dev)
        peer = me[None, :]                                 # sender index
    else:
        me, peer = ex.me, ex.peer          # [1] the rank, [1, R] senders
    eye = me[:, None] == peer
    heard = inp.peer_mask.bool()          # [..., R, R] (process: [1, R])

    def diag(t):
        """Each receiver's own entry of a ``[..., receiver, sender]``
        matrix."""
        if ex is None:
            return t.diagonal(dim1=-2, dim2=-1)
        return t[..., ex.rank]

    in_new = _members(state.bitmask_new, R)                # [..., R, R]
    in_old = _members(state.bitmask_old, R)
    transit = (state.cid_state == int(ConfigState.TRANSIT)).to(I32)
    ext = state.cid_state == int(ConfigState.EXTENDED)
    in_vote = torch.where(ext[..., None], in_old, in_new)
    maj_vote = _maj(in_vote)
    maj_old = _maj(in_old)
    i_member = (diag(in_vote) > 0) | ((transit > 0) & (diag(in_old) > 0))
    my_lterm = last_term(log, state.end)

    # ---- Phase A: control gather (every receiver reads the senders) ----
    (g_term, g_role, g_end, g_lterm, g_apply, g_tmo, g_vterm, g_vfor,
     g_qdep, g_head) = _senders(
        ex, state.term, state.role, state.end, my_lterm,
        torch.minimum(inp.apply_done, state.commit), inp.timeout_fired,
        state.voted_term, state.voted_for, inp.queue_depth, state.head)
    rec_upd0 = heard & (g_vterm[..., None, :] > state.vote_rec_term)
    vote_rec_term1 = torch.where(rec_upd0, g_vterm[..., None, :],
                                 state.vote_rec_term)
    vote_rec_for1 = torch.where(rec_upd0, g_vfor[..., None, :],
                                state.vote_rec_for)

    # ---- Phase B: one-round election ----
    if not elections:
        new_voted_term, new_voted_for = state.voted_term, state.voted_for
        vote_rec_term2, vote_rec_for2 = vote_rec_term1, vote_rec_for1
        became = torch.zeros(rs, dtype=torch.bool, device=dev)
        max_heard = torch.where(heard, g_term[..., None, :],
                                I32_MIN).max(-1).values
        new_term = torch.maximum(state.term, max_heard)
        role = torch.where(new_term > state.term, int(Role.FOLLOWER),
                           state.role).to(I32)
        i_lead = role == int(Role.LEADER)
        leader_id = torch.where(new_term > state.term, -1,
                                state.leader_id).to(I32)
        end1 = state.end
        log2, end2 = append_batch(
            log, state.end, state.head, inp.batch_data, inp.batch_meta,
            torch.where(i_lead, inp.batch_count, 0).to(I32), new_term)
    else:
        is_cand = (g_tmo > 0)[..., None, :] & (in_vote > 0)
        cand_term = g_term + 1                             # [R] by sender
        i_cand = diag(is_cand) & (state.role != int(Role.LEADER))
        can_grant = (
            heard & is_cand
            & (cand_term[..., None, :] >= state.term[..., :, None])
            & ((cand_term[..., None, :] > state.voted_term[..., :, None])
               | ((cand_term[..., None, :] == state.voted_term[..., :, None])
                  & (peer == state.voted_for[..., :, None])))
            & ((g_lterm[..., None, :] > my_lterm[..., :, None])
               | ((g_lterm[..., None, :] == my_lterm[..., :, None])
                  & (g_end[..., None, :] >= state.end[..., :, None]))))
        keys = [k[..., None, :].expand(heard.shape)
                for k in (cand_term, g_lterm, g_end)]
        best = lex_argmax(can_grant, keys)
        my_vote = torch.where(i_cand, me,
                              torch.where(i_member, best, -1)).to(I32)
        vote_cast = my_vote >= 0
        new_voted_term = torch.where(
            vote_cast,
            torch.maximum(state.voted_term, _from_sender(
                cand_term, torch.clamp(my_vote, min=0).long())),
            state.voted_term)
        new_voted_for = torch.where(vote_cast, my_vote, state.voted_for)

        # the vote gather
        v_vote, v_vterm, v_vfor = _senders(ex, my_vote, new_voted_term,
                                           new_voted_for)
        got = (v_vote[..., None, :] == me[:, None]) & heard
        rec_upd = heard & (v_vterm[..., None, :] > vote_rec_term1)
        vote_rec_term2 = torch.where(rec_upd, v_vterm[..., None, :],
                                     vote_rec_term1)
        vote_rec_for2 = torch.where(rec_upd, v_vfor[..., None, :],
                                    vote_rec_for1)
        got_i = got.to(I32)
        win = (i_cand & ((got_i * in_vote).sum(-1) >= maj_vote)
               & torch.where(transit > 0,
                             (got_i * in_old).sum(-1) >= maj_old, True))

        my_term1 = torch.where(i_cand, state.term + 1, state.term)
        eff_term = torch.where(is_cand, cand_term[..., None, :],
                               g_term[..., None, :])
        max_heard = torch.where(heard, eff_term, I32_MIN).max(-1).values
        new_term = torch.maximum(my_term1, max_heard)
        role = torch.where(
            win, int(Role.LEADER),
            torch.where(new_term > my_term1, int(Role.FOLLOWER),
                        torch.where(i_cand, int(Role.CANDIDATE),
                                    state.role))).to(I32)
        became = win & (state.role != int(Role.LEADER))
        i_lead = role == int(Role.LEADER)
        leader_id = torch.where(
            win, me, torch.where(new_term > state.term, -1,
                                 state.leader_id)).to(I32)

        # ---- Phase C: leader append (NOOP on election, then batch) ----
        noop_data = torch.zeros(rs + (1, cfg.slot_words), dtype=I32,
                                device=dev)
        noop_meta = torch.zeros(rs + (1, META_W), dtype=I32, device=dev)
        noop_meta[..., M_TYPE] = int(EntryType.NOOP)
        log1, end1 = append_batch(log, state.end, state.head, noop_data,
                                  noop_meta, became.to(I32), new_term)
        log2, end2 = append_batch(
            log1, end1, state.head, inp.batch_data, inp.batch_meta,
            torch.where(i_lead, inp.batch_count, 0).to(I32), new_term)

    # ---- Phase D: leader fan-out ----
    others = heard & (in_new > 0) & ~eye
    min_end = torch.where(others, g_end[..., None, :], I32_MAX
                          ).min(-1).values
    wstart = torch.minimum(torch.maximum(min_end, end2 - W), end2)
    wstart = torch.clamp(torch.maximum(wstart, state.head), min=0)
    wcount = torch.clamp(end2 - wstart, 0, W).to(I32)
    wdata, wmeta = extract_window(log2, wstart, W)
    prev_term = torch.where(wstart > 0, term_at(log2, wstart - 1), 0)
    min_apply = torch.where(heard & (in_new > 0), g_apply[..., None, :],
                            I32_MAX).min(-1).values

    contrib = i_lead.to(I32)
    msg_scal = torch.stack([
        torch.ones_like(wstart), wstart, wcount, new_term, prev_term,
        state.commit, state.head], dim=-1) * contrib[..., None]  # [R, S_N]
    (g_scal,) = _senders(ex, msg_scal)        # the window-scalar gather
    claim = heard & (g_scal[..., None, :, S_VALID] > 0)
    dom = lex_argmax(claim,
                     [g_scal[..., None, :, S_TERM].expand(heard.shape)])
    has_msg = dom >= 0
    dsafe = torch.clamp(dom, min=0).long()
    m_scal = _from_sender(g_scal, dsafe)                   # [R, S_N]
    m_term = m_scal[..., S_TERM]
    m_data, m_meta = _window_fanout(ex, fanout, contrib, wdata, wmeta,
                                    dsafe)

    # ---- Phase E: term-gated absorb ----
    use = has_msg & (m_scal[..., S_VALID] > 0) & (m_term >= new_term)
    new_term2 = torch.where(use, torch.maximum(new_term, m_term), new_term)
    role2 = torch.where(
        use & ((m_term > new_term) | (dom != me)),
        torch.where(i_lead & (dom == me), role, int(Role.FOLLOWER)),
        role).to(I32)
    leader_id2 = torch.where(use, dom, leader_id)
    i_lead2 = role2 == int(Role.LEADER)

    m_wstart, m_wcount = m_scal[..., S_WSTART], m_scal[..., S_WCOUNT]
    gap = m_wstart > end2
    local_prev = torch.where(m_wstart > 0, term_at(log2, m_wstart - 1), 0)
    prev_ok = (m_wstart == 0) | (local_prev == m_scal[..., S_PREV])
    can_absorb = use & ~gap & prev_ok
    log3, end3 = absorb_window(log2, end2, m_data, m_meta, m_wstart,
                               torch.where(can_absorb, m_wcount, 0))
    end3 = torch.where(use & ~gap & ~prev_ok,
                       torch.maximum(m_wstart - 1, state.commit), end3)
    commit1 = torch.where(
        can_absorb & ~i_lead2,
        torch.maximum(state.commit,
                      torch.minimum(torch.minimum(m_scal[..., S_COMMIT], end3),
                                    state.commit + W)),
        state.commit)
    head1 = torch.where(
        can_absorb,
        torch.maximum(state.head, torch.minimum(m_scal[..., S_HEAD], commit1)),
        state.head)

    # ---- CONFIG derivation (latest CONFIG in the log, else checkpoint) ----
    sw = log3.slot_words
    wend_abs = m_wstart + m_wcount
    stale_src = state.cfg_src >= end3
    wp = torch.clamp(state.cfg_src - m_wstart, 0, W - 1)
    wp_meta = _pick(m_meta, wp)
    same_entry = ((wp_meta[..., M_GIDX] == state.cfg_src)
                  & (wp_meta[..., M_TYPE] == int(EntryType.CONFIG))
                  & (wp_meta[..., M_TERM] == state.cfg_src_term))
    replaced = (can_absorb & (state.cfg_src >= m_wstart)
                & (state.cfg_src < wend_abs) & ~same_entry)
    cfg_invalid = (state.cfg_src >= 0) & (stale_src | replaced)

    all_meta = log3.meta
    all_gidx = all_meta[..., M_GIDX]                       # [R, n_slots]
    live = ((all_meta[..., M_TYPE] == int(EntryType.CONFIG))
            & (all_gidx >= head1[..., None]) & (all_gidx < end3[..., None]))
    pos = lex_argmax(live, [all_gidx])
    found = pos >= 0
    rw = _pick(log3.buf, pos)                              # [R, cols]
    base_src = torch.where(
        cfg_invalid, torch.where(found, rw[..., sw + M_GIDX], -1),
        state.cfg_src)
    base_sterm = torch.where(
        cfg_invalid, torch.where(found, rw[..., sw + M_TERM], 0),
        state.cfg_src_term)
    base_old = torch.where(
        cfg_invalid, torch.where(found, _u32(rw[..., 0]), state.ccfg_old),
        state.bitmask_old)
    base_new = torch.where(
        cfg_invalid, torch.where(found, _u32(rw[..., 1]), state.ccfg_new),
        state.bitmask_new)
    base_cid = torch.where(
        cfg_invalid, torch.where(found, rw[..., 2], state.ccfg_cid),
        state.cid_state)
    base_epoch = torch.where(
        cfg_invalid, torch.where(found, rw[..., 3], state.ccfg_epoch),
        state.epoch)

    # newest CONFIG in the absorbed window
    w_offs = torch.arange(W, dtype=I32, device=dev)
    w_gidx = m_wstart[..., None] + w_offs
    w_is_cfg = (can_absorb[..., None] & (w_offs < m_wcount[..., None])
                & (m_meta[..., M_TYPE] == int(EntryType.CONFIG))
                & (m_meta[..., M_GIDX] == w_gidx)
                & (w_gidx >= head1[..., None]) & (w_gidx < end3[..., None]))
    wpos = lex_argmax(w_is_cfg, [w_gidx])
    w_words = _pick(m_data, wpos)
    w_src = torch.where(wpos >= 0, m_wstart + wpos, -1)
    w_term = _pick(m_meta, wpos)[..., M_TERM]

    # newest CONFIG in the just-appended batch
    Bn = inp.batch_meta.shape[-2]
    b_offs = torch.arange(Bn, dtype=I32, device=dev)
    b_is_cfg = ((b_offs < (end2 - end1)[..., None])
                & (inp.batch_meta[..., M_TYPE] == int(EntryType.CONFIG))
                & ((end1[..., None] + b_offs) < end3[..., None]))
    bpos = lex_argmax(b_is_cfg, [b_offs.expand(b_is_cfg.shape)])
    b_words = _pick(inp.batch_data, bpos)
    b_src = torch.where(bpos >= 0, end1 + bpos, -1)

    cand_src = torch.stack([base_src, w_src, b_src], -1).to(I32)
    cand_sterm = torch.stack([
        base_sterm, torch.where(wpos >= 0, w_term, 0),
        torch.where(bpos >= 0, new_term, 0)], -1).to(I32)
    pick = torch.clamp(
        lex_argmax(cand_src >= -1, [cand_src, cand_sterm]), min=0)
    cfg_src2 = _pick(cand_src, pick)
    cfg_src_term2 = _pick(cand_sterm, pick)
    bm_old2 = _pick(torch.stack([base_old, _u32(w_words[..., 0]),
                                 _u32(b_words[..., 0])], -1), pick)
    bm_new2 = _pick(torch.stack([base_new, _u32(w_words[..., 1]),
                                 _u32(b_words[..., 1])], -1), pick)
    cid2 = _pick(torch.stack([base_cid, w_words[..., 2], b_words[..., 2]],
                             -1), pick)
    epoch2 = _pick(torch.stack([base_epoch, w_words[..., 3],
                                b_words[..., 3]], -1), pick)
    in_new2 = _members(bm_new2, R)
    in_old2 = _members(bm_old2, R)
    maj_old2 = _maj(in_old2)
    transit2 = (cid2 == int(ConfigState.TRANSIT)).to(I32)
    q_mask2 = torch.where(cid2 == int(ConfigState.EXTENDED), bm_old2,
                          bm_new2)
    in_q2 = _members(q_mask2, R)
    maj_q2 = _maj(in_q2)

    # ---- Phase F: ack gather + quorum commit scan, with Phase G's
    # commit-crossing CONFIG search over the same window rows (one
    # kernel launch on the card: ops/quorum.py:commit_window, over the
    # N = G·R instances as rows; the ring goes in as a view) ----
    my_ack = torch.where(can_absorb, m_wstart + m_wcount, 0).to(I32)
    ack_dom = torch.where(can_absorb, dom, -1)
    g_ack, g_dom = _senders(ex, my_ack, ack_dom)          # the ack gather
    peer_acked = heard & (g_dom[..., None, :] == me[:, None])  # [R, R]

    def flat(t):
        return t.reshape(-1)
    commit2, xpos = commit_window(
        log3.buf.view(-1, cfg.n_slots, log3.buf.shape[-1]),
        peer_acked.reshape(-1, R), flat(g_ack), w=W,
        commit=flat(state.commit), my_term=flat(new_term2),
        my_end=flat(end3), bm_old=flat(bm_old2), bm_new=flat(q_mask2),
        transit=flat(transit2), maj_old=flat(maj_old2),
        maj_new=flat(maj_q2), i_lead=flat(i_lead2), commit1=flat(commit1))
    commit2, xpos = commit2.view(rs), xpos.view(rs)

    # ---- Phase G: apply echo, pruning, committed-config checkpoint ----
    apply2 = torch.minimum(torch.maximum(
        torch.maximum(state.apply, inp.apply_done), head1), commit2)
    pressure = (end3 - head1) > (3 * cfg.n_slots) // 4
    head2 = torch.where(
        i_lead2 & pressure,
        torch.minimum(torch.maximum(torch.maximum(head1, min_apply), head1),
                      apply2),
        head1)
    hard = (end3 - head1) > (7 * cfg.n_slots) // 8
    head2 = torch.where(i_lead2 & hard, torch.maximum(head2, apply2), head2)

    xw = gather_rows(log3.buf, (state.commit + torch.clamp(xpos, min=0)
                                )[..., None])[..., 0, :]
    newer = (xpos >= 0) & (xw[..., 3] > state.ccfg_epoch)
    cc1_old = torch.where(newer, _u32(xw[..., 0]), state.ccfg_old)
    cc1_new = torch.where(newer, _u32(xw[..., 1]), state.ccfg_new)
    cc1_cid = torch.where(newer, xw[..., 2], state.ccfg_cid)
    cc1_epoch = torch.where(newer, xw[..., 3], state.ccfg_epoch)
    promote = (cfg_src2 >= 0) & (cfg_src2 < commit2) & (epoch2 > cc1_epoch)

    pa = peer_acked.to(I32)

    # ---- audit: one digest per entry of [commit2 - W, commit2) ----
    # Commit advances at most W per step, so consecutive windows tile
    # the committed prefix, and each entry is re-digested while it stays
    # in the window (the ledger re-checks a replica's own reports, which
    # catches post-commit corruption). Entries below head are masked:
    # their slots may be recycled. Gathered from the ring as this step
    # leaves it, before the next step appends in place.
    audit_start = audit_digest = audit_term = None
    if audit:
        a_g = (commit2 - W)[..., None] + torch.arange(W, dtype=I32,
                                                      device=dev)
        audit_start = torch.clamp(torch.maximum(commit2 - W, head2),
                                  min=0).to(I32)
        a_valid = a_g >= audit_start[..., None]
        a_rows = gather_rows(log3.buf, a_g)                # [R, W, cols]
        audit_digest = torch.where(a_valid, digest_fold(a_rows).to(I32), 0)
        audit_term = torch.where(a_valid, a_rows[..., sw + M_TERM], 0)

    # ---- telemetry: the [R, T_N] counter vector, from scalars the step
    # already holds (no ring reads) ----
    telemetry_vec = None
    if telemetry:
        if elections:
            t_elec = i_cand.to(I32)
            # granted: voted for ANOTHER replica's candidacy; denied:
            # heard candidacies (own excluded) that did not get the vote
            t_grant = (vote_cast & (my_vote != me)).to(I32)
            n_cand = (is_cand & heard).to(I32).sum(-1)
            t_deny = torch.clamp(n_cand - t_elec - t_grant, min=0)
        else:
            t_elec = t_grant = t_deny = torch.zeros(rs, dtype=I32,
                                                    device=dev)
        telemetry_vec = torch.stack([c.to(I32) for c in (
            t_elec, t_grant, t_deny, end2 - end1, commit2 - state.commit,
            R - heard.sum(-1), pa.sum(-1),
            (cfg.n_slots - 1) - (end3 - head2))], -1)

    # ---- txn: each replica's vote on its group's armed prepare watch,
    # read from its own post-absorb log (one row per instance; the row of
    # an unarmed watch, -1, is gathered at offset 0 and masked) ----
    txn_vote = None
    if txn:
        t_w = (inp.txn_watch if inp.txn_watch is not None
               else torch.full(rs, -1, dtype=I32, device=dev))
        t_wt = (inp.txn_term if inp.txn_term is not None
                else torch.zeros(rs, dtype=I32, device=dev))
        t_row = gather_rows(log3.buf, torch.clamp(t_w, min=0)[..., None]
                            )[..., 0, :]
        txn_vote = prepare_vote(
            watch=t_w, watch_term=t_wt, head=head2, commit=commit2,
            entry_term=t_row[..., sw + M_TERM],
            entry_gidx=t_row[..., sw + M_GIDX])

    new_state = ReplicaState(
        log=log3, term=new_term2, role=role2, leader_id=leader_id2,
        voted_term=new_voted_term, voted_for=new_voted_for,
        vote_rec_term=vote_rec_term2, vote_rec_for=vote_rec_for2,
        head=head2, apply=apply2, commit=commit2, end=end3,
        cid_state=cid2, bitmask_old=bm_old2, bitmask_new=bm_new2,
        epoch=epoch2, cfg_src=cfg_src2, cfg_src_term=cfg_src_term2,
        ccfg_old=torch.where(promote, bm_old2, cc1_old),
        ccfg_new=torch.where(promote, bm_new2, cc1_new),
        ccfg_cid=torch.where(promote, cid2, cc1_cid),
        ccfg_epoch=torch.where(promote, epoch2, cc1_epoch),
    )
    is_leader_row = g_role[..., None, :] == int(Role.LEADER)
    max_end = torch.where(heard, g_end[..., None, :], 0).max(-1).values
    min_head = torch.where(heard, g_head[..., None, :], I32_MAX
                           ).min(-1).values
    out = StepOutput(
        term=new_term2, role=role2, leader_id=leader_id2,
        voted_term=new_voted_term, voted_for=new_voted_for,
        head=head2, apply=apply2, commit=commit2, end=end3,
        hb_seen=(has_msg & use).to(I32),
        became_leader=became.to(I32),
        acked=can_absorb.to(I32),
        accepted=(end2 - end1).to(I32),
        peer_acked=pa,
        leadership_verified=(
            i_lead2 & ((pa * in_q2).sum(-1) >= maj_q2)
            & ((transit2 <= 0) | ((pa * in_old2).sum(-1) >= maj_old2))
        ).to(I32),
        burst_hint=torch.where(heard & is_leader_row,
                               g_qdep[..., None, :], 0
                               ).max(-1).values.to(I32),
        rebase_delta=torch.where(
            max_end >= cfg.rebase_threshold,
            torch.clamp(min_head & ~(cfg.n_slots - 1), min=0), 0).to(I32),
        audit_start=audit_start, audit_digest=audit_digest,
        audit_term=audit_term, telemetry=telemetry_vec, txn_vote=txn_vote,
    )
    return new_state, out


def group_step(*, cfg, n_replicas: int, fanout: str = "gather",
               elections: bool = True, audit: bool = False,
               telemetry: bool = False, txn: bool = False):
    """The group-batched protocol step: ``fn(state, inp) -> (state,
    out)`` advances G independent consensus groups of R replicas, every
    tensor shaped ``[G, R, ...]``, in one pass of :func:`replica_step`.
    No value crosses the group axis; the ring work runs on the N = G·R
    instances as rows, with one ``commit_window`` launch over all N per
    step. G is not bound: any stack of groups sharing ``cfg`` runs
    through the same function.

    Unlike the JAX ``group_step`` it takes no ``axis_name``,
    ``use_pallas`` or ``interpret``: the replica axis is a tensor
    dimension, and the tensors' device picks the route —
    ``commit_window``'s CUDA kernel for CUDA tensors, its plain version
    for CPU tensors, never one in place of the other."""
    if fanout not in ("gather", "psum"):
        raise ValueError(f"unknown fanout {fanout!r}")

    def fn(state: ReplicaState, inp: StepInput
           ) -> Tuple[ReplicaState, StepOutput]:
        if state.term.dim() != 2 or state.term.shape[1] != n_replicas:
            raise ValueError(
                f"group_step takes [G, {n_replicas}, ...] tensors, got a "
                f"state of shape {tuple(state.term.shape)}")
        return replica_step(state, inp, cfg=cfg, n_replicas=n_replicas,
                            fanout=fanout, elections=elections,
                            audit=audit, telemetry=telemetry, txn=txn)
    return fn


# per-replica scalar outputs the host rules consume, packed into ONE
# [..., len(SCAN_KEYS)] i32 matrix; ``accepted`` is cumulative across a
# scan. Order is part of the host contract — append only.
SCAN_KEYS = ("term", "role", "leader_id", "voted_term", "voted_for",
             "head", "apply", "commit", "end", "hb_seen",
             "became_leader", "acked", "accepted",
             "leadership_verified", "rebase_delta", "burst_hint")


def scan_scalars(out: StepOutput, accepted_total: torch.Tensor
                 ) -> torch.Tensor:
    """Stack one step's :data:`SCAN_KEYS` outputs along a trailing axis,
    with the cumulative ``accepted_total`` in the ``accepted`` column."""
    return torch.stack([
        (accepted_total if k == "accepted" else getattr(out, k)).to(I32)
        for k in SCAN_KEYS], dim=-1)


def scan_readback(out: StepOutput, accepted_total: torch.Tensor, *,
                  audit: bool = False, telemetry: bool = False) -> dict:
    """One scan step's readback dict: the scalar matrix + ``peer_acked``,
    plus the step's audit windows (with its commit as ``audit_commit``)
    and telemetry vector only when those variants are on."""
    ys = dict(scal=scan_scalars(out, accepted_total),
              peer_acked=out.peer_acked)
    if audit:
        ys.update(audit_start=out.audit_start,
                  audit_digest=out.audit_digest,
                  audit_term=out.audit_term, audit_commit=out.commit)
    if telemetry:
        ys["telemetry"] = out.telemetry
    return ys


def fetch_window(log, start: torch.Tensor, *, window_slots: int):
    """Host helper: ``window_slots`` entries from ``start [..., R]`` of
    every replica's log (every group's) — newly committed payloads for
    replay."""
    return extract_window(log, start, window_slots)
