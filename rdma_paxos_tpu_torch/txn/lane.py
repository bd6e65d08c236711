"""Device-side commit lane of the cross-group transaction subsystem.

The port of the JAX package's ``txn/lane.py``. The host 2PC coordinator
(``txn/coordinator.py``) appends one PREPARE record per participant
group and then needs each group's verdict: did the prepare become
durable under the term it was appended in, or did a leader change
overwrite it? All G groups advance in one pass of the step, so the
verdict is computed inside that pass: each replica evaluates its
group's watch ``(index, term)`` against its own post-absorb log and
reports a small vote scalar, and the coordinator reads the stacked
``[G, R]`` vote matrix from the same readback that reports the
replication of the prepares.

Plain PyTorch on the step's tensors (the reference's lane is jnp, not
a Pallas kernel); it is the only txn module ``consensus/step.py``
imports.
"""

from __future__ import annotations

import torch

# Prepare-vote values, reported per (group, replica) by the ``txn=``
# step variant. The coordinator treats CONFLICT as dominant, then
# PREPARED, else PENDING (NONE rows carry no watch).
TXN_NONE = 0       # no watch armed for this group
TXN_PENDING = 1    # prepare appended but not yet committed
TXN_PREPARED = 2   # prepare durable: committed under the watched term
TXN_CONFLICT = 3   # index committed under a DIFFERENT term (the
                   # prepare was overwritten by a failover leader)


def prepare_vote(*, watch: torch.Tensor, watch_term: torch.Tensor,
                 head: torch.Tensor, commit: torch.Tensor,
                 entry_term: torch.Tensor,
                 entry_gidx: torch.Tensor) -> torch.Tensor:
    """Each replica's prepare vote for its group's armed watch, on
    tensors of any common shape (``[R]`` or ``[G, R]``).

    ``watch`` is the prepare entry's log offset (-1 = no watch armed);
    ``entry_term``/``entry_gidx`` are the meta columns of the slot the
    watch maps to in each replica's post-absorb log. A watch below the
    prune head votes PREPARED: pruning follows the host apply cursor,
    so a pruned index was committed and replayed — and the state-
    machine fold's per-tid record check is the backstop for the
    (coordinator-abort-covered) case where a failover overwrote the
    index before it committed.
    """
    committed = watch < commit
    vote = torch.where(
        watch < head, TXN_PREPARED,
        torch.where(
            (entry_gidx == watch) & (entry_term == watch_term) & committed,
            TXN_PREPARED,
            torch.where(committed, TXN_CONFLICT, TXN_PENDING)))
    return torch.where(watch < 0, TXN_NONE, vote).to(torch.int32)
