"""Epoch machinery shared by the txn coordinator and topology.

The port's copy of the JAX package's ``topology/epoch.py`` (host-only,
numpy; ``tests/test_torch_hygiene.py`` pins its constants against the
reference). A host-side actor submits records to a replicated log and
must prove they COMMITTED, knowing that any leader change between
append and proof can silently overwrite the suffix the record sat on
("Reconfigurable Atomic Transaction Commit", arXiv:1906.01365). This
module holds those rules: deposition detection via per-group last-seen
terms, record-term completion proofs, forget-and-retry under the same
exactly-once stamp, and the epoch counter topology fences its cutovers
with. Two users share them: the transaction coordinator
(``txn/coordinator.py``) and the topology controller
(``topology/transition.py``).
"""

from __future__ import annotations

from typing import List

# Completion status of one stamped record placement
# (:func:`placement_status`).
PENDING = "pending"            # not yet provably committed — keep waiting
COMPLETE = "complete"          # committed under the append term: durable
INVALIDATED = "invalidated"    # append term deposed: forget, retry stamp

# Retry patience (steps) before a submitted-but-unplaced record is
# resubmitted — covers a deposed/mis-hinted leader that dropped the
# submission (per-stamp dedup keeps every retry exactly-once).
RETRY_STEPS = 4


def commit_frontier(res, rebased_total) -> List[int]:
    """Per-group ABSOLUTE commit frontier from one step's outputs
    (max over replicas — commit indices are quorum facts, any
    replica's is valid), rebase-corrected into the absolute domain."""
    import numpy as np
    commit = np.asarray(res["commit"])
    return [int(commit[g].max()) + int(rebased_total[g])
            for g in range(commit.shape[0])]


def term_now(res) -> List[int]:
    """Per-group current term from one step's outputs (max over
    replicas — terms only advance, so the max is the freshest)."""
    import numpy as np
    term = np.asarray(res["term"])
    return [int(term[g].max()) for g in range(term.shape[0])]


def placement_status(index: int, wterm: int, commit_abs_g: int,
                     term_now_g: int) -> str:
    """Completion rule for ONE stamped record whose append was
    observed at absolute ``index`` under term ``wterm`` (``index < 0``
    = submitted, placement not yet seen).

    * ``COMPLETE`` — the group's commit frontier passed the index
      while the append term still rules: majority-replicated under an
      unchanged leadership, nothing can have overwritten it.
    * ``INVALIDATED`` — the term advanced past ``wterm``: the append
      may sit on a deposed leader's overwritten suffix, so a later
      frontier past its index proves NOTHING. The caller must forget
      the placement and retry under the SAME stamp — if the record
      DID commit, dedup makes the retry a no-op.
    * ``PENDING`` — otherwise (including ``index < 0``).
    """
    if index < 0:
        return PENDING
    if index < commit_abs_g and term_now_g == wterm:
        return COMPLETE
    if term_now_g > wterm:
        return INVALIDATED
    return PENDING


class TermWatch:
    """Per-group deposition detector: remember the max term each
    group's in-flight appends were observed under; a current term
    above it means the leadership that accepted them is gone and
    un-committed appends may be overwritten.

    Pure bookkeeping — the OWNER's lock guards it (both users mutate
    only under their coordinator/controller lock)."""

    def __init__(self, n_groups: int):
        self._seen = [0] * int(n_groups)

    def reset(self, g: int) -> None:
        """Forget ``g`` — call when a fresh batch of appends goes out
        (the watch is per-batch, not per-lifetime)."""
        self._seen[g] = 0

    def note(self, g: int, term: int) -> None:
        """An append on ``g`` was observed under ``term``."""
        self._seen[g] = max(self._seen[g], int(term))

    def seen(self, g: int) -> int:
        return self._seen[g]

    def deposed(self, g: int, term_now_g: int) -> bool:
        """True iff ``g`` accepted appends under some term and its
        current term has advanced past it. Zero ``seen`` (nothing
        appended yet / just reset) never reports deposition."""
        return bool(self._seen[g]) and int(term_now_g) > self._seen[g]


class EpochClock:
    """The topology epoch: a monotone counter bumped at every cutover
    (in lock-step with ``KeyRouter.version``). Routing decisions and
    txn admissions carry the epoch they were made under; a mismatch at
    a later fence is the deterministic "the world moved" signal.

    Pure bookkeeping — the owning controller's lock guards bumps."""

    def __init__(self, start: int = 0):
        self._epoch = int(start)

    def current(self) -> int:
        return self._epoch

    def bump(self) -> int:
        self._epoch += 1
        return self._epoch
