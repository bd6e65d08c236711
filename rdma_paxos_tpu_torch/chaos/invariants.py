"""The I1–I5 protocol safety invariants — one implementation, shared.

The port's copy of the JAX package's ``chaos/invariants.py`` (standard library
and numpy only).

The nemesis runner and any other harness check the SAME properties:

  I1 (committed-prefix agreement): all replicas agree on entries below
      their commit indices — byte-for-byte identical replay streams.
  I2 (commit monotonicity): no replica's commit index ever regresses
      *within one process incarnation* (a crash-restart legitimately
      resumes from the stable prefix; callers report restarts via
      :meth:`InvariantChecker.reset_replica`).
  I3 (durability): once ANY replica commits index k, the entries below
      k never change on any replica that subsequently commits past k.
  I4 (single leader per term): two replicas never claim leadership in
      the same term.
  I5 (offset chain): head <= apply <= commit <= end on every replica.

Violations raise :class:`InvariantViolation` carrying enough structure
(invariant id, replica, step, detail) for the caller to dump a
reproducer artifact and surface the path in its assertion message.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from rdma_paxos_tpu_torch.consensus.state import Role


class InvariantViolation(AssertionError):
    """A protocol safety invariant failed."""

    def __init__(self, invariant: str, detail: str, *,
                 replica: Optional[int] = None,
                 step: Optional[int] = None):
        self.invariant = invariant
        self.replica = replica
        self.step = step
        self.detail = detail
        where = []
        if step is not None:
            where.append(f"step {step}")
        if replica is not None:
            where.append(f"replica {replica}")
        loc = f" ({', '.join(where)})" if where else ""
        super().__init__(f"{invariant} violated{loc}: {detail}")

    def as_dict(self) -> dict:
        return dict(invariant=self.invariant, replica=self.replica,
                    step=self.step, detail=self.detail)


class InvariantChecker:
    """Stateful per-run checker: feed every step's outputs through
    :meth:`check_step`; run :meth:`check_convergence` over the replay
    streams after the cluster settles (the I1/I3 witness is the full
    replayed prefix, so agreement is checked once streams stop
    moving — exactly as the original fuzzer did)."""

    def __init__(self, n_replicas: int):
        self.R = int(n_replicas)
        self.prev_commit = np.zeros(self.R, np.int64)
        self.seen_terms: Dict[int, int] = {}      # term -> leader (I4)
        self.steps_checked = 0

    def reset_replica(self, r: int) -> None:
        """A crash-restart wiped replica ``r``'s volatile state: its
        commit index legitimately resumes from the stable prefix, so
        re-arm I2's monotonicity baseline for the new incarnation.
        I4's term record deliberately survives — vote durability must
        hold ACROSS restarts."""
        self.prev_commit[r] = 0

    def check_step(self, res, *, step: Optional[int] = None,
                   rebased_total: int = 0) -> None:
        """I2 + I4 + I5 over one step's outputs. ``rebased_total`` is
        the cluster's cumulative rollover delta (``SimCluster
        .rebased_total``) so commit monotonicity is judged on ABSOLUTE
        indices, immune to coordinated i32 rebases."""
        step = self.steps_checked if step is None else step
        self.steps_checked += 1
        for r in range(self.R):
            commit_abs = int(res["commit"][r]) + int(rebased_total)
            if commit_abs < self.prev_commit[r]:
                raise InvariantViolation(
                    "I2", f"commit regressed {self.prev_commit[r]} -> "
                    f"{commit_abs}", replica=r, step=step)
            self.prev_commit[r] = commit_abs
        for r in range(self.R):
            if int(res["role"][r]) == int(Role.LEADER):
                t = int(res["term"][r])
                holder = self.seen_terms.setdefault(t, r)
                if holder != r:
                    raise InvariantViolation(
                        "I4", f"two leaders in term {t}: replicas "
                        f"{holder} and {r}", replica=r, step=step)
        for r in range(self.R):
            h, a = int(res["head"][r]), int(res["apply"][r])
            c, e = int(res["commit"][r]), int(res["end"][r])
            if not (h <= a <= c <= e):
                raise InvariantViolation(
                    "I5", f"offset chain broken: head={h} apply={a} "
                    f"commit={c} end={e}", replica=r, step=step)

    def check_convergence(
            self, replayed: Sequence[Sequence[tuple]]) -> None:
        """I1 + I3: every replica's replay stream is a prefix of the
        longest one (committed-prefix agreement + durability — a
        diverging or mutated prefix fails here)."""
        streams: List[list] = [list(s) for s in replayed]
        longest = max(streams, key=len)
        for r, s in enumerate(streams):
            if s != longest[:len(s)]:
                diff = next((i for i, (a, b) in
                             enumerate(zip(s, longest))
                             if a != b), min(len(s), len(longest)))
                raise InvariantViolation(
                    "I1/I3", "replay streams diverge at apply index "
                    f"{diff} (stream len {len(s)} vs longest "
                    f"{len(longest)})", replica=r)
