"""Load-driven topology policy — the loop that decides WHEN to split
and merge.

The port's copy of the JAX package's ``topology/policy.py``.

The mechanism lives in :mod:`~rdma_paxos_tpu_torch.topology.transition`;
this module closes the loop the way every other actuator in the repo
does (``RepairController.on_alert``, the governor's SLO shed): a
feedback observer exports device-truth load gauges, stock
``AlertEngine`` rules fire on sustained conditions, and the
``add_hook`` callback turns a fire transition into a proposal.

Signals — all derived from the per-group COMMIT frontier (device
truth: what the groups actually committed, not what clients offered):

* ``topology_group_share{group=g}`` — group ``g``'s share of the
  committed work over a trailing step window.
* ``topology_skew`` — the hottest group's share normalized to the
  fair share ``1/G`` (2.0 = one group doing double its share).
* ``topology_override_load`` — the COLDEST policy-installed override
  group's normalized share (``G`` — i.e. never cold — while the
  policy owns no installed rules, so the merge rule stays silent).

Stock rules (``stock_rules()``, registered via ``alerts.add_rule`` by
``attach_topology``): sustained skew above ``skew_ratio`` fires the
split rule; a policy-owned override group sustained below
``cold_ratio`` fires the merge rule. ``for_evals`` is the hysteresis
— a one-eval spike never reshapes the keyspace.

Proposals: split carves the hot group's upper key half —
``[median_key, last_key + b"\\x00")`` of the keys it authoritatively
owns — into the least-loaded group. (Byte-range capture caveat: other
groups' keys falling inside that interval migrate too; the transition
seeds them correctly, the policy just pays a bigger window.) Merge
returns the coldest policy-installed rule's range to its ring owners.
Both consult the governor first — no proposal while the SLO shed
latch is up (a latency incident is the wrong moment to add seeding
traffic) — and sit out the policy's own eval-domain cooldown on top
of the controller's step-domain one. The policy only ever merges
rules it itself installed (``_mine``): operator-pinned overrides are
never touched.

Host-pure module: never imports torch (frontier math is plain ints via
the shared :mod:`~rdma_paxos_tpu_torch.topology.epoch` helpers) and
changes nothing on the device.
"""

from __future__ import annotations

import collections
import threading
from typing import Deque, List, Optional, Tuple

from rdma_paxos_tpu_torch.obs.alerts import WARN
from rdma_paxos_tpu_torch.shard.router import RangeRule
from rdma_paxos_tpu_torch.topology import epoch as _epoch

SPLIT_RULE = "topology_group_skew"
MERGE_RULE = "topology_group_cold"


class TopologyPolicy:
    """Observes per-group committed-work shares and proposes
    split/merge transitions through an attached
    :class:`~rdma_paxos_tpu_torch.topology.transition.TopologyController`.

    ``observe(cluster, res)`` rides the controller's finish()-tail
    hook (readback thread); ``on_alert`` rides the AlertEngine's fire
    transitions (driver cadence thread). Lock order: the policy lock
    is OUTERMOST — proposals are issued with it released, so
    ``policy._lock -> controller._lock -> cluster._host_lock`` never
    inverts.
    """

    def __init__(self, ctl=None, *, window: int = 32,
                 skew_ratio: float = 2.0, cold_ratio: float = 0.5,
                 for_evals: int = 4, cooldown_evals: int = 16,
                 min_keys: int = 4):
        self.ctl = None
        self.skew_ratio = float(skew_ratio)
        self.cold_ratio = float(cold_ratio)
        self.for_evals = int(for_evals)
        self.cooldown_evals = int(cooldown_evals)
        self.min_keys = int(min_keys)
        self._window = int(window)
        self.proposals = 0
        self.vetoes = 0
        self._lock = threading.Lock()
        # eval counter (one per observe pass — the hysteresis/cooldown
        # time base)  # guarded-by: _lock [writes]
        self._evals = 0
        # no proposal before this eval (policy-level cooldown)
        # guarded-by: _lock [writes]
        self._gate_after = 0
        # previous absolute commit frontier (per group)
        # guarded-by: _lock [writes]
        self._frontier_prev: Optional[List[int]] = None
        # trailing per-group committed-entry deltas
        # guarded-by: _lock [writes]
        self._loadwin: List[Deque[int]] = []
        # last computed per-group shares  # guarded-by: _lock [writes]
        self._shares: List[float] = []
        # override rules THIS policy proposed (merge candidates; pruned
        # once no longer installed)  # guarded-by: _lock [writes]
        self._mine: List[RangeRule] = []
        if ctl is not None:
            self.bind(ctl)
        from rdma_paxos_tpu_torch.analysis import runtime_guard
        runtime_guard.maybe_guard(self, "_lock", __file__)

    def bind(self, ctl) -> None:
        self.ctl = ctl
        with self._lock:
            self._loadwin = [collections.deque(maxlen=self._window)
                             for _ in range(ctl.G)]
            self._shares = [1.0 / ctl.G] * ctl.G

    # ---------------- stock rules ----------------

    def stock_rules(self) -> List[dict]:
        """The skew/cold rule pair ``attach_topology`` registers.
        Plain dicts — they ride health snapshots like every other
        rule, and the names are the hook-dispatch contract."""
        return [
            dict(name=SPLIT_RULE, severity=WARN, kind="gauge_cmp",
                 metric="topology_skew", op=">",
                 value=self.skew_ratio, for_evals=self.for_evals),
            dict(name=MERGE_RULE, severity=WARN, kind="gauge_cmp",
                 metric="topology_override_load", op="<",
                 value=self.cold_ratio, for_evals=self.for_evals),
        ]

    # ---------------- the feedback pass ----------------

    def observe(self, cluster, res) -> None:
        """One evaluation: fold the finished step's commit-frontier
        advance into the trailing window and export the load gauges
        the stock rules evaluate."""
        ctl = self.ctl
        if ctl is None:
            return
        frontier = [int(v) for v in _epoch.commit_frontier(
            res, cluster.rebased_total)]
        overrides = ctl.kvs.router.overrides    # atomic list read
        with self._lock:
            self._evals += 1
            if (self._frontier_prev is not None
                    and len(self._frontier_prev) == len(frontier)):
                for g, (cur, prev) in enumerate(
                        zip(frontier, self._frontier_prev)):
                    self._loadwin[g].append(max(0, cur - prev))
            self._frontier_prev = frontier
            sums = [sum(w) for w in self._loadwin]
            total = sum(sums)
            if total > 0:
                self._shares = [s / total for s in sums]
            shares = list(self._shares)
            if not ctl.in_window():
                # a proposed-then-abandoned rule never installed (and
                # a merged one just uninstalled): stop tracking it
                self._mine = [r for r in self._mine if r in overrides]
            mine = list(self._mine)
        G = len(shares)
        obs = ctl.obs
        if obs is not None:
            for g, s in enumerate(shares):
                obs.metrics.set("topology_group_share", round(s, 4),
                                group=g)
            obs.metrics.set("topology_skew", round(max(shares) * G, 4))
            installed = [r for r in mine if r in overrides]
            obs.metrics.set(
                "topology_override_load",
                round(min((shares[r.group] * G for r in installed),
                          default=float(G)), 4))

    # ---------------- alert → proposal ----------------

    def on_alert(self, name: str, severity: str) -> None:
        """AlertEngine fire-transition hook (``add_hook``): dispatch
        to the proposal matching the fired stock rule. Exceptions are
        the engine's problem to swallow; this path never raises on a
        refused proposal — refusal IS the hysteresis."""
        if name == SPLIT_RULE:
            self._try_split()
        elif name == MERGE_RULE:
            self._try_merge()

    def _governor_vetoes(self) -> bool:
        """Consult the governor: while the SLO shed latch is up the
        cluster is in a latency incident — seeding traffic and a
        freeze window would pour fuel on it."""
        gov = getattr(self.ctl.cluster, "governor", None)
        if gov is not None and gov.decision.shed:
            self.vetoes += 1
            return True
        return False

    def _cooling(self) -> bool:
        with self._lock:
            return self._evals < self._gate_after

    def _note_proposed(self, rule: Optional[RangeRule]) -> None:
        with self._lock:
            self._gate_after = self._evals + self.cooldown_evals
            if rule is not None:
                self._mine.append(rule)
        self.proposals += 1

    def _try_split(self) -> None:
        ctl = self.ctl
        if ctl is None or self._cooling() or self._governor_vetoes():
            return
        with self._lock:
            shares = list(self._shares)
        if len(shares) < 2:
            return
        hot = max(range(len(shares)), key=lambda g: shares[g])
        target = min((g for g in range(len(shares)) if g != hot),
                     key=lambda g: shares[g])
        rng = self._median_range(hot)
        if rng is None:
            return
        lo, hi = rng
        if ctl.propose_split(lo, hi, target):
            self._note_proposed(RangeRule(lo, hi, target))

    def _try_merge(self) -> None:
        ctl = self.ctl
        if ctl is None or self._cooling() or self._governor_vetoes():
            return
        with self._lock:
            shares = list(self._shares)
            mine = list(self._mine)
        G = len(shares)
        installed = [r for r in mine if r in ctl.kvs.router.overrides]
        cold = [r for r in installed
                if shares[r.group] * G < self.cold_ratio]
        if not cold:
            return
        rule = min(cold, key=lambda r: shares[r.group])
        try:
            if ctl.propose_merge(rule):
                self._note_proposed(None)
        except ValueError:
            pass        # uninstalled since the check — nothing to do

    def _median_range(self, hot: int) -> Optional[Tuple[bytes, bytes]]:
        """The hot group's upper key half as a byte range: ``[median,
        last + b"\\x00")`` over the keys it authoritatively owns
        today. None when the group holds too few keys for a split to
        mean anything."""
        ctl = self.ctl
        kvs = ctl.kvs
        lead = ctl.cluster.leader_hint(hot)
        if lead < 0:
            lead = 0
        keys = sorted(
            k for k, _v in kvs.groups[hot].items_in_range(lead, b"",
                                                          None)
            if kvs.router.group_of(k) == hot)
        if len(keys) < self.min_keys:
            return None
        return keys[len(keys) // 2], keys[-1] + b"\x00"

    # ---------------- export ----------------

    def status(self) -> dict:
        with self._lock:
            return dict(
                evals=self._evals,
                shares=[round(s, 4) for s in self._shares],
                proposals=self.proposals,
                vetoes=self.vetoes,
                cooldown_after=self._gate_after,
                rules=[r.to_dict() for r in self._mine],
            )
