"""Adaptive dispatch governor — telemetry-driven auto-tuning of the
dispatch geometry.

The port's copy of the JAX package's ``runtime/governor.py`` (standard
library only; ``tests/test_torch_governor.py`` holds its decision
sequences equal to the reference's).

Burst K, depth-D pipelining and the K-window scan tier are static flags
a human picks per run. Real traffic is bursty, diurnal, and read/write
mixed, so a hand-picked geometry is always wrong for part of the day: a
deep burst tier pays window-fill latency at trickle load, a serial
geometry caps throughput at peak. The design wins by amortizing —
fewer, larger protocol rounds once per-round cost is fixed — which only
holds when the batching degree TRACKS offered load.

:class:`DispatchGovernor` is a step-domain feedback controller that
closes that loop. It runs on the existing readback thread (the
engines' ``finish()`` observes it exactly like ``leases``/``reads``)
and publishes one :class:`Decision` per finished step:

* **tier** — serial step vs fused burst/scan ``K``, chosen from a
  FIXED ladder (``(1,) + cluster.K_TIERS``). The ladder is the contract
  that makes the governor free: every K it can pick is a tier the
  engine already prewarms, so a governed run builds no burst or scan
  function the ungoverned engine would not
  (``tests/test_torch_governor.py`` pins it). Climb is one rung per
  evaluation; descent requires ``down_evals`` consecutive evaluations
  of fitting a lower rung (hysteresis — a single shallow step never
  collapses a hot tier).
* **pipeline** — depth-D pipelining engages only after backlog has
  STOOD for ``engage_evals`` consecutive evaluations (overlap pays only
  while append batches flow; in the latency-bound regime serial acks a
  commit one dispatch sooner).
* **coalesce_us** — a bounded admission wait: at high arrival rate
  with a window still filling, delaying the dispatch a few hundred µs
  fills the window and halves the dispatch count per committed entry.
  Never applied while shedding, and hard-capped — it can move latency
  by at most ``coalesce_us`` per dispatch.
* **shed** — the SLO guard: the ``commit_latency_slo_burn`` fast-burn
  pager (an ``AlertEngine.add_hook`` policy, the exact
  ``RepairController.on_alert`` pattern) drops the governor to serial
  and disengages pipelining the moment it fires, and the ladder only
  re-climbs after the alert resolves. The governor can never page the
  latency SLO — the pager IS its back-off signal.

Decisions are DETERMINISTIC given the observed step-domain inputs
(standing backlog, per-step arrival derived from backlog deltas +
accepted counts, and the shed latch): no wall clock, no randomness — a
chaos replay that replays the same step sequence re-derives the
identical tier sequence, which is why the nemesis runners can attach a
governor and keep bit-reproducible verdicts. Tier transitions emit
``governor_tier`` trace events and ``dispatch_tier{tier=}`` counters;
applied admission waits ride the ``governor_coalesce_us`` histogram
(driver-side).

:class:`HintGovernor` is the multi-host variant: its decision derives
ONLY from the gathered ``burst_hint``, so every host agrees on the
collective program schedule with no extra collective. Its node-daemon
wiring comes with the multi-device port (ROADMAP Queue 1, item 14).

Host-pure module: never imports torch or numpy, never touches device
state except under the engine host lock.
"""

from __future__ import annotations

import collections
import threading
from typing import Deque, List, NamedTuple, Optional, Tuple

SHED_RULE = "commit_latency_slo_burn"


class Decision(NamedTuple):
    """One published governor decision (immutable — readers on the
    dispatch thread see a complete decision or the previous one)."""
    kind: str            # "serial" | "burst" | "scan"
    max_k: int           # ladder rung; 1 == serial single step
    pipeline: bool       # engage depth-D pipelining
    coalesce_us: int     # bounded admission wait before dispatch (0=off)
    shed: bool           # SLO-shed latch active
    rungs: Tuple[int, ...]   # per-group chosen K (max_k == max(rungs))


#: the decision every governor starts from (and drains to): serial,
#: no pipelining, no coalescing — the latency-safest geometry.
SERIAL = Decision("serial", 1, False, 0, False, (1,))


def tier_label(kind: str, k: int) -> str:
    """Render a tier for the ``dispatch_tier{tier=}`` series:
    ``serial`` / ``burst4`` / ``scan16``."""
    return "serial" if k <= 1 else f"{kind}{k}"


class DispatchGovernor:
    """Step-domain feedback controller picking the dispatch tier.

    ``observe(cluster, res)`` runs at the tail of every engine
    ``finish()`` (the readback thread under pipelined drivers) and
    publishes :attr:`decision`; the drivers' dispatch paths consult it
    lock-free (a stale-by-one-step decision is by design — the same
    contract as ``cluster.last``).
    """

    def __init__(self, groups: int = 1, *,
                 batch_slots: int,
                 ladder=None,
                 down_evals: int = 4,
                 engage_evals: int = 2,
                 coalesce_us: int = 200,
                 coalesce_fill_frac: float = 0.5,
                 arrival_window: int = 8,
                 obs=None, alerts=None,
                 shed_rule: str = SHED_RULE):
        self.G = int(groups)
        self.B = int(batch_slots)
        # the fixed tier ladder: rung 0 is the serial step, the rest
        # are the engine's prewarmed fused tiers — NEVER anything
        # outside it (the ladder-only contract)
        self.ladder: Tuple[int, ...] = (
            (1,) + tuple(int(k) for k in ladder) if ladder
            else (1,))
        self.down_evals = int(down_evals)
        self.engage_evals = int(engage_evals)
        self.coalesce_us = int(coalesce_us)
        self.coalesce_fill_frac = float(coalesce_fill_frac)
        self.obs = obs
        # the AlertEngine whose firing set clears the shed latch; the
        # fire transition itself arrives via on_alert (add_hook)
        self.alerts = alerts
        self.shed_rule = shed_rule
        self._lock = threading.Lock()
        # per-group controller state (all step-domain):
        # current ladder rung index per group
        self._rung: List[int] = [0] * self.G   # guarded-by: _lock [writes]
        # consecutive evals the backlog fit >= one rung lower
        self._below: List[int] = [0] * self.G  # guarded-by: _lock [writes]
        # consecutive evals with standing backlog (pipeline hysteresis)
        self._standing = 0                     # guarded-by: _lock [writes]
        # previous eval's per-group backlog (arrival derivation)
        self._prev_backlog: List[int] = [0] * self.G  # guarded-by: _lock [writes]
        # trailing per-group arrival window (entries/eval)
        self._arrivals: List[Deque[int]] = [
            collections.deque(maxlen=int(arrival_window))
            for _ in range(self.G)]            # guarded-by: _lock [writes]
        # SLO-shed latch: set on the pager's fire transition, cleared
        # when the rule leaves the firing set
        self._shed = False                     # guarded-by: _lock [writes]
        self.sheds = 0
        # pinned tier (tests / operator override): decisions are fixed
        # at this tier, observation keeps running
        self._pinned: Optional[Tuple[str, int]] = None  # guarded-by: _lock [writes]
        self.evals = 0
        # the published decision — swapped whole under the lock,
        # read lock-free by the dispatch thread
        self.decision: Decision = SERIAL       # guarded-by: _lock [writes]

    # ------------------------------------------------------------------
    # inputs
    # ------------------------------------------------------------------

    def on_alert(self, name: str, severity: str) -> None:
        """Alert→action hook (``AlertEngine.add_hook``): the fast-burn
        latency pager sheds the governor to serial immediately — tier
        drops on the FIRE transition, not the next evaluation."""
        if name != self.shed_rule:
            return
        with self._lock:
            if not self._shed:
                self._shed = True
                self.sheds += 1
                self._rung = [0] * self.G
                self._standing = 0
                self._publish_locked([0] * self.G, [0] * self.G)
        if self.obs is not None:
            from rdma_paxos_tpu_torch.obs import trace as _trace
            self.obs.trace.record(_trace.GOVERNOR_SHED, alert=name,
                                  severity=severity)

    def pin(self, kind: str, k: int = 1) -> None:
        """Pin every decision to one tier (``("serial", 1)`` /
        ``("burst", K)`` / ``("scan", K)``) — the bit-identity tests'
        surface and an operator escape hatch. ``k`` must sit on the
        ladder."""
        if kind not in ("serial", "burst", "scan"):
            raise ValueError(f"unknown tier kind {kind!r}")
        if kind == "serial":
            k = 1
        if int(k) not in self.ladder:
            raise ValueError(
                f"K={k} is not on the prewarmed ladder {self.ladder}")
        with self._lock:
            self._pinned = (kind, int(k))
            self._publish_locked([0] * self.G, [0] * self.G)

    def unpin(self) -> None:
        with self._lock:
            self._pinned = None

    # ------------------------------------------------------------------
    # the feedback pass (engine finish() tail, readback thread)
    # ------------------------------------------------------------------

    def observe(self, cluster, res) -> None:
        """One evaluation: derive the step-domain signals from the
        finished step and publish the next decision. Backlogs are read
        under the engine host lock (the pending queues belong to the
        dispatch/readback split)."""
        backlog = self._backlogs(cluster)
        # a deep watch backlog is demand too: the streams hub's
        # undispatched tail + subscriber queue depth drains through
        # the same committed frontier the dispatch advances (consulted
        # the way repair and elections already are; read WITHOUT the
        # engine host lock — the hub's own lock suffices and must
        # never nest inside it)
        streams = getattr(cluster, "streams", None)
        if streams is not None:
            sb = streams.backlogs()
            for g in range(min(len(sb), len(backlog))):
                backlog[g] += int(sb[g])
        accepted = self._accepted(res)
        scan = bool(getattr(cluster, "scan", False))
        # an open elastic-topology transition window holds the serial
        # tier: its seed/freeze/cutover passes ride drained serial
        # dispatches (the txn wants_serial give-way rule). The ladder
        # state keeps evaluating underneath, so the tier re-climbs on
        # the first eval after the window closes.
        topo = getattr(cluster, "topology", None)
        hold = bool(topo is not None and topo.in_window())
        with self._lock:
            self.evals += 1
            if self.alerts is not None and self._shed:
                # resolve-side of the shed latch: the pager left the
                # firing set — re-climb from serial
                if self.shed_rule not in self.alerts.firing():
                    self._shed = False
                    if self.obs is not None:
                        from rdma_paxos_tpu_torch.obs import trace as _trace
                        self.obs.trace.record(_trace.GOVERNOR_RESUME,
                                              alert=self.shed_rule)
            arrivals = []
            for g in range(self.G):
                # entries that ARRIVED since the previous eval: the
                # backlog delta plus what this step consumed
                arr = max(0, backlog[g] - self._prev_backlog[g]
                          + accepted[g])
                self._prev_backlog[g] = backlog[g]
                self._arrivals[g].append(arr)
                arrivals.append(arr)
            if any(backlog):
                self._standing += 1
            else:
                self._standing = 0
            if not self._shed and self._pinned is None:
                for g in range(self.G):
                    # demand = standing backlog OR the trailing
                    # arrival rate, whichever is larger: at steady
                    # state a well-sized tier drains the whole take
                    # every dispatch, so post-take backlog reads ~0 —
                    # judging the rung on backlog alone would descend,
                    # spike the queue, and oscillate (a latency cost
                    # the p99 bound forbids)
                    win = self._arrivals[g]
                    rate = sum(win) // max(1, len(win))
                    self._advance_rung_locked(
                        g, max(backlog[g], rate))
            prev = self.decision
            dec = self._publish_locked(backlog, arrivals, scan=scan,
                                       hold_serial=hold)
        self._emit(prev, dec, backlog, arrivals)

    def _advance_rung_locked(self, g: int, demand: int) -> None:
        """Asymmetric ladder walk for one group over the demand
        signal (max of standing backlog and trailing arrival rate):
        climb IMMEDIATELY to the lowest rung whose capacity covers it
        (a lagging climb just queues the storm's front — the latency
        the p99 bound forbids trading away), descend one rung only
        after ``down_evals`` consecutive evaluations of fitting a
        lower tier (a single shallow eval never collapses a hot
        tier)."""
        rung = self._rung[g]
        cap = self.ladder[rung] * self.B
        if demand > cap:
            target = rung
            while (target + 1 < len(self.ladder)
                   and self.ladder[target] * self.B < demand):
                target += 1
            self._rung[g] = target
            self._below[g] = 0
            return
        lower_cap = (self.ladder[rung - 1] * self.B if rung > 0
                     else 0)
        if rung > 0 and demand <= lower_cap:
            self._below[g] += 1
            if self._below[g] >= self.down_evals:
                self._rung[g] = rung - 1
                self._below[g] = 0
        else:
            self._below[g] = 0

    # holds-lock: _lock
    def _publish_locked(self, backlog: List[int],
                        arrivals: List[int],
                        scan: bool = False,
                        hold_serial: bool = False) -> Decision:
        if self._pinned is not None:
            kind, k = self._pinned
            dec = Decision(kind, k, k > 1 and not self._shed, 0,
                           self._shed, (k,) * self.G)
            self.decision = dec
            return dec
        if self._shed:
            dec = SERIAL._replace(shed=True,
                                  rungs=(1,) * self.G)
            self.decision = dec
            return dec
        if hold_serial:
            # topology window open: serial, but NOT a shed (no latch,
            # no pager semantics) — the rung state stays put
            dec = SERIAL._replace(rungs=(1,) * self.G)
            self.decision = dec
            return dec
        rungs = tuple(self.ladder[r] for r in self._rung)
        k = max(rungs)
        kind = "serial" if k <= 1 else ("scan" if scan else "burst")
        pipeline = (k > 1 and self._standing >= self.engage_evals)
        coalesce = 0
        if k > 1 and self.coalesce_us > 0:
            total = sum(backlog)
            fill = int(self.coalesce_fill_frac * k * self.B)
            win = self._arrivals[0]
            rate = (sum(sum(a) for a in self._arrivals)
                    / max(1, len(win)))
            # admission coalescing: the stream is flowing fast enough
            # to fill the window (>= half a batch per eval) but the
            # window is not full yet — wait a bounded beat so the next
            # dispatch carries more entries
            if 0 < total < fill and rate * 2 >= self.B:
                coalesce = self.coalesce_us
        dec = Decision(kind, k, pipeline, coalesce, False, rungs)
        self.decision = dec
        return dec

    def _emit(self, prev: Decision, dec: Decision,
              backlog: List[int], arrivals: List[int]) -> None:
        if self.obs is None:
            return
        self.obs.metrics.inc("dispatch_tier",
                             tier=tier_label(dec.kind, dec.max_k))
        if (prev.max_k, prev.kind, prev.shed) != (dec.max_k, dec.kind,
                                                  dec.shed):
            from rdma_paxos_tpu_torch.obs import trace as _trace
            self.obs.trace.record(
                _trace.GOVERNOR_TIER,
                tier=tier_label(dec.kind, dec.max_k),
                prev=tier_label(prev.kind, prev.max_k),
                pipeline=dec.pipeline, shed=dec.shed,
                backlog=int(sum(backlog)),
                arrival=int(sum(arrivals)),
                rungs=[int(k) for k in dec.rungs])

    # ------------------------------------------------------------------
    # signal extraction (engine-shape aware)
    # ------------------------------------------------------------------

    def _backlogs(self, cluster) -> List[int]:
        """Per-group standing backlog depth (max over replicas — the
        burst sizing's own rule), read under the engine host lock."""
        with cluster._host_lock:
            # the sharded engine nests pending as [G][R] even at G==1
            # (SimCluster is flat [R]) — branch on the engine shape,
            # never on the group count
            if hasattr(cluster, "G"):
                return [max(len(q) for q in cluster.pending[g])
                        for g in range(self.G)]
            return [max((len(q) for q in cluster.pending), default=0)]

    def _accepted(self, res) -> List[int]:
        """Per-group accepted-entry count for the finished step (the
        leader's append count — element max over the replica axis)."""
        acc = res.get("accepted")
        if acc is None:
            return [0] * self.G
        try:
            if getattr(acc, "ndim", 1) >= 2:      # sharded: [G, R]
                return [int(acc[g].max()) for g in range(self.G)]
            return [int(max(int(v) for v in acc))]
        except (TypeError, ValueError):
            return [0] * self.G

    def status(self) -> dict:
        with self._lock:
            d = self.decision
            return dict(tier=tier_label(d.kind, d.max_k),
                        max_k=d.max_k, pipeline=d.pipeline,
                        coalesce_us=d.coalesce_us, shed=d.shed,
                        rungs=[int(k) for k in d.rungs],
                        ladder=list(self.ladder),
                        pinned=(list(self._pinned)
                                if self._pinned else None),
                        sheds=self.sheds, evals=self.evals)


class HintGovernor:
    """The multi-host (NodeDaemon) governor: burst-vs-serial-vs-
    coalesce from the gathered ``burst_hint`` ONLY.

    Every input is a value all hosts gathered identically (full
    connectivity — the only configuration the daemon bursts in), so N
    daemons feeding the same hint sequence into N independent
    instances derive the SAME tier sequence with zero extra
    collectives — the burst-size agreement extended to the governor
    (``tests/test_torch_governor.py`` pins it).

    The daemon compiles exactly ONE burst program (every distinct K is
    a separate multi-process compile), so there is no ladder here; the
    governable axis is admission coalescing: when the gathered backlog
    is small but RISING, hold the batch for up to ``coalesce_limit``
    iterations (a serial heartbeat step that takes no batch) so the
    next burst rides a fuller window.
    """

    def __init__(self, batch_slots: int, *, coalesce_limit: int = 2,
                 window: int = 8):
        self.B = int(batch_slots)
        self.coalesce_limit = int(coalesce_limit)
        self._hints: Deque[int] = collections.deque(maxlen=int(window))
        self._coalesced = 0
        self.decisions = collections.Counter()

    def decide(self, hint: int) -> str:
        """-> ``"step"`` | ``"burst"`` | ``"coalesce"`` for the next
        iteration, from the gathered hint only (deterministic, pure —
        the host-agreement contract)."""
        hint = int(hint)
        prev = self._hints[-1] if self._hints else 0
        self._hints.append(hint)
        if hint <= 0:
            self._coalesced = 0
            out = "step"
        elif hint >= self.B:
            self._coalesced = 0
            out = "burst"
        elif hint > prev and self._coalesced < self.coalesce_limit:
            # small but rising: hold admission one beat — bounded, so
            # a stalling stream never waits more than coalesce_limit
            # iterations before the partial window ships
            self._coalesced += 1
            out = "coalesce"
        else:
            self._coalesced = 0
            out = "burst"
        self.decisions[out] += 1
        return out


def attach_governor(cluster, *, obs=None, alerts=None,
                    **opts) -> DispatchGovernor:
    """Enable the governor on an engine (SimCluster or ShardedCluster,
    any execution mode): hangs a :class:`DispatchGovernor` on
    ``cluster.governor`` — the engines' ``finish()`` observes it from
    then on (the ``leases``/``reads`` attach pattern). The ladder is
    derived from the engine's OWN prewarmed tier set, so a governed
    run can never build a function the ungoverned engine would not.
    Pure host bookkeeping: the step is untouched."""
    gov = DispatchGovernor(
        groups=int(getattr(cluster, "G", 1)),
        batch_slots=cluster.cfg.batch_slots,
        ladder=cluster.K_TIERS,
        obs=(obs if obs is not None else cluster.obs),
        alerts=alerts, **opts)
    cluster.governor = gov
    return gov
