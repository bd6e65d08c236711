"""Seeded fault-schedule DSL (nemesis) + the pluggable per-link model.

The port's copy of the JAX package's ``chaos/faults.py``
(``tests/test_torch_chaos.py`` holds its masks and schedules equal to
the reference's). ``corrupt_slot`` is rewritten in torch; crash-restart
goes over the port's snapshot and replay-stream functions.

The pre-chaos harness expressed failures through one binary, symmetric
``peer_mask`` matrix mutated by ``SimCluster.partition()/heal()``. That
models clean partitions and nothing else. This module generalizes it
into a **per-link fault model** the cluster consults each step:

* asymmetric link breaks — ``i`` cannot hear ``j`` while ``j`` still
  hears ``i`` (the one-directional NIC/switch failures the reference's
  QP-level fencing worries about);
* probabilistic message drop per link (seeded, replayable);
* message delay — a link with a d-step delay delivers every (d+1)-th
  step. In a lock-step protocol where every step retransmits the
  current window/control state, a delivery delayed d steps is
  indistinguishable from hearing nothing for d steps and then hearing
  the CURRENT state, so the periodic gate is the exact semantics, not
  an approximation;
* message duplication — a stale extra delivery forced through an
  otherwise dropped/delayed step. Window absorption is idempotent and
  term-gated, so duplicates must be harmless; modeling them lets the
  invariant checker PROVE that instead of assuming it;
* crash-restart — a crashed replica is silent (hears nobody, heard by
  nobody); restart wipes its volatile device state and recovers from
  "stable storage": its own applied prefix (the StableStore analog —
  ``SimCluster.replayed`` is exactly what the driver persists) plus
  the HardState/peer-vote-record election durability, via the same
  ``take_snapshot``/``install_snapshot``/``recover_vote`` path the
  real driver uses;
* election-timeout jitter/skew — a deterministic step-domain timer
  model (:class:`StepTimerModel`) whose per-replica periods are seeded
  and can be skewed mid-schedule by the nemesis.

Everything is host-side. The link model only rewrites the ``peer_mask``
INPUT of the replica step — faults are data, never step structure. The
effective mask is a PURE function of (model state, step index): the
per-step randomness is derived from ``(seed, step_index)`` rather than
a shared mutable RNG, so replaying a schedule from an artifact yields
bit-identical masks regardless of call count or ordering.
"""

from __future__ import annotations

import json
import random
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from rdma_paxos_tpu_torch.obs import trace as obs_trace

# ---------------------------------------------------------------------------
# per-link model
# ---------------------------------------------------------------------------

# link keys are (dst, src): "dst cannot hear src" — matching the
# peer_mask[receiver, sender] orientation of StepInput.peer_mask


def _links(n: int, dst, src) -> List[Tuple[int, int]]:
    """Expand (dst, src) with None wildcards into concrete link pairs
    (diagonal excluded — a replica always hears itself)."""
    dsts = range(n) if dst is None else [int(dst)]
    srcs = range(n) if src is None else [int(src)]
    return [(d, s) for d in dsts for s in srcs if d != s]


class LinkModel:
    """Pluggable per-link fault state; attach via ``cluster.link_model``.

    ``effective_mask(base, step_idx)`` composes, in precedence order
    (later wins): base mask → delay gating → probabilistic drop →
    forced duplicate delivery → asymmetric blocks → crashed replicas →
    diagonal always on. Duplication deliberately overrides drop/delay
    (a stale copy squeaking through) but never blocks or crashes.
    """

    def __init__(self, n_replicas: int, seed: int = 0):
        self.R = int(n_replicas)
        self.seed = int(seed)
        self.down: Set[int] = set()
        self.blocked: Set[Tuple[int, int]] = set()
        self.drop: Dict[Tuple[int, int], float] = {}
        self.delay: Dict[Tuple[int, int], int] = {}
        self.dup: Dict[Tuple[int, int], float] = {}
        self.faults_active = 0          # bookkeeping for health/verdicts
        self.obs = None                 # optional Observability facade

    # ---------------- mutation (nemesis-facing) ----------------

    def _record(self, kind: str, **fields) -> None:
        self.faults_active = (len(self.down) + len(self.blocked)
                              + len(self.drop) + len(self.delay)
                              + len(self.dup))
        if self.obs is not None:
            self.obs.metrics.inc("faults_injected_total")
            self.obs.trace.record(obs_trace.FAULT_INJECTED, fault=kind,
                                  **fields)

    def block(self, dst: Optional[int], src: Optional[int]) -> None:
        """``dst`` stops hearing ``src`` (None = wildcard). Asymmetric:
        the reverse direction is untouched."""
        self.blocked.update(_links(self.R, dst, src))
        self._record("block", dst=dst, src=src)

    def unblock(self, dst: Optional[int] = None,
                src: Optional[int] = None) -> None:
        self.blocked.difference_update(_links(self.R, dst, src))
        self._record("unblock", dst=dst, src=src)

    def partition(self, groups: Sequence[Sequence[int]]) -> None:
        """Symmetric split expressed as blocks (unlike
        ``SimCluster.partition()`` this composes with other faults and
        heals without clobbering them). Replicas NOT listed in any
        group are fully isolated — each forms an implicit singleton
        group — matching ``SimCluster.partition()``'s semantics exactly
        so a schedule means the same fault under either API."""
        member = {}
        for gi, g in enumerate(groups):
            for r in g:
                member[int(r)] = gi
        for i in range(self.R):
            member.setdefault(i, -1 - i)     # unlisted: isolated
        for i in range(self.R):
            for j in range(self.R):
                if i != j and member[i] != member[j]:
                    self.blocked.add((i, j))
        self._record("partition", groups=[list(map(int, g))
                                          for g in groups])

    def set_drop(self, p: float, dst: Optional[int] = None,
                 src: Optional[int] = None) -> None:
        for link in _links(self.R, dst, src):
            if p > 0:
                self.drop[link] = float(p)
            else:
                self.drop.pop(link, None)
        self._record("drop", p=p, dst=dst, src=src)

    def set_delay(self, d: int, dst: Optional[int] = None,
                  src: Optional[int] = None) -> None:
        for link in _links(self.R, dst, src):
            if d > 0:
                self.delay[link] = int(d)
            else:
                self.delay.pop(link, None)
        self._record("delay", d=d, dst=dst, src=src)

    def set_dup(self, p: float, dst: Optional[int] = None,
                src: Optional[int] = None) -> None:
        for link in _links(self.R, dst, src):
            if p > 0:
                self.dup[link] = float(p)
            else:
                self.dup.pop(link, None)
        self._record("dup", p=p, dst=dst, src=src)

    def heal(self) -> None:
        """Clear every link fault (crashed replicas stay down — only
        ``restart_replica`` brings one back)."""
        self.blocked.clear()
        self.drop.clear()
        self.delay.clear()
        self.dup.clear()
        self._record("heal")

    # ---------------- the per-step mask ----------------

    def faulty(self) -> bool:
        """Any state that could yield a non-full mask (the psum
        compatibility question — see NemesisRunner's fanout guard)."""
        return bool(self.down or self.blocked or self.drop or self.delay)

    def effective_mask(self, base: np.ndarray,
                       step_idx: int) -> np.ndarray:
        mask = np.asarray(base, np.int32).copy()
        if not (self.down or self.blocked or self.drop or self.delay
                or self.dup):
            return mask
        for (d, s), dd in self.delay.items():
            if step_idx % (dd + 1) != dd:
                mask[d, s] = 0
        if self.drop:
            u = np.random.default_rng(
                (self.seed & 0x7FFFFFFF, step_idx)).random(
                    (self.R, self.R))
            for (d, s), p in self.drop.items():
                if u[d, s] < p:
                    mask[d, s] = 0
        if self.dup:
            u = np.random.default_rng(
                ((self.seed + 1) & 0x7FFFFFFF, step_idx)).random(
                    (self.R, self.R))
            for (d, s), p in self.dup.items():
                if u[d, s] < p:
                    mask[d, s] = 1          # stale duplicate delivery
        for d, s in self.blocked:
            mask[d, s] = 0
        for r in self.down:
            mask[r, :] = 0
            mask[:, r] = 0
        np.fill_diagonal(mask, 1)
        return mask


# ---------------------------------------------------------------------------
# crash-restart (volatile-state wipe + stable-storage recovery)
# ---------------------------------------------------------------------------

class HardStateTracker:
    """The driver persists ``(term, voted_term, voted_for)`` to a
    HardState file every step (``_ReplicaRuntime.hard``); in pure
    simulation this tracker is that file — fed from each step's outputs
    so a restart restores exactly what a real crash would have kept."""

    def __init__(self, n_replicas: int):
        self._hs = [(0, 0, -1)] * n_replicas

    def observe(self, res) -> None:
        for r in range(len(self._hs)):
            self._hs[r] = (int(res["term"][r]), int(res["voted_term"][r]),
                           int(res["voted_for"][r]))

    def get(self, r: int) -> Tuple[int, int, int]:
        return self._hs[r]


def corrupt_slot(cluster, r: int, g_idx: int, *,
                 group: Optional[int] = None, word: int = 0) -> None:
    """Add one to a payload word of the slot holding global index
    ``g_idx`` in replica ``r``'s device log memory (int32 wrap) — the
    SILENT fault the audit subsystem detects. Pure state surgery (no
    link/timer effects); callers must be on the drained serial path.
    The ring is rewritten into a fresh tensor, never in place: the
    previous step's outputs alias the state. ``group`` (a sharded
    cluster) is not ported (ROADMAP Queue 1, item 12)."""
    import dataclasses as _dc

    from rdma_paxos_tpu_torch.consensus.log import Log as _Log

    if group is not None:
        raise NotImplementedError(
            "corrupt_slot(group=...): sharded clusters are not ported "
            "(ROADMAP Queue 1, item 12)")
    slot = int(g_idx) & (cluster.cfg.n_slots - 1)
    with cluster._host_lock:
        buf = cluster.state.log.buf.clone()
        v = int(buf[int(r), slot, int(word)])
        buf[int(r), slot, int(word)] = ((v + 1 + (1 << 31))
                                        & 0xFFFFFFFF) - (1 << 31)
        cluster.state = _dc.replace(cluster.state, log=_Log(buf=buf))


def crash_replica(cluster, r: int, link: LinkModel) -> None:
    """Crash replica ``r``: it goes silent (the link model drops every
    message to and from it) until :func:`restart_replica`. Its device
    row keeps stepping in lock-step — isolated, it can neither commit
    nor vote usefully — and whatever it held in volatile memory is
    discarded at restart, which is where the crash semantics bite."""
    link.down.add(int(r))
    link._record("crash", replica=int(r))


def restart_replica(cluster, r: int, link: LinkModel,
                    hard: Optional[HardStateTracker] = None,
                    kvs=None) -> None:
    """Restart a crashed replica with a volatile-state wipe.

    Stable storage in the sim is the applied prefix (``replayed[r]`` is
    byte-for-byte what the driver's StableStore persists) plus the
    HardState triple. Recovery mirrors ``ClusterDriver._do_recover``:

    * normally the replica re-installs from its OWN stable prefix — a
      self-snapshot at ``applied[r]`` (the uncommitted/unapplied device
      suffix is lost, exactly what a crash loses);
    * a replica flagged ``need_recovery`` (its ring recycled slots past
      its apply cursor) cannot trust its own log — it recovers from a
      live donor, transferring the donor's store, like the driver's
      straggler path;
    * election durability: the restored vote is the newest of the
      HardState triple and live peers' vote records
      (``recover_vote``), so a recovered replica can never re-grant a
      vote that was already counted.
    """
    from rdma_paxos_tpu_torch.consensus.snapshot import (
        install_snapshot, recover_vote, take_snapshot)

    r = int(r)
    donor = r
    if r in cluster.need_recovery:
        live = [p for p in range(cluster.R)
                if p != r and p not in link.down
                and p not in cluster.need_recovery]
        if not live:
            raise RuntimeError(
                "replica %d needs donor recovery but no live donor "
                "exists" % r)
        # the most caught-up live member (Raft election ordering uses
        # the same ranking) so the transferred store is maximal
        donor = max(live, key=lambda p: int(cluster.applied[p]))
    snap = take_snapshot(cluster.state, donor,
                         index=int(cluster.applied[donor]))
    vt, vf = recover_vote(cluster.state, r)
    cur_term = 0
    if hard is not None:
        cur_term, hvt, hvf = hard.get(r)
        if hvt > vt:
            vt, vf = hvt, hvf
    cluster.state = install_snapshot(cluster.state, r, snap,
                                     voted_term=vt, voted_for=vf,
                                     cur_term=cur_term)
    cluster.applied[r] = snap.index
    if donor != r:
        # store transfer: the donor's persisted history replaces r's
        from rdma_paxos_tpu_torch.runtime.hostpath import stream_copy
        cluster.replayed[r] = stream_copy(cluster.replayed[donor])
        cluster.frames[r] = []
    cluster.need_recovery.discard(r)
    link.down.discard(r)
    link._record("restart", replica=r, donor=donor, index=snap.index)
    if link.obs is not None:
        link.obs.trace.record(obs_trace.CRASH_RESTART, replica=r,
                              donor=donor, index=snap.index)
    if kvs is not None:
        # the app process restarted too: rebuild its table by refolding
        # the store (deterministic — dedup registry included)
        kvs.rebuild(r)


# ---------------------------------------------------------------------------
# deterministic election timers (step domain)
# ---------------------------------------------------------------------------

class StepTimerModel:
    """Election timers over logical steps: per-replica periods drawn
    seeded from ``[lo, hi]`` (randomized-timeout desynchronization, the
    ``ElectionTimer`` analog with steps for seconds), re-jittered after
    every firing. The nemesis skews a replica's timer via
    :meth:`skew` — a skew < 1 models a trigger-happy node that fires
    spuriously, > 1 a sluggish one that cedes elections."""

    def __init__(self, n_replicas: int, seed: int = 0, lo: int = 6,
                 hi: int = 12):
        self.R = int(n_replicas)
        self.lo, self.hi = int(lo), int(hi)
        # string seeding hashes via sha512 — deterministic across
        # processes (tuple seeding would use PYTHONHASHSEED-randomized
        # hash(), breaking replay-from-artifact)
        self._rng = random.Random(f"timer:{seed}")
        self._skew = [1.0] * self.R
        self._period = [self._rng.randint(self.lo, self.hi)
                        for _ in range(self.R)]
        # staggered starts so the first election is not a stampede
        self._since = [self._rng.randint(0, self.lo)
                       for _ in range(self.R)]

    def skew(self, r: int, factor: float) -> None:
        self._skew[int(r)] = float(factor)

    def observe(self, res) -> None:
        """Advance per-replica clocks; a heartbeat (or being leader)
        beats the timer, exactly like the driver's loop."""
        from rdma_paxos_tpu_torch.consensus.state import Role
        for r in range(self.R):
            if (int(res["hb_seen"][r])
                    or int(res["role"][r]) == int(Role.LEADER)):
                self._since[r] = 0
            else:
                self._since[r] += 1

    def fire(self, down: Set[int]) -> List[int]:
        """Replicas whose timers expired this step (never a crashed
        one); each firing re-draws that replica's period."""
        fired = []
        for r in range(self.R):
            if r in down:
                self._since[r] = 0
                continue
            if self._since[r] >= max(1, round(
                    self._period[r] * self._skew[r])):
                fired.append(r)
                self._since[r] = 0
                self._period[r] = self._rng.randint(self.lo, self.hi)
        return fired


# ---------------------------------------------------------------------------
# the schedule DSL
# ---------------------------------------------------------------------------

# op -> required kwargs (validated at construction so a schedule can
# never die mid-run on a typo)
_OPS = {
    "partition": ("groups",),
    "heal": (),
    "block": ("dst", "src"),
    "unblock": (),
    "drop": ("p",),
    "delay": ("d",),
    "dup": ("p",),
    "crash": ("replica",),
    "restart": ("replica",),
    "skew": ("replica", "factor"),
}
# ops that can yield a non-full effective mask (psum-incompatible)
MASK_OPS = frozenset(
    ("partition", "block", "drop", "delay", "crash", "restart"))


class FaultSchedule:
    """An ordered list of ``(step, op, kwargs)`` fault events —
    buildable fluently, JSON round-trippable (the reproducer artifact
    carries schedules in this form), and validated up front."""

    def __init__(self, events: Optional[List[dict]] = None):
        self.events: List[dict] = []
        for ev in events or []:
            self.at(ev["step"], ev["op"],
                    **{k: v for k, v in ev.items()
                       if k not in ("step", "op")})

    def at(self, step: int, op: str, **kw) -> "FaultSchedule":
        if op not in _OPS:
            raise ValueError(f"unknown fault op {op!r} "
                             f"(known: {sorted(_OPS)})")
        missing = [k for k in _OPS[op] if k not in kw]
        if missing:
            raise ValueError(f"fault {op!r} missing kwargs {missing}")
        self.events.append(dict(step=int(step), op=op, **kw))
        self.events.sort(key=lambda e: e["step"])
        return self

    def due(self, step: int) -> List[dict]:
        return [e for e in self.events if e["step"] == step]

    def mask_affecting(self) -> List[dict]:
        return [e for e in self.events if e["op"] in MASK_OPS]

    def without_mask_faults(self) -> "FaultSchedule":
        return FaultSchedule([e for e in self.events
                              if e["op"] not in MASK_OPS])

    def validate(self, n_replicas: int) -> None:
        """Reject structurally-broken schedules at construction: out of
        range replicas, restarts of never-crashed replicas, and crash
        sets that could take down a majority at once (losing a majority
        's volatile state can lose committed entries — the durability
        contract here, like the reference's, is replication to a
        quorum's memory, see driver.py's sync-cadence note)."""
        down: Set[int] = set()
        limit = (n_replicas - 1) // 2
        for ev in self.events:
            for k in ("replica", "dst", "src"):
                v = ev.get(k)
                if v is not None and not (0 <= int(v) < n_replicas):
                    raise ValueError(f"{ev}: {k}={v} out of range")
            if ev["op"] == "partition":
                seen = [r for g in ev["groups"] for r in g]
                if sorted(seen) != sorted(set(seen)) or any(
                        not (0 <= r < n_replicas) for r in seen):
                    raise ValueError(f"{ev}: bad partition groups")
            if ev["op"] == "crash":
                down.add(int(ev["replica"]))
                if len(down) > limit:
                    raise ValueError(
                        f"{ev}: schedule crashes {len(down)} replicas "
                        f"concurrently; at most {limit} of "
                        f"{n_replicas} may be down at once (quorum "
                        "memory is the durability contract)")
            if ev["op"] == "restart":
                if int(ev["replica"]) not in down:
                    raise ValueError(
                        f"{ev}: restart of a replica that is not down")
                down.discard(int(ev["replica"]))

    # ---------------- serialization ----------------

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.events, indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "FaultSchedule":
        return cls(json.loads(text))

    def __len__(self) -> int:
        return len(self.events)

    def apply(self, step: int, cluster, link: LinkModel,
              timers: Optional[StepTimerModel] = None,
              hard: Optional[HardStateTracker] = None,
              kvs=None) -> List[dict]:
        """Fire every event due at ``step`` against the live harness;
        returns the events fired (for logging/history)."""
        fired = self.due(step)
        for ev in fired:
            op = ev["op"]
            if op == "partition":
                link.partition(ev["groups"])
            elif op == "heal":
                link.heal()
            elif op == "block":
                link.block(ev["dst"], ev["src"])
            elif op == "unblock":
                link.unblock(ev.get("dst"), ev.get("src"))
            elif op == "drop":
                link.set_drop(ev["p"], ev.get("dst"), ev.get("src"))
            elif op == "delay":
                link.set_delay(ev["d"], ev.get("dst"), ev.get("src"))
            elif op == "dup":
                link.set_dup(ev["p"], ev.get("dst"), ev.get("src"))
            elif op == "crash":
                crash_replica(cluster, ev["replica"], link)
            elif op == "restart":
                restart_replica(cluster, ev["replica"], link,
                                hard=hard, kvs=kvs)
            elif op == "skew":
                if timers is not None:
                    timers.skew(ev["replica"], ev["factor"])
        return fired


def generate_schedule(seed: int, n_replicas: int, steps: int, *,
                      kinds: Sequence[str] = ("partition", "crash",
                                              "drop", "delay", "dup",
                                              "skew"),
                      intensity: float = 1.0) -> FaultSchedule:
    """Seeded nemesis schedule: a deterministic sequence of fault
    episodes (inject at ``t``, clear/restart at ``t + duration``),
    paced so the cluster gets recovery windows between episodes.
    ``intensity`` scales episode frequency. Same seed ⇒ same schedule,
    always."""
    rng = random.Random(f"schedule:{seed}")   # process-stable seeding
    sched = FaultSchedule()
    R = int(n_replicas)
    down_until: Dict[int, int] = {}
    max_down = (R - 1) // 2
    t = rng.randint(4, 10)
    while t < steps - 8:
        kind = rng.choice(list(kinds))
        dur = rng.randint(3, 10)
        end = min(t + dur, steps - 4)
        if kind == "partition":
            ids = list(range(R))
            rng.shuffle(ids)
            cut = rng.randrange(1, R)
            sched.at(t, "partition", groups=[ids[:cut], ids[cut:]])
            sched.at(end, "heal")
        elif kind == "crash":
            down = {r for r, u in down_until.items() if u > t}
            alive = [r for r in range(R) if r not in down]
            if len(down) < max_down and alive:
                r = rng.choice(alive)
                sched.at(t, "crash", replica=r)
                sched.at(end, "restart", replica=r)
                down_until[r] = end
        elif kind == "drop":
            sched.at(t, "drop", p=rng.uniform(0.1, 0.5))
            sched.at(end, "drop", p=0.0)
        elif kind == "delay":
            i, j = rng.sample(range(R), 2)
            sched.at(t, "delay", d=rng.randint(1, 3), dst=i, src=j)
            sched.at(end, "delay", d=0, dst=i, src=j)
        elif kind == "dup":
            sched.at(t, "dup", p=rng.uniform(0.2, 0.8))
            sched.at(end, "dup", p=0.0)
        elif kind == "skew":
            r = rng.randrange(R)
            sched.at(t, "skew", replica=r,
                     factor=rng.choice([0.3, 0.5, 2.0, 3.0]))
            sched.at(end, "skew", replica=r, factor=1.0)
        t = end + max(2, int(rng.randint(3, 12) / max(intensity, 1e-6)))
    sched.validate(R)
    return sched
