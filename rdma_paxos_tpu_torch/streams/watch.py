"""Watch/subscribe — committed-delta fan-out with exactly-once resume.

The port's copy of the JAX package's ``streams/watch.py`` (the
runtime lock sanitizer's ``maybe_guard`` call left out, ROADMAP Queue
1, item 15).

A :class:`WatchHub` tails each group's committed stream from its own
pump thread (NEVER the readback thread: the engine finish() tail only
kicks a condition variable, so a slow or wedged consumer can never
delay the data path or the ReadHub's queued point reads — the
drain-path decoupling this PR pins by test). Per wake the pump
advances a per-group cursor, decodes the new records once, applies
the app fold's exactly-once acceptance rule (``DedupFold`` — the
mirror of ``ReplicatedKVS._fold``), and fans matching key-range
events into per-subscription BOUNDED deques. Clients pull with
:meth:`Subscription.next`/:meth:`Subscription.poll`; a subscription
that falls ``queue_cap`` behind is marked overflowed and must
reconnect with its resume token — backpressure surfaces as an
explicit resume, never an unbounded queue.

Resume tokens name the last consumed event in the audit chain's own
coordinates ``(group, term, absolute index)`` and additionally carry
the event's stream POSITION — the replay cursor. The hub retains the
last ``retain`` post-fold events per group; a reconnect with a token
replays retained events past the token's position into the fresh
queue before going live — zero duplicates, zero gaps, across leader
failover, lease revocation, and client reconnect. Positions anchor
the replay because they are ALWAYS known (an entry that lost its
decoded coordinates — e.g. via a legacy tuple-view materialization of
the donor stream — still has its position) and failover-stable: the
committed prefix never shrinks and every replica applies the same
committed order, so position k names the same entry on any donor.

Host-pure; shared state guarded by ``_wlock`` (the condition's lock).
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional

from rdma_paxos_tpu_torch.streams.tail import (
    DedupFold, GroupTail, OP_PUT, OP_RM, decode_kvs)


class ResumeExpired(RuntimeError):
    """The resume token points before the hub's retained event window
    — the events needed for a gapless replay are gone."""


class WatchEvent:
    """One exactly-once committed delta."""

    __slots__ = ("group", "term", "index", "pos", "op", "key", "val",
                 "conn", "req")

    def __init__(self, group, term, index, pos, op, key, val, conn,
                 req):
        self.group = group
        self.term = term
        self.index = index     # absolute log index (resume coordinate)
        self.pos = pos
        self.op = op           # OP_PUT | OP_RM
        self.key = key
        self.val = val
        self.conn = conn
        self.req = req

    def token(self) -> dict:
        """Resume token naming THIS event as the last consumed."""
        return dict(group=self.group, term=self.term,
                    index=self.index, pos=self.pos)

    def __repr__(self) -> str:
        return (f"WatchEvent(g={self.group} t={self.term} "
                f"i={self.index} op={self.op} key={self.key!r})")


class Subscription:
    """One client's bounded event queue over a key range."""

    def __init__(self, hub: "WatchHub", sub_id: int, group: int,
                 lo: bytes, hi: Optional[bytes], cap: int):
        self.hub = hub
        self.sub_id = sub_id
        self.group = group
        self.lo = lo
        self.hi = hi
        self.cap = cap
        self.queue: collections.deque = collections.deque()
        self.overflowed = False
        self.closed = False
        self.fail_reason: Optional[str] = None
        self.delivered = 0
        self.last_ev = None    # last popped event (token anchor)

    def _matches(self, ev: WatchEvent) -> bool:
        # group first: the pump fans each group's decoded batch over
        # ALL subscriptions, so key-range alone would leak a sibling
        # group's events into this queue (G > 1)
        return (ev.group == self.group
                and ev.key >= self.lo
                and (self.hi is None or ev.key < self.hi))

    def poll(self, max_n: int = 64) -> List[WatchEvent]:
        """Up to ``max_n`` pending events (non-blocking)."""
        return self.hub._pop(self, max_n, timeout=None)

    def next(self, timeout: Optional[float] = None
             ) -> Optional[WatchEvent]:
        """Block up to ``timeout`` for one event; None on timeout or
        closed-and-drained."""
        got = self.hub._pop(self, 1, timeout=timeout)
        return got[0] if got else None

    def token(self) -> Optional[dict]:
        """Resume token of the last CONSUMED event (None before the
        first pop — resume-from-start)."""
        last = self.last_ev
        return None if last is None else last.token()

    def close(self) -> None:
        self.hub.unsubscribe(self.sub_id)


class WatchHub:
    """Per-group watch cursors + the pump thread (see module doc)."""

    def __init__(self, tails: List[GroupTail], *, obs=None,
                 queue_cap: int = 1024, retain: int = 1 << 16,
                 cdc=None):
        self.obs = obs
        self.queue_cap = int(queue_cap)
        self.retain = int(retain)
        self.cdc = cdc
        self._tails = {t.group: t for t in tails}
        self._wlock = threading.Lock()
        self._wcv = threading.Condition(self._wlock)
        # guarded-by: _wlock
        self._wsubs: Dict[int, Subscription] = {}
        # guarded-by: _wlock
        self._wcursor: Dict[int, int] = {t.group: 0 for t in tails}
        # guarded-by: _wlock
        self._wtarget: Dict[int, int] = {t.group: 0 for t in tails}
        # guarded-by: _wlock
        self._wevents: Dict[int, List[WatchEvent]] = {
            t.group: [] for t in tails}
        # guarded-by: _wlock
        self._wfold: Dict[int, DedupFold] = {
            t.group: DedupFold() for t in tails}
        # highest event position/index ever trimmed from retention
        # per group (-1 = nothing trimmed): the EXACT resume-gap
        # bound — a token at/under it cannot replay gapless
        # guarded-by: _wlock
        self._wtrim: Dict[int, int] = {t.group: -1 for t in tails}
        # guarded-by: _wlock
        self._wtrimidx: Dict[int, int] = {t.group: -1 for t in tails}
        self._wnext_id = 1        # guarded-by: _wlock
        self._wstopped = False    # guarded-by: _wlock
        self.events_total = 0     # guarded-by: _wlock
        # earliest un-dispatched kick timestamp per group — anchors a
        # watch-delivery trace at COMMIT time, so the merged timeline
        # shows commit → pump → deliver. Only populated while the
        # trace plane samples.  # guarded-by: _wlock
        self._wkick: Dict[int, float] = {}
        self._pump = threading.Thread(
            target=self._pump_loop, name="watch-pump", daemon=True)
        self._pump.start()

    # ---------------- client surface ----------------

    def subscribe(self, group: int = 0, *, lo: bytes = b"",
                  hi: Optional[bytes] = None,
                  token: Optional[dict] = None,
                  cap: Optional[int] = None) -> Subscription:
        """Open a subscription over ``[lo, hi)`` of ``group``. With a
        resume ``token``, retained events past the token replay into
        the queue first — gapless, duplicate-free — then live events
        follow."""
        with self._wlock:
            if self._wstopped:
                raise RuntimeError("watch hub stopped")
            sub = Subscription(self, self._wnext_id, int(group),
                               bytes(lo), hi, self.queue_cap
                               if cap is None else int(cap))
            self._wnext_id += 1
            if token is not None:
                if int(token["group"]) != int(group):
                    raise ValueError("token group mismatch")
                tpos = token.get("pos")
                if tpos is not None:
                    # position-anchored replay (the robust path: every
                    # event has one — see the module docstring)
                    tpos = int(tpos)
                    if tpos < self._wtrim[sub.group]:
                        # an event past the token was trimmed from
                        # retention — a replay would silently gap
                        raise ResumeExpired(
                            f"resume position {tpos} precedes the "
                            f"retained window (trimmed through "
                            f"{self._wtrim[sub.group]})")
                    for ev in self._wevents[sub.group]:
                        if ev.pos > tpos and sub._matches(ev):
                            sub.queue.append(ev)
                else:
                    # coordinate-only token (external/persisted form)
                    after = int(token["index"])
                    if after < self._wtrimidx[sub.group]:
                        raise ResumeExpired(
                            f"resume index {after} precedes the "
                            f"retained window (trimmed through "
                            f"{self._wtrimidx[sub.group]})")
                    for ev in self._wevents[sub.group]:
                        if ev.index > after and sub._matches(ev):
                            sub.queue.append(ev)
            self._wsubs[sub.sub_id] = sub
            return sub

    def unsubscribe(self, sub_id: int) -> None:
        with self._wlock:
            sub = self._wsubs.pop(sub_id, None)
            if sub is not None:
                sub.closed = True
            self._wcv.notify_all()

    def _pop(self, sub: Subscription, max_n: int,
             timeout: Optional[float]) -> List[WatchEvent]:
        with self._wlock:
            if timeout is not None:
                self._wcv.wait_for(
                    lambda: sub.queue or sub.closed or self._wstopped,
                    timeout)
            out = []
            while sub.queue and len(out) < max_n:
                out.append(sub.queue.popleft())
            if out:
                sub.last_ev = out[-1]
            return out

    # ---------------- engine-side surface ----------------

    def kick(self, lengths: Dict[int, int]) -> None:
        """New committed frontier (engine finish() tail, readback
        thread): record per-group targets and wake the pump. O(G) —
        never decodes, never blocks on a consumer."""
        from rdma_paxos_tpu_torch.obs.tracectx import active_tracer
        tr = active_tracer(self.obs)
        with self._wlock:
            for g, n in lengths.items():
                if n > self._wtarget.get(g, 0):
                    self._wtarget[g] = n
                    if tr is not None:
                        # keep the EARLIEST pending kick: latency is
                        # measured from the first commit the pump has
                        # not yet caught up to
                        self._wkick.setdefault(g, tr.now())
            self._wcv.notify_all()

    def wait_caught_up(self, lengths: Dict[int, int],
                       timeout: float = 10.0) -> bool:
        """Kick the pump to the given per-group frontiers and block
        until its cursors reach them (or ``timeout``/stop). The
        flush primitive for run-end drains — callers in
        replay-deterministic modules (the chaos runner) must not spin
        on wall clock themselves."""
        # holds-lock: _wlock  (wait_for invokes the predicate held)
        def ready():
            return self._wstopped or all(
                self._wcursor.get(g, 0) >= int(n)
                for g, n in lengths.items())
        with self._wlock:
            for g, n in lengths.items():
                if int(n) > self._wtarget.get(g, 0):
                    self._wtarget[g] = int(n)
            self._wcv.notify_all()
            self._wcv.wait_for(ready, timeout)
            return all(self._wcursor.get(g, 0) >= int(n)
                       for g, n in lengths.items())

    def cursors(self) -> Dict[int, int]:
        """Per-group pump positions (CDC lag = tail - cursor)."""
        with self._wlock:
            return dict(self._wcursor)

    def backlogs(self) -> Dict[int, int]:
        """Per-group undispatched depth (target - cursor) plus the
        deepest subscriber queue — the governor reads this as demand."""
        with self._wlock:
            out = {}
            for g in self._wcursor:
                lag = self._wtarget.get(g, 0) - self._wcursor[g]
                qmax = max((len(s.queue) for s in self._wsubs.values()
                            if s.group == g), default=0)
                out[g] = max(0, lag) + qmax
            return out

    # ---------------- pump ----------------

    def _pump_loop(self) -> None:
        # lock order: _wlock is NEVER held across the tail snapshot
        # (which takes the engine host lock) — the governor reads
        # backlogs() without the host lock, so no cycle exists
        while True:
            with self._wlock:
                self._wcv.wait_for(
                    lambda: self._wstopped or any(
                        self._wtarget.get(g, 0) > c
                        for g, c in self._wcursor.items()))
                if self._wstopped:
                    return
                work = [(g, c, self._wtarget.get(g, 0))
                        for g, c in self._wcursor.items()
                        if self._wtarget.get(g, 0) > c]
            for g, lo, hi in work:
                recs = self._tails[g].records(lo, hi)
                self._dispatch(g, lo, hi, recs)

    def _dispatch(self, g: int, lo: int, hi: int, recs) -> None:
        from rdma_paxos_tpu_torch.obs.tracectx import active_tracer
        tr = active_tracer(self.obs)
        tid = None
        if tr is not None:
            with self._wlock:
                k0 = self._wkick.pop(g, None)
            # t0 = the kick (commit frontier advance); "pump" marks
            # when the pump thread actually picked the batch up
            tid = tr.begin("watch", ts=k0, group=g, lo=lo, hi=hi)
            tr.phase(tid, "pump")
        if self.cdc is not None:
            self.cdc.write_records(g, recs)
        events = []
        with self._wlock:
            fold = self._wfold[g]
            for rec in recs:
                if not fold.accept(rec):
                    continue
                cmd = decode_kvs(rec.payload)
                if cmd is None:
                    continue
                op, key, val = cmd
                if op not in (OP_PUT, OP_RM):
                    continue
                events.append(WatchEvent(
                    g, rec.term, rec.index, rec.pos, op, key, val,
                    rec.conn, rec.req))
            self._wcursor[g] = max(self._wcursor[g], hi)
            retained = self._wevents[g]
            retained.extend(events)
            if len(retained) > self.retain:
                cut = len(retained) - self.retain
                self._wtrim[g] = max(self._wtrim[g],
                                     retained[cut - 1].pos)
                self._wtrimidx[g] = max(
                    [self._wtrimidx[g]]
                    + [e.index for e in retained[:cut]
                       if e.index >= 0])
                del retained[:cut]
            delivered = 0
            for sub in self._wsubs.values():
                for ev in events:
                    if not sub._matches(ev):
                        continue
                    if len(sub.queue) >= sub.cap:
                        sub.overflowed = True
                        break
                    sub.queue.append(ev)
                    sub.delivered += 1
                    delivered += 1
            self.events_total += delivered
            self._wcv.notify_all()
        if tid is not None:
            tr.phase(tid, "deliver")
            tr.end(tid, events=len(events), delivered=delivered)
        if self.obs is not None and events:
            self.obs.metrics.inc("watch_events_delivered_total",
                                 delivered, group=g)

    # ---------------- lifecycle ----------------

    def fail_all(self, reason: str) -> None:
        """Stop the pump and close every subscription (driver stop
        path — mirrors ``ReadHub.fail_all``): a watcher blocked in
        ``next()`` wakes with the queue drained and ``closed`` set,
        never hangs on a dead engine."""
        with self._wlock:
            if self._wstopped:
                return
            self._wstopped = True
            for sub in self._wsubs.values():
                sub.closed = True
                sub.fail_reason = reason
            self._wcv.notify_all()
        self._pump.join(timeout=5.0)
        if self.cdc is not None:
            self.cdc.flush()

    def status(self) -> dict:
        with self._wlock:
            return dict(
                subs=len(self._wsubs),
                events_total=self.events_total,
                cursors=dict(self._wcursor),
                targets=dict(self._wtarget),
                overflowed=sum(1 for s in self._wsubs.values()
                               if s.overflowed),
                stopped=self._wstopped)
