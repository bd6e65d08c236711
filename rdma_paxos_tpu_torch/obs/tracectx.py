"""One causal trace plane — cross-subsystem provenance on the shared
clock.

The port's copy of the JAX package's ``obs/tracectx.py`` (standard
library only).

:mod:`~rdma_paxos_tpu_torch.obs.spans` follows ONE consensus command; this
module links what happens *around* commands into the same timeline:

* :class:`TraceContext` — a thread-safe, bounded store of subsystem
  traces. A trace is a named interval with ordered **phases** (the
  txn coordinator's lock-wait → prepare → vote-wait → decide chain, a
  topology window's seed → freeze → verify → cutover chain, a watch
  delivery's pump → deliver chain), **links** to the `(conn, req)`
  span keys of the consensus records it fanned out, a **parent**
  pointer for blame ("this txn aborted because THAT transition window
  froze its range"), and free-form attrs. Trace ids are deterministic
  (`kind-N` from a per-kind counter) so chaos runs replay
  bit-identically under a scripted clock.

* :func:`merge_timeline` — folds span dumps AND trace dumps into one
  Perfetto-loadable Chrome trace JSON: replica tracks + critical-path
  tracks from :func:`~rdma_paxos_tpu_torch.obs.spans.to_chrome_trace`, plus
  one pseudo-process per subsystem (txn / topology / watch) whose
  tracks carry the phase slices. Everything aligns on the shared
  :mod:`~rdma_paxos_tpu_torch.obs.clock` anchors, so cross-host dumps merge
  the same way span dumps always have.

* :func:`blame` — the critical-path blame report: decomposes each
  sampled command's latency into admission / txn-lock /
  topology-freeze / dispatch / quorum / apply / ack and names the
  dominant phase per percentile. `txn-lock` comes from a linked txn
  trace's lock-wait phase; `topology-freeze` is the span's overlap
  with any transition window's freeze→cutover interval — the two
  components no single-subsystem view can see.

HARD RULE (inherited from the rest of ``obs``): host-side only. No
call site lives inside the replica step; enabling tracing
changes no compiled programs and no step outputs. An unsampled
command costs one counter increment (its subsystem never calls in:
:func:`active_tracer` gates on the same sampling switch the span
recorder uses).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Tuple

from rdma_paxos_tpu_torch.obs.clock import anchor as clock_anchor
from rdma_paxos_tpu_torch.obs.spans import (
    ACK, APPEND, APPLY, CP_PHASES, ENQUEUE, QUORUM, SUBMIT,
    to_chrome_trace)

DEFAULT_CAPACITY = 1024

# subsystem pseudo-processes on the merged timeline (below the span
# exporter's CP_PID=9999 / READS_PID=9998)
SUBSYS_PIDS = {"txn": 9997, "topology": 9996, "watch": 9995}
OTHER_SUBSYS_PID = 9990

# the blame decomposition, in report order (also the dominance
# tie-break order: earlier wins a tie)
BLAME_PHASES = ("admission", "txn_lock", "topology_freeze",
                "dispatch", "quorum", "apply", "ack")


class _Trace:
    """One subsystem trace (host bookkeeping only)."""

    __slots__ = ("tid", "kind", "parent", "status", "t0", "t1",
                 "phases", "links", "attrs")

    def __init__(self, tid: str, kind: str, parent: Optional[str],
                 t0: float, attrs: dict):
        self.tid = tid
        self.kind = kind
        self.parent = parent
        self.status = "open"
        self.t0 = t0
        self.t1: Optional[float] = None
        self.phases: List[List] = []       # [name, ts] in call order
        self.links: List[List[int]] = []   # [conn, req, group]
        self.attrs: dict = dict(attrs)

    def as_dict(self) -> dict:
        return dict(tid=self.tid, kind=self.kind, parent=self.parent,
                    status=self.status, t0=self.t0, t1=self.t1,
                    phases=[list(p) for p in self.phases],
                    links=[list(l) for l in self.links],
                    attrs=dict(self.attrs))


class TraceContext:
    """Thread-safe, bounded store of cross-subsystem traces.

    Ids are deterministic (``kind-N``) so two chaos runs of the same
    seed under a scripted clock dump byte-identical timelines. The
    store is leaf-locked: every method takes only ``_lock`` and calls
    nothing that locks, so producers may call in while holding their
    own subsystem locks (the txn coordinator and topology controller
    both do) without lock-order hazards.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 clock=time.monotonic):
        self.capacity = int(capacity)
        self._clock = clock
        self._lock = threading.Lock()
        # guarded-by: _lock [writes]
        self._open: Dict[str, _Trace] = {}
        # guarded-by: _lock [writes]
        self._done: collections.deque = collections.deque(
            maxlen=self.capacity)
        # guarded-by: _lock [writes] — per-kind id counters
        self._seq: Dict[str, int] = {}
        self.dropped = 0                   # evicted-while-open count

    def now(self) -> float:
        """The context's clock — producers that backdate a trace start
        (e.g. the watch hub stamping commit time at kick) read it here
        so every timestamp in one dump shares a timebase."""
        return self._clock()

    @property
    def open_count(self) -> int:
        return len(self._open)

    # ---------------- recording ----------------

    def begin(self, kind: str, parent: Optional[str] = None,
              ts: Optional[float] = None, **attrs) -> str:
        """Open a trace; returns its deterministic id (``kind-N``)."""
        with self._lock:
            n = self._seq.get(kind, 0)
            self._seq[kind] = n + 1
            tid = f"{kind}-{n}"
            if len(self._open) >= self.capacity:
                # evict the oldest open trace (a leaked/abandoned one)
                # rather than refusing new work forever
                old = next(iter(self._open))
                self._end_locked(self._open[old], "evicted",
                                 self._clock())
                self.dropped += 1
            tr = _Trace(tid, kind, parent,
                        self._clock() if ts is None else float(ts),
                        attrs)
            self._open[tid] = tr
            return tid

    def phase(self, tid: str, name: str, ts: Optional[float] = None,
              once: bool = False) -> None:
        """Stamp a named phase start on an open trace (no-op on an
        unknown/ended id). ``once=True`` dedupes: a driver loop that
        re-enters the same controller state each tick records the
        phase only the first time."""
        with self._lock:
            tr = self._open.get(tid)
            if tr is None:
                return
            if once and any(p[0] == name for p in tr.phases):
                return
            tr.phases.append(
                [name, self._clock() if ts is None else float(ts)])

    def annotate(self, tid: str, **attrs) -> None:
        with self._lock:
            tr = self._open.get(tid)
            if tr is not None:
                tr.attrs.update(attrs)

    def link(self, tid: str, conn: int, req: int,
             group: int = -1) -> None:
        """Link a consensus record's span key ``(conn, req)`` (and its
        group) to this trace — the join column the blame report and
        the merged timeline use."""
        with self._lock:
            tr = self._open.get(tid)
            if tr is not None:
                tr.links.append([int(conn), int(req), int(group)])

    def set_parent(self, tid: str, parent: Optional[str]) -> None:
        """Late-bind the blocking parent (e.g. a TOPOLOGY-aborted txn
        learns its transition window only at abort time)."""
        with self._lock:
            tr = self._open.get(tid)
            if tr is not None:
                tr.parent = parent

    def end(self, tid: str, status: str = "done",
            ts: Optional[float] = None, **attrs) -> None:
        with self._lock:
            tr = self._open.get(tid)
            if tr is None:
                return
            if attrs:
                tr.attrs.update(attrs)
            self._end_locked(tr, status,
                             self._clock() if ts is None else float(ts))

    # holds-lock: _lock
    def _end_locked(self, tr: _Trace, status: str, t1: float) -> None:
        tr.status = status
        tr.t1 = t1
        self._open.pop(tr.tid, None)
        self._done.append(tr)

    def fail_open(self, status: str = "failover") -> int:
        """Terminate EVERY open trace (process stop / driver crash):
        the trace-plane analogue of ``SpanRecorder.fail_open`` — open
        traces must terminate, never leak. Returns the count."""
        n = 0
        with self._lock:
            ts = self._clock()
            for tr in list(self._open.values()):
                self._end_locked(tr, status, ts)
                n += 1
        return n

    # ---------------- queries / export ----------------

    def get(self, tid: str) -> Optional[dict]:
        with self._lock:
            tr = self._open.get(tid)
            if tr is not None:
                return tr.as_dict()
            for done in self._done:
                if done.tid == tid:
                    return done.as_dict()
        return None

    def counts(self) -> dict:
        with self._lock:
            by_kind: Dict[str, int] = {}
            for tr in self._done:
                by_kind[tr.kind] = by_kind.get(tr.kind, 0) + 1
            return dict(open=len(self._open), done=len(self._done),
                        dropped=self.dropped, by_kind=by_kind)

    def dump(self, anchor: Optional[dict] = None) -> dict:
        """Point-in-time trace dump, stamped with the shared clock
        anchor — merges with span dumps from any process on one
        timebase. Open traces are included as-is (status ``open``)."""
        with self._lock:
            traces = ([tr.as_dict() for tr in self._done]
                      + [tr.as_dict() for tr in self._open.values()])
        return dict(schema=1,
                    anchor=anchor if anchor is not None
                    else clock_anchor(),
                    dropped=self.dropped, traces=traces)

    def write_json(self, path: str) -> str:
        import json
        import os
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.dump(), f, indent=2)
        os.replace(tmp, path)
        return path

    def reset(self) -> None:
        with self._lock:
            self._open.clear()
            self._done.clear()
            self._seq.clear()
            self.dropped = 0


def active_tracer(obs) -> Optional[TraceContext]:
    """The facade's trace context iff tracing is enabled — gated on
    the SAME sampling switch as :func:`active_recorder`, so an
    operator who turns spans off (``RP_TRACE_SAMPLE=0``) silences the
    whole trace plane with it and an unsampled deployment pays one
    counter increment per command, nothing more."""
    if obs is None:
        return None
    tc = getattr(obs, "tracectx", None)
    if tc is None:
        return None
    sp = getattr(obs, "spans", None)
    return tc if (sp is not None and sp.enabled) else None


# ---------------------------------------------------------------------------
# merged Perfetto timeline (spans + subsystem traces)
# ---------------------------------------------------------------------------

def _wall_fn(dump: dict):
    a = dump["anchor"]

    def wall(ts, _a=a):
        return _a["wall"] + (ts - _a["monotonic"])

    return wall


def _as_list(dumps) -> List[dict]:
    if dumps is None:
        return []
    if isinstance(dumps, dict):
        return [dumps]
    return list(dumps)


def merge_timeline(span_dumps, trace_dumps=(), *,
                   t0_wall: Optional[float] = None) -> dict:
    """Merge span dumps AND trace dumps into ONE Perfetto-loadable
    Chrome trace JSON: the span exporter's replica / critical-path /
    reads tracks, plus one pseudo-process per subsystem kind whose
    tracks carry each trace as an outer slice with nested phase
    slices. All dumps align via their stamped clock anchors; the
    timeline epoch is the min wall timestamp across BOTH planes (or
    ``t0_wall`` when given), so a txn trace, its prepare-record spans,
    the transition window that aborted it, and the watch delivery of
    the commit all land on the same axis."""
    span_dumps = _as_list(span_dumps)
    trace_dumps = _as_list(trace_dumps)
    walls: List[float] = []
    for d in span_dumps:
        wall = _wall_fn(d)
        for sp in d["spans"]:
            walls.extend(wall(ts) for _, _, ts in sp["events"])
        for rd in d.get("reads", ()):
            walls.append(wall(rd["t0"]))
    prepared = []
    for d in trace_dumps:
        wall = _wall_fn(d)
        for tr in d["traces"]:
            walls.append(wall(tr["t0"]))
        prepared.append((d, wall))
    t0 = (t0_wall if t0_wall is not None
          else (min(walls) if walls else 0.0))
    out = to_chrome_trace(span_dumps, t0_wall=t0)
    events = out["traceEvents"]

    def us(w):
        return round((w - t0) * 1e6, 3)

    tids: Dict[int, int] = {}              # pid -> next track id
    pids_seen: Dict[int, str] = {}
    n_traces = 0
    for d, wall in prepared:
        for tr in d["traces"]:
            n_traces += 1
            pid = SUBSYS_PIDS.get(tr["kind"], OTHER_SUBSYS_PID)
            pids_seen.setdefault(
                pid, tr["kind"] if pid != OTHER_SUBSYS_PID
                else "subsystem")
            tid = tids.get(pid, 0) + 1
            tids[pid] = tid
            ta = wall(tr["t0"])
            # an open trace renders up to its last known timestamp
            tz = tr["t1"] if tr["t1"] is not None else (
                tr["phases"][-1][1] if tr["phases"] else tr["t0"])
            tb = wall(tz)
            args = dict(trace=tr["tid"], kind=tr["kind"],
                        status=tr["status"], parent=tr["parent"],
                        links=[f"c{c}/r{r}" for c, r, _ in tr["links"]])
            args.update(tr["attrs"])
            events.append(dict(
                name="thread_name", ph="M", pid=pid, tid=tid,
                args=dict(name=f"{tr['tid']} [{tr['status']}]")))
            events.append(dict(
                name=f"{tr['tid']} [{tr['status']}]", ph="X",
                ts=us(ta), dur=round(max(tb - ta, 0.0) * 1e6, 3),
                pid=pid, tid=tid, args=args))
            # nested phase slices: each named phase runs from its
            # stamp to the next phase's stamp (or trace end)
            bounds = [wall(ts) for _, ts in tr["phases"]] + [tb]
            for (name, _), pa, pb in zip(tr["phases"], bounds,
                                         bounds[1:]):
                events.append(dict(
                    name=name, ph="X", ts=us(pa),
                    dur=round(max(pb - pa, 0.0) * 1e6, 3),
                    pid=pid, tid=tid, args=dict(trace=tr["tid"])))
    for pid in sorted(pids_seen):
        events.append(dict(name="process_name", ph="M", pid=pid,
                           tid=0, args=dict(name=pids_seen[pid])))
    out["otherData"]["traces"] = n_traces
    return out


# ---------------------------------------------------------------------------
# critical-path blame
# ---------------------------------------------------------------------------

def _span_marks(sp: dict, wall) -> Dict[str, float]:
    marks: Dict[str, float] = {}
    for phase, rep, ts in sp["events"]:
        if phase not in CP_PHASES:
            continue
        if phase == APPLY and rep != sp["origin"] and APPLY in marks:
            continue
        if phase in marks and phase != APPLY:
            continue
        marks[phase] = wall(ts)
    return marks


def blame(span_dumps, trace_dumps=()) -> dict:
    """Decompose per-command latency into the BLAME_PHASES components
    and name the dominant phase per percentile.

    Pure-span components come from a span's own phase marks
    (admission = submit→enqueue, dispatch = →append, quorum =
    →quorum, apply = →apply, ack = →ack); `txn_lock` is the lock-wait
    of a txn trace that LINKS the span's ``(conn, req)`` key;
    `topology_freeze` is the span's overlap with any topology trace's
    freeze→cutover window. The command total is its span extent plus
    its txn lock-wait (the wait precedes submit — invisible to the
    span, real to the client)."""
    span_dumps = _as_list(span_dumps)
    trace_dumps = _as_list(trace_dumps)
    # (conn, req) -> lock-wait seconds, from txn traces
    lock_wait: Dict[Tuple[int, int], float] = {}
    # [t_freeze_wall, t_end_wall) transition windows
    windows: List[Tuple[float, float]] = []
    for d in trace_dumps:
        wall = _wall_fn(d)
        for tr in d["traces"]:
            ph = {name: wall(ts) for name, ts in tr["phases"]}
            if tr["kind"] == "txn" and "lock_wait" in ph:
                until = ph.get("prepare", ph.get("merge"))
                if until is None and tr["t1"] is not None:
                    until = wall(tr["t1"])
                if until is not None and until > ph["lock_wait"]:
                    w = until - ph["lock_wait"]
                    for conn, req, _ in tr["links"]:
                        lock_wait[(conn, req)] = w
            elif tr["kind"] == "topology" and "freeze" in ph:
                end = ph.get("cutover")
                if end is None and tr["t1"] is not None:
                    end = wall(tr["t1"])
                if end is not None and end > ph["freeze"]:
                    windows.append((ph["freeze"], end))
    rows: List[Tuple[float, Dict[str, float]]] = []
    for d in span_dumps:
        wall = _wall_fn(d)
        for sp in d["spans"]:
            marks = _span_marks(sp, wall)
            chain = [(p, marks[p]) for p in CP_PHASES if p in marks]
            if len(chain) < 2:
                continue
            comp: Dict[str, float] = {}

            def _seg(name, a, b):
                if a in marks and b in marks and marks[b] > marks[a]:
                    comp[name] = comp.get(name, 0.0) + (
                        marks[b] - marks[a])

            _seg("admission", SUBMIT, ENQUEUE)
            if ENQUEUE in marks:
                _seg("dispatch", ENQUEUE, APPEND)
            else:
                _seg("dispatch", SUBMIT, APPEND)
            _seg("quorum", APPEND, QUORUM)
            _seg("apply", QUORUM, APPLY)
            _seg("ack", APPLY, ACK)
            lw = lock_wait.get((sp["conn"], sp["req"]))
            if lw:
                comp["txn_lock"] = lw
            a, b = chain[0][1], chain[-1][1]
            frozen = sum(max(0.0, min(b, w1) - max(a, w0))
                         for w0, w1 in windows)
            if frozen > 0:
                comp["topology_freeze"] = frozen
            total = (b - a) + comp.get("txn_lock", 0.0)
            if total > 0:
                rows.append((total, comp))
    doc = dict(commands=len(rows), phases={}, percentiles={})
    if not rows:
        return doc
    grand = sum(t for t, _ in rows)
    agg: Dict[str, List[float]] = {}
    for _, comp in rows:
        for name, v in comp.items():
            agg.setdefault(name, []).append(v)
    for name in BLAME_PHASES:
        vals = agg.get(name)
        if not vals:
            continue
        tot = sum(vals)
        doc["phases"][name] = dict(
            n=len(vals), total_us=round(tot * 1e6, 1),
            mean_us=round(tot / len(vals) * 1e6, 1),
            max_us=round(max(vals) * 1e6, 1),
            share=round(tot / grand, 4) if grand else 0.0)
    rows.sort(key=lambda r: r[0])
    n = len(rows)
    for pname, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
        total, comp = rows[min(int(n * q), n - 1)]
        dom, dv = None, -1.0
        for name in BLAME_PHASES:
            v = comp.get(name, 0.0)
            if v > dv:
                dom, dv = name, v
        doc["percentiles"][pname] = dict(
            latency_us=round(total * 1e6, 1), dominant=dom,
            components={name: round(comp[name] * 1e6, 1)
                        for name in BLAME_PHASES if name in comp})
    return doc


def format_blame(doc: dict) -> str:
    lines = [f"commands: {doc['commands']}"]
    if not doc["commands"]:
        return lines[0] + " (nothing sampled)"
    width = max(len(p) for p in BLAME_PHASES)
    lines.append(f"{'phase'.ljust(width)}  {'n':>7} {'total_us':>12} "
                 f"{'mean_us':>10} {'max_us':>10} {'share':>7}")
    for name in BLAME_PHASES:
        st = doc["phases"].get(name)
        if st is None:
            continue
        lines.append(f"{name.ljust(width)}  {st['n']:>7} "
                     f"{st['total_us']:>12.1f} {st['mean_us']:>10.1f} "
                     f"{st['max_us']:>10.1f} {st['share']:>7.1%}")
    for pname in ("p50", "p95", "p99"):
        pe = doc["percentiles"].get(pname)
        if pe is None:
            continue
        parts = " ".join(f"{k}={v:.1f}us"
                         for k, v in pe["components"].items())
        lines.append(f"{pname}: {pe['latency_us']:.1f}us dominated by "
                     f"{pe['dominant']} ({parts})")
    return "\n".join(lines)


def blame_summary(doc: dict) -> Optional[dict]:
    """Compact per-percentile dominant-phase summary for health
    snapshots / the console BLAME column."""
    if not doc.get("commands"):
        return None
    out = {p: doc["percentiles"][p]["dominant"]
           for p in ("p50", "p95", "p99")
           if p in doc["percentiles"]}
    if "p99" in doc["percentiles"]:
        out["p99_us"] = doc["percentiles"]["p99"]["latency_us"]
    return out or None


def health_blame(obs) -> Optional[dict]:
    """The one-liner the drivers embed in health snapshots: blame over
    the process's own live span/trace dumps, or None when tracing is
    off / nothing sampled yet."""
    rec = getattr(obs, "spans", None) if obs is not None else None
    if rec is None or not rec.enabled:
        return None
    sd = rec.dump()
    if not sd["spans"]:
        return None
    tc = getattr(obs, "tracectx", None)
    tds = [tc.dump()] if tc is not None else []
    return blame_summary(blame([sd], tds))
