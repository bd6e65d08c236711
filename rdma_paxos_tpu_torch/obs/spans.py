"""Causal command tracing and step-phase attribution.

The port's copy of the first part of the JAX package's
``obs/spans.py``: :class:`SpanRecorder` (sampled end-to-end command
spans, correlated across replicas by ``(term, index)``),
:func:`span_trace_id`, :func:`active_recorder` and
:class:`StepPhaseProfiler` (wall time per hot-loop phase into
``step_phase_us{phase=...}``), and its Chrome trace-event export
(:func:`to_chrome_trace`, which ``obs/tracectx.py:merge_timeline``
builds on). The profiler's opt-in fence waits for the CUDA device the
step's outputs live on (``torch.cuda.synchronize``) where the JAX
package blocks on the outputs. The critical-path breakdown
(:func:`breakdown`, :func:`format_breakdown`) and the CLI —
``python -m rdma_paxos_tpu_torch.obs.spans merge|dump|report`` — are
the reference's too.

Host-side only: nothing here runs inside the replica step.
"""

from __future__ import annotations

import argparse
import collections
import heapq
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from rdma_paxos_tpu_torch.obs.clock import anchor as clock_anchor
from rdma_paxos_tpu_torch.obs.metrics import LATENCY_BUCKETS_US

# ---------------------------------------------------------------------------
# span phases (the causal chain of one client command)
# ---------------------------------------------------------------------------

SUBMIT = "submit"        # client session issued the command
ENQUEUE = "enqueue"      # proxy queued it for the consensus step
APPEND = "append"        # leader appended it — stamped (term, index)
QUORUM = "quorum"        # majority acked: the LEADER's commit covers it
COMMIT = "commit"        # a replica's commit index covers it
APPLY = "apply"          # a replica's host apply covers it
ACK = "ack"              # client ack released
RETRANSMIT = "retransmit"  # the same (conn, req) was re-submitted
FAIL = "fail"            # terminal failure mark

# ordered critical-path phases (per-replica COMMIT marks are evidence,
# not client-visible latency; APPLY uses the origin replica's mark)
CP_PHASES = (SUBMIT, ENQUEUE, APPEND, QUORUM, APPLY, ACK)

# terminal statuses
OPEN = "open"            # still in flight (or never resolved)
DONE = "done"            # acked to the client
FAILOVER = "failover"    # failed at deposition / step-down / stop

DEFAULT_SAMPLE_EVERY = 64
DEFAULT_CAPACITY = 4096

# runtime override for the sampling rate: every recorder built without
# an explicit ``sample_every`` (the driver, the sharded driver, the
# RP_GOVERNOR daemon — all construct a default Observability) honors
# it. 0 disables tracing entirely; garbage falls back to the default.
SAMPLE_ENV = "RP_TRACE_SAMPLE"


def default_sample_every() -> int:
    raw = os.environ.get(SAMPLE_ENV)
    if raw is None:
        return DEFAULT_SAMPLE_EVERY
    try:
        return max(0, int(raw))
    except ValueError:
        return DEFAULT_SAMPLE_EVERY


def span_trace_id(conn: int, req: int) -> str:
    """The stable external id of one command span — what exemplars
    carry and what ``obs blame``/Perfetto label spans as."""
    return f"c{conn}/r{req}"


class _Span:
    """One sampled command's causal record (host bookkeeping only)."""

    __slots__ = ("conn", "req", "origin", "term", "index", "leader",
                 "group", "status", "retransmits", "pending_marks",
                 "events")

    def __init__(self, conn: int, req: int, origin: int):
        self.conn = conn
        self.req = req
        self.origin = origin           # replica the command entered at
        self.term: Optional[int] = None
        self.index: Optional[int] = None
        self.leader: Optional[int] = None
        self.group = -1                # consensus group (-1: unsharded)
        self.status = OPEN
        self.retransmits = 0
        # commit+apply marks still expected (2 per correlated replica);
        # a DONE span retires once they all arrive
        self.pending_marks = 0
        self.events: List[Tuple[str, int, float]] = []  # (phase, rep, ts)

    def as_dict(self) -> dict:
        d = dict(conn=self.conn, req=self.req, origin=self.origin,
                 term=self.term, index=self.index, leader=self.leader,
                 status=self.status, retransmits=self.retransmits,
                 events=[[p, r, t] for (p, r, t) in self.events])
        if self.group >= 0:
            # sharded spans carry their group; unsharded dumps keep the
            # pre-sharding schema byte-for-byte (golden-file pinned)
            d["group"] = self.group
        return d


class SpanRecorder:
    """Thread-safe, bounded, sampled recorder of command spans.

    Keys: a command is identified by ``(conn, req)`` — the driver's
    globally-unique connection id + per-replica submit sequence, or a
    KVS session's ``(client_id, req_id)`` stamp. A retransmit reuses
    the key, so it lands on the SAME span (it is the same logical
    command).

    Frontier marks are O(log open-spans) via per-replica heaps:
    ``commit_advance(r, n)`` / ``apply_advance(r, n)`` pop every
    sampled span whose stamped absolute index is below the frontier.
    Indices are ABSOLUTE (rebase-corrected): callers add their
    ``rebased_total`` so i32 rollovers never tear a span.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 sample_every: Optional[int] = None,
                 clock=time.monotonic):
        self.capacity = capacity
        if sample_every is None:
            # resolved at construction (not import) so a test/daemon
            # that sets RP_TRACE_SAMPLE after import still wins
            sample_every = default_sample_every()
        self.sample_every = max(0, int(sample_every))  # 0 = disabled
        self._clock = clock
        self._lock = threading.Lock()
        self._counter = 0                  # commands seen (sampling)
        self._open: Dict[Tuple[int, int], _Span] = {}
        self._done: collections.deque = collections.deque(maxlen=capacity)
        # acked spans still awaiting commit/apply marks (FIFO): a
        # permanently-stopped replica's frontier never advances, so at
        # capacity the oldest of these is force-retired — the client
        # already has its ack; the missing marks ARE the evidence —
        # instead of wedging the recorder for the process lifetime
        self._done_pending: "collections.OrderedDict" = \
            collections.OrderedDict()
        self.dropped = 0                   # samples refused at capacity
        # (group, term, index) -> key, for cross-replica correlation
        # queries (group -1 = unsharded single-group callers)
        self._by_ti: Dict[Tuple[int, int, int], Tuple[int, int]] = {}
        # per-replica frontier heaps: (abs_index, key)
        self._await_commit: Dict[int, list] = {}
        self._await_apply: Dict[int, list] = {}
        # per-origin-replica ack matching: (req, key) — the driver
        # releases acks by monotone submit sequence
        self._await_ack: Dict[int, list] = {}
        # cheap read-span variant (runtime/reads.py): completed
        # lease/read-index reads as (replica, path, t0, t1) records —
        # no correlation machinery, own sampling counter so read
        # traffic can never shift which COMMANDS get sampled
        self._reads: collections.deque = collections.deque(
            maxlen=capacity)
        self._read_counter = 0

    # ---------------- cheap-path predicates ----------------

    @property
    def enabled(self) -> bool:
        return self.sample_every > 0

    @property
    def open_count(self) -> int:
        return len(self._open)

    def set_sample_every(self, n: int) -> None:
        """1 = trace every command (``--trace``); 0 = off."""
        self.sample_every = max(0, int(n))

    def resize(self, capacity: int) -> None:
        """Grow/shrink the retained-span bound (``--trace`` runs size
        it to the whole workload so the export misses nothing)."""
        with self._lock:
            self.capacity = int(capacity)
            self._done = collections.deque(self._done,
                                           maxlen=self.capacity)

    # ---------------- recording ----------------

    def begin(self, conn: int, req: int, replica: int,
              phase: str = ENQUEUE) -> bool:
        """A command entered the system; returns True iff sampled.
        Re-entering an already-open key records a retransmit on the
        existing span (same logical command)."""
        if not self.sample_every:
            return False
        with self._lock:
            key = (conn, req)
            sp = self._open.get(key)
            if sp is not None:
                sp.retransmits += 1
                sp.events.append((RETRANSMIT, replica, self._clock()))
                return True
            self._counter += 1
            if (self._counter - 1) % self.sample_every:
                return False
            if len(self._open) >= self.capacity:
                if self._done_pending:
                    # evict the oldest acked-but-unmarked span rather
                    # than refusing every future sample
                    old_key, _ = self._done_pending.popitem(last=False)
                    old_sp = self._open.get(old_key)
                    if old_sp is not None:
                        self._retire_locked(old_key, old_sp)
                else:
                    self.dropped += 1
                    return False
            sp = _Span(conn, req, replica)
            sp.events.append((phase, replica, self._clock()))
            self._open[key] = sp
            h = self._await_ack.setdefault(replica, [])
            heapq.heappush(h, (req, key))
            if len(h) > 4 * self.capacity:
                self._compact_locked(h)     # direct-key acks bypass it
            return True

    def mark(self, conn: int, req: int, phase: str,
             replica: int = -1) -> None:
        """Stamp a phase on an open sampled span (no-op otherwise)."""
        if not self._open:
            return
        with self._lock:
            sp = self._open.get((conn, req))
            if sp is not None:
                sp.events.append((phase, replica, self._clock()))

    def stamp_append(self, conn: int, req: int, term: int, index: int,
                     leader: int,
                     replicas: Sequence[int] = (),
                     group: int = -1) -> None:
        """The leader appended this command at absolute ``index`` in
        ``term`` — the cross-replica correlation key. ``replicas``
        lists the replica ids whose commit/apply frontiers this
        process observes (all of them in-process; just the local one
        for a NodeDaemon); the span retires once each has both marks
        (plus the client ack). A second append of the same key (a
        committed duplicate from a retransmit) is recorded but the
        FIRST (term, index) wins — first-commit order is the one the
        state machine deduplicates to.

        ``group`` namespaces the correlation key for sharded clusters:
        ``(term, index)`` is unique within ONE consensus group but G
        independent groups number terms and indices identically, so
        the full key is ``(group, term, index)`` (-1 for unsharded
        callers — the legacy key, unchanged)."""
        if not self._open:
            return
        with self._lock:
            sp = self._open.get((conn, req))
            if sp is None:
                return
            ts = self._clock()
            if sp.term is not None:
                sp.retransmits += 1
                sp.events.append((RETRANSMIT, leader, ts))
                return
            sp.term, sp.index, sp.leader = int(term), int(index), leader
            sp.group = int(group)
            sp.events.append((APPEND, leader, ts))
            key = (conn, req)
            self._by_ti[(sp.group, sp.term, sp.index)] = key
            sp.pending_marks = 2 * len(replicas)
            for r in replicas:
                hc = self._await_commit.setdefault(r, [])
                ha = self._await_apply.setdefault(r, [])
                heapq.heappush(hc, (sp.index, key))
                heapq.heappush(ha, (sp.index, key))
                if len(hc) > 4 * self.capacity:
                    # a frontier that never advances (partitioned
                    # replica) must not accumulate retired spans' stale
                    # entries without bound
                    self._compact_locked(hc)
                    self._compact_locked(ha)

    def _compact_locked(self, heap: list) -> None:
        live = [(i, k) for (i, k) in heap if k in self._open]
        heapq.heapify(live)
        heap[:] = live

    def _frontier(self, heaps: Dict[int, list], replica: int,
                  upto: int, phase: str) -> None:
        h = heaps.get(replica)
        if not h:
            return
        with self._lock:
            ts = self._clock()
            while h and h[0][0] < upto:
                idx, key = heapq.heappop(h)
                sp = self._open.get(key)
                if sp is None or sp.index != idx:
                    continue               # retired / superseded entry
                sp.events.append((phase, replica, ts))
                if phase == COMMIT and replica == sp.leader:
                    # the leader's commit advance IS the quorum ack
                    sp.events.append((QUORUM, replica, ts))
                sp.pending_marks -= 1
                if sp.pending_marks <= 0 and sp.status == DONE:
                    self._retire_locked(key, sp)

    def commit_advance(self, replica: int, upto: int) -> None:
        """Replica ``replica``'s commit frontier reached ``upto``
        (absolute count: indices < upto are committed)."""
        self._frontier(self._await_commit, replica, upto, COMMIT)

    def apply_advance(self, replica: int, upto: int) -> None:
        self._frontier(self._await_apply, replica, upto, APPLY)

    def ack_release(self, replica: int,
                    upto_req: int) -> List[Tuple[int, int]]:
        """The driver released client acks on ``replica`` for every
        submit sequence <= ``upto_req``. Returns the ``(conn, req)``
        keys of the SAMPLED spans acked by this call — the driver's
        latency observe attaches histogram exemplars only to those."""
        h = self._await_ack.get(replica)
        if not h:
            return []
        acked: List[Tuple[int, int]] = []
        with self._lock:
            ts = self._clock()
            while h and h[0][0] <= upto_req:
                req, key = heapq.heappop(h)
                sp = self._open.get(key)
                if sp is None:
                    continue
                sp.events.append((ACK, replica, ts))
                sp.status = DONE
                acked.append(key)
                if sp.pending_marks <= 0:
                    self._retire_locked(key, sp)
                else:
                    self._done_pending[key] = None
        return acked

    def ack_key(self, conn: int, req: int) -> None:
        """Direct-key client ack (KVS sessions, which observe commit
        through the dedup high-water mark rather than a driver seq)."""
        if not self._open:
            return
        with self._lock:
            key = (conn, req)
            sp = self._open.get(key)
            if sp is None:
                return
            sp.events.append((ACK, sp.origin, self._clock()))
            sp.status = DONE
            if sp.pending_marks <= 0:
                self._retire_locked(key, sp)
            else:
                self._done_pending[key] = None

    def fail_open(self, replica: int, status: str = FAILOVER) -> int:
        """Close EVERY open span awaiting ack on ``replica`` with a
        terminal ``status`` — the leader-failover path: when the
        driver fails its inflight waiters (deposition, step-down,
        stop), their spans must terminate too, never leak. Returns the
        number closed."""
        h = self._await_ack.get(replica)
        if not h:
            return 0
        n = 0
        with self._lock:
            ts = self._clock()
            while h:
                _, key = heapq.heappop(h)
                sp = self._open.get(key)
                if sp is None:
                    continue
                sp.events.append((FAIL, replica, ts))
                sp.status = status
                self._retire_locked(key, sp)
                n += 1
        return n

    def fail_key(self, conn: int, req: int, status: str = FAILOVER,
                 replica: int = -1) -> None:
        if not self._open:
            return
        with self._lock:
            key = (conn, req)
            sp = self._open.get(key)
            if sp is None:
                return
            sp.events.append((FAIL, replica, self._clock()))
            sp.status = status
            self._retire_locked(key, sp)

    def _retire_locked(self, key, sp: _Span) -> None:
        self._open.pop(key, None)
        self._done_pending.pop(key, None)
        if sp.term is not None:
            self._by_ti.pop((sp.group, sp.term, sp.index), None)
        self._done.append(sp)

    # ---------------- queries / export ----------------

    def read_span(self, replica: int, path: str, t0: float, *,
                  group: int = -1, status: str = DONE) -> Optional[str]:
        """Record one served linearizable READ as a lightweight span
        (sampled like commands, but on a separate counter): the read
        critical path is just [enqueue, serve] on the serving replica
        — no append/commit/apply correlation to carry. Rendered as
        duration slices on a dedicated reads track by
        :func:`to_chrome_trace`. Returns the read's trace id when
        sampled (truthy, so pre-existing boolean callers still work),
        None otherwise — the id feeds the read-latency histogram's
        exemplar."""
        if not self.sample_every:
            return None
        with self._lock:
            self._read_counter += 1
            if (self._read_counter - 1) % self.sample_every:
                return None
            rid = f"read-{self._read_counter - 1}"
            self._reads.append(dict(replica=int(replica), path=path,
                                    t0=float(t0), t1=self._clock(),
                                    group=int(group), status=status,
                                    id=rid))
            return rid

    def key_for(self, term: int, index: int,
                group: int = -1) -> Optional[Tuple[int, int]]:
        with self._lock:
            return self._by_ti.get((int(group), int(term), int(index)))

    def counts(self) -> dict:
        with self._lock:
            by_status: Dict[str, int] = {}
            for sp in self._done:
                by_status[sp.status] = by_status.get(sp.status, 0) + 1
            return dict(open=len(self._open), done=len(self._done),
                        dropped=self.dropped, sampled=by_status)

    def dump(self, anchor: Optional[dict] = None) -> dict:
        """Point-in-time span dump: plain data, JSON-serializable,
        stamped with the shared clock anchor so multi-process dumps
        align on one timebase. Open spans are included as-is (status
        ``open``)."""
        with self._lock:
            spans = ([sp.as_dict() for sp in self._done]
                     + [sp.as_dict() for sp in self._open.values()])
            reads = [dict(r) for r in self._reads]
        out = dict(schema=1,
                   anchor=anchor if anchor is not None else clock_anchor(),
                   sample_every=self.sample_every,
                   dropped=self.dropped, spans=spans)
        if reads:
            # only when read spans exist: dumps from read-free runs
            # keep the pre-reads schema byte-for-byte (golden-pinned)
            out["reads"] = reads
        return out

    def write_json(self, path: str) -> str:
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
            self._by_ti.clear()
            self._await_commit.clear()
            self._await_apply.clear()
            self._await_ack.clear()
            self._done_pending.clear()
            self._reads.clear()
            self._read_counter = 0
            self._counter = 0
            self.dropped = 0


def active_recorder(obs) -> Optional[SpanRecorder]:
    """The facade's span recorder iff tracing is enabled — the ONE
    enablement probe every integration point (sim, KVS, ...) shares,
    so the predicate can never diverge between paths."""
    if obs is None:
        return None
    sp = getattr(obs, "spans", None)
    return sp if (sp is not None and sp.enabled) else None


# ---------------------------------------------------------------------------
# step-phase profiler
# ---------------------------------------------------------------------------

# the attributable hot-loop phases (one histogram series per phase)
PHASE_HOST_ENCODE = "host_encode"        # batch pack / input build
PHASE_DEVICE_DISPATCH = "device_dispatch"  # program enqueue (async)
PHASE_DEVICE_SYNC = "device_sync"        # explicit fence (opt-in)
PHASE_QUORUM_WAIT = "quorum_wait"        # blocking commit readback
PHASE_APPLY = "apply"                    # committed-window replay
PHASE_ACK_RELEASE = "ack_release"        # waiter release + latency obs
PHASE_APPLY_REPLAY_ACK = "apply_replay_ack"  # driver store/replay/ack
                                         # sweep (whole-batch, per
                                         # replica) — the host_path
                                         # A/B attribution phase


class StepPhaseProfiler:
    """Wall-time phase attribution for the driver/daemon hot loops.

    Without fencing (the default), ``device_dispatch`` measures program
    ENQUEUE under async dispatch and the device time surfaces wherever
    the host first blocks on results (``quorum_wait``) — the honest
    shape of a pipelined driver, and exactly what the pre-existing
    ``step_latency_us`` conflated. With ``fence=True``, :meth:`sync`
    blocks on the step's outputs immediately after dispatch, so device
    time lands in its own ``device_sync`` series and ``quorum_wait``
    shrinks to the readback. Fencing serializes the dispatch pipeline —
    it is a profiling mode, off by default, and changes no compiled
    programs (cache-key guarded).
    """

    BUCKETS_US = LATENCY_BUCKETS_US
    PHASES = (PHASE_HOST_ENCODE, PHASE_DEVICE_DISPATCH,
              PHASE_DEVICE_SYNC, PHASE_QUORUM_WAIT, PHASE_APPLY,
              PHASE_ACK_RELEASE, PHASE_APPLY_REPLAY_ACK)

    def __init__(self, metrics=None, *, fence: bool = False,
                 replica: int = -1):
        self.metrics = metrics           # MetricsRegistry or None
        self.fence = fence
        self.replica = replica
        self.acc: Dict[str, Tuple[int, float, float]] = {}
        # open stamps per (thread, phase): the driver's dispatch and
        # readback threads run the same phase at once
        self._open: Dict[Tuple[int, str], int] = {}
        # guards acc, events and events_dropped across threads; an
        # RLock, since a collection can start inside the locked update
        # and a gc.callbacks hook stop a phase on the same thread
        self._lock = threading.RLock()
        # opt-in timestamped phase slices (enable_events): the
        # host-phase TRACK of the merged device timeline
        # (obs.device.merge_timeline) — histograms alone cannot place
        # a phase on a wall-clock axis
        self.events: Optional[collections.deque] = None
        self.events_dropped = 0          # slices the full ring pushed out

    def enable_events(self, capacity: int = 65536) -> None:
        """Record ``(phase, t0_monotonic, t1_monotonic)`` triples in a
        bounded ring alongside the histograms (off by default — one
        extra clock read per stop). A full ring drops its oldest slice
        and counts it in ``events_dropped``."""
        with self._lock:
            self.events = collections.deque(maxlen=capacity)
            self.events_dropped = 0

    def start(self, phase: str) -> None:
        self._open[(threading.get_ident(), phase)] = time.perf_counter_ns()

    def stop(self, phase: str, observe: bool = True) -> None:
        """Close ``phase`` on the calling thread; ``observe=False``
        keeps it out of the ``step_phase_us`` histogram."""
        t0 = self._open.pop((threading.get_ident(), phase), None)
        if t0 is None:
            return
        us = (time.perf_counter_ns() - t0) / 1e3
        with self._lock:
            n, tot, mx = self.acc.get(phase, (0, 0.0, 0.0))
            self.acc[phase] = (n + 1, tot + us, max(mx, us))
            ev = self.events
            if ev is not None:
                if len(ev) == ev.maxlen:
                    self.events_dropped += 1
                t1m = time.monotonic()
                ev.append((phase, t1m - us / 1e6, t1m))
        if observe and self.metrics is not None:
            self.metrics.observe("step_phase_us", us,
                                 buckets=self.BUCKETS_US, phase=phase,
                                 replica=self.replica)

    def sync(self, outputs) -> None:
        """Explicit device fence: wait for the CUDA device ``outputs``
        live on, timed as ``device_sync``. NO-OP unless fencing is
        enabled — the default path never blocks here."""
        if not self.fence:
            return
        self.start(PHASE_DEVICE_SYNC)
        dev = _device_of(outputs)
        if dev is not None and dev.type == "cuda":
            import torch
            torch.cuda.synchronize(dev)
        self.stop(PHASE_DEVICE_SYNC)

    def sums(self) -> Dict[str, dict]:
        """Per-phase ``{n, total_us, max_us}`` sums with zero-sample
        phases SUPPRESSED — the one exporter benches embed in their
        detail rows, so A/B tables never carry dead columns (e.g. a
        ``device_sync`` row when ``fence=`` is off)."""
        return {p: dict(n=a[0], total_us=round(a[1], 1),
                        max_us=round(a[2], 1))
                for p, a in sorted(self.acc.items()) if a[0] > 0}

    def report(self) -> str:
        lines = []
        for phase, (n, tot, mx) in sorted(self.acc.items()):
            if n == 0:
                continue          # zero-sample phases carry no signal
            lines.append(f"{phase}: n={n} mean={tot / max(n, 1):.1f}us "
                         f"max={mx:.1f}us")
        return "\n".join(lines)


def _device_of(outputs):
    """The device of the first tensor in ``outputs`` (a tensor, a
    dataclass of tensors, or a dict of them); None when it holds none."""
    vals = (outputs.values() if isinstance(outputs, dict)
            else vars(outputs).values() if hasattr(outputs, "__dict__")
            else (outputs,))
    for v in vals:
        dev = getattr(v, "device", None)
        if dev is not None:
            return dev
    return None


# ---------------------------------------------------------------------------
# Chrome trace-event export (Perfetto-loadable)
# ---------------------------------------------------------------------------

CP_PID = 9999            # the critical-path pseudo-process
READS_PID = 9998         # the lease/read-index read-span pseudo-process


def _span_label(sp: dict) -> str:
    label = "c%d/r%d" % (sp["conn"], sp["req"])
    if sp.get("term") is not None:
        label += " (t%d,i%d)" % (sp["term"], sp["index"])
    return label


def _critical_path(sp: dict, wall) -> List[Tuple[str, float, float]]:
    """-> ordered (segment, t0_wall, t1_wall) list for one span: the
    client-visible chain over whichever CP phases were observed."""
    marks: Dict[str, float] = {}
    for phase, rep, ts in sp["events"]:
        if phase not in CP_PHASES:
            continue
        if phase == APPLY and rep != sp["origin"] and APPLY in marks:
            continue                      # prefer the origin's apply
        if phase in marks and phase != APPLY:
            continue                      # first mark wins
        marks[phase] = wall(ts)
    chain = [(p, marks[p]) for p in CP_PHASES if p in marks]
    return [(f"{a}->{b}", ta, tb)
            for (a, ta), (b, tb) in zip(chain, chain[1:])]


def to_chrome_trace(dumps, *, max_cp_tracks: int = 512,
                    t0_wall: Optional[float] = None) -> dict:
    """Merge one or more span dumps into a Chrome trace-event JSON
    object (Perfetto-loadable): per-replica tracks carry instant
    phase marks correlated by ``(term, index)``; each sampled command
    additionally gets a critical-path track of duration slices.
    Dumps from different processes are aligned via their stamped
    clock anchors. ``t0_wall`` overrides the computed timeline epoch —
    the hook ``obs.tracectx.merge_timeline`` uses to fold subsystem
    traces onto the SAME axis (and the only caller for which the epoch
    lands in ``otherData``)."""
    if isinstance(dumps, dict):
        dumps = [dumps]
    walls: List[float] = []
    prepared = []
    for d in dumps:
        a = d["anchor"]

        def wall(ts, _a=a):
            return _a["wall"] + (ts - _a["monotonic"])

        for sp in d["spans"]:
            walls.extend(wall(ts) for _, _, ts in sp["events"])
        for rd in d.get("reads", ()):
            walls.append(wall(rd["t0"]))
        prepared.append((d, wall))
    t0 = (t0_wall if t0_wall is not None
          else (min(walls) if walls else 0.0))

    def us(w):
        return round((w - t0) * 1e6, 3)

    events: List[dict] = []
    replicas_seen = set()
    cp_tid = 0
    for d, wall in prepared:
        for sp in d["spans"]:
            label = _span_label(sp)
            args = dict(conn=sp["conn"], req=sp["req"],
                        origin=sp["origin"], term=sp.get("term"),
                        index=sp.get("index"), status=sp["status"],
                        retransmits=sp.get("retransmits", 0))
            for phase, rep, ts in sp["events"]:
                pid = rep if rep >= 0 else sp["origin"]
                replicas_seen.add(pid)
                events.append(dict(
                    name=f"{phase} {label}", ph="i", s="p",
                    ts=us(wall(ts)), pid=pid, tid=0, args=args))
            if cp_tid < max_cp_tracks:
                segs = _critical_path(sp, wall)
                if segs:
                    cp_tid += 1
                    events.append(dict(
                        name="thread_name", ph="M", pid=CP_PID,
                        tid=cp_tid, args=dict(name=label)))
                    for seg, ta, tb in segs:
                        events.append(dict(
                            name=seg, ph="X", ts=us(ta),
                            dur=round(max(tb - ta, 0.0) * 1e6, 3),
                            pid=CP_PID, tid=cp_tid, args=args))
    n_reads = 0
    for d, wall in prepared:
        for rd in d.get("reads", ()):
            # the read critical path is one slice: enqueue→serve on
            # the serving replica's reads track
            n_reads += 1
            ta, tb = wall(rd["t0"]), wall(rd["t1"])
            events.append(dict(
                name=f"read:{rd['path']}", ph="X", ts=us(ta),
                dur=round(max(tb - ta, 0.0) * 1e6, 3),
                pid=READS_PID, tid=rd["replica"],
                args=dict(replica=rd["replica"], path=rd["path"],
                          group=rd.get("group", -1),
                          status=rd.get("status"))))
    meta = [dict(name="process_name", ph="M", pid=r, tid=0,
                 args=dict(name=f"replica {r}"))
            for r in sorted(replicas_seen)]
    meta.append(dict(name="process_name", ph="M", pid=CP_PID, tid=0,
                     args=dict(name="critical path")))
    if n_reads:
        meta.append(dict(name="process_name", ph="M", pid=READS_PID,
                         tid=0, args=dict(name="reads")))
    other = dict(tool="rdma_paxos_tpu_torch.obs.spans",
                 dumps=len(prepared),
                 spans=sum(len(d["spans"]) for d, _ in prepared))
    if t0_wall is not None:
        # only explicit-epoch callers carry it: the default export
        # keeps the reference's fields
        other["t0_wall"] = t0
    return dict(traceEvents=meta + events, displayTimeUnit="ms",
                otherData=other)


# ---------------------------------------------------------------------------
# critical-path breakdown
# ---------------------------------------------------------------------------

def breakdown(dumps) -> dict:
    """Aggregate critical-path segment durations over every span in
    ``dumps``: per segment n/mean/p50/p95/p99 µs, plus span status
    counts — the "where did the time go" table."""
    if isinstance(dumps, dict):
        dumps = [dumps]
    segs: Dict[str, List[float]] = {}
    status: Dict[str, int] = {}
    for d in dumps:
        a = d["anchor"]

        def wall(ts, _a=a):
            return _a["wall"] + (ts - _a["monotonic"])

        for sp in d["spans"]:
            status[sp["status"]] = status.get(sp["status"], 0) + 1
            for seg, ta, tb in _critical_path(sp, wall):
                segs.setdefault(seg, []).append((tb - ta) * 1e6)
    out = dict(spans=status, segments={})
    for seg, vals in segs.items():
        vals.sort()
        n = len(vals)
        out["segments"][seg] = dict(
            n=n, mean_us=round(sum(vals) / n, 2),
            p50_us=round(vals[n // 2], 2),
            p95_us=round(vals[int(n * .95)], 2),
            p99_us=round(vals[min(int(n * .99), n - 1)], 2))
    return out


def format_breakdown(bd: dict) -> str:
    lines = ["spans: " + ", ".join(f"{k}={v}"
                                   for k, v in sorted(bd["spans"].items()))]
    order = [f"{a}->{b}" for a, b in zip(CP_PHASES, CP_PHASES[1:])]
    segs = bd["segments"]
    width = max([len(s) for s in segs] or [8])
    lines.append(f"{'segment'.ljust(width)}  {'n':>7} {'mean_us':>10} "
                 f"{'p50_us':>10} {'p95_us':>10} {'p99_us':>10}")
    for seg in sorted(segs, key=lambda s: (order.index(s)
                                           if s in order else 99, s)):
        st = segs[seg]
        lines.append(f"{seg.ljust(width)}  {st['n']:>7} "
                     f"{st['mean_us']:>10.2f} {st['p50_us']:>10.2f} "
                     f"{st['p95_us']:>10.2f} {st['p99_us']:>10.2f}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI: dump / merge / report
# ---------------------------------------------------------------------------

def _load_dumps(paths: Sequence[str]) -> List[dict]:
    dumps = []
    for p in paths:
        with open(p) as f:
            doc = json.load(f)
        if "spans" not in doc:
            raise SystemExit(f"{p}: not a span dump (no 'spans' key)")
        dumps.append(doc)
    return dumps


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rdma_paxos_tpu_torch.obs.spans",
        description="Merge span dumps into a Perfetto-loadable Chrome "
                    "trace and print critical-path breakdowns.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, doc in (("merge", "merge one or more (multi-replica) raw "
                                "span dumps into ONE Chrome trace-event "
                                "JSON, aligned on the shared clock "
                                "anchors — open the output in "
                                "https://ui.perfetto.dev"),
                      ("dump", "alias of merge (single-file convert)")):
        p = sub.add_parser(name, help=doc)
        p.add_argument("files", nargs="+", help="raw span dump JSONs")
        p.add_argument("-o", "--out", required=True,
                       help="Chrome trace JSON output path")
    rp = sub.add_parser("report", help="print the aggregated "
                        "critical-path breakdown of span dumps")
    rp.add_argument("files", nargs="+")
    args = ap.parse_args(argv)

    dumps = _load_dumps(args.files)
    if args.cmd in ("merge", "dump"):
        trace = to_chrome_trace(dumps)
        with open(args.out, "w") as f:
            json.dump(trace, f)
        n = trace["otherData"]["spans"]
        print(f"wrote {args.out}: {len(trace['traceEvents'])} events "
              f"from {n} spans across {len(dumps)} dump(s) — load it "
              f"in https://ui.perfetto.dev")
    else:
        print(format_breakdown(breakdown(dumps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
