"""Device telemetry: the on-device protocol counters of the
``telemetry=True`` replica step, bounded profiler captures merged onto
the span timeline, and per-variant dispatch reports.

The port of the JAX package's ``obs/device.py``, in three legs.

* **Counters** — :data:`COUNTERS`, :data:`GAUGES`, :data:`NAMES`,
  :data:`WIDTH`, :data:`INDEX`, :func:`zeros`, :func:`reduce_steps`,
  :func:`accumulate`, :func:`export` and :func:`ingest`. The step emits one
u32 vector per replica per step — elections started, votes
granted/denied, appends accepted, commit-frontier advance, unheard
links, quorum width, log headroom — reduced in the step so the readback
is O(counters), never O(log). The engine ingests the vectors in
``finish`` (the readback thread under the pipelined driver) into a host
accumulator and, when an obs facade is attached, into ``device_*``
registry series.

* **:class:`ProfilerSession`** — a bounded ``torch.profiler`` capture
  (activities CPU, and CUDA when a card is present) started by the
  drivers' ``start_profile`` or an alert page. The session exports the
  capture as a Chrome trace and records ``time.time()`` just before a
  marker event it emits at the capture's start, so :meth:`chrome_events`
  gives every event's ``ts`` in µs since :attr:`wall_start` (the JAX
  profiler's contract, whatever clock base the trace carries), and
  :func:`merge_timeline` folds span dumps, host phases and the device
  tracks into one Perfetto document on one wall timebase.

* **:func:`program_report`** — per step variant and burst tier, the
  PyTorch ops one dispatch issues (non-view ops, counted at the
  dispatcher) and, on the card, the CUDA kernels it launches (profiled).
  This is not JAX's cost analysis: nothing is compiled, so there are no
  flops, bytes-accessed or memory figures; the port's dispatch cost is
  its launches. Profiled kernel counts can drop records, so a check
  holds them with ``<=``, never equality.

Layout contract: :data:`COUNTERS` + :data:`GAUGES` name the vector
columns in order. ``consensus/step.py`` carries its own matching ``T_*``
index constants and does not import this module;
``tests/test_torch_telemetry.py`` pins the two layouts against each
other, and ``tests/test_torch_hygiene.py`` pins :data:`NAMES` against
the reference.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import socket
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from rdma_paxos_tpu_torch.obs.clock import anchor as clock_anchor

# ---------------------------------------------------------------------------
# counter-vector layout (mirrors consensus/step.py T_* — pinned by test)
# ---------------------------------------------------------------------------

# monotone per-step counts: accumulated (summed) across steps/bursts
COUNTERS = (
    "elections_started",    # this replica began a candidacy
    "votes_granted",        # granted another replica's candidacy
    "votes_denied",         # heard candidacies it did not grant
    "accepted_entries",     # client entries appended from the batch
    "committed_entries",    # commit-frontier advance
    "links_unheard",        # peers masked by partition/link model
)
# point-in-time values: latest step wins (min across a fused burst
# for log_headroom — the tightest the ring got inside the dispatch)
GAUGES = (
    "quorum_width",         # replicas that acked this replica's window
    "log_headroom",         # free ring slots: (n_slots-1) - (end-head)
)
NAMES: Tuple[str, ...] = COUNTERS + GAUGES
WIDTH = len(NAMES)
INDEX: Dict[str, int] = {n: i for i, n in enumerate(NAMES)}

_N_COUNTERS = len(COUNTERS)
_I_QUORUM = INDEX["quorum_width"]
_I_HEADROOM = INDEX["log_headroom"]


def zeros(*lead_shape: int) -> np.ndarray:
    """The host-side telemetry accumulator: int64 ``[..., WIDTH]``."""
    return np.zeros(tuple(lead_shape) + (WIDTH,), np.int64)


def reduce_steps(stacked: np.ndarray) -> np.ndarray:
    """Reduce a fused burst's per-step vectors ``[K, ..., WIDTH]`` to
    one ``[..., WIDTH]`` vector: counters sum over the K steps,
    ``quorum_width`` takes the final step's value, ``log_headroom``
    the minimum across the burst (the tightest the ring got)."""
    out = stacked.sum(axis=0).astype(np.int64)
    out[..., _I_QUORUM] = stacked[-1, ..., _I_QUORUM]
    out[..., _I_HEADROOM] = stacked[..., _I_HEADROOM].min(axis=0)
    return out


def accumulate(acc: np.ndarray, vec: np.ndarray) -> np.ndarray:
    """Fold one finish()'s reduced vector into the running host
    accumulator: counter columns add, gauge columns overwrite."""
    acc[..., :_N_COUNTERS] += vec[..., :_N_COUNTERS]
    acc[..., _N_COUNTERS:] = vec[..., _N_COUNTERS:]
    return acc


def export(metrics, vec: np.ndarray, *, replica: int,
           group: Optional[int] = None) -> None:
    """Push one replica's reduced vector into the registry:
    ``device_<counter>_total`` counters (incremented by this finish's
    delta) and ``device_<gauge>`` gauges, labelled ``{replica=}`` (+
    ``{group=}`` for sharded engines). Host-side only — runs on the
    readback thread, never inside the replica step."""
    labels = dict(replica=replica)
    if group is not None:
        labels["group"] = group
    for i, name in enumerate(COUNTERS):
        v = int(vec[i])
        if v:
            metrics.inc("device_%s_total" % name, v, **labels)
    for name in GAUGES:
        metrics.set("device_%s" % name, int(vec[INDEX[name]]), **labels)


def ingest(obs, vec: np.ndarray, *, group_offset: int = 0) -> None:
    """Registry export for a whole reduced vector array: ``[R, WIDTH]``
    (single group) or ``[G, R, WIDTH]`` (sharded — ``group_offset``
    shifts the group label for multi-host shards)."""
    if obs is None:
        return
    m = obs.metrics
    if vec.ndim == 2:
        for r in range(vec.shape[0]):
            export(m, vec[r], replica=r)
    else:
        for g in range(vec.shape[0]):
            for r in range(vec.shape[1]):
                export(m, vec[g, r], replica=r, group=g + group_offset)


# ---------------------------------------------------------------------------
# torch.profiler capture manager
# ---------------------------------------------------------------------------

# torch.profiler runs ONE capture per process; the session guards that
# invariant so driver/CLI/alert triggers can race benignly
_ACTIVE_LOCK = threading.Lock()
_ACTIVE: Optional["ProfilerSession"] = None

# the marker event each capture emits at its start: its ``ts`` is the
# capture's time origin (the trace's own clock base differs between
# torch versions)
ANCHOR_EVENT = "rp_profile_anchor"


def _trace_files(log_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(log_dir, "**", "*.trace.json.gz"),
                            recursive=True))


def _load_events(path: str) -> List[dict]:
    """One exported trace's events with ``ts`` in µs since its anchor
    marker (the capture's :attr:`ProfilerSession.wall_start`). What the
    profiler recorded while starting, before the marker, is dropped
    (metadata events are kept, at 0)."""
    with gzip.open(path, "rt") as f:
        doc = json.load(f)
    events = doc.get("traceEvents", [])
    marks = [float(e["ts"]) for e in events
             if e.get("name") == ANCHOR_EVENT and "ts" in e]
    stamped = [float(e["ts"]) for e in events if "ts" in e]
    base = marks[0] if marks else (min(stamped) if stamped else 0.0)
    out = []
    for e in events:
        if "ts" in e:
            ts = float(e["ts"]) - base
            if ts < 0 and e.get("ph") != "M":
                continue
            e = dict(e, ts=max(ts, 0.0))
        out.append(e)
    return out


class ProfilerSession:
    """A bounded ``torch.profiler`` capture whose device trace aligns
    onto the shared obs wall timebase.

    :meth:`start` records ``time.time()`` immediately before it emits
    the :data:`ANCHOR_EVENT` marker, and every exported event's ``ts`` is
    re-based on that marker, so ``wall = wall_start + ts * 1e-6``
    projects each event onto the timebase span dumps use
    (:mod:`obs.clock`). ``stop()`` is explicit; :meth:`maybe_stop`
    enforces ``max_seconds`` from a host poll loop (the driver calls it
    each observe pass) so an alert-triggered capture can never run
    unbounded."""

    def __init__(self, log_dir: str, *, max_seconds: float = 10.0):
        self.log_dir = log_dir
        self.max_seconds = float(max_seconds)
        self.active = False
        self.wall_start: Optional[float] = None
        self.anchor = None
        self.trace_files: List[str] = []
        self._deadline = float("inf")
        self._prof = None

    def start(self) -> "ProfilerSession":
        global _ACTIVE
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        with _ACTIVE_LOCK:
            if _ACTIVE is not None and _ACTIVE.active:
                raise RuntimeError(
                    "a ProfilerSession is already active (torch.profiler "
                    "runs one capture per process); stop it first")
            os.makedirs(self.log_dir, exist_ok=True)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
            self.anchor = clock_anchor()
            self.wall_start = time.time()
            with record_function(ANCHOR_EVENT):
                pass
            self._deadline = time.monotonic() + self.max_seconds
            self.active = True
            _ACTIVE = self
        return self

    def expired(self) -> bool:
        return self.active and time.monotonic() >= self._deadline

    def maybe_stop(self) -> bool:
        """Stop iff the bounded duration elapsed (poll-loop hook)."""
        if self.expired():
            self.stop()
            return True
        return False

    def stop(self) -> "ProfilerSession":
        global _ACTIVE
        with _ACTIVE_LOCK:
            if not self.active:
                return self
            try:
                self._prof.stop()
                path = os.path.join(
                    self.log_dir, "%s.%d.%d.trace.json" % (
                        socket.gethostname(), os.getpid(),
                        int(self.wall_start * 1e3)))
                self._prof.export_chrome_trace(path)
                with open(path, "rb") as src, \
                        gzip.open(path + ".gz", "wb") as dst:
                    dst.write(src.read())
                os.unlink(path)
            finally:
                # even when the export fails (disk full in log_dir), the
                # session must read inactive and release the
                # one-per-process slot
                self.active = False
                self._prof = None
                if _ACTIVE is self:
                    _ACTIVE = None
            # resolve INSIDE the lock: a concurrent stop() returns on
            # the not-active fast path above only after the files are
            # populated, so its caller never reads an empty capture
            self.trace_files = _trace_files(self.log_dir)
        return self

    def chrome_events(self) -> List[dict]:
        """The captured Chrome trace events (``ts`` µs since
        :attr:`wall_start`), concatenated across trace files. Empty
        when the capture produced none (or was never stopped)."""
        events: List[dict] = []
        for path in self.trace_files:
            events.extend(_load_events(path))
        return events

    def summary(self) -> dict:
        return dict(log_dir=self.log_dir, active=self.active,
                    wall_start=self.wall_start,
                    max_seconds=self.max_seconds,
                    trace_files=list(self.trace_files))


def load_profiler_dir(log_dir: str) -> List[dict]:
    """Chrome events from a previously captured profiler log dir (the
    CLI path — no live session needed), ``ts`` µs since each capture's
    start."""
    s = ProfilerSession(log_dir)
    s.trace_files = _trace_files(log_dir)
    return s.chrome_events()


# ---------------------------------------------------------------------------
# merged Perfetto timeline: spans + host phases + device trace
# ---------------------------------------------------------------------------

HOST_PHASE_PID = 9998        # one below the spans critical-path pid
DEVICE_PID_BASE = 10000      # profiler pids are remapped above here
# a busy capture emits millions of runtime events; an uncapped merge
# writes a multi-hundred-MB JSON no viewer loads. The newest events
# (the serving window, not the capture-init preamble) are kept; the
# drop count lands in otherData — bounded, never silently complete.
MAX_DEVICE_EVENTS = 200_000


def _span_walls(dumps: Sequence[dict]) -> List[float]:
    walls: List[float] = []
    for d in dumps:
        a = d["anchor"]
        for sp in d["spans"]:
            walls.extend(a["wall"] + (ts - a["monotonic"])
                         for _, _, ts in sp["events"])
    return walls


def merge_timeline(span_dumps, *, phase_events: Optional[Sequence] = None,
                   phase_anchor: Optional[dict] = None,
                   profiler: Optional[ProfilerSession] = None,
                   device_events: Optional[Sequence[dict]] = None,
                   device_wall_start: Optional[float] = None,
                   max_cp_tracks: int = 512,
                   max_device_events: int = MAX_DEVICE_EVENTS) -> dict:
    """One Perfetto document on ONE wall timebase: the span export's
    replica + critical-path tracks, a ``host phases`` track from the
    :class:`~rdma_paxos_tpu_torch.obs.spans.StepPhaseProfiler` event
    ring (``(phase, t0_monotonic, t1_monotonic)`` triples projected
    through ``phase_anchor``), and the profiler's tracks (``ts`` µs since
    the capture's ``wall_start``). Every source contributes to the
    common epoch, so the three layers line up — a client span's quorum
    wait sits directly above the host dispatch phase and the kernels
    that served it."""
    from rdma_paxos_tpu_torch.obs import spans as spans_mod

    if isinstance(span_dumps, dict):
        span_dumps = [span_dumps]
    span_dumps = list(span_dumps or [])
    phase_events = list(phase_events or [])
    if profiler is not None:
        device_events = profiler.chrome_events()
        device_wall_start = profiler.wall_start
    device_events = [e for e in (device_events or [])
                     if e.get("ph") in ("X", "M")]

    pa = phase_anchor if phase_anchor is not None else clock_anchor()
    walls = _span_walls(span_dumps)
    walls.extend(pa["wall"] + (t0 - pa["monotonic"])
                 for _, t0, _ in phase_events)
    if device_events and device_wall_start is not None:
        walls.append(device_wall_start)
    t0_wall = min(walls) if walls else 0.0

    doc = spans_mod.to_chrome_trace(span_dumps, t0_wall=t0_wall,
                                    max_cp_tracks=max_cp_tracks)
    events = doc["traceEvents"]

    def us(w: float) -> float:
        return round((w - t0_wall) * 1e6, 3)

    # host-phase track: one thread row per phase name
    if phase_events:
        tids = {p: i + 1
                for i, p in enumerate(sorted({p for p, _, _
                                              in phase_events}))}
        events.append(dict(name="process_name", ph="M",
                           pid=HOST_PHASE_PID, tid=0,
                           args=dict(name="host phases")))
        for p, tid in sorted(tids.items()):
            events.append(dict(name="thread_name", ph="M",
                               pid=HOST_PHASE_PID, tid=tid,
                               args=dict(name=p)))
        for p, m0, m1 in phase_events:
            w0 = pa["wall"] + (m0 - pa["monotonic"])
            w1 = pa["wall"] + (m1 - pa["monotonic"])
            events.append(dict(
                name=p, ph="X", ts=us(w0),
                dur=round(max(w1 - w0, 0.0) * 1e6, 3),
                pid=HOST_PHASE_PID, tid=tids[p], args={}))

    # device tracks: profiler pids remapped above DEVICE_PID_BASE so
    # they can never collide with replica / critical-path / phase pids
    n_dev = 0
    dev_dropped = 0
    if device_events and device_wall_start is not None:
        xs = [e for e in device_events if e.get("ph") == "X"]
        if len(xs) > max_device_events:
            # keep the NEWEST slices (the serving window) and say so.
            # Chrome traces are ordered per thread/file, NOT globally
            # by time — sort first or the tail-slice drops whole
            # device tracks instead of the capture-init preamble
            xs.sort(key=lambda e: e.get("ts", 0))
            dev_dropped = len(xs) - max_device_events
            keep = xs[-max_device_events:]
            device_events = ([e for e in device_events
                              if e.get("ph") == "M"] + keep)
        pid_map: Dict[int, int] = {}
        for e in device_events:
            pid = pid_map.setdefault(
                e.get("pid", 0), DEVICE_PID_BASE + len(pid_map))
            ne = dict(e)
            ne["pid"] = pid
            if e.get("ph") == "M":
                if e.get("name") == "process_name":
                    ne["args"] = dict(name="device: %s"
                                      % e.get("args", {}).get("name", "?"))
                events.append(ne)
                continue
            ne["ts"] = us(device_wall_start + e["ts"] * 1e-6)
            events.append(ne)
            n_dev += 1

    doc["otherData"]["merged"] = True
    doc["otherData"]["host_phase_events"] = len(phase_events)
    doc["otherData"]["device_events"] = n_dev
    doc["otherData"]["device_events_dropped"] = dev_dropped
    return doc


# ---------------------------------------------------------------------------
# per-variant dispatch reports
# ---------------------------------------------------------------------------

def count_ops(fn, world=None) -> int:
    """The non-view PyTorch ops ``fn()`` dispatches — what decides the
    kernels it launches, counted exactly at the dispatcher. A dispatch
    mode holds for its own thread only: with a device-list engine's
    ``world`` every job its worker threads run meanwhile is counted
    too."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.n += 1
            return func(*args, **(kwargs or {}))
    modes = [Count()]
    if world is not None:
        world.job_context = lambda: modes.append(Count()) or modes[-1]
    try:
        with modes[0]:
            fn()
    finally:
        if world is not None:
            world.job_context = None
    return sum(m.n for m in modes)


def count_kernels(fn) -> Optional[int]:
    """The CUDA kernels ``fn()`` launches, from a ``torch.profiler``
    capture of it (copies and memsets excluded). None when a
    :class:`ProfilerSession` is active (one capture per process).
    Profiled counts can drop records: hold them with ``<=``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if _ACTIVE is not None and _ACTIVE.active:
        return None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and not e.key.startswith(("Memcpy", "Memset")):
            n += e.count
    return n


def _example_step_args(cluster):
    """An idle step input shaped for ``cluster`` (the prewarm shapes,
    which are what the serving path dispatches) and the lead shape
    ``(R,)`` or ``(G, R)``."""
    from rdma_paxos_tpu_torch.consensus.step import make_step_input
    G = getattr(cluster, "G", None)
    inp = make_step_input(cluster.cfg, cluster.R, n_groups=G,
                          device=cluster.device)
    return inp, ((G, cluster.R) if G is not None else (cluster.R,))


def _measure(cluster, call) -> dict:
    """Ops (and on the card kernels) of ``call(state)``, each run on a
    fresh clone of the live state (a device-list engine's blocks: every
    entry's ops and kernels are counted)."""
    st = cluster.clone_live()
    row = dict(ops=count_ops(lambda: call(st),
                             world=getattr(cluster, "world", None)),
               kernels=None)
    if cluster.device.type == "cuda":
        st = cluster.clone_live()
        row["kernels"] = count_kernels(lambda: call(st))
    return row


def program_report(cluster, *, tiers: Sequence[int] = ()) -> dict:
    """Dispatch report for every step variant this cluster serves (full
    + stable step, plus the requested fused-burst tiers): per variant
    the non-view PyTorch ops of one dispatch and, on the card, its CUDA
    kernels. Not JAX's cost analysis (the port compiles nothing: no
    flops, bytes-accessed or memory figures); what one dispatch costs
    here is its launches. Each variant runs once on a clone of the live
    state with an idle input, so call it with the engine drained (a
    clone taken while a step writes the ring is torn; only the
    dispatches are counted)."""
    import torch

    from rdma_paxos_tpu_torch.consensus.log import META_W

    inp, lead = _example_step_args(cluster)
    cfg, B, dev = cluster.cfg, cluster.cfg.batch_slots, cluster.device
    variants = []
    for elections in (True, False):
        fn = cluster._steps[elections]
        row = dict(variant=("step/full" if elections else "step/stable"))
        row.update(_measure(cluster, lambda st, fn=fn: fn(st, inp)))
        variants.append(row)
    for K in tiers:
        def z(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)
        args = (z(K, *lead, B, cfg.slot_words), z(K, *lead, B, META_W),
                z(K, *lead), torch.ones(lead + (cluster.R,),
                                        dtype=torch.int32, device=dev),
                z(*lead), z(*lead))
        row = dict(variant="burst/K=%d" % K)
        row.update(_measure(cluster,
                            lambda st: cluster._burst(st, *args)))
        variants.append(row)
    return dict(
        schema=1, kind="program_report", anchor=clock_anchor(),
        backend=dev.type,
        engine=getattr(cluster, "_mode", "sim"),
        n_replicas=cluster.R,
        n_groups=getattr(cluster, "G", 1),
        config=dict(n_slots=cfg.n_slots, slot_bytes=cfg.slot_bytes,
                    window_slots=cfg.window_slots,
                    batch_slots=cfg.batch_slots),
        telemetry=bool(getattr(cluster, "_telemetry", False)),
        audit=bool(getattr(cluster, "_audit", False)),
        variants=variants)


def write_program_report(path: str, cluster, *,
                         tiers: Sequence[int] = ()) -> dict:
    """Atomic ``program_report.json`` artifact; returns the report
    dict."""
    rep = program_report(cluster, tiers=tiers)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rep, f, indent=2)
    os.replace(tmp, path)
    rep["path"] = path
    return rep


# ---------------------------------------------------------------------------
# CLI: merge a profiler capture + span dumps into one Perfetto file
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rdma_paxos_tpu_torch.obs.device",
        description="Merge a torch.profiler capture dir and span dumps "
                    "into ONE Perfetto timeline on the shared clock "
                    "anchors.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    mp = sub.add_parser("merge", help="write the merged Perfetto JSON")
    mp.add_argument("--profile-dir", default=None,
                    help="a ProfilerSession log dir (trace.json.gz "
                         "inside)")
    mp.add_argument("--wall-start", type=float, default=None,
                    help="the capture's wall_start (time.time() at its "
                         "start) — required with --profile-dir")
    mp.add_argument("--spans", nargs="*", default=[],
                    help="raw span dump JSONs")
    mp.add_argument("-o", "--out", required=True)
    args = ap.parse_args(argv)

    dumps = []
    for p in args.spans:
        with open(p) as f:
            dumps.append(json.load(f))
    dev_events = None
    if args.profile_dir:
        if args.wall_start is None:
            raise SystemExit("--profile-dir requires --wall-start "
                             "(the capture's start wall time)")
        dev_events = load_profiler_dir(args.profile_dir)
    doc = merge_timeline(dumps, device_events=dev_events,
                         device_wall_start=args.wall_start)
    with open(args.out, "w") as f:
        json.dump(doc, f)
    print("wrote %s: %d events (%d device, %d host-phase) — load in "
          "https://ui.perfetto.dev"
          % (args.out, len(doc["traceEvents"]),
             doc["otherData"]["device_events"],
             doc["otherData"]["host_phase_events"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
