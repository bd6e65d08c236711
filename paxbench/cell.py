"""One run of one cell: set up the deployment, warm it with the cell's
own traffic, measure for the window, drain, and judge.

The system under test is the port's driver, as users run it: built
from the configuration file (the reference's timeouts), started
with ``run()`` and its defaults (leases, alert cadence and idle
quiescence on), electing its first leader by itself, with its stores
under the run's work directory. The window drives the leader's shim
intake handler (``_make_handler(r)``, the call the proxy's link threads
make). A configuration with ``groups`` G > 1 runs the sharded driver
instead (``shard.py``): every group led, clients that route by key, the
program's outputs read and judged group by group. A configuration with
a ``runner`` key runs that runner instead (``runners/<name>.py``, found
by ``spec.runner``), which takes this function's arguments and returns
its result; it measures its window with ``window`` and ``result``
below, so every reader means the same in each deployment."""

from __future__ import annotations

import gc
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from paxbench import reference, shard, spec
from paxbench.generators import Pool
from paxbench.loop import ClosedLoop

FORBIDDEN = ("jax", "jaxlib", "flax", "rdma_paxos_tpu")
SETTLE_S = 10.0
TRACE_TRIES = 3         # device captures a traced run takes at most
LEADER_HOLD_S = 1.0     # a leader counts as elected once it held this long


def say(msg: str) -> None:
    print(f"[paxbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _wait(cond: Callable[[], bool], timeout: float, what: str,
          poll: float = 0.002) -> None:
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise TimeoutError(what)
        time.sleep(poll)


def build_driver(conf: dict, device, workdir: str, **extra):
    """The one-group ``ClusterDriver`` a configuration describes;
    ``extra`` adds arguments a runner needs (``app_ports``)."""
    from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
    from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver
    return ClusterDriver(LogConfig(**conf["log"]), int(conf["replicas"]),
                         workdir=workdir, fanout=conf["fanout"],
                         pipeline=int(conf["pipeline"]),
                         timeout_cfg=TimeoutConfig(**conf["timeouts"]),
                         device=device, **extra)


def _stable_leader(d, hold: float, timeout: float) -> int:
    """The leader, once one has held for ``hold`` seconds."""
    end = time.monotonic() + timeout
    lead, since = -1, time.monotonic()
    while time.monotonic() < end:
        now, cur = time.monotonic(), d.leader()
        if cur != lead:
            lead, since = cur, now
        elif lead >= 0 and now - since >= hold:
            return lead
        time.sleep(0.005)
    raise TimeoutError("no leader held for %.1f s" % hold)


def _settled(streams) -> bool:
    return len({len(s) for s in streams}) == 1


class Marks:
    """Seconds each part of set-up took (``diag.setup_parts_s``)."""

    def __init__(self):
        self.parts: Dict[str, float] = {}
        self._tick = time.perf_counter()

    def __call__(self, what: str) -> None:
        now = time.perf_counter()
        self.parts[what] = round(now - self._tick, 3)
        self._tick = now


def run(cell: dict, *, seed: int, seconds: float, trace: bool, device,
        workdir: str, t_start: float, fault: Optional[Callable] = None,
        drain_s: float = 60.0, trace_s: float = 10.0) -> Dict:
    conf, traffic = cell["config"], cell["traffic"]
    runner = spec.runner(conf.get("runner"))
    if runner is not None:
        return runner.run(cell, seed=seed, seconds=seconds, trace=trace,
                          device=device, workdir=workdir, t_start=t_start,
                          fault=fault, drain_s=drain_s, trace_s=trace_s)
    R = int(conf["replicas"])
    G = int(conf.get("groups", 1))
    slot = int(conf["log"]["slot_bytes"])
    mark = Marks()
    mark("start")
    pool: Pool = spec.generator(traffic["kind"]).make(traffic, seed)
    mark("traffic")
    d = (shard.build_driver if G > 1 else build_driver)(conf, device,
                                                         workdir)
    loop = None
    try:
        d.prewarm()
        if trace:
            from paxbench.trace import warm_profiler
            warm_profiler()
        mark("prewarm")
        d.run()
        if G > 1:
            shard.stable_leaders(d, LEADER_HOLD_S, 60)
        else:
            _stable_leader(d, LEADER_HOLD_S, 60)
        mark("election")
        cap = int(float(traffic["max_rate"]) * (seconds + 60))
        handlers = [d._make_handler(r) for r in range(R)]
        if G > 1:
            loop = shard.ShardedLoop(
                pool.payloads, shard.route(pool, d.router), G,
                int(traffic["clients"]), int(traffic["outstanding"]),
                handlers, cap)
        else:
            loop = ClosedLoop(pool.payloads, int(traffic["clients"]),
                              int(traffic["outstanding"]), handlers,
                              d.leader, cap)
        opened = loop.connect_all()
        _wait(lambda: all(loop.fired[k] for k in opened), 60,
              "a CONNECT was never committed")
        if any(loop.status[k] != 0 for k in opened):
            raise RuntimeError("a CONNECT failed")
        mark("connect")
        w = window(d, loop, traffic=traffic, seconds=seconds, trace=trace,
                   workdir=workdir, t_start=t_start, fault=fault,
                   drain_s=drain_s, trace_s=trace_s, device=device,
                   settled=shard.settled if G > 1 else _settled, mark=mark)
        streams = None if G > 1 else list(d.cluster.replayed)
    finally:
        if loop is not None and not loop.closing:
            loop.close()
        d.stop()
    n = loop.n_sent
    conns, pidx, status = loop.conn[:n], loop.pidx[:n], loop.status[:n]
    fired, t_send, t_ack = loop.fired[:n], loop.t_send[:n], loop.t_ack[:n]
    req = pidx >= 0
    acked = req & (fired > 0) & (status == 0)
    stores = [f"{workdir}/replica{r}.db" for r in range(R)]
    t_ref = time.perf_counter()
    notes: List[str] = []
    if G > 1:
        streams, logs, ends = shard.outputs(d.cluster)
        checks = reference.judge_groups(
            notes=notes, conns=conns, pidx=pidx, status=status,
            fired=fired, order=loop.order[:n], groups=loop.group[:n],
            payloads=pool.payloads, slot_bytes=slot, streams=streams,
            stores=stores, logs=logs, ends=ends)
    else:
        buf = d.cluster.state.log.buf
        ends = np.asarray(d.cluster.state.end.cpu()).ravel()
        checks = reference.judge(
            notes=notes, conns=conns, pidx=pidx, status=status,
            fired=fired, order=loop.order[:n], payloads=pool.payloads,
            slot_bytes=slot, streams=streams, stores=stores,
            logs=[buf[r] for r in range(R)], ends=ends)
    checks["overflow"] = int(loop.overflow)
    res = result(w, conf=conf, seconds=seconds, marks=mark.parts,
                 t_send=t_send, t_ack=t_ack, sent=req, acked=acked,
                 checks=checks, reconnects=loop.reconnects,
                 refused=int((req & (fired > 0) & (status != 0)).sum()),
                 reference_s=time.perf_counter() - t_ref, n_rows=n)
    if G > 1:
        in_win = acked & (t_ack >= w["t0"]) & (t_ack < w["t1"])
        by_group = np.bincount(loop.group[:n][in_win], minlength=G)
        res["diag"]["acked_by_group"] = by_group.tolist()
        checks["groups_unacked"] = int((by_group == 0).sum())
    for m in notes:
        say(m)
    return res


def window(d, loop, *, traffic: dict, seconds: float, trace: bool,
           workdir: str, t_start: float, fault: Optional[Callable],
           drain_s: float, trace_s: float, device, settled: Callable,
           mark: Callable[[str], None]) -> Dict:
    """Plant ``fault``, start ``loop`` (``start``, ``close``, ``join``,
    ``answered``, ``n_sent``), warm up by the traffic's
    ``warmup_steps`` (the last part of set-up, ``mark``ed), measure for
    ``seconds``, close the loop, wait for every answer and for the
    replicas' streams to settle. Returns the window's clock and step
    readings, phases, collector and trace."""
    if fault is not None:
        fault(d)
    prof = d.cluster.profiler
    steps0 = d.cluster.step_index
    loop.start()
    _wait(lambda: d.cluster.step_index - steps0
          >= int(traffic["warmup_steps"]), 120,
          "the warm-up did not finish", poll=0.001)
    mark("warmup")
    # ---- the measured window ----
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    s0, ph0 = d.cluster.step_index, dict(prof.acc)
    cpu0 = time.process_time()
    gst0, term0 = gc.get_stats(), _terms(d)
    gcs = _GcClock() if trace else None
    dt = tr_s0 = tr_s1 = None
    # a traced run reads its host phases, steps and collector over
    # the window's first part and traces the device over its last
    # ``trace_s`` seconds (the profiler slows the host while on)
    t_tr = t0 + (seconds - min(trace_s, seconds / 4) if trace
                 else seconds)
    # the untraced part in fifths, each one's steps and phases read at
    # its end (``diag.steps_by_fifth``, ``phase_ms_per_step_by_fifth``)
    fifths = [(s0, ph0)]
    for f in range(1, 5):
        time.sleep(max(0.0, t0 + (t_tr - t0) * f / 5 - time.perf_counter()))
        fifths.append((d.cluster.step_index, dict(prof.acc)))
    time.sleep(max(0.0, t_tr - time.perf_counter()))
    t_mid = time.perf_counter()
    s_mid, ph_mid = d.cluster.step_index, dict(prof.acc)
    fifths.append((s_mid, ph_mid))
    if gcs is not None:
        gcs.stop()
    tries = []
    if trace:
        from paxbench.trace import DeviceTrace, kernels_lost
        prof.enable_events()
        end = t0 + seconds
        # a capture that lost its kernel records is taken again at once,
        # for as long, while the loop still runs; the window then closes
        # after the capture that is kept
        for _ in range(TRACE_TRIES):
            dt = DeviceTrace(workdir)
            tr_s0 = d.cluster.step_index
            dt.start()
            time.sleep(max(0.0, end - time.perf_counter()))
            dt.stop()
            tr_s1 = d.cluster.step_index
            tries.append(_trace_counts(dt, tr_s1 - tr_s0))
            if not kernels_lost(dt.events, tr_s1 - tr_s0):
                break
            say(f"the device trace lost its kernel records "
                f"({tries[-1]}); tracing again")
            end = time.perf_counter() + min(trace_s, seconds / 4)
    t1 = time.perf_counter()
    s1, gst1, term1 = d.cluster.step_index, gc.get_stats(), _terms(d)
    cpu1 = time.process_time()
    loop.close()
    # ---- after the window: wait for every answer, then settle ----
    try:
        _wait(lambda: loop.answered() >= loop.n_sent, drain_s,
              "requests still unanswered", poll=0.01)
    except TimeoutError:
        say(f"{loop.n_sent - loop.answered()} requests never answered")
    loop.join(5)
    try:
        _wait(lambda: settled(d.cluster.replayed), SETTLE_S,
              "replicas did not settle", poll=0.01)
    except TimeoutError:
        say("the replicas' streams did not reach one length")
    phases = {k: ph_mid[k][1] - ph0.get(k, (0, 0.0, 0.0))[1]
              for k in ph_mid}
    return dict(
        t0=t0, t_mid=t_mid, t1=t1, setup_s=setup_s, s0=s0, s_mid=s_mid,
        s1=s1, phases=phases, gcs=gcs, dt=dt, gst=(gst0, gst1),
        terms=[term0, term1], cpu_s=cpu1 - cpu0,
        trace_steps=(tr_s1 - tr_s0) if dt else None,
        dispatches=(ph_mid.get("device_dispatch", (0,))[0]
                    - ph0.get("device_dispatch", (0,))[0]),
        memory_peak_bytes=_memory_peak(device),
        max_inflight=d.cluster.max_inflight_dispatches, fifths=fifths,
        phase_events=list(prof.events or ()) if trace else None,
        trace_tries=tries)


def result(w: Dict, *, conf: dict, seconds: float, marks: Dict,
           t_send: np.ndarray, t_ack: np.ndarray, sent: np.ndarray,
           acked: np.ndarray, checks: Dict[str, int], reconnects: int,
           refused: int, reference_s: float, n_rows: int) -> Dict:
    """The run's result from the window's readings (``window``) and the
    clients' rows: each request's send and answer stamps, which rows
    are requests (``sent``) and which were acked (``acked``)."""
    t0, t1, t_mid = w["t0"], w["t1"], w["t_mid"]
    in_win = acked & (t_ack >= t0) & (t_ack < t1)
    lat_ms = (t_ack[in_win] - t_send[in_win]) * 1e3
    sent_win = sent & (t_send >= t0) & (t_send < t1)
    mid = acked & (t_ack >= t0) & (t_ack < t_mid)
    dt, gcs, phases = w["dt"], w["gcs"], w["phases"]
    ctx = dict(window_s=t1 - t0, acked=int(in_win.sum()),
               steps=w["s1"] - w["s0"], lat_ms=lat_ms, phases=phases,
               conf=conf, part_s=t_mid - t0, part_acked=int(mid.sum()),
               part_steps=w["s_mid"] - w["s0"],
               gc_pause_s=gcs.total if gcs is not None else None,
               trace=dt, trace_steps=w["trace_steps"],
               phase_events=w["phase_events"])
    per_s = np.histogram(t_ack[in_win] - t0, bins=max(1, int(seconds)),
                         range=(0, max(1, int(seconds))))[0]
    gst0, gst1 = w["gst"]
    diag = dict(acks_per_s=per_s.tolist(), dispatches=w["dispatches"],
                steps=w["s1"] - w["s0"], max_inflight=w["max_inflight"],
                gc_collections=[b["collections"] - a["collections"]
                                for a, b in zip(gst0, gst1)],
                terms=w["terms"], reconnects=reconnects, refused=refused,
                trace_aligned_by=dt.aligned_by if dt else None,
                trace_captures=w["trace_tries"] or None,
                setup_parts_s=marks,
                phase_us={k: int(v) for k, v in phases.items()},
                cpu_s=round(w["cpu_s"], 3),
                **_by_fifth(w["fifths"], t1 - t0))
    return dict(diag=diag, setup_s=w["setup_s"], window_s=t1 - t0,
                attempted=int(sent_win.sum()),
                failed=int((sent_win & ~acked).sum()),
                acked=int(in_win.sum()), lat_ms=lat_ms,
                checks=checks, ctx=ctx,
                memory_peak_bytes=w["memory_peak_bytes"],
                reference_s=reference_s, sent=n_rows)


def _trace_counts(dt, steps: int) -> Dict[str, int]:
    """How many steps a capture spanned, and how many kernels, copies
    and commit window kernels it holds (``diag.trace_captures``)."""
    from paxbench.trace import is_kernel
    k = sum(1 for n, _a, _b in dt.events if is_kernel(n))
    return dict(steps=steps, kernels=k, copies=len(dt.events) - k,
                commit_window=sum(1 for n, _a, _b in dt.events
                                  if "commit_window" in n))


def _by_fifth(fifths, window_s: float) -> Dict:
    """Steps in each fifth of the untraced window, and the host time
    per step, in ms, of each phase that took a twentieth of the window
    or more."""
    steps = [b[0] - a[0] for a, b in zip(fifths, fifths[1:])]

    def us(ph, k):
        return ph.get(k, (0, 0.0))[1]
    first, last = fifths[0][1], fifths[-1][1]
    big = [k for k in last if us(last, k) - us(first, k) >= window_s * 5e4]
    return dict(steps_by_fifth=steps, phase_ms_per_step_by_fifth={
        k: [round((us(b[1], k) - us(a[1], k)) / 1e3 / max(1, n), 3)
            for a, b, n in zip(fifths, fifths[1:], steps)] for k in big})


def _terms(d) -> List[int]:
    last = d.cluster.last
    return [] if last is None else np.asarray(last["term"]).ravel().tolist()


class _GcClock:
    """Seconds the collector ran, through ``gc.callbacks``."""

    def __init__(self):
        self.total, self._t = 0.0, None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, _info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.total += time.perf_counter() - self._t
            self._t = None

    def stop(self):
        if self._cb in gc.callbacks:
            gc.callbacks.remove(self._cb)


def _memory_peak(device) -> int:
    import torch
    if getattr(device, "type", str(device)) != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))
