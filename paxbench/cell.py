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
program's outputs read and judged group by group."""

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


def build_driver(conf: dict, device, workdir: str):
    from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
    from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver
    return ClusterDriver(LogConfig(**conf["log"]), int(conf["replicas"]),
                         workdir=workdir, fanout=conf["fanout"],
                         pipeline=int(conf["pipeline"]),
                         timeout_cfg=TimeoutConfig(**conf["timeouts"]),
                         device=device)


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


def run(cell: dict, *, seed: int, seconds: float, trace: bool, device,
        workdir: str, t_start: float, fault: Optional[Callable] = None,
        drain_s: float = 60.0, trace_s: float = 10.0) -> Dict:
    conf, traffic = cell["config"], cell["traffic"]
    R = int(conf["replicas"])
    G = int(conf.get("groups", 1))
    slot = int(conf["log"]["slot_bytes"])
    marks: Dict[str, float] = {}
    tick = [time.perf_counter()]

    def mark(what: str) -> None:
        now = time.perf_counter()
        marks[what] = round(now - tick[0], 3)
        tick[0] = now
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
        time.sleep(max(0.0, t_tr - time.perf_counter()))
        t_mid = time.perf_counter()
        s_mid, ph_mid = d.cluster.step_index, dict(prof.acc)
        if gcs is not None:
            gcs.stop()
        if trace:
            from paxbench.trace import DeviceTrace
            prof.enable_events()
            dt = DeviceTrace(workdir)
            tr_s0 = d.cluster.step_index
            dt.start()
            time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
            dt.stop()
            tr_s1 = d.cluster.step_index
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
        settled = shard.settled if G > 1 else _settled
        try:
            _wait(lambda: settled(d.cluster.replayed), SETTLE_S,
                  "replicas did not settle", poll=0.01)
        except TimeoutError:
            say("the replicas' streams did not reach one length")
        mem = _memory_peak(device)
        phases = {k: ph_mid[k][1] - ph0.get(k, (0, 0.0, 0.0))[1]
                  for k in ph_mid}
        dispatches = (ph_mid.get("device_dispatch", (0,))[0]
                      - ph0.get("device_dispatch", (0,))[0])
        max_inflight = d.cluster.max_inflight_dispatches
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
    in_win = acked & (t_ack >= t0) & (t_ack < t1)
    lat_ms = (t_ack[in_win] - t_send[in_win]) * 1e3
    sent_win = req & (t_send >= t0) & (t_send < t1)
    failed = int((sent_win & ~acked).sum())
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
    mid = acked & (t_ack >= t0) & (t_ack < t_mid)
    ctx = dict(window_s=t1 - t0, acked=int(in_win.sum()), steps=s1 - s0,
               lat_ms=lat_ms, phases=phases, conf=conf,
               part_s=t_mid - t0, part_acked=int(mid.sum()),
               part_steps=s_mid - s0,
               gc_pause_s=gcs.total if gcs is not None else None,
               trace=dt, trace_steps=(tr_s1 - tr_s0) if dt else None,
               phase_events=list(prof.events or ()) if trace else None)
    per_s = np.histogram(t_ack[in_win] - t0, bins=max(1, int(seconds)),
                         range=(0, max(1, int(seconds))))[0]
    diag = dict(acks_per_s=per_s.tolist(), dispatches=dispatches,
                steps=s1 - s0, max_inflight=max_inflight,
                gc_collections=[b["collections"] - a["collections"]
                                for a, b in zip(gst0, gst1)],
                terms=[term0, term1], reconnects=loop.reconnects,
                refused=int((req & (fired > 0) & (status != 0)).sum()),
                trace_aligned_by=dt.aligned_by if dt else None,
                setup_parts_s=marks,
                phase_us={k: int(v) for k, v in phases.items()},
                cpu_s=round(cpu1 - cpu0, 3))
    if G > 1:
        by_group = np.bincount(loop.group[:n][in_win], minlength=G)
        diag["acked_by_group"] = by_group.tolist()
        checks["groups_unacked"] = int((by_group == 0).sum())
    for m in notes:
        say(m)
    return dict(diag=diag, setup_s=setup_s, window_s=t1 - t0,
                attempted=int(sent_win.sum()), failed=failed,
                acked=int(in_win.sum()), lat_ms=lat_ms,
                checks=checks, ctx=ctx, memory_peak_bytes=mem,
                reference_s=time.perf_counter() - t_ref, sent=n)


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
