"""The driver's host phases account for every moment of its dispatch and
readback threads, on the CPU.

* a running ``ClusterDriver`` under steady closed-loop traffic (the
  pipelined loop and the serial one): on each of its two threads the
  ``StepPhaseProfiler`` phases cover at least 90 % of a stretch of wall
  time, and the removed ``timer_device_step_us`` histogram is gone;
* the profiler pairs a phase's start and stop per thread, updates its
  sums exactly from many threads, and counts the slices its full event
  ring drops;
* the ``gc`` phase: one slice per collection while the driver runs,
  kept out of the ``step_phase_us`` histogram, its hook gone after
  ``stop()``;
* the benchmark's readers of the new phases: ms per protocol step over
  the window's untraced part, None where the phase is absent."""

from __future__ import annotations

import collections
import gc
import sys
import threading
import time

import pytest
import torch

from paxbench import spec
from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
from rdma_paxos_tpu_torch.obs.spans import StepPhaseProfiler
from rdma_paxos_tpu_torch.runtime import driver as tdriver
from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver
from rdma_paxos_tpu_torch.runtime.sim import PHASE_FINISH_RULES

torch.set_num_threads(1)

GEO = dict(n_slots=256, slot_bytes=64, window_slots=32, batch_slots=16)
TIMERS = dict(elec_timeout_low=1e9, elec_timeout_high=2e9)   # manual
CONNECT, SEND = 2, 3
CLIENTS, OUTSTANDING = 2, 16
STRETCH_S = 1.0


class ThreadPhases:
    """Wraps a profiler's ``start``/``stop`` to keep each closed slice
    with the thread that ran it: ``{thread id: [(phase, t0, t1)]}``."""

    def __init__(self, prof: StepPhaseProfiler):
        self.by_thread = collections.defaultdict(list)
        self._open = {}
        start, stop = prof.start, prof.stop

        def on_start(phase):
            self._open[(threading.get_ident(), phase)] = time.monotonic()
            start(phase)

        def on_stop(phase, observe=True):
            stop(phase, observe)
            tid = threading.get_ident()
            t0 = self._open.pop((tid, phase), None)
            if t0 is not None:
                self.by_thread[tid].append((phase, t0, time.monotonic()))
        prof.start, prof.stop = on_start, on_stop

    def coverage(self, tid: int, a: float, b: float) -> float:
        """Share of ``[a, b]`` inside some phase of thread ``tid``."""
        iv = sorted((max(t0, a), min(t1, b))
                    for _p, t0, t1 in self.by_thread[tid]
                    if t1 > a and t0 < b)
        covered, end = 0.0, a
        for lo, hi in iv:
            lo = max(lo, end)
            if hi > lo:
                covered += hi - lo
                end = hi
        return covered / (b - a)


def closed_loop(d, stop: threading.Event) -> threading.Thread:
    """CLIENTS connections on replica 0, OUTSTANDING SENDs in flight in
    all: each released SEND is answered by the next."""
    handler = d._make_handler(0)
    conns = [(0 << 24) | (40 + i) for i in range(CLIENTS)]
    for conn in conns:
        handler(CONNECT, conn, b"")

    def run():
        inflight = collections.deque()
        i = 0
        while not stop.is_set():
            while len(inflight) < OUTSTANDING:
                inflight.append(handler(SEND, conns[i % CLIENTS],
                                        b"SET k%05d v\n" % i))
                i += 1
            ev = inflight.popleft()
            if hasattr(ev, "done"):
                ev.done.wait(5)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


@pytest.mark.parametrize("pipeline", [2, 0])
def test_phases_cover_both_threads(pipeline, tmp_path):
    d = ClusterDriver(LogConfig(**GEO), 3, timeout_cfg=TimeoutConfig(
        **TIMERS), workdir=str(tmp_path), pipeline=pipeline, device="cpu",
        health_period=0.1)
    stop = threading.Event()
    client = None
    try:
        d.cluster.run_until_elected(0)
        d.step()
        assert d.leader() == 0
        tagged = ThreadPhases(d._phase_prof)
        d.run()
        client = closed_loop(d, stop)
        time.sleep(0.5)                      # past the first bursts
        a = time.monotonic()
        time.sleep(STRETCH_S)
        b = time.monotonic()
        stop.set()
        client.join(10)
        d.stop()
        assert d.loop_error is None
        for name, t in (("dispatch", d._thread),
                        ("readback", d._rb_thread)):
            share = tagged.coverage(t.ident, a, b)
            assert share >= 0.9, (name, share, {
                p for p, _a, _b in tagged.by_thread[t.ident]})
        acc = d._phase_prof.acc
        for phase in (tdriver.PHASE_SUBMIT_PUMP,
                      tdriver.PHASE_INTAKE_LOCK_WAIT,
                      tdriver.PHASE_READBACK_IDLE, PHASE_FINISH_RULES,
                      tdriver.PHASE_POST_STEP_RULES, tdriver.PHASE_CADENCE,
                      tdriver.PHASE_STORE_SYNC, "apply_replay_ack",
                      "ack_release", "host_encode", "device_dispatch"):
            assert acc.get(phase, (0,))[0] > 0, phase
        if pipeline:
            assert acc[tdriver.PHASE_PIPELINE_WAIT][0] > 0
        hists = d.obs.metrics.snapshot()["histograms"]
        assert not [k for k in hists if k.startswith("timer_")]
        assert not hasattr(d, "_timer_obs")
    finally:
        stop.set()
        if client is not None:
            client.join(10)
        d.stop()


def test_a_phase_on_two_threads_pairs_per_thread():
    """Thread a opens ``x``, thread b opens ``x``, a closes, b closes:
    each slice spans its own thread's start and stop."""
    prof = StepPhaseProfiler()
    prof.enable_events()
    steps = [threading.Event() for _ in range(3)]

    def a():
        prof.start("x")
        steps[0].set()
        steps[1].wait(5)
        time.sleep(0.04)
        prof.stop("x")
        steps[2].set()

    def b():
        steps[0].wait(5)
        time.sleep(0.02)
        prof.start("x")
        steps[1].set()
        steps[2].wait(5)
        time.sleep(0.04)
        prof.stop("x")
    ts = [threading.Thread(target=f) for f in (a, b)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
        assert not t.is_alive()
    n, tot, mx = prof.acc["x"]
    assert n == 2 and len(prof.events) == 2
    # a: >= 20 + 40 ms; b: >= 40 + 40 ms. Keyed by phase alone, a's stop
    # would close b's start (~40 ms) and b's stop would find nothing
    spans = sorted(t1 - t0 for _p, t0, t1 in prof.events)
    assert spans[0] >= 0.055 and spans[1] >= 0.075, spans
    assert tot >= 0.13e6


def test_sums_are_exact_across_threads():
    prof = StepPhaseProfiler()
    n_threads, n_each = 16, 1000

    def work():
        for _ in range(n_each):
            prof.start("y")
            prof.stop("y")
    ts = [threading.Thread(target=work) for _ in range(n_threads)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)                  # switch threads often
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert prof.acc["y"][0] == n_threads * n_each


def test_dropped_events_are_counted():
    prof = StepPhaseProfiler()
    prof.enable_events(capacity=4)
    for i in range(10):
        prof.start("p%d" % i)
        prof.stop("p%d" % i)
    assert prof.events_dropped == 6
    assert [p for p, _a, _b in prof.events] == ["p6", "p7", "p8", "p9"]
    prof.enable_events(capacity=4)              # a fresh ring
    assert prof.events_dropped == 0 and not prof.events


def test_gc_phase_while_the_driver_runs():
    d = ClusterDriver(LogConfig(**GEO), 3, timeout_cfg=TimeoutConfig(
        **TIMERS), device="cpu")
    try:
        prof = d._phase_prof
        d.run()
        assert d._on_gc in gc.callbacks
        prof.enable_events()
        n0 = prof.acc.get(tdriver.PHASE_GC, (0,))[0]
        gc.collect()
        assert prof.acc[tdriver.PHASE_GC][0] > n0
        assert any(p == tdriver.PHASE_GC for p, _a, _b in prof.events)
        hists = d.obs.metrics.snapshot()["histograms"]
        assert not [k for k in hists if "phase=gc" in k]
    finally:
        d.stop()
    assert d._on_gc not in gc.callbacks
    n1 = d._phase_prof.acc[tdriver.PHASE_GC][0]
    gc.collect()
    assert d._phase_prof.acc[tdriver.PHASE_GC][0] == n1


# reader -> the phases it sums
READERS = {
    "pipeline_wait_ms_per_step": ("pipeline_wait",),
    "readback_idle_ms_per_step": ("readback_idle",),
    "host_rules_ms_per_step": ("finish_rules", "post_step_rules"),
    "cadence_ms_per_step": ("cadence",),
    "intake_lock_wait_ms_per_step": ("intake_lock_wait",),
    "store_sync_ms_per_step": ("store_sync",),
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_ms_per_step(metric):
    reader = spec.reader(metric)
    phases = {p: 3000.0 * (i + 1) for i, p in enumerate(READERS[metric])}
    phases["device_dispatch"] = 99999.0        # another phase: not read
    want = sum(phases[p] for p in READERS[metric]) / 1e3 / 40
    assert reader.read(dict(phases=phases, part_steps=40)) == \
        pytest.approx(want)
    assert reader.read(dict(phases={"device_dispatch": 5.0},
                            part_steps=40)) is None
    assert reader.read(dict(phases=phases, part_steps=0)) is None


def test_every_new_reader_is_declared_for_both_cells():
    per_layer = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for metric in READERS:
        m = per_layer[metric]
        assert m["source"] == "program_span"
        assert m["moves"] == "acked_ops_per_s"
        assert m["workloads"] == ["apus3.set_c256p16", "apus3.set_c50"]
