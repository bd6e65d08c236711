"""Port parity of the front door: the port's ``ClusterDriver`` on the CPU
against the JAX package's driver.

* step-locked: one script of elections, shim events (a fragmented SEND,
  a non-leader pass-through), a partition that steps the leader down and
  deposes it, and heal, through both drivers' ``step()`` — step outputs,
  replay streams, ack statuses, detector state, and each replica's
  stable store and hard-state bytes equal after every step;
* the run loop: the same pre-queued record through the port's driver
  serial and pipelined commits the JAX driver's stream and releases its
  acks, and the pipelined run overlaps dispatches;
* the crash contract, the failure detector's eviction, the lost-majority
  step-down, the automatic snapshot recovery of a force-pruned replica,
  and the surfaces that wait for later slices."""

import shutil
import time

import numpy as np
import pytest
import torch

from rdma_paxos_tpu.config import LogConfig as JCfg, TimeoutConfig as JTO
from rdma_paxos_tpu.runtime.driver import ClusterDriver as JDriver
from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
from rdma_paxos_tpu_torch.consensus import snapshot as tsnap
from rdma_paxos_tpu_torch.consensus.state import ConfigState
from rdma_paxos_tpu_torch.proxy.proxy import PendingEvent
from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver
from tests.test_torch_sim import jax_step_cache_restored  # noqa: F401

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

GEO = dict(n_slots=128, slot_bytes=64, window_slots=32, batch_slots=8)
# manual elections only — wall-clock timers must never fire mid-test
TIMERS = dict(elec_timeout_low=1e9, elec_timeout_high=2e9)
CONNECT, SEND, CLOSE = 2, 3, 4


def make_pair(tmp_path=None, R=3, geo=GEO, **kw):
    """The JAX driver and the port's, built alike (the read path on
    both, as by default)."""
    wd = {}
    if tmp_path is not None:
        for side in ("j", "t"):
            (tmp_path / side).mkdir()
            wd[side] = str(tmp_path / side)
    jd = JDriver(JCfg(**geo), R, timeout_cfg=JTO(**TIMERS),
                 workdir=wd.get("j"), **kw)
    td = ClusterDriver(LogConfig(**geo), R, timeout_cfg=TimeoutConfig(
        **TIMERS), workdir=wd.get("t"), device="cpu", **kw)
    return jd, td


def verdict(v):
    """A handler's return, comparable across the packages."""
    return "pending" if isinstance(v, PendingEvent) or hasattr(
        v, "done") else v


class Lockstep:
    """Runs one script through both drivers, comparing after each step."""

    def __init__(self, jd, td, stores: bool):
        self.jd, self.td, self.stores = jd, td, stores
        self.events = []          # (jax PendingEvent, port PendingEvent)
        self.n_steps = 0

    def event(self, r, etype, conn, payload=b""):
        jv = self.jd._make_handler(r)(etype, conn, payload)
        tv = self.td._make_handler(r)(etype, conn, payload)
        assert verdict(jv) == verdict(tv), (r, etype, conn, jv, tv)
        if verdict(tv) == "pending":
            self.events.append((jv, tv))
        return verdict(tv)

    def both(self, fn):
        fn(self.jd)
        fn(self.td)

    def step(self, n=1):
        for _ in range(n):
            jres, tres = self.jd.step(), self.td.step()
            self.n_steps += 1
            self.compare(jres, tres, f"step {self.n_steps}")

    def compare(self, jres, tres, tag):
        jd, td = self.jd, self.td
        for k, v in tres.items():
            np.testing.assert_array_equal(np.asarray(jres[k]), v,
                                          err_msg=f"{tag}: {k}")
        for r in range(td.R):
            assert list(jd.cluster.replayed[r]) == list(
                td.cluster.replayed[r]), (tag, r)
        assert [(j.done.is_set(), j.status) for j, _ in self.events] == [
            (t.done.is_set(), t.status) for _, t in self.events], tag
        assert jd.stepped_down == td.stepped_down, tag
        np.testing.assert_array_equal(jd.unverified, td.unverified, tag)
        np.testing.assert_array_equal(jd.fail_count, td.fail_count, tag)
        assert jd.leader() == td.leader(), tag
        # the read path: lease state (the step-down revokes) and hub
        assert (jd.cluster.leases is None) == (td.cluster.leases is None)
        if td.cluster.leases is not None:
            assert jd.cluster.leases.status() == \
                td.cluster.leases.status(), tag
            assert jd.cluster.reads.status() == \
                td.cluster.reads.status(), tag
        if self.stores:
            for jr, tr in zip(jd.runtimes, td.runtimes):
                assert jr.store.dump() == tr.store.dump(), (tag, tr.idx)
                assert jr.hard.load() == tr.hard.load(), (tag, tr.idx)
                with open(jr.hard.path, "rb") as a, \
                        open(tr.hard.path, "rb") as b:
                    assert a.read() == b.read(), (tag, tr.idx)


def test_step_locked_parity_with_the_jax_driver(tmp_path):
    jd, td = make_pair(tmp_path, pipeline=0, step_down_steps=4)
    s = Lockstep(jd, td, stores=True)
    try:
        s.step()                                  # idle: no leader yet
        s.both(lambda d: setattr(d.runtimes[0].timer, "_deadline", 0.0))
        s.step(2)                                 # forced election of 0
        assert td.leader() == 0
        c1, c2 = (0 << 24) | 1, (0 << 24) | 2
        assert s.event(0, CONNECT, c1, b"\x00" * 8) == "pending"
        s.event(0, SEND, c1, b"SET a 1\n")
        s.event(0, SEND, c1, bytes(range(150)))   # 3 fragments of 64 B
        s.step(2)
        # a non-leader's client session stays local (pass-through)
        assert s.event(1, CONNECT, (1 << 24) | 1) is None
        assert s.event(1, SEND, (1 << 24) | 1, b"GET a\n") is None
        s.event(0, CONNECT, c2)
        for i in range(20):                       # a backlog: bursts
            s.event(0, SEND, c2, b"w%02d" % i)
        s.event(0, CLOSE, c1)
        s.step(3)
        assert all(t.status == 0 for _, t in s.events)
        # isolate the leader with waiters parked on it: it cannot verify
        # a majority, steps down after 4 steps and fails them
        s.both(lambda d: d.cluster.partition([[0], [1, 2]]))
        for i in range(3):
            s.event(0, SEND, c2, b"lost%d" % i)
        s.step(5)
        assert td.stepped_down == {0}
        assert [t.status for _, t in s.events[-3:]] == [-1] * 3
        assert s.event(0, SEND, c2, b"refused") == -1
        # the majority side elects 1; heal deposes the old leader
        s.both(lambda d: setattr(d.runtimes[1].timer, "_deadline", 0.0))
        s.step(2)
        assert td.leader() == 1
        c3 = (1 << 24) | 3
        s.event(1, CONNECT, c3)
        for i in range(5):
            s.event(1, SEND, c3, b"after%d" % i)
        s.step(2)
        s.both(lambda d: d.cluster.heal())
        s.step(4)
        assert td.stepped_down == set()
        assert s.events[-1][1].status == 0
        assert len(td.cluster.replayed[0]) == len(td.cluster.replayed[1])
    finally:
        jd.stop()
        td.stop()


def drive_record(d, pipeline_witness=False):
    """The pre-queued record of ``tests/test_pipeline.py`` (two
    connections, 200 SENDs, sized past one fused burst) through the
    run loop; returns the committed stream and the ack statuses."""
    d.cluster.run_until_elected(0)
    d.step()
    assert d.leader() == 0
    handler = d._make_handler(0)
    conns = [(0 << 24) | 11, (0 << 24) | 12]
    for conn in conns:
        st = handler(CONNECT, conn, b"")
        assert not isinstance(st, int) or st == 0
    evs = [handler(SEND, conns[i % 2], b"w%03d" % i) for i in range(200)]
    d.run(period=0.001)
    for i, ev in enumerate(evs):
        assert ev.done.wait(30), f"ack {i} never released"
    time.sleep(0.1)          # let follower replay frontiers settle
    d.stop()
    assert d.loop_error is None
    return list(d.cluster.replayed[0]), [ev.status for ev in evs]


def test_pipelined_and_serial_commit_the_jax_stream():
    jd = JDriver(JCfg(**GEO), 3, timeout_cfg=JTO(**TIMERS), pipeline=0)
    j_stream, j_st = drive_record(jd)
    runs = {}
    for depth in (0, 2):
        td = ClusterDriver(LogConfig(**GEO), 3, timeout_cfg=TimeoutConfig(
            **TIMERS), pipeline=depth, device="cpu")
        runs[depth] = drive_record(td) + (td,)
    assert runs[2][2].cluster.max_inflight_dispatches >= 2
    assert runs[0][2].cluster.max_inflight_dispatches <= 1
    assert j_st == [0] * 200
    for depth in (0, 2):
        stream, st, _ = runs[depth]
        assert st == j_st, depth
        assert stream == j_stream, depth
    payloads = [p for (_t, _c, _r, p) in j_stream if p.startswith(b"w")]
    assert payloads == [b"w%03d" % i for i in range(200)]


def test_pipeline_crash_releases_waiters():
    d = ClusterDriver(LogConfig(**GEO), 3, timeout_cfg=TimeoutConfig(
        **TIMERS), pipeline=2, device="cpu")
    d.cluster.run_until_elected(0)
    d.step()
    handler = d._make_handler(0)
    conn = (0 << 24) | 31
    handler(CONNECT, conn, b"")
    ev = handler(SEND, conn, b"doomed")

    def boom(*a, **k):
        raise RuntimeError("injected dispatch failure")
    d.cluster.begin_step = boom
    d.cluster.begin_burst = boom
    d.cluster.step = boom
    d.cluster.step_burst = boom
    d.run()
    assert ev.done.wait(10), "waiter never released after crash"
    assert ev.status == -1
    assert isinstance(d.loop_error, RuntimeError)
    d.stop()


def test_auto_eviction_matches_the_jax_driver():
    """tests/test_driver_failures.py's eviction of a dead member, on
    both drivers step-locked: the CONFIG change commits with the same
    masks and epochs after every step."""
    geo = dict(n_slots=64, slot_bytes=32, window_slots=16, batch_slots=8)
    jd, td = make_pair(R=5, geo=geo, auto_evict=True, fail_threshold=5)
    s = Lockstep(jd, td, stores=False)

    def cmp_config(tag):
        assert jd._mm.current(0) == td._mm.current(0), tag
        assert jd._config_phase == td._config_phase, tag
    try:
        for d in (jd, td):
            d.runtimes[0].timer.beat = lambda: None
            d.cluster.run_until_elected(0)
        s.step()
        assert td.leader() == 0
        s.both(lambda d: d.cluster.partition([[0, 1, 2, 3], [4]]))
        for i in range(40):
            s.step()
            cmp_config(i)
        cur = td._mm.current(0)
        assert cur["bitmask_new"] == 0b01111, cur
        assert cur["cid_state"] == int(ConfigState.STABLE)
        assert cur["epoch"] == 2
        # quorum shrank with it: 3-of-4 commits with one more member down
        s.both(lambda d: d.cluster.partition([[0, 1, 2], [3], [4]]))
        s.both(lambda d: d.cluster.submit(0, b"post-evict"))
        s.step()
        cmp_config("post")
        r = td.cluster.last
        assert r["commit"][0] == r["end"][0]
    finally:
        jd.stop()
        td.stop()


def test_minority_leader_steps_down_and_refuses_sessions():
    """The lost-majority step-down of tests/test_step_down.py, through
    the shim handler: the isolated leader fails its parked waiter,
    refuses the session's next event and new sessions, and rejoins
    once deposed."""
    d = ClusterDriver(LogConfig(**GEO), 3, timeout_cfg=TimeoutConfig(
        **TIMERS), step_down_steps=10, pipeline=0, device="cpu")
    d.runtimes[0].timer._deadline = 0.0
    d.step()
    h = d._make_handler(0)
    conn = (0 << 24) | 7
    h(CONNECT, conn, b"")
    ok = h(SEND, conn, b"SET before ok\n")
    d.step()
    d.step()
    assert ok.done.is_set() and ok.status == 0
    d.cluster.partition([[0], [1, 2]])
    parked = h(SEND, conn, b"SET never commits\n")
    for _ in range(10):
        d.step()
    assert parked.done.is_set() and parked.status == -1
    assert 0 in d.stepped_down
    assert h(SEND, conn, b"GET before\n") == -1
    assert h(CONNECT, (0 << 24) | 8, b"") == -1
    d.runtimes[1].timer._deadline = 0.0
    d.step()
    assert d.leader() == 1
    d.cluster.heal()
    for _ in range(3):
        d.step()
    assert 0 not in d.stepped_down
    d.stop()


def test_forced_recovery_is_a_loop_crash():
    """The automatic recovery of a force-pruned replica runs inside the
    loop: an install that fails there is a loop crash that records the
    error and fails the parked waiters, as any crash does."""
    d = ClusterDriver(LogConfig(**GEO), 3, timeout_cfg=TimeoutConfig(
        **TIMERS), pipeline=2, device="cpu")
    d.cluster.run_until_elected(0)
    d.step()
    h = d._make_handler(0)
    h(CONNECT, 41, b"")
    d.step()
    d.cluster.partition([[0], [1, 2]])      # the waiter cannot commit
    ev = h(SEND, 41, b"x")

    def boom(r, donor):
        raise RuntimeError("injected install failure")
    d._install_donor_snapshot = boom
    d.cluster.need_recovery.add(2)
    d.run()
    assert ev.done.wait(10) and ev.status == -1
    assert isinstance(d.loop_error, RuntimeError)
    assert "injected install failure" in str(d.loop_error)
    assert h(SEND, 41, b"y") == -1           # a dead loop refuses intake
    d.stop()


def test_auto_recovery_matches_the_jax_driver(tmp_path):
    """tests/test_force_pruning.py's driver case, step-locked: a wedged
    follower is force-pruned past its apply cursor, flagged on unwedge,
    and healed by the driver with the leader's snapshot and store —
    step outputs, replay streams, stores and hard state equal to the
    JAX driver's after every step, and device state after the heal."""
    from rdma_paxos_tpu_torch.convert import replica_state_to_numpy
    jd, td = make_pair(tmp_path, pipeline=0)
    s = Lockstep(jd, td, stores=True)
    try:
        s.both(lambda d: d.cluster.run_until_elected(0))
        s.step()
        s.both(lambda d: d.cluster.wedge_apply(2))
        for i in range(300):
            s.both(lambda d: d.cluster.submit(0, b"a%04d" % i))
        for _ in range(250):
            s.step()
            if not td.cluster.pending[0]:
                break
        assert not td.cluster.pending[0] and not jd.cluster.pending[0]
        s.both(lambda d: d.cluster.unwedge_apply(2))
        s.step()                   # flags 2, and heals it in _post_step
        assert not td.cluster.need_recovery
        assert td.cluster.applied[2] == td.cluster.applied[0]
        assert not td.runtimes[2].app_dirty
        js = replica_state_to_numpy(jd.cluster.state)
        ts = replica_state_to_numpy(td.cluster.state)
        for k in js:
            np.testing.assert_array_equal(js[k], ts[k], err_msg=k)
        s.both(lambda d: d.cluster.submit(0, b"post-recovery"))
        s.step(3)
        assert td.cluster.replayed[2][-1][3] == b"post-recovery"
    finally:
        jd.stop()
        td.stop()


@pytest.mark.parametrize("kw", [
    dict(series_capacity=640),
    dict(scan=True), dict(repair=True), dict(governor=True),
    dict(streams=True), dict(governor_opts={}), dict(metrics_port=0),
    dict(profile_on_page=1.0), dict(alert_rules=[]), dict(streams_opts={}),
    dict(repair_opts={}), dict(mode="spmd"),
    dict(health_period=1.0), dict(alert_period=1.0)])
def test_later_slices_raise(kw):
    """The later slices' settings are ported and taken: the alert and
    health plane, repair, the governor, the scan tier, the streams hub,
    profiler captures and the spmd mode (which takes a device list and
    refuses a single device); ``repair=`` alone is refused for want of
    ``audit=True``, as in JAX."""
    if set(kw) & {"mode"}:
        with pytest.raises(ValueError, match="device list"):
            ClusterDriver(LogConfig(**GEO), 3, device="cpu", **kw)
        d = ClusterDriver(LogConfig(**GEO), 3, device=["cpu"] * 3, **kw)
        try:
            d.runtimes[0].timer._deadline = 0.0
            d.step(), d.step()
            assert d.cluster._mode == "spmd" and d.leader() == 0
        finally:
            d.stop()
        assert not any(t.is_alive() for t in d.cluster.world._threads)
        return
    if kw == dict(repair=True):
        with pytest.raises(ValueError, match="audit=True"):
            ClusterDriver(LogConfig(**GEO), 3, device="cpu", **kw)
        return
    d = ClusterDriver(LogConfig(**GEO), 3, device="cpu", **kw)
    try:
        d.step(), d.step()
        assert (d.governor is not None) == ("governor" in kw)
        assert d.cluster.scan == bool(kw.get("scan"))
        assert (d.exporter is not None) == ("metrics_port" in kw)
        assert (d.cluster.streams is not None) == bool(kw.get("streams"))
        assert (d.health()["streams"] is not None) == bool(
            kw.get("streams"))
        if "alert_rules" in kw:
            assert d.alerts.state() == {}
        assert d._profile_on_page == kw.get("profile_on_page", 0.0)
        assert d.profile_session is None
    finally:
        d.stop()


@pytest.mark.parametrize("variant", ["audit", "telemetry"])
def test_variant_drivers_match_jax(variant, tmp_path):
    """``ClusterDriver(audit=True)`` and ``(telemetry=True)`` (refused
    before the variants were ported), step-locked against the JAX
    driver: equal step results (the variant's fields included), ledger
    dumps and flight rings, or device counters and their ``device_*``
    series; an audited driver dumps its artifact under the workdir."""
    from rdma_paxos_tpu.obs import audit as jaudit
    from rdma_paxos_tpu_torch.obs import audit as taudit
    jd, td = make_pair(tmp_path, pipeline=0, **{variant: True})
    s = Lockstep(jd, td, stores=True)
    try:
        s.both(lambda d: setattr(d.runtimes[0].timer, "_deadline", 0.0))
        s.step(2)
        c1 = (0 << 24) | 1
        s.event(0, CONNECT, c1)
        for i in range(30):
            s.event(0, SEND, c1, b"v%02d" % i)
        s.step(4)
        s.both(lambda d: d.cluster.partition([[0, 1], [2]]))
        s.event(0, SEND, c1, b"partitioned")
        s.step(2)
        s.both(lambda d: d.cluster.heal())
        s.step(3)
        assert all(t.status == 0 for _, t in s.events)
        jc, tc = jd.cluster, td.cluster
        if variant == "audit":
            jdump, tdump = jc.auditor.dump(), tc.auditor.dump()
            jdump.pop("anchor")
            tdump.pop("anchor")
            assert tdump == jdump and tc.auditor.findings == []
            jf, tf = jc.flight.dump(), tc.flight.dump()
            jf.pop("anchor")
            tf.pop("anchor")
            assert tf == jf
            path = td._dump_audit_artifact("test")
            assert path == str(tmp_path / "t" / "audit_dump.json")
            assert td.audit_artifact == path
            assert taudit.main(["report", path]) == 0
            assert jaudit.main(["report", path]) == 0
        else:
            np.testing.assert_array_equal(tc.device_counters,
                                          jc.device_counters)
            for r in range(3):
                for name in ("device_committed_entries_total",
                             "device_accepted_entries_total",
                             "device_links_unheard_total",
                             "device_log_headroom",
                             "device_quorum_width"):
                    assert td.obs.metrics.get(name, replica=r) == \
                        jd.obs.metrics.get(name, replica=r), (name, r)
            assert td.obs.metrics.get(
                "device_committed_entries_total", replica=0) == int(
                tc.last["commit"][0]) + tc.rebased_total
    finally:
        jd.stop()
        td.stop()


@pytest.mark.parametrize("part", ["do_recover", "take", "install"])
def test_digest_verified_recovery_matches_jax(part, tmp_path):
    """``_do_recover(ledger=)``, ``take_snapshot(digests=True)`` and
    ``install_snapshot(ledger=)`` on a driver's audited engine (refused
    before the audit chain was ported) give JAX's snapshots and
    verdicts: a corrupted donor is refused before any state or store is
    touched, a clean one installs and the stores and states stay equal
    to the JAX driver's."""
    from rdma_paxos_tpu.consensus import snapshot as jsnap
    from rdma_paxos_tpu_torch.convert import replica_state_to_numpy
    from tests.test_torch_audit import corrupt
    jd, td = make_pair(tmp_path, pipeline=0, audit=True)
    s = Lockstep(jd, td, stores=True)
    try:
        s.both(lambda d: d.cluster.run_until_elected(0))
        s.step()
        for i in range(40):
            s.both(lambda d: d.cluster.submit(0, b"a%03d" % i))
        s.step(6)
        s.both(lambda d: corrupt(d.cluster, 2,
                                 int(d.cluster.applied[2]) - 1))
        s.step()
        jc, tc = jd.cluster, td.cluster
        if part == "take":
            for donor in range(3):
                kw = dict(index=int(tc.applied[donor]), digests=True,
                          rebased_total=tc.rebased_total)
                js = jsnap.take_snapshot(jc.state, donor, **kw)
                ts = tsnap.take_snapshot(tc.state, donor, **kw)
                assert ts.audit_start == js.audit_start >= 0
                np.testing.assert_array_equal(ts.audit_digests,
                                              js.audit_digests)
        elif part == "install":
            for c, mod in ((jc, jsnap), (tc, tsnap)):
                bad = mod.take_snapshot(c.state, 2, digests=True,
                                        index=int(c.applied[2]))
                with pytest.raises(mod.SnapshotVerifyError,
                                   match="contradicts"):
                    mod.install_snapshot(c.state, 1, bad, ledger=c.auditor)
        else:
            before = replica_state_to_numpy(tc.state)
            stores = [rt.store.dump() for rt in td.runtimes]
            for d in (jd, td):
                with pytest.raises(RuntimeError, match="contradicts"):
                    d._do_recover(1, 2, ledger=d.cluster.auditor)
            after = replica_state_to_numpy(tc.state)
            for k in before:
                np.testing.assert_array_equal(before[k], after[k], k)
            assert [rt.store.dump() for rt in td.runtimes] == stores
            s.both(lambda d: d._do_recover(2, 0, ledger=d.cluster.auditor))
            s.step(2)
            js = replica_state_to_numpy(jc.state)
            ts = replica_state_to_numpy(tc.state)
            for k in js:
                np.testing.assert_array_equal(js[k], ts[k], err_msg=k)
    finally:
        jd.stop()
        td.stop()


def _attach_governor_and_step(d):
    from rdma_paxos_tpu_torch.runtime.governor import attach_governor
    gov = attach_governor(d.cluster)
    d.step()
    assert gov.evals == 1


@pytest.mark.parametrize("call", [
    _attach_governor_and_step,
    lambda d: d.health(), lambda d: d.evaluate_alerts(),
    lambda d: d.serve_metrics(0), lambda d: d.start_profile()])
def test_later_methods_raise(call):
    """Every surface of the later slices answers now: the governor,
    health, alerts, the metrics exporter and profiler captures (the
    profiler half of ``obs/device.py``)."""
    from rdma_paxos_tpu_torch.obs.health import validate_cluster
    d = ClusterDriver(LogConfig(**GEO), 3, device="cpu", leases=False)
    try:
        if "start_profile" in call.__code__.co_names:
            s = call(d)
            assert s.active and d.profile_session is s
            d.stop_profile()
            assert not s.active and s.trace_files
            shutil.rmtree(s.log_dir)
        else:
            out = call(d)
            if "health" in call.__code__.co_names:
                assert validate_cluster(out) == []
            elif "evaluate_alerts" in call.__code__.co_names:
                assert set(out) == {"fired", "resolved"}
            elif "serve_metrics" in call.__code__.co_names:
                assert out.port > 0 and d.exporter is out
        with pytest.raises(RuntimeError, match="leases=False"):
            d.read(lambda: None)
    finally:
        d.stop()


def test_driver_needs_a_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClusterDriver(LogConfig(**GEO), 3)


@pytest.mark.parametrize("attr", ["link_model", "leases", "reads",
                                  "streams", "governor", "txn", "auditor",
                                  "flight"])
def test_engine_later_attachments_default_to_none(attr):
    """The engine shows the JAX engine's later-slice attachments, None as
    there when none is attached, and still steps."""
    from rdma_paxos_tpu.runtime.sim import SimCluster as JSim
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    c = SimCluster(LogConfig(**GEO), 3, device="cpu")
    assert getattr(c, attr) is None
    assert getattr(JSim(JCfg(**GEO), 3), attr) is None
    c.step(timeouts=[0])
    assert c.leader() == 0
