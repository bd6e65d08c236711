"""Port parity of the read path: the port's ``runtime/reads.py`` (leader
leases, the ReadHub), its hooks in ``ReplicatedKVS`` and ``SimCluster``
and the driver's read queue, on the CPU against the JAX package's.

* step-locked scripts on both engines — the lease lifecycle (grant,
  renew, expire, the new leader's barrier), the stale holder that
  expires before a usurper can commit, the wedged-apply refusal, the
  hub's follower read waiting for the apply frontier, its timeout,
  ``fail_all`` and a failing serve callback — give equal lease and hub
  status, served values, paths and read counters at every step;
* the chaos schedules of ``tests/test_reads.py`` (a leaseholder crash in
  a read burst, timeout skew with reads) give the JAX verdict, history
  and ledger;
* the KVS history hooks and ``submit_get`` record and commit as JAX's;
* the read path leaves step outputs unchanged, and the port's driver
  attaches it by default and serves ``read()`` without a ring slot.
"""

import inspect
import json
import threading
import time

import numpy as np
import pytest
import torch

from rdma_paxos_tpu.chaos import faults as jfaults
from rdma_paxos_tpu.chaos import history as jhist
from rdma_paxos_tpu.chaos.runner import NemesisRunner as JRunner
from rdma_paxos_tpu.config import LogConfig as JCfg
from rdma_paxos_tpu.models.replicated_kvs import ReplicatedKVS as JKVS
from rdma_paxos_tpu.obs import Observability as JObs
from rdma_paxos_tpu.runtime import driver as jdriver
from rdma_paxos_tpu.runtime import reads as jreads
from rdma_paxos_tpu.runtime.sim import SimCluster as JSim
from rdma_paxos_tpu_torch.chaos import faults as tfaults
from rdma_paxos_tpu_torch.chaos import history as thist
from rdma_paxos_tpu_torch.chaos.runner import NemesisRunner
from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
from rdma_paxos_tpu_torch.models.kvs import OP_INCR
from rdma_paxos_tpu_torch.models.replicated_kvs import ReplicatedKVS
from rdma_paxos_tpu_torch.obs import Observability, trace as obs_trace
from rdma_paxos_tpu_torch.runtime import driver as tdriver
from rdma_paxos_tpu_torch.runtime import reads as treads
from rdma_paxos_tpu_torch.runtime.sim import SimCluster
from tests.test_reads import READ_BURST

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

GEO = dict(n_slots=128, slot_bytes=128, window_slots=32, batch_slots=16)


class Side:
    """One package's engine, KVS and read path, driven by a script."""

    def __init__(self, jax: bool, leases: bool = True, **kw):
        self.jax = jax
        if jax:
            self.c = JSim(JCfg(**GEO), 3, **kw)
            self.c.obs = JObs()
            self.mod = jreads
        else:
            self.c = SimCluster(LogConfig(**GEO), 3, device="cpu", **kw)
            self.c.obs = Observability()
            self.mod = treads
        if leases:
            self.mod.attach(self.c)
        self.kv = (JKVS if jax else ReplicatedKVS)(self.c, cap=256)
        self.log = []

    def note(self, *what):
        self.log.append(what)

    def put_committed(self, leader, key, val, req):
        self.kv.put(leader, key, val, client_id=9, req_id=req)
        for _ in range(6):
            self.c.step()
            self.kv._fold(leader)
            if self.kv.last_req[leader].get(9, 0) >= req:
                return
        raise AssertionError("put did not commit")

    def snapshot(self, tag):
        lm, hub = self.c.leases, self.c.reads
        self.note(tag, lm.status() if lm else None,
                  hub.status() if hub else None,
                  self.mod.read_counts(self.c.obs),
                  [self.kv.serving_path(r) for r in range(3)])

    def ticket(self, t):
        return (t.status, t.path, t.value, t.read_index)


def _grant_renew(s):
    s.c.run_until_elected(0)
    for i in range(4):
        s.c.step()
        s.snapshot(("renew", i))
    s.put_committed(0, b"k", b"v1", 1)
    s.note(s.kv.get(0, b"k", linearizable=True),
           s.c.obs.metrics.get("read_latency_us", path="lease")["count"],
           len(s.c.obs.trace.events(obs_trace.LEASE_GRANTED)))


def _expire_barrier(s):
    s.c.run_until_elected(0)
    s.c.step()
    s.c.partition([[0], [1, 2]])
    for i in range(2):
        s.c.step()
        s.note(s.c.leases.valid(0, 0))
    s.c.run_until_elected(1)
    for i in range(12):
        s.snapshot(("barrier", i))
        if s.c.leases.valid(0, 1):
            break
        s.note(s.kv.get(1, b"nope", linearizable=True))
        s.c.step()
    s.snapshot("end")


def _stale_holder(s):
    s.c.run_until_elected(0)
    s.put_committed(0, b"k", b"v1", 1)
    s.c.partition([[0], [1, 2]])
    s.c.step()
    s.note(s.c.leases.valid(0, 0), s.kv.get(0, b"k", linearizable=True))
    s.c.step(timeouts=[1])
    s.note(s.c.leases.valid(0, 0))
    s.kv.put(1, b"k", b"v2", client_id=8, req_id=1)
    s.c.step()
    s.note(s.c.leases.valid(0, 0), s.kv.get(0, b"k", linearizable=True))
    s.snapshot("end")


def _wedged(s):
    s.c.run_until_elected(0)
    s.put_committed(0, b"k", b"v1", 1)
    s.c.wedge_apply(0)
    s.kv.put(0, b"k", b"v2", client_id=9, req_id=2)
    for i in range(3):
        s.c.step()
        s.snapshot(("wedged", i))
    s.note(s.c.leases.valid(0, 0), s.kv.get(0, b"k", linearizable=True))
    s.c.unwedge_apply(0)
    s.c.step()
    s.note(s.kv.get(0, b"k", linearizable=True))


def _hub_follower(s):
    s.c.run_until_elected(0)
    s.put_committed(0, b"k", b"v1", 1)
    kv = s.kv
    t = s.c.reads.submit(lambda: kv.serve_local(2, b"k"), replica=2)
    for i in range(4):
        s.note(s.ticket(t))
        if t.done:
            break
        s.c.step()
    s.snapshot("end")


def _hub_timeout(s):
    t = s.c.reads.submit(lambda: b"x", replica=1, patience=3)
    for i in range(6):
        s.c.step()
        s.note(s.ticket(t), s.c.reads.status())


def _hub_fail_all(s):
    s.c.run_until_elected(0)
    t = s.c.reads.submit(lambda: b"x", replica=2, patience=10_000)
    s.note(s.ticket(t), s.c.reads.fail_all("test"), s.ticket(t),
           s.c.reads.pending_count())


def _hub_serve_exception(s):
    s.c.run_until_elected(0)

    def boom():
        raise RuntimeError("serve failed")

    t = s.c.reads.submit(boom, replica=0)
    for _ in range(3):
        if t.done:
            break
        s.c.step()
    s.c.step()
    s.note(s.ticket(t))
    s.snapshot("end")


SCRIPTS = dict(grant_renew=_grant_renew, expire_barrier=_expire_barrier,
               stale_holder=_stale_holder, wedged=_wedged,
               hub_follower=_hub_follower, hub_timeout=_hub_timeout,
               hub_fail_all=_hub_fail_all,
               hub_serve_exception=_hub_serve_exception)
# what each script must show (the JAX tests' claims, on the port)
EXPECT = dict(
    grant_renew=lambda log: log[-1] == (b"v1", 1, 1),
    expire_barrier=lambda log: log[0] == (True,) and log[1] == (False,)
    and log[-1][1]["holders"] == [1] and log[-1][1]["revocations"] >= 1
    and log[-1][3]["read_index"] >= 1,
    stale_holder=lambda log: log[0] == (True, b"v1")
    and log[1] == (False,) and log[2] == (False, None),
    wedged=lambda log: log[-2] == (True, None) and log[-1] == (b"v2",),
    hub_follower=lambda log: log[-2][0][:3] == ("ok", "read_index", b"v1"),
    hub_timeout=lambda log: log[-1][0] == ("failed", None, None, None)
    and log[-1][1]["failed"] == 1,
    hub_fail_all=lambda log: log[0][1] == 1 and log[0][2][0] == "failed"
    and log[0][3] == 0,
    hub_serve_exception=lambda log: log[0][0][0] == "failed",
)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_read_path_scripts_match_reference(script):
    sides = [Side(jax=True), Side(jax=False)]
    for s in sides:
        SCRIPTS[script](s)
    assert sides[1].log == sides[0].log
    assert EXPECT[script](sides[1].log), sides[1].log


def test_read_path_leaves_step_outputs_unchanged():
    """Pure host bookkeeping: the same steps with and without the read
    path attached (and reads queued) give equal outputs."""
    outs = []
    for leases in (False, True):
        s = Side(jax=False, leases=leases)
        s.c.run_until_elected(0)
        res = []
        for i in range(8):
            s.kv.put(0, b"k%d" % i, b"v", client_id=3, req_id=i + 1)
            if leases:
                s.c.reads.submit(lambda: None, replica=i % 3)
            res.append({k: v.copy() for k, v in s.c.step().items()})
        outs.append(res)
    for a, b in zip(*outs):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def test_concurrent_submit_during_drain():
    """Reads submitted from another thread while the engine steps: the
    hub queue is shared between client threads and the finishing
    thread."""
    s = Side(jax=False)
    s.c.run_until_elected(0)
    s.put_committed(0, b"k", b"v1", 1)
    out = []
    stop = threading.Event()
    kv = s.kv

    def reader():
        while not stop.is_set():
            t = s.c.reads.submit(lambda: kv.serve_local(2, b"k"),
                                 replica=2)
            t.wait(5)
            out.append((t.status, t.value))

    th = threading.Thread(target=reader)
    th.start()
    for _ in range(30):
        s.c.step()
    stop.set()
    s.c.reads.fail_all("test end")
    th.join(timeout=10)
    assert not th.is_alive()
    assert ("ok", b"v1") in out


def test_kvs_history_hooks_match_reference():
    """Session PUT/RM/merge, a retransmit, weak and linearizable GETs
    and a reads-through-log GET: equal histories and commit streams."""
    sides = [Side(jax=True), Side(jax=False)]
    for s, hmod in zip(sides, (jhist, thist)):
        h = hmod.HistoryRecorder()
        s.kv.history = h
        c, kv = s.c, s.kv
        c.run_until_elected(0)
        sess = kv.session(client_id=5)
        h.set_clock(1)
        rid = sess.put(0, b"a", b"1")
        sess.retransmit_put(0, b"a", b"1", rid)
        sess.remove(0, b"b")
        sess.merge(0, OP_INCR, b"n", np.array([3] + [0] * 7,
                                               "<i4").tobytes())
        kv.submit_get(0, b"a", client_id=6, req_id=1)
        for t in range(2, 6):
            h.set_clock(t)
            c.step()
            s.note(kv.get(1, b"a"), kv.get(0, b"a", linearizable=True),
                   kv.get(2, b"a", linearizable=True), dict(kv.last_req[0]),
                   list(kv.deduped))
        s.note(h.to_jsonl(), [list(x) for x in c.replayed])
    assert sides[1].log == sides[0].log
    assert sides[1].log[-2][1] == b"1"


@pytest.mark.chaos
@pytest.mark.parametrize("case", ["crash_mid_read_burst", "timeout_skew"])
def test_chaos_read_schedules_match_reference(case):
    """``test_chaos_leaseholding_leader_crash_mid_read_burst`` and
    ``test_chaos_timeout_skew_with_reads`` on both runners."""
    if case == "crash_mid_read_burst":
        events = [dict(step=20, op="crash", replica=0),
                  dict(step=40, op="restart", replica=0)]
        kw = dict(n_replicas=3, seed=3, steps=55)
    else:
        events = [dict(step=8, op="skew", replica=1, factor=0.3),
                  dict(step=8, op="skew", replica=2, factor=3.0),
                  dict(step=18, op="partition", groups=[[0], [1, 2]]),
                  dict(step=30, op="heal"),
                  dict(step=36, op="skew", replica=1, factor=1.0),
                  dict(step=36, op="skew", replica=2, factor=1.0)]
        kw = dict(n_replicas=3, seed=11, steps=50)
    jr = JRunner(schedule=jfaults.FaultSchedule(events),
                 workload_opts=dict(READ_BURST), **kw)
    jv = jr.run()
    tr = NemesisRunner(schedule=tfaults.FaultSchedule(events),
                       workload_opts=dict(READ_BURST), device="cpu", **kw)
    tv = tr.run()
    assert tv == jv
    assert tr.history.to_jsonl() == jr.history.to_jsonl()
    assert json.dumps(tr.cluster.auditor.dump()["groups"],
                      sort_keys=True) == json.dumps(
        jr.cluster.auditor.dump()["groups"], sort_keys=True)
    assert tv["ok"] and tv["linearizability"]["violations"] == []
    reads = tv["reads"]
    assert reads["lease"] > 0 and reads["read_index"] > 0
    kinds = {e.kind for e in tr.obs.trace.events()}
    assert obs_trace.LEASE_GRANTED in kinds
    if case == "crash_mid_read_burst":
        assert reads["leases"]["grants"] >= 2
        assert reads["leases"]["revocations"] >= 1
    else:
        assert (obs_trace.LEASE_EXPIRED in kinds
                or obs_trace.LEASE_REVOKED in kinds)


# ---------------------------------------------------------------------------
# the driver's read queue
# ---------------------------------------------------------------------------

TCFG = TimeoutConfig(elec_timeout_low=0.3, elec_timeout_high=0.6)


def test_driver_read_path_defaults_match_reference():
    for name in ("leases", "lease_opts", "link_model"):
        assert inspect.signature(tdriver.ClusterDriver).parameters[
            name].default == inspect.signature(
                jdriver.ClusterDriver).parameters[name].default, name
    d = tdriver.ClusterDriver(LogConfig(**GEO), 3, device="cpu",
                              lease_opts=dict(lease_steps=3))
    assert d.cluster.leases.lease_steps == 3
    assert d.health()["leases"]["holders"] == [-1]
    d.stop()
    d = tdriver.ClusterDriver(LogConfig(**GEO), 3, device="cpu",
                              leases=False)
    assert d.cluster.leases is None and d.cluster.reads is None
    with pytest.raises(RuntimeError, match="read path"):
        d.read()
    d.stop()


def test_driver_read_serves_without_ring_slots():
    d = tdriver.ClusterDriver(LogConfig(**GEO), 3, timeout_cfg=TCFG,
                              pipeline=2, device="cpu")
    d.run(period=0.005)
    try:
        t0 = time.time()
        while d.leader() < 0:
            time.sleep(0.02)
            assert time.time() - t0 < 60, "no leader"
        lead = d.leader()
        for i in range(8):
            d.cluster.submit(lead, b"w%d" % i)
        deadline = time.time() + 30
        while (int(d.cluster.last["commit"].max()) < 8
               and time.time() < deadline):
            time.sleep(0.02)
        end_before = int(d.cluster.last["end"].max())
        results = [d.read(lambda: int(d.cluster.applied[lead]))
                   for _ in range(10)]
        assert all(t.status == "ok" for t in results)
        assert {t.path for t in results} <= {"lease", "read_index"}
        assert all(t.value >= 8 for t in results)
        # zero ring slots: the append frontier is where the writes left it
        assert int(d.cluster.last["end"].max()) == end_before
        st = d.health()
        assert st["reads"]["served"]["lease"] >= 1
        assert st["leases"]["holders"] == [lead]
        assert d.read_replica() == lead
    finally:
        d.stop()
    assert d.loop_error is None


def test_driver_takes_a_link_model_and_never_idles_under_it():
    link = tfaults.LinkModel(3, seed=0)
    d = tdriver.ClusterDriver(LogConfig(**GEO), 3, timeout_cfg=TimeoutConfig(
        elec_timeout_low=1e9, elec_timeout_high=2e9), link_model=link,
        pipeline=0, device="cpu")
    assert d.cluster.link_model is link and link.obs is d.obs
    d.runtimes[0].timer._deadline = 0.0
    d.step()
    assert d.leader() == 0
    d.step()
    assert not d._can_idle_skip()
    link.block(None, 0)                 # nobody hears the leader
    link.block(0, None)
    for _ in range(3):
        res = d.step()
    assert not res["leadership_verified"][0]
    d.stop()


def test_mesh_engine_lease_reads_match_jax():
    """The twin of tests/test_reads.py's mesh lease reads: per-group
    leases on a 2×2 mesh engine, a linearizable get through the
    leaseholders, the lease status equal to the JAX mesh engine's."""
    from rdma_paxos_tpu.shard import ShardedCluster as JSharded
    from rdma_paxos_tpu.shard.kvs import ShardedKVS as JKVS
    from rdma_paxos_tpu_torch.shard import ShardedCluster, ShardedKVS
    t = ShardedCluster(LogConfig(**GEO), 2, 2, mesh=(2, 2),
                       device=["cpu"] * 4)
    try:
        j = JSharded(JCfg(**GEO), 2, 2, mesh=(2, 2))
        got = []
        for c, obs, reads, kvs_cls in ((j, JObs, jreads, JKVS),
                                       (t, Observability, treads,
                                        ShardedKVS)):
            c.obs = obs()
            reads.attach(c)
            c.place_leaders()
            for _ in range(4):
                c.step()
            holders = c.leases.holders()
            assert all(h >= 0 for h in holders)
            kvs = kvs_cls(c, cap=256)
            key = b"meshkey"
            g = kvs.group_of(key)
            kvs.groups[g].put(holders[g], key, b"mv", client_id=7,
                              req_id=1)
            for _ in range(4):
                c.step()
            got.append((list(holders), kvs.get(key, linearizable=True),
                        c.leases.status(), c.reads.status()))
        assert got[1] == got[0]
        assert got[1][1] == b"mv"
    finally:
        t.close()
