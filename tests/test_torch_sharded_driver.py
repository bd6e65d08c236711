"""Port parity of ``runtime/sharded_driver.py``: the port's
``ShardedClusterDriver`` on the CPU against the JAX package's.

* ``key_prefix_of``'s routing cases;
* step-locked: G = 4 groups led round-robin by the step-domain group
  timers, shim handlers on all three replicas, held CONNECTs and SENDs
  whose keys spread over the groups, through both drivers' ``step()`` —
  step outputs, per-group replay streams, ack statuses, leader views
  and lease state equal after every step, and each group's acks
  released in submit order with status 0;
* the run loop: pre-queued SENDs on every replica through the port's
  pipelined loop are acked once each, with status 0, in per-group order;
* the surfaces that raise (``tests/test_pipeline.py``'s list), and the
  mesh engine's construction (``tests/test_torch_mesh.py`` runs the
  step-locked drive and the loop on it)."""

import numpy as np
import pytest
import torch

from rdma_paxos_tpu.config import LogConfig as JCfg, TimeoutConfig as JTO
from rdma_paxos_tpu.runtime.sharded_driver import (
    ShardedClusterDriver as JDriver, key_prefix_of as jkey_prefix_of)
from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
from rdma_paxos_tpu_torch.proxy.proxy import PendingEvent
from rdma_paxos_tpu_torch.runtime.sharded_driver import (
    ShardedClusterDriver, key_prefix_of)
from tests.test_torch_sim import jax_step_cache_restored  # noqa: F401

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

GEO = dict(n_slots=128, slot_bytes=64, window_slots=32, batch_slots=8)
# the wall-clock timers never fire; the group timers are step-domain
TIMERS = dict(elec_timeout_low=1e9, elec_timeout_high=2e9)
CONNECT, SEND, CLOSE = 2, 3, 4
G = 4


def test_key_prefix_of_cases():
    cases = [b"SET k3-17 v1\n", b"*3\r\n$3\r\nSET\r\n$5\r\nk4-99\r\n$2\r\nv0\r\n",
             b"", b"SET user.1-x v\n", b"SET a:b.c-d v\n", b"PING\n",
             b"GET key\n", b"*1\r\n$4\r\nPING\r\n", b"SET -x v\n"]
    for p in cases:
        assert key_prefix_of(p) == jkey_prefix_of(p), p
    assert key_prefix_of(b"SET k3-17 v1\n") == b"k3"
    assert key_prefix_of(b"SET user.1-x v\n") == b"user"
    assert key_prefix_of(b"SET a:b.c-d v\n") == b"a"
    assert key_prefix_of(b"") == b""


def cpu_devices(mesh):
    """The port engine's ``device=``: the CPU, or ``mesh``'s device
    list of CPU entries."""
    return "cpu" if mesh is None else ["cpu"] * (mesh[0] * mesh[1])


def make_pair(mesh=None, **kw):
    jd = JDriver(JCfg(**GEO), 3, G, timeout_cfg=JTO(**TIMERS), mesh=mesh,
                 **kw)
    td = ShardedClusterDriver(LogConfig(**GEO), 3, G,
                              timeout_cfg=TimeoutConfig(**TIMERS),
                              mesh=mesh, device=cpu_devices(mesh), **kw)
    return jd, td


def test_step_locked_parity_with_the_jax_sharded_driver():
    step_locked_parity()


def step_locked_parity(mesh=None):
    """The step-locked drive against the JAX driver (on ``mesh``'s
    engine on both sides when given)."""
    jd, td = make_pair(mesh, pipeline=0, group_timer_lo=1,
                       group_timer_hi=2)
    events = []       # (group, replica, jax event, port event)

    def compare(jres, tres, tag):
        for k, v in tres.items():
            np.testing.assert_array_equal(np.asarray(jres[k]), v,
                                          err_msg=f"{tag}: {k}")
        for g in range(G):
            for r in range(3):
                assert list(jd.cluster.replayed[g][r]) == list(
                    td.cluster.replayed[g][r]), (tag, g, r)
        assert jd.leaders() == td.leaders(), tag
        assert jd.leader() == td.leader(), tag
        assert [(j.done.is_set(), j.status) for *_, j, _t in events] == [
            (t.done.is_set(), t.status) for *_, t in events], tag
        assert jd.cluster.leases.status() == td.cluster.leases.status()
        assert jd.cluster.reads.status() == td.cluster.reads.status()
        # per (group, replica) the released acks are a prefix of the
        # submitted events: acks arrive in order
        for g in range(G):
            for r in range(3):
                done = [t.done.is_set() for gg, rr, _j, t in events
                        if (gg, rr) == (g, r)]
                assert done == sorted(done, reverse=True), (tag, g, r)

    try:
        n = 0
        while td.leader() < 0:
            compare(jd.step(), td.step(), f"boot {n}")
            n += 1
            assert n < 20, td.leaders()
        # round-robin placement by the group timers' rotation
        assert td.leaders() == [g % 3 for g in range(G)]
        hj = [jd._make_handler(r) for r in range(3)]
        ht = [td._make_handler(r) for r in range(3)]
        for wave in range(3):
            for r in range(3):
                for c in range(2):
                    conn = (r << 24) | (wave << 12) | (100 + c)
                    a, b = hj[r](CONNECT, conn, b""), ht[r](CONNECT, conn,
                                                           b"")
                    assert a == b == 0          # held, acked at once
                    tid = r * 2 + c
                    for i in range(5):
                        p = b"SET k%d-%d v%d\n" % (tid, i, wave)
                        a = hj[r](SEND, conn, p)
                        b = ht[r](SEND, conn, p)
                        assert isinstance(b, PendingEvent)
                        g = td.router.group_of(b"k%d" % tid)
                        events.append((g, r, a, b))
                    if wave == 2 and c == 0:
                        a = hj[r](CLOSE, conn, b"")
                        b = ht[r](CLOSE, conn, b"")
                        events.append((None, r, a, b))
            for i in range(4):
                compare(jd.step(), td.step(), f"wave {wave} step {i}")
        assert all(t.status == 0 for *_, t in events)
        assert len({g for g, *_ in events if g is not None}) > 1
        # every replica's per-group stream: its CONNECTs ahead of its
        # SENDs, each connection's SENDs in submit order
        c = td.cluster
        for g in range(G):
            stream = list(c.replayed[g][0])
            for r in range(3):
                assert list(c.replayed[g][r]) == stream
                assert c.applied[g, r] == int(c.last["commit"][g, r])
            seen = {}
            for etype, conn, _req, payload in stream:
                if etype == SEND:
                    assert conn in seen, "SEND before its CONNECT"
                    seen[conn].append(payload)
                elif etype == CONNECT:
                    seen.setdefault(conn, [])
            for conn, sends in seen.items():
                idx = [int(p.split(b"-")[1].split(b" ")[0]) for p in sends]
                assert idx == list(range(5)), (g, conn, idx)
        st = td.health()
        assert st["n_groups"] == G and st["leaders"] == td.leaders()
        assert st["router"] == td.router.to_dict()
    finally:
        jd.stop()
        td.stop()


def test_pipelined_loop_acks_every_event_once_in_group_order():
    pipelined_loop()


def pipelined_loop(mesh=None):
    """Pre-queued SENDs through the pipelined loop (of ``mesh``'s
    engine when given): every event acked once with status 0, each
    connection's SENDs committed in submit order; returns the driver's
    per-group committed streams."""
    td = ShardedClusterDriver(LogConfig(**GEO), 3, G, mesh=mesh,
                              device=cpu_devices(mesh),
                              timeout_cfg=TimeoutConfig(**TIMERS),
                              group_timer_lo=1, group_timer_hi=2)
    try:
        while td.leader() < 0:
            td.step()
        handlers = [td._make_handler(r) for r in range(3)]
        evs = []
        for r in range(3):
            for c in range(3):
                conn = (r << 24) | (200 + c)
                assert handlers[r](CONNECT, conn, b"") == 0
                for i in range(30):
                    evs.append(handlers[r](
                        SEND, conn, b"SET p%d-%d v\n" % (r * 3 + c, i)))
        td.run(period=0.002)
        for ev in evs:
            assert ev.done.wait(60), "ack timed out"
        assert all(ev.status == 0 for ev in evs)
        assert td.loop_error is None
        released = [ev for ev in evs if ev.done.is_set()]
        assert len(released) == len(evs) == 270
        # the committed streams hold every SEND once, in per-connection
        # submit order
        td.stop()
        c = td.cluster
        per_conn = {}
        for g in range(G):
            for etype, conn, _req, payload in c.replayed[g][0]:
                if etype == SEND:
                    per_conn.setdefault(conn, []).append(payload)
        for conn, sends in per_conn.items():
            idx = [int(p.split(b"-")[1].split(b" ")[0]) for p in sends]
            assert idx == list(range(30)), conn
        assert len(per_conn) == 9
        return per_conn
    finally:
        td.stop()


def test_sharded_driver_reads_and_status():
    td = ShardedClusterDriver(LogConfig(**GEO), 3, G, device="cpu",
                              timeout_cfg=TimeoutConfig(**TIMERS),
                              group_timer_lo=1, group_timer_hi=1)
    try:
        while td.leader() < 0:
            td.step()
        for _ in range(3):
            td.step()
        td.run(period=0.002)
        for g in range(G):
            t = td.read(lambda: "served", group=g, timeout=30)
            assert t.status == "ok" and t.value == "served"
            assert td.read_replica(g) in (td.leaders()[g],
                                          td.cluster.leases.holders()[g])
        t = td.read(lambda: 1, key=b"k1")
        assert t.status == "ok"
        with pytest.raises(ValueError, match="key= or group="):
            td.read(lambda: 1)
        assert td.can_serve_read(0)
    finally:
        td.stop()


def test_sharded_driver_unsupported_surfaces_raise():
    td = ShardedClusterDriver(LogConfig(**GEO), 3, 2, device="cpu",
                              timeout_cfg=TimeoutConfig(**TIMERS))
    try:
        for call in (lambda: td.request_membership(0b11),
                     lambda: td.recover_replica(1),
                     lambda: td.reset_app(1),
                     lambda: td.checkpoint_app(1)):
            with pytest.raises(NotImplementedError):
                call()
        # ported since: health() and the repair wiring
        # (tests/test_torch_alerts.py, tests/test_torch_repair.py)
        assert td.health()["leaders"] == td.leaders()
        # ported since: the elastic-topology cutover hook (wired into the
        # engine; with nothing in flight it fails nothing)
        assert td.cluster._on_topology_cutover == td._on_topology_cutover
        td._on_topology_cutover([0], [1])
        assert td.obs.metrics.get("inflight_failed_total", replica=0) == 0
    finally:
        td.stop()
    with pytest.raises(ValueError, match="audit=True"):
        ShardedClusterDriver(LogConfig(**GEO), 3, 2, device="cpu",
                             repair=True)
    # ported since: the mesh engine, which takes a device list
    # (tests/test_torch_mesh.py drives it)
    with pytest.raises(ValueError, match="device list"):
        ShardedClusterDriver(LogConfig(**GEO), 3, 2, device="cpu",
                             mesh=(2, 3))
    md = ShardedClusterDriver(LogConfig(**GEO), 3, 2, device=["cpu"] * 6,
                              mesh=(2, 3),
                              timeout_cfg=TimeoutConfig(**TIMERS))
    try:
        md.step()
        assert md.health()["engine"] == "spmd-group"
        assert md.health()["mesh"]["devices"] == ["cpu"] * 6
    finally:
        md.stop()
    assert not any(t.is_alive() for t in md.cluster.world._threads)
    with pytest.raises(ValueError, match="link_models"):
        ShardedClusterDriver(LogConfig(**GEO), 3, 2, device="cpu",
                             link_model=object())
