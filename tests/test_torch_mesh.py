"""Port parity of the mesh engine: ``ShardedCluster(mesh=(gs, R))`` on a
CPU device list against the JAX package's ``mesh=`` engine (conftest's
virtual CPU devices) and its single-device ``vmap`` engine, with exact
equality (the state is all i32/u32) — the twins of
``tests/test_mesh.py``:

* the layout: shape, axis names, the listing with its repeats, and the
  loud checks (too few devices, axis names, replica-axis width, group
  divisibility, one device where a list is due);
* G = 1 × R = 3 against ``SimCluster`` and the JAX mesh engine;
* 4×2 serial steps and 2×4 with a burst against the JAX mesh engine,
  through elections, a group leader's crash (partition and failover)
  and the heal;
* one program per variant for any G on one layout;
* the two-device smoke;
* the sharded driver on the mesh engine: step-locked against the JAX
  mesh driver, and the pipelined loop acking every event once, in
  order, with the same committed streams as on the stacked engine;
* ``tests/test_torch_shard.py``'s seeded G = 4 drive (bursts, scans,
  pipelined tickets, rollovers, a wedge, audit and telemetry) with the
  port on a 2×3 layout, against JAX and per-group ``SimCluster`` twins;
* ``drain()`` of pipelined tickets, against JAX."""

import numpy as np
import pytest
import torch

from rdma_paxos_tpu.config import LogConfig as JCfg
from rdma_paxos_tpu.shard import ShardedCluster as JSharded
from rdma_paxos_tpu_torch.config import LogConfig
from rdma_paxos_tpu_torch.parallel import mesh as tmesh
from rdma_paxos_tpu_torch.parallel.mesh import (
    GROUP_AXIS, REPLICA_AXIS, DeviceLayout, build_mesh_2d, group_sharding)
from rdma_paxos_tpu_torch.runtime.sim import SimCluster
from rdma_paxos_tpu_torch.shard import ShardedCluster
from tests.test_mesh import _drive_pair, _recorded_workload
from tests.test_torch_shard import _dumps, run_groups, writable_rebase
from tests.test_torch_sharded_driver import (
    pipelined_loop, step_locked_parity)
from tests.test_torch_sim import jax_step_cache_restored  # noqa: F401

torch.set_num_threads(1)

# tests/test_mesh.py's geometry
GEO = dict(n_slots=128, slot_bytes=128, window_slots=32, batch_slots=16)
SMALL = dict(n_slots=64, slot_bytes=64, window_slots=16, batch_slots=8)
STEP_KEYS = SimCluster.RES_KEYS


def cpus(n):
    return ["cpu"] * n


@pytest.fixture
def engines():
    """``add(cluster)`` registers a port engine whose worker threads are
    joined at teardown."""
    made = []
    yield lambda c: made.append(c) or c
    for c in made:
        c.close()


# ---------------------------------------------------------------------------
# the layout and its checks
# ---------------------------------------------------------------------------

def test_build_mesh_2d_shape_axis_names_and_listing():
    m = build_mesh_2d(2, 3, cpus(6))
    assert m.axis_names == (GROUP_AXIS, REPLICA_AXIS)
    assert m.shape == (2, 3)
    assert "over [cpu, cpu, cpu, cpu, cpu, cpu] (1 distinct" in m.describe()
    sh = group_sharding(m)
    t = torch.arange(4 * 3 * 2).reshape(4, 3, 2)
    blocks = sh.split(t)
    assert [b.shape for b in blocks] == [(2, 1, 2)] * 6
    assert torch.equal(blocks[4], t[2:4, 1:2])        # shard 1, replica 1
    assert torch.equal(sh.join(blocks, device="cpu"), t)
    k = torch.arange(5 * 4 * 3).reshape(5, 4, 3)      # a K axis in front
    assert torch.equal(sh.join(sh.split(k, 1), 1, device="cpu"), k)


def test_mesh_validation_is_loud():
    cfg = LogConfig(**GEO)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="need 24 devices for a 8x3 mesh, "
                                         "have 8"):
        build_mesh_2d(8, 3, cpus(8))
    if have < 6:
        with pytest.raises(ValueError, match=f"need 6 devices for a 2x3 "
                                             f"mesh, have {have}"):
            ShardedCluster(cfg, 3, 2, mesh=(2, 3))
    with pytest.raises(ValueError, match="replica axis"):
        ShardedCluster(cfg, 3, 2, mesh=(2, 2), device=cpus(4))
    with pytest.raises(ValueError, match="divide"):
        ShardedCluster(cfg, 2, 3, mesh=(2, 2), device=cpus(4))
    arr = np.empty(4, dtype=object)
    arr[:] = [torch.device("cpu")] * 4
    bad = DeviceLayout(arr.reshape(2, 2), ("a", "b"))
    with pytest.raises(ValueError, match="mesh axes"):
        ShardedCluster(cfg, 2, 2, mesh=bad)
    with pytest.raises(ValueError, match="device list"):
        ShardedCluster(cfg, 2, 2, mesh=(1, 2), device="cpu")
    # a prebuilt layout is used as it is
    sc = ShardedCluster(cfg, 2, 2, mesh=build_mesh_2d(1, 2, cpus(2)))
    try:
        assert sc.health()["mesh"] == dict(layout="1x2", group_shards=1,
                                           devices=["cpu", "cpu"])
        assert sc.health()["engine"] == "spmd-group"
    finally:
        sc.close()


# ---------------------------------------------------------------------------
# G = 1 × R = 3 ≡ SimCluster ≡ the JAX mesh engine
# ---------------------------------------------------------------------------

def test_mesh_g1_r3_bit_identical_to_simcluster_and_jax(engines):
    sim = SimCluster(LogConfig(**GEO), 3, device="cpu")
    sh = engines(ShardedCluster(LogConfig(**GEO), 3, 1, mesh=(1, 3),
                                device=cpus(3)))
    jsh = JSharded(JCfg(**GEO), 3, 1, mesh=(1, 3))
    for ev, tmo in _recorded_workload():
        for e in ev:
            if e[0] == "sub":
                sim.submit(e[1], e[2])
                for c in (sh, jsh):
                    c.submit(0, e[1], e[2])
            elif e[0] == "part":
                sim.partition(e[1])
                for c in (sh, jsh):
                    c.partition(0, e[1])
            else:
                sim.heal()
                for c in (sh, jsh):
                    c.heal()
        a = sim.step(timeouts=tmo)
        b = sh.step(timeouts={0: tmo} if tmo else ())
        c = jsh.step(timeouts={0: tmo} if tmo else ())
        for k in STEP_KEYS:
            assert np.array_equal(a[k], b[k][0]), k
            assert np.array_equal(np.asarray(c[k]), b[k]), k
    assert sim.replayed == sh.replayed[0] == jsh.replayed[0]
    assert (sim.applied == sh.applied[0]).all()
    assert sim.leader() == sh.leader(0) == jsh.leader(0)


# ---------------------------------------------------------------------------
# G × R mesh ≡ the JAX mesh engine, with a leader crash and the heal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G,R,burst", [(4, 2, False), (2, 4, True)])
def test_mesh_bit_identical_to_the_jax_mesh(engines, G, R, burst):
    a = JSharded(JCfg(**GEO), R, G, mesh=(G, R))
    b = engines(ShardedCluster(LogConfig(**GEO), R, G, mesh=(G, R),
                               device=cpus(G * R)))
    _drive_pair(a, b, G, R, burst=burst)
    # one step of every entry per protocol step, none skipped
    assert len(b.blocks) == G * R
    assert b.world.exchanges > 0


# ---------------------------------------------------------------------------
# one program per variant for any G on one layout
# ---------------------------------------------------------------------------

def test_mesh_one_program_per_variant_for_any_group_count(engines):
    cfg = LogConfig(**SMALL)
    layout = build_mesh_2d(2, 2, cpus(4))
    sc = engines(ShardedCluster(cfg, 2, 2, mesh=layout,
                                stable_fast_path=False))
    for g in range(2):
        sc.run_until_elected(g, g % 2)
        for i in range(4):
            sc.submit(g, sc.leader(g), b"v%d" % i)
    for _ in range(3):
        sc.step()
    assert all(sc.last["commit"][g].max() >= 4 for g in range(2))
    assert len(sc.programs_used) == 1, sc.programs_used
    (key,) = sc.programs_used
    assert "spmd-group" in key and layout.key in key
    programs = dict(tmesh.PROGRAMS)
    # G = 4 on the same layout: the same program, no new one
    sc2 = engines(ShardedCluster(cfg, 2, 4, mesh=layout,
                                 stable_fast_path=False))
    for g in range(4):
        sc2.run_until_elected(g, g % 2)
    sc2.step()
    assert sc2.programs_used == sc.programs_used
    assert sc2._steps[True].func is sc._steps[True].func
    assert all(tmesh.PROGRAMS.get(k) is v for k, v in programs.items())
    # the stacked engine on the same shapes has its own, disjoint key
    sc3 = ShardedCluster(cfg, 2, 2, stable_fast_path=False, device="cpu")
    sc3.step()
    assert sc3.programs_used and not (sc3.programs_used
                                      & sc.programs_used)


# ---------------------------------------------------------------------------
# the two-device smoke
# ---------------------------------------------------------------------------

def test_mesh_two_device_smoke(engines):
    cfg = LogConfig(**SMALL)
    sc = engines(ShardedCluster(cfg, 2, 2, mesh=(1, 2), device=cpus(2)))
    jsc = JSharded(JCfg(**SMALL), 2, 2, mesh=(1, 2))
    assert sc.mesh.shape == (1, 2)
    for c in (sc, jsc):
        for g in range(2):
            c.run_until_elected(g, g % 2)
            for i in range(6):
                c.submit(g, c.leader(g), b"s%d-%d" % (g, i))
    d0 = sc.dispatches
    res, jres = sc.step_burst(), jsc.step_burst()
    assert sc.dispatches == d0 + 1
    for _ in range(2):
        res, jres = sc.step(), jsc.step()
    for k in STEP_KEYS:
        assert np.array_equal(np.asarray(jres[k]), res[k]), k
    for g in range(2):
        assert res["commit"][g].max() >= 6
        got = [p for (_t, _c, _r, p) in sc.replayed[g][0]]
        assert got == [b"s%d-%d" % (g, i) for i in range(6)]


# ---------------------------------------------------------------------------
# the sharded driver on the mesh engine
# ---------------------------------------------------------------------------

def test_sharded_driver_step_locked_on_the_mesh():
    step_locked_parity(mesh=(2, 3))


def test_sharded_driver_loop_on_the_mesh_acks_like_the_stacked_engine():
    assert pipelined_loop(mesh=(2, 3)) == pipelined_loop()


# ---------------------------------------------------------------------------
# the seeded G = 4 drive, the port on a 2×3 layout
# ---------------------------------------------------------------------------

def test_seeded_groups_on_a_2x3_layout_match_jax_and_twins():
    j, t, twins, kinds = run_groups(3, mesh=(2, 3), audit=True,
                                    telemetry=True, scan=True)
    try:
        assert {("step", 1), ("burst", 1), ("burst", 2)} <= kinds, kinds
        assert {k for k, _ in kinds} >= {"scan"}, kinds
        assert t.rebases.sum() >= 1, t.rebases
        assert _dumps(t.auditor.dump()) == _dumps(j.auditor.dump())
        assert _dumps(t.flight.dump()) == _dumps(j.flight.dump())
        np.testing.assert_array_equal(t.device_counters,
                                      np.asarray(j.device_counters))
        # the range re-digest reads group 2's replica 0 on its entry
        g, r = 2, 0
        lo, hi = int(t.last["head"][g, r]), int(t.last["commit"][g, r])
        assert t.redigest(g, r, lo, hi) == j.redigest(g, r, lo, hi) > 0
        assert _dumps(t.auditor.dump()) == _dumps(j.auditor.dump())
    finally:
        t.close()


# ---------------------------------------------------------------------------
# drain()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", [None, (2, 3)])
def test_drain_finishes_pipelined_tickets_like_jax(engines, mesh):
    cfg = dict(SMALL, slot_bytes=32)
    j = writable_rebase(JSharded(JCfg(**cfg), 3, 2, mesh=mesh))
    t = engines(ShardedCluster(
        LogConfig(**cfg), 3, 2, mesh=mesh,
        device="cpu" if mesh is None else cpus(6)))
    for c in (j, t):
        c.place_leaders()
        assert c.drain() is None             # nothing in flight
        for i in range(3):
            for g in range(2):
                c.submit(g, c.leader(g), b"d%d-%d" % (g, i))
            c.begin_step()
    rj, rt = j.drain(), t.drain()
    assert not t._tickets and t.inflight_dispatches == 0
    assert t.max_inflight_dispatches == j.max_inflight_dispatches == 3
    for k in STEP_KEYS:
        assert np.array_equal(np.asarray(rj[k]), rt[k]), k
    assert t.replayed == j.replayed
