"""Port parity of the spmd engine: ``SimCluster(mode="spmd")`` on a
device list (``["cpu"] * R`` here) against the JAX package's
``mode="spmd"`` engine on conftest's virtual CPU devices, with exact
equality (the state is all i32/u32) — the twins of ``tests/test_spmd.py``
and ``tests/test_rebase.py``'s sharded-state rollover, the seeded
workloads of ``tests/test_torch_sim.py`` run in spmd mode (elections,
partitions, bursts, the scan tier, a wedge, rollovers, audit and
telemetry), and the device-list machinery itself: the layout and its
loud checks, the world's seams, a raising or absent entry, and the
launch counts under threads."""

import sys
import time

import numpy as np
import pytest
import torch

from rdma_paxos_tpu.config import LogConfig as JCfg
from rdma_paxos_tpu.runtime.sim import SimCluster as JSim
from rdma_paxos_tpu.runtime.sim import cap_scan_tiers as jcap_scan_tiers
from rdma_paxos_tpu_torch.config import LogConfig
from rdma_paxos_tpu_torch.consensus.state import Role
from rdma_paxos_tpu_torch.ops import quorum
from rdma_paxos_tpu_torch.parallel.mesh import (
    REPLICA_AXIS, DeviceWorld, make_replica_mesh)
from rdma_paxos_tpu_torch.runtime.sim import SimCluster, cap_scan_tiers
from tests.test_rebase import CFG as REBASE_GEO, drain
from tests.test_torch_sim import (  # noqa: F401
    assert_engines_equal, jax_step_cache_restored, run_workload)

torch.set_num_threads(1)

# tests/test_spmd.py's geometry
GEO = dict(n_slots=64, slot_bytes=32, window_slots=16, batch_slots=8)


def machine_cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


@pytest.fixture
def pair():
    """``make(R, **kw)`` -> (the JAX spmd engine, the port's on
    ``["cpu"] * R``); the port engines' worker threads are joined at
    teardown."""
    made = []

    def make(R, geo=GEO, **kw):
        j = JSim(JCfg(**geo), R, mode="spmd", **kw)
        t = SimCluster(LogConfig(**geo), R, mode="spmd",
                       device=["cpu"] * R, **kw)
        made.append(t)
        return j, t
    yield make
    for t in made:
        t.close()


def both(j, t, fn):
    """``fn`` on both engines; their results equal on every column."""
    a, b = fn(j), fn(t)
    if isinstance(a, dict):
        for k in SimCluster.RES_KEYS:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k],
                                          err_msg=k)
    return b


# ---------------------------------------------------------------------------
# the layout and its checks
# ---------------------------------------------------------------------------

def test_layout_shape_describe_and_loud_checks():
    m = make_replica_mesh(3, ["cpu"] * 3)
    assert m.axis_names == (REPLICA_AXIS,) and m.shape == (3,)
    assert "[cpu, cpu, cpu] (1 distinct device(s))" in m.describe()
    assert make_replica_mesh(2, ["cpu"] * 5).shape == (2,)
    have = machine_cards()
    with pytest.raises(ValueError, match=f"need 3 devices, have {have}"):
        make_replica_mesh(3)
    with pytest.raises(ValueError, match="need 3 devices, have 2"):
        make_replica_mesh(3, ["cpu"] * 2)
    cfg = LogConfig(**GEO)
    if have < 3:
        # no device list: the machine's cards, and there are too few
        with pytest.raises(ValueError, match=f"need 3 devices, have {have}"):
            SimCluster(cfg, 3, mode="spmd")
    # one device is not a list: nothing is implied
    with pytest.raises(ValueError, match="device list"):
        SimCluster(cfg, 3, mode="spmd", device="cpu")
    if have == 0:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SimCluster(cfg, 3, mode="spmd", device=["cuda:0"] * 3)
    c = SimCluster(cfg, 3, mode="spmd", device=["cpu"] * 3)
    try:
        # one row per entry, each its own copy: never a stacked engine
        assert len(c.blocks) == 3
        assert {b.log.buf.shape for b in c.blocks} == {
            (1, cfg.n_slots, cfg.slot_words + 8)}
        assert len({b.log.buf.data_ptr() for b in c.blocks}) == 3
        assert c.state.log.buf.shape[0] == 3
        assert c.world.describe().startswith("device world: 3 layout")
    finally:
        c.close()
    with pytest.raises(ValueError, match="unknown mode"):
        SimCluster(cfg, 3, mode="mesh", device="cpu")


# ---------------------------------------------------------------------------
# tests/test_spmd.py
# ---------------------------------------------------------------------------

def test_spmd_replication_8_replicas(pair):
    j, t = pair(8)
    for c in (j, t):
        c.run_until_elected(0)
        c.submit(0, b"spmd!")
    res = both(j, t, lambda c: c.step())
    assert res["commit"][0] == 2
    res = both(j, t, lambda c: c.step())
    assert list(res["commit"]) == [2] * 8
    for r in range(8):
        assert [p for (_, _, _, p) in t.replayed[r]] == [b"spmd!"]
    assert_engines_equal(j, t, "8 replicas")
    # every entry steps once per protocol step: 5 seams on the election
    # step, 4 on each stable step (no vote gather)
    assert t.step_index == 3 and t.world.exchanges == 5 + 2 * 4


@pytest.mark.parametrize("fanout", ["gather", "psum"])
def test_psum_fanout_matches_gather_and_jax(pair, fanout):
    j, t = pair(5, fanout=fanout)
    for c in (j, t):
        c.run_until_elected(0)
    for i in range(6):
        for c in (j, t):
            c.submit(0, b"op-%d" % i)
        both(j, t, lambda c: c.step())
    both(j, t, lambda c: c.step(timeouts=[2]))
    for c in (j, t):
        c.submit(2, b"after-churn")
    for _ in range(3):
        res = both(j, t, lambda c: c.step())
    assert res["role"][2] == int(Role.LEADER)
    assert_engines_equal(j, t, fanout)
    assert [p for (_, _, _, p) in t.replayed[4]][-1] == b"after-churn"


def test_spmd_group3_with_learners(pair):
    j, t = pair(8, group_size=3)
    for c in (j, t):
        c.run_until_elected(1)
        c.submit(1, b"learn")
    both(j, t, lambda c: c.step())
    res = both(j, t, lambda c: c.step())
    assert list(res["end"]) == [2] * 8
    assert res["commit"][1] == 2
    assert_engines_equal(j, t, "learners")


def test_spmd_failover(pair):
    j, t = pair(8)
    for c in (j, t):
        c.run_until_elected(0)
        c.submit(0, b"pre")
    both(j, t, lambda c: c.step())
    both(j, t, lambda c: c.step())
    for c in (j, t):
        c.partition([[0], list(range(1, 8))])
    res = both(j, t, lambda c: c.step(timeouts=[3]))
    assert res["role"][3] == int(Role.LEADER)
    for c in (j, t):
        c.submit(3, b"post")
    res = both(j, t, lambda c: c.step())
    assert res["commit"][3] == 4
    assert_engines_equal(j, t, "failover")


def test_spmd_rebase_on_the_rows(pair):
    """tests/test_rebase.py's sharded-state rollover: each entry's row
    rolls over on its own device."""
    geo = dict(n_slots=REBASE_GEO.n_slots, slot_bytes=REBASE_GEO.slot_bytes,
               window_slots=REBASE_GEO.window_slots,
               batch_slots=REBASE_GEO.batch_slots,
               rebase_threshold=REBASE_GEO.rebase_threshold)
    j, t = pair(3, geo=geo)
    payloads = [b"s%05d" % i for i in range(700)]
    for c in (j, t):
        c.run_until_elected(0)
        drain(c, 0, payloads)
    assert t.rebases >= 1
    assert int(t.last["end"].max()) < geo["rebase_threshold"]
    for r in range(3):
        assert [p for (_, _, _, p) in t.replayed[r]] == payloads, r
    assert_engines_equal(j, t, "rebase")


# ---------------------------------------------------------------------------
# the seeded workloads of tests/test_torch_sim.py, in spmd mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,fanout,seed,kw", [
    (3, "gather", 0, dict(audit=True, telemetry=True)),
    (5, "gather", 1, dict(wedge=True, scan=True)),
    (3, "psum", 2, dict(rebase=300, steps=90)),
])
def test_seeded_workload_matches_jax_spmd(R, fanout, seed, kw):
    j, t = run_workload(R, fanout, seed, spmd=True, **kw)
    try:
        assert max(len(s) for s in t.replayed) > 60
        if kw.get("rebase"):
            assert t.rebases >= 1
        if kw.get("audit"):
            a, b = j.auditor.dump(), t.auditor.dump()
            a.pop("anchor", None), b.pop("anchor", None)
            assert repr(a) == repr(b)
            np.testing.assert_array_equal(np.asarray(j.device_counters),
                                          t.device_counters)
            # the range re-digest reads replica 1's row on its device
            lo, hi = int(t.last["head"][1]), int(t.last["commit"][1])
            assert t.redigest(1, lo, hi) == j.redigest(1, lo, hi) > 0
    finally:
        t.close()


def test_spmd_equals_the_stacked_engine_pipelined_and_txn():
    """Pipelined tickets (two in flight), the txn vote lane and the
    scan tier: the spmd engine equals the port's stacked engine step
    for step (the stacked engine's own JAX parity is
    tests/test_torch_sim.py's)."""
    cfg = LogConfig(n_slots=128, slot_bytes=128, window_slots=32,
                    batch_slots=16)
    a = SimCluster(cfg, 3, device="cpu", txn=True, scan=True)
    b = SimCluster(cfg, 3, mode="spmd", device=["cpu"] * 3, txn=True,
                   scan=True)
    try:
        for c in (a, b):
            c.run_until_elected(0)
        for i in range(12):
            for c in (a, b):
                for k in range(20):
                    c.submit(0, b"p%d-%d" % (i, k))
            if i % 3 == 0:
                ta = [a.begin_step(), a.begin_step()]
                tb = [b.begin_step(), b.begin_step()]
                ra = [a.finish(x) for x in ta][-1]
                rb = [b.finish(x) for x in tb][-1]
            elif i % 3 == 1:
                ra, rb = a.step_burst(), b.step_burst()
            else:
                idx = int(a.last["end"][0]) + a.rebased_total
                for c in (a, b):
                    c.set_txn_watch(idx, int(a.last["term"][0]))
                ra, rb = a.step(), b.step()
                np.testing.assert_array_equal(ra["txn_vote"],
                                              rb["txn_vote"])
            for k in SimCluster.RES_KEYS:
                np.testing.assert_array_equal(ra[k], rb[k], err_msg=k)
        assert b.scan_dispatches == a.scan_dispatches > 0
        assert b.max_inflight_dispatches == 2
        assert a.replayed == b.replayed
        sa, sb = a.state, b.state
        assert torch.equal(sa.log.buf, sb.log.buf)
    finally:
        b.close()


def test_state_view_is_read_only_and_assignment_places_rows():
    """``state`` is an assembled copy: a write into it raises at the
    next dispatch (it would be lost); ``cluster.state = ...`` and the
    blocks write the rows."""
    cfg = LogConfig(**GEO)
    c = SimCluster(cfg, 3, mode="spmd", device=["cpu"] * 3)
    try:
        c.run_until_elected(0)
        c.submit(0, b"x")
        c.step()
        c.state.log.buf[1, 1, 0] += 1
        with pytest.raises(RuntimeError, match="written in place"):
            c.step()
        # assignment places each row: the write lands in replica 1's
        st = c.state
        st.log.buf[1, 1, 0] += 7
        c.state = st
        assert int(c.blocks[1].log.buf[0, 1, 0]) == int(st.log.buf[1, 1, 0])
        c.blocks[2].log.buf[0, 1, 0] += 5
        assert int(c.state.log.buf[2, 1, 0]) == int(
            c.blocks[2].log.buf[0, 1, 0])
        c.step()
    finally:
        c.close()


def test_program_report_counts_every_entrys_ops():
    """``program_report`` on the spmd engine counts the ops its worker
    threads dispatch: about three times the stacked engine's."""
    from rdma_paxos_tpu_torch.obs.device import program_report
    cfg = LogConfig(**GEO)
    a = SimCluster(cfg, 3, device="cpu")
    b = SimCluster(cfg, 3, mode="spmd", device=["cpu"] * 3)
    try:
        ra, rb = (program_report(c, tiers=(2,)) for c in (a, b))
        assert rb["engine"] == "spmd" and ra["engine"] == "sim"
        for va, vb in zip(ra["variants"], rb["variants"]):
            assert va["variant"] == vb["variant"]
            assert 3 * va["ops"] <= vb["ops"] <= 4 * va["ops"], (va, vb)
    finally:
        b.close()


# ---------------------------------------------------------------------------
# the world: seams, a raising entry, an absent entry
# ---------------------------------------------------------------------------

def test_world_seams_gather_and_sum_in_rank_order():
    w = DeviceWorld(make_replica_mesh(3, ["cpu"] * 3), timeout=10)
    try:
        def job(ep, i):
            x = torch.full((1, 2), 10 * i + 1, dtype=torch.int32)
            (g,) = ep.all_gather([x])
            (s,) = ep.all_sum([x])
            return g, s
        for _ in range(3):           # the slot sets alternate
            out = w.run(job)
            for g, s in out:
                assert g.tolist() == [[1, 1], [11, 11], [21, 21]]
                assert s.tolist() == [[33, 33]] and s.dtype == torch.int32
        assert w.exchanges == 6
    finally:
        w.close()
    assert not any(t.is_alive() for t in w._threads)


def test_a_raising_entry_aborts_the_seam_and_reaches_the_caller():
    w = DeviceWorld(make_replica_mesh(3, ["cpu"] * 3), timeout=30)
    try:
        def job(ep, i):
            if i == 1:
                raise KeyError("entry 1 fails mid-step")
            ep.all_gather([torch.zeros(1, dtype=torch.int32)])
            ep.all_gather([torch.zeros(1, dtype=torch.int32)])
        t0 = time.perf_counter()
        with pytest.raises(KeyError, match="entry 1 fails"):
            w.run(job)
        # the peers left their barrier at once, not after the timeout
        assert time.perf_counter() - t0 < 10
        with pytest.raises(RuntimeError, match="broken"):
            w.run(lambda ep, i: None)
    finally:
        w.close()


def test_an_absent_entry_breaks_the_seam_within_its_timeout():
    w = DeviceWorld(make_replica_mesh(2, ["cpu"] * 2), timeout=0.5)
    try:
        def job(ep, i):
            if i == 0:
                ep.all_gather([torch.zeros(1, dtype=torch.int32)])
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="barrier broke"):
            w.run(job)
        assert time.perf_counter() - t0 < 5
    finally:
        w.close()


def test_launch_counts_stay_exact_under_threads(monkeypatch):
    """R threads counting launches at once lose none (the counters are
    read-modify-writes under a lock). The kernel is stubbed; meta
    tensors take the wrapper's non-CPU path."""
    monkeypatch.setattr(quorum, "_check_window", lambda *a: None)
    monkeypatch.setattr(quorum, "commit_window_cuda",
                        lambda *a, **k: (None, None))
    monkeypatch.setattr(quorum.commit_window, "launches", 0)
    meta = torch.empty(1, 8, 8, device="meta")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        w = DeviceWorld(make_replica_mesh(3, ["cpu"] * 3))
        try:
            w.run(lambda ep, i: [quorum.commit_window(meta, None, None, w=1)
                                 for _ in range(3000)])
        finally:
            w.close()
    finally:
        sys.setswitchinterval(old)
    assert quorum.commit_window.launches == 9000


# ---------------------------------------------------------------------------
# cap_scan_tiers (the JAX engine module's surface)
# ---------------------------------------------------------------------------

def test_cap_scan_tiers_matches_jax():
    j = JSim(JCfg(**GEO), 3)
    t = SimCluster(LogConfig(**GEO), 3, device="cpu")
    for K in (2, 4, 5, 16, 64):
        for c, cap in ((j, jcap_scan_tiers), (t, cap_scan_tiers)):
            c.K_TIERS = SimCluster.K_TIERS
            cap(c, K)
        assert tuple(t.K_TIERS) == tuple(j.K_TIERS), K
    for c, cap in ((j, jcap_scan_tiers), (t, cap_scan_tiers)):
        with pytest.raises(ValueError, match="K must be >= 2"):
            cap(c, 1)
    # a capped engine picks its bursts from the capped ladder
    for c in (j, t):
        c.K_TIERS = SimCluster.K_TIERS
    for c, cap in ((j, jcap_scan_tiers), (t, cap_scan_tiers)):
        cap(c, 4)
        c.run_until_elected(0)
        for i in range(40):
            c.submit(0, b"k%d" % i)
    both(j, t, lambda c: c.step_burst())
    assert_engines_equal(j, t, "capped burst")
