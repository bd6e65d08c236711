"""Kernel checks that need the card: each CUDA kernel of the port against
its plain PyTorch version, on the card. Marked ``gpu``; each test
decides at run time and skips without a CUDA device. On the card
(which has no JAX, so tests/conftest.py is skipped):
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.parametrize("N,W", [(3, 16), (13, 128), (192, 2048)])
def test_commit_scan_kernel_equals_plain(N, W):
    _need_card()
    from rdma_paxos_tpu_torch.ops.quorum import (
        R_PAD, commit_scan, commit_scan_cuda, commit_scan_ref)
    rng = np.random.default_rng(N * W)
    commit = rng.integers(0, 1000, N)
    ends = np.zeros((N, R_PAD), np.int64)
    ends[:, :13] = commit[:, None] + rng.integers(-3, W + 4, (N, 13))
    ends[:, :13] *= rng.random((N, 13)) < 0.9
    bm = rng.integers(0, 1 << 13, (N, 2))
    bm[:, 1] |= (rng.random(N) < 0.3) << 31
    scal = np.stack([commit, rng.integers(1, 3, N),
                     commit + rng.integers(0, W + 4, N), bm[:, 0], bm[:, 1],
                     rng.integers(0, 2, N), np.full(N, 2), np.full(N, 3)], 1)
    dev = torch.device("cuda")

    def t(a):
        return torch.from_numpy((np.asarray(a) & 0xFFFFFFFF).astype(
            np.uint32).view(np.int32)).to(dev)
    e, tm, s = t(ends), t(rng.integers(0, 3, (N, W))), t(scal)
    want = commit_scan_ref(e, tm, s)
    assert torch.equal(commit_scan_cuda(e, tm, s), want)
    before = commit_scan.launches
    assert torch.equal(commit_scan(e, tm, s), want)
    assert commit_scan.launches == before + 1
    torch.cuda.synchronize()


@pytest.mark.parametrize("G,R,W", [(1, 3, 2048), (1, 13, 128), (64, 3, 2048)])
def test_commit_window_kernel_equals_plain(G, R, W):
    """N = G x R instances in {3, 13, 192}, on the seeded rings of
    ``chip_smoke.py`` (main-path width: 2048-row window, 8192 slots)."""
    _need_card()
    from chip_smoke import window_case
    from rdma_paxos_tpu_torch.ops.quorum import (
        commit_window, commit_window_cuda, commit_window_ref)
    rng = np.random.default_rng(G * R * W)
    args, kw = window_case(rng, torch.device("cuda"), G=G, R=R, W=W,
                           n_slots=4 * W)
    want = commit_window_ref(*args, w=W, **kw)
    got = commit_window_cuda(*args, w=W, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    before = commit_window.launches
    got = commit_window(*args, w=W, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert commit_window.launches == before + 1
    torch.cuda.synchronize()


def test_front_door_pipelined_driver_on_the_card():
    """Phase (6a) of ``chip_smoke.py`` at a small size: a pre-queued
    record through the pipelined driver on the card acks every event
    once, commits the CPU serial run's stream, overlaps dispatches and
    launches the commit-window kernel once per protocol step."""
    _need_card()
    from chip_smoke import drive_front_door, front_record
    geom = dict(n_slots=1024, slot_bytes=128, window_slots=256,
                batch_slots=256)
    payloads = front_record(3000, 100)
    gpu = drive_front_door(torch.device("cuda", 0), geom, "psum", payloads,
                           4, 2)
    cpu = drive_front_door(torch.device("cpu"), geom, "psum", payloads, 4, 0)
    for run in (gpu, cpu):
        assert run["statuses"] == [0] * len(payloads)
        assert (run["fired"] == 1).all()
    assert gpu["streams"] == cpu["streams"]
    assert [p for (t, _c, _q, p) in gpu["streams"][0] if t == 3] == payloads
    assert gpu["max_inflight"] >= 2
    assert gpu["launches"] == gpu["steps"] > 0


def test_sanitized_pipelined_driver_on_the_card(monkeypatch):
    """Phase (17b) of ``chip_smoke.py`` at a small size: under
    ``RP_SANITIZE=1`` the pipelined driver on the card runs its engine
    sanitized, acks every event once, commits the CPU twin's streams,
    overlaps dispatches, launches the commit-window kernel once per
    protocol step, and an off-lock write of a guarded field raises."""
    _need_card()
    from chip_smoke import (
        drive_front_door, front_record, offlock_write_raises)
    monkeypatch.setenv("RP_SANITIZE", "1")
    geom = dict(n_slots=1024, slot_bytes=128, window_slots=256,
                batch_slots=256)
    payloads = front_record(3000, 100)
    gpu = drive_front_door(torch.device("cuda", 0), geom, "psum", payloads,
                           4, 2, probe=offlock_write_raises)
    cpu = drive_front_door(torch.device("cpu"), geom, "psum", payloads, 4,
                           0, probe=offlock_write_raises)
    for run in (gpu, cpu):
        assert run["engine"] == "SimCluster+sanitized"
        assert run["probe"] is True
        assert run["statuses"] == [0] * len(payloads)
        assert (run["fired"] == 1).all()
    assert gpu["streams"] == cpu["streams"]
    assert gpu["max_inflight"] >= 2
    assert gpu["launches"] == gpu["steps"] > 0


def test_snapshot_recovery_on_the_card():
    """Phase (7a) of ``chip_smoke.py`` at a small size: a laggard pruned
    past the ring and a fresh learner recover by snapshot install on the
    card, with replica state and replay streams bit-equal to the CPU run
    at every mark and one commit-window launch per protocol step."""
    _need_card()
    from chip_smoke import drive_recovery
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    geom = dict(n_slots=1024, slot_bytes=128, window_slots=256,
                batch_slots=256)
    w0, s0 = commit_window.launches, commit_scan.launches
    gpu = drive_recovery(torch.device("cuda", 0), geom, "gather", 3000, True)
    assert commit_window.launches - w0 == gpu["steps"] > 0
    assert commit_scan.launches == s0
    cpu = drive_recovery(torch.device("cpu"), geom, "gather", 3000, True)
    assert gpu["pruned"] and gpu["catch_up"] == cpu["catch_up"]
    assert gpu["marks"] == cpu["marks"]


def test_audit_and_telemetry_on_the_card():
    """Phases (8a) and (8b) of ``chip_smoke.py``: the audited engine with
    telemetry at geometry (a) gives the CPU run's ledger, flight ring and
    device counters; a corrupted word is found at its index, the
    corrupted donor refused and the healthy one installed, as on the
    CPU."""
    _need_card()
    from chip_smoke import drive_audited, drive_corruption
    gpu, cpu = (drive_audited(torch.device(d)) for d in ("cuda", "cpu"))
    for k in ("steps", "dump", "summary", "flight"):
        assert gpu[k] == cpu[k], k
    assert np.array_equal(gpu["counters"], cpu["counters"])
    assert gpu["summary"]["findings"] == 0
    gpu, cpu = (drive_corruption(torch.device(d)) for d in ("cuda", "cpu"))
    for k in ("steps", "found_in", "first", "catch_up", "redigested",
              "chains", "dump", "state"):
        assert gpu[k] == cpu[k], k


def test_group_step_on_the_card():
    """One G = 4 group step on the card (leaders placed, per-group
    traffic) equals its CPU run, results and state, and launches
    ``commit_window`` exactly once, over the 12 instances."""
    _need_card()
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.convert import replica_state_to_numpy
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.shard import ShardedCluster
    cfg = LogConfig(n_slots=64, slot_bytes=32, window_slots=16,
                    batch_slots=8)
    runs = {}
    for dev in ("cpu", "cuda"):
        c = ShardedCluster(cfg, 3, 4, device=dev)
        c.place_leaders()
        rng = np.random.default_rng(3)
        for g in range(4):
            for _ in range(int(rng.integers(1, 9))):
                c.submit(g, c.leader_hint(g), bytes(
                    rng.integers(0, 256, 20, dtype=np.uint8)))
        before = commit_window.launches
        res = c.step()
        launched = commit_window.launches - before
        runs[dev] = (res, replica_state_to_numpy(c.state), launched,
                     [[list(s) for s in row] for row in c.replayed])
    (cres, cst, _, crep), (gres, gst, launched, grep) = (
        runs["cpu"], runs["cuda"])
    assert launched == 1
    for k in cres:
        assert np.array_equal(cres[k], gres[k]), k
    for k in cst:
        assert np.array_equal(cst[k], gst[k]), k
    assert crep == grep


def test_scalar_host_plane_on_the_card():
    """``SimCluster`` on the card with the scalar host data plane
    (``set_vectorized(False)``): replay streams, frames and apply
    cursors equal the vectorized plane's on the card and the CPU run's,
    with one ``commit_window`` launch per protocol step."""
    _need_card()
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.runtime import hostpath
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    cfg = LogConfig(n_slots=256, slot_bytes=64, window_slots=32,
                    batch_slots=16)

    def run(dev, vec):
        prev = hostpath.set_vectorized(vec)
        try:
            c = SimCluster(cfg, 3, device=dev)
            c.collect_frames = True
            c.run_until_elected(0)
            rng = np.random.default_rng(8)
            before, steps = commit_window.launches, c.step_index
            for i in range(10):
                for _ in range(int(rng.integers(1, 24))):
                    c.submit(0, bytes(rng.integers(
                        0, 256, int(rng.integers(0, 65)), dtype=np.uint8)),
                        conn=int(rng.integers(1, 5)))
                (c.step_burst if i % 3 else c.step)()
            return ([list(s) for s in c.replayed],
                    [list(f) for f in c.frames], c.applied.tolist(),
                    commit_window.launches - before, c.step_index - steps)
        finally:
            hostpath.set_vectorized(prev)
    off, on, cpu = run("cuda", False), run("cuda", True), run("cpu", False)
    assert off[:3] == on[:3] == cpu[:3]
    assert off[3] == off[4] and on[3] == on[4]
    assert sum(map(len, off[0])) > 0


def test_vote_lane_on_the_card():
    """The ``txn=`` lane on the card: G = 4 groups with every group's
    watch armed on a committed entry (PREPARED), a wrong term
    (CONFLICT) and a future index (PENDING); every step's ``[G, R]``
    votes and results and the state equal the CPU run, with one
    ``commit_window`` launch per step."""
    _need_card()
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.convert import replica_state_to_numpy
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.shard import ShardedCluster
    cfg = LogConfig(n_slots=64, slot_bytes=128, window_slots=16,
                    batch_slots=8)
    runs = {}
    for dev in ("cpu", "cuda"):
        c = ShardedCluster(cfg, 3, 4, txn=True, device=dev)
        c.place_leaders()
        term = [int(c.last["term"][g].max()) for g in range(4)]
        end = [int(c.last["end"][g].max()) for g in range(4)]
        for g, (idx, t) in enumerate([(end[0] - 1, term[0]),
                                      (end[1] - 1, term[1] + 1),
                                      (end[2] + 5, term[2])]):
            c.set_txn_watch(g, idx, t)
        before = commit_window.launches
        out = [c.step(), c.step()]
        launched = commit_window.launches - before
        runs[dev] = ([{k: v.tolist() for k, v in r.items()} for r in out],
                     replica_state_to_numpy(c.state), launched)
    (cres, cst, _), (gres, gst, launched) = runs["cpu"], runs["cuda"]
    assert launched == 2
    assert gres == cres
    for k in cst:
        assert np.array_equal(cst[k], gst[k]), k
    assert gres[-1]["txn_vote"] == [[2] * 3, [3] * 3, [1] * 3, [0] * 3]


def _repair_drill(dev):
    """An audited ``SimCluster`` with a repair controller: a follower's
    committed slot flipped, then stepped (observe, drive) until it is
    healed; returns the step outputs, the controller's status, the
    ledger dump and the launches per step."""
    import json
    from rdma_paxos_tpu_torch.chaos.faults import corrupt_slot
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.runtime.repair import RepairController
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    cfg = LogConfig(n_slots=64, slot_bytes=32, window_slots=16,
                    batch_slots=8)
    c = SimCluster(cfg, 3, audit=True, device=dev)
    ctl = RepairController(c, probation_steps=3)
    before = commit_window.launches
    c.run_until_elected(0)
    for i in range(8):
        c.submit(0, b"v%d" % i)
    out = []
    for i in range(40):
        if i == 4:
            corrupt_slot(c, 2, int(c.last["commit"].min()) - 1)
        c.submit(0, b"w%d" % i)
        res = c.step()
        ctl.observe()
        if ctl.needs_drain():
            ctl.drive()
        out.append({k: v.tolist() for k, v in res.items()})
        if ctl.repairs_done and not ctl.states:
            break
    dump = {k: v for k, v in c.auditor.dump().items() if k != "anchor"}
    return (out, ctl.status(), json.dumps(dump, sort_keys=True,
                                          default=str),
            commit_window.launches - before, c.step_index)


def test_repair_drill_on_the_card():
    """The repair loop on the card equals its CPU twin: every step's
    outputs, the controller's status (quarantine, install, backfill,
    re-admission) and the ledger, with one ``commit_window`` launch per
    protocol step."""
    _need_card()
    cres, cst, cled, _, _ = _repair_drill("cpu")
    gres, gst, gled, launched, steps = _repair_drill("cuda")
    assert launched == steps
    assert gres == cres and gst == cst and gled == cled
    assert gst["repairs_done"] == 1 and gst["active"] == {}


def test_governed_run_on_the_card():
    """A governed ``SimCluster`` on the card under a seeded bursty
    arrival trace equals its CPU twin: decisions, outputs and status,
    with one ``commit_window`` launch per protocol step."""
    _need_card()
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.runtime.governor import attach_governor
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    cfg = LogConfig(n_slots=512, slot_bytes=128, window_slots=64,
                    batch_slots=16)
    rng = np.random.default_rng(21)
    loads = ([int(v) for v in rng.integers(0, 4, 10)]
             + [int(v) for v in rng.integers(40, 96, 10)]
             + [int(v) for v in rng.integers(0, 4, 10)])
    runs = {}
    for dev in ("cpu", "cuda"):
        c = SimCluster(cfg, 3, device=dev)
        c.run_until_elected(0)
        gov = attach_governor(c, obs=None)
        before, s0 = commit_window.launches, c.step_index
        log = []
        for n in loads:
            if n:
                c.submit_many(0, [(3, 1, 0, b"g" * 24)] * n)
            d = gov.decision
            res = (c.step_burst(max_k=d.max_k)
                   if d.max_k > 1 and max(len(q) for q in c.pending)
                   else c.step())
            log.append((tuple(gov.decision),
                        {k: v.tolist() for k, v in res.items()}))
        runs[dev] = (log, gov.status(), commit_window.launches - before,
                     c.step_index - s0)
    (clog, cst, _, _), (glog, gst, launched, steps) = (runs["cpu"],
                                                       runs["cuda"])
    assert launched == steps
    assert glog == clog and gst == cst
    assert max(d[1] for d, _ in glog) > 1


def _streams_run(dev):
    """A hub on a ``SimCluster`` at a small geometry: committed puts, a
    whole-range watch, a scan served while the engine steps, and the
    table walk."""
    import threading

    from rdma_paxos_tpu_torch import streams
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.models.replicated_kvs import ReplicatedKVS
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.runtime import reads
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    c = SimCluster(LogConfig(n_slots=128, slot_bytes=128, window_slots=32,
                             batch_slots=16), 3, device=dev)
    reads.attach(c)
    hub = streams.attach(c)
    before, s0 = commit_window.launches, c.step_index
    c.run_until_elected(0)
    kv = ReplicatedKVS(c, cap=256)
    hub.kvs = kv
    sub = hub.subscribe(0)
    for i in range(12):
        kv.put(0, b"k%02d" % i, b"v%d" % i, client_id=9, req_id=i + 1)
        c.step()
    box = {}
    th = threading.Thread(target=lambda: box.setdefault(
        "rows", hub.scan_all(prefix=b"k", limit=5)))
    th.start()
    for _ in range(200):
        c.step()
        if not th.is_alive():
            break
    th.join(10)
    assert hub.watch.wait_caught_up({0: hub.tails[0].length()})
    evs = [(e.term, e.index, e.pos, e.key, e.val) for e in sub.poll(64)]
    hub.fail_all("test done")
    return (box["rows"], evs, kv.items_in_range(0, b"", None),
            commit_window.launches - before, c.step_index - s0)


def test_streams_on_the_card():
    """A streams hub on the card equals its CPU twin: the scan's rows,
    the watch's events and the table walk, with one ``commit_window``
    launch per protocol step."""
    _need_card()
    crows, cevs, citems, _, _ = _streams_run("cpu")
    grows, gevs, gitems, launched, steps = _streams_run("cuda")
    assert launched == steps
    assert (grows, gevs, gitems) == (crows, cevs, citems)
    assert len(grows) == 12 and len(gevs) == 12


def _topology_run(dev):
    """A split then a merge of a live range on a ``ShardedKVS`` at
    G = 2 with leases attached."""
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.runtime import reads
    from rdma_paxos_tpu_torch.shard import ShardedCluster
    from rdma_paxos_tpu_torch.shard.kvs import ShardedKVS
    from rdma_paxos_tpu_torch.shard.router import RangeRule
    from rdma_paxos_tpu_torch.topology import attach_topology
    from rdma_paxos_tpu_torch.txn.chaos import keys_for_groups
    sc = ShardedCluster(LogConfig(n_slots=256, slot_bytes=128,
                                  window_slots=32, batch_slots=8), 3, 2,
                        device=dev)
    kv = ShardedKVS(sc, cap=256)
    reads.attach(sc)
    ctl = attach_topology(kv, cooldown_steps=4)
    before, s0 = commit_window.launches, sc.step_index
    sc.place_leaders()
    keys = keys_for_groups(kv.router, 6)
    for g, ks in enumerate(keys):
        for k in ks:
            kv.put(k, b"v0:" + k, leader=sc.leader_hint(g))
    for _ in range(4):
        sc.step()
    hot = sorted(keys[0])
    rule = RangeRule(hot[3], hot[-1] + b"\x00", 1)
    log = []
    for direction in ("split", "merge"):
        while ctl.cooling():
            sc.step()
        assert (ctl.propose_split(rule.lo, rule.hi, 1)
                if direction == "split" else ctl.propose_merge(rule))
        while ctl.in_window():
            sc.step()
            ctl.drive()
        log.append((kv.router.to_dict(), ctl.status(),
                    [kv.get(k) for k in hot],
                    [kv.group_of(k) for k in hot]))
    return log, commit_window.launches - before, sc.step_index - s0


def test_topology_split_merge_on_the_card():
    """A split and a merge on the card equal their CPU twin: the router,
    the controller's status, the values and owners after each window,
    with one ``commit_window`` launch per protocol step."""
    _need_card()
    clog, _, _ = _topology_run("cpu")
    glog, launched, steps = _topology_run("cuda")
    assert launched == steps
    assert glog == clog
    assert glog[0][1]["transitions_total"] == 1
    assert glog[1][1]["transitions_total"] == 2


def test_lone_instance_commit_window_kernel_equals_plain():
    """The process-group step's call: one instance (N = 1) reading its
    group's R gathered acks, kernel against plain on the card."""
    _need_card()
    from chip_smoke import window_case
    from rdma_paxos_tpu_torch.ops.quorum import (
        commit_window_cuda, commit_window_ref)
    rng = np.random.default_rng(11)
    args, kw = window_case(rng, torch.device("cuda"), G=1, R=3, W=2048,
                           n_slots=8192)
    buf, peer, my_ack = args
    for n in range(3):
        one = (buf[n:n + 1].contiguous(), peer[n:n + 1].contiguous(), my_ack)
        kn = {k: v[n:n + 1].contiguous() for k, v in kw.items()}
        want = commit_window_ref(*one, w=2048, **kn)
        got = commit_window_cuda(*one, w=2048, **kn)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), n


@pytest.mark.parametrize("G,gl", [(4, 1), (64, 16)])
def test_device_list_entry_commit_window_kernel_equals_plain(G, gl):
    """A device-list entry's call: replica r of a group shard's gl
    groups, each instance reading its own group's acks as a row, kernel
    against plain and against the stacked call on the card."""
    _need_card()
    from chip_smoke import entry_call, window_case
    from rdma_paxos_tpu_torch.ops.quorum import (
        commit_window_cuda, commit_window_ref)
    rng = np.random.default_rng(G)
    args, kw = window_case(rng, torch.device("cuda"), G=G, R=3, W=2048,
                           n_slots=8192)
    stacked = commit_window_ref(*args, w=2048, **kw)
    for r in range(3):
        call, idx = entry_call(args, kw, 3, range(G - gl, G), r)
        got = commit_window_cuda(*call[0], w=2048, **call[1])
        want = commit_window_ref(*call[0], w=2048, **call[1])
        assert all(torch.equal(a, b) for a, b in zip(got, want)), r
        assert all(torch.equal(a, b[idx]) for a, b in zip(got, stacked))


def test_spmd_engine_on_the_card():
    """``SimCluster(mode="spmd")`` on ``["cuda:0"] * 3``: a few steps
    equal to the stacked engine on the card, exactly R commit-window
    launches per protocol step (one per entry, N = 1 each)."""
    _need_card()
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    cfg = LogConfig(n_slots=1024, slot_bytes=128, window_slots=256,
                    batch_slots=256)
    a = SimCluster(cfg, 3, fanout="psum")
    b = SimCluster(cfg, 3, mode="spmd", device=["cuda:0"] * 3,
                   fanout="psum")
    try:
        for c in (a, b):
            c.run_until_elected(0)
        for i in range(6):
            for c in (a, b):
                for k in range(300):
                    c.submit(0, b"g%d-%d" % (i, k))
            ra = a.step()
            n0 = commit_window.launches
            rb = b.step()
            assert commit_window.launches - n0 == 3
            for k in SimCluster.RES_KEYS:
                assert np.array_equal(ra[k], rb[k]), (i, k)
        assert a.replayed == b.replayed
        assert torch.equal(a.state.log.buf, b.state.log.buf)
    finally:
        b.close()


def test_host_world_on_the_card(tmp_path):
    """Three ``HostReplicaDriver(device="cuda")`` ranks sharing the card
    under gloo (``chip_smoke.py`` phase 14c's drill, small geometry):
    one ``commit_window`` launch per protocol step per rank, and every
    rank equal to its CPU twin."""
    _need_card()
    import chip_smoke
    geom = dict(n_slots=256, slot_bytes=128, window_slots=32,
                batch_slots=32, rebase_threshold=512)
    cases = [("s", geom, 24, f) for f in ("psum", "gather")]
    gpu = chip_smoke.run_host_world("cuda", cases, str(tmp_path), "gpu")
    cpu = chip_smoke.run_host_world("cpu", cases, str(tmp_path), "cpu")
    for (ga, gm, _), (ca, _cm, _) in zip(gpu, cpu):
        assert sorted(ga) == sorted(ca)
        for k in ga:
            np.testing.assert_array_equal(ga[k], ca[k], err_msg=k)
        for f in ("psum", "gather"):
            assert gm[f"s/{f}"]["launches"] == gm[f"s/{f}"]["steps"] > 0


def test_profiler_capture_holds_commit_window_kernels(tmp_path):
    """A ``ProfilerSession`` around steps on the card: the capture and
    the merged timeline hold the ``commit_window`` kernel's events, at
    most one per protocol step (profiled records can drop)."""
    _need_card()
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.obs import device as obs_device
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    c = SimCluster(LogConfig(n_slots=256, slot_bytes=64, window_slots=32,
                             batch_slots=32), 3)
    c.run_until_elected(0)
    s = obs_device.ProfilerSession(str(tmp_path / "prof")).start()
    for i in range(8):
        c.submit(0, b"p%d" % i)
        c.step()
    torch.cuda.synchronize()
    s.stop()
    kern = [e for e in s.chrome_events()
            if "commit_window_kernel" in e.get("name", "")]
    assert 0 < len(kern) <= 8
    doc = obs_device.merge_timeline([], profiler=s)
    assert doc["otherData"]["device_events"] > 0
    assert any("commit_window_kernel" in e.get("name", "")
               for e in doc["traceEvents"])


def test_one_rank_node_daemon_on_the_card(tmp_path):
    """A one-rank ``NodeDaemon`` on the card elects itself and commits a
    write through its shim handler (bursts on, the card's default), with
    one ``commit_window`` launch per protocol step."""
    _need_card()
    import socket
    import torch.distributed as dist
    from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from rdma_paxos_tpu_torch.runtime.node import NodeDaemon
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    commit_window.launches = 0
    node = NodeDaemon(
        LogConfig(n_slots=256, slot_bytes=64, window_slots=32,
                  batch_slots=32), process_id=0, num_processes=1,
        coordinator=f"127.0.0.1:{port}", workdir=str(tmp_path),
        timeout_cfg=TimeoutConfig(elec_timeout_low=1e9,
                                  elec_timeout_high=2e9))
    try:
        assert node.hd.device.type == "cuda" and node.burst_enabled
        node.prewarm_burst()
        node.timer._deadline = 0.0
        res = node.iterate()
        assert int(res["role"]) == 3, res           # Role.LEADER
        conn = node._on_event(2, 1, b"")
        ev = node._on_event(3, 1, b"SET card yes\n")
        for _ in range(4):
            node.iterate()
        assert conn.done.is_set() and ev.done.is_set() and ev.status == 0
        assert len(node.store) >= 2
        assert commit_window.launches == node.steps > 8
    finally:
        node.close()
        dist.destroy_process_group()


@pytest.mark.parametrize("variant", ["plain", "audit_telemetry"])
@pytest.mark.parametrize("kind", ["sim", "shard"])
def test_graphed_engine_equals_the_cpu_engine(kind, variant):
    """The stable step replayed from its CUDA graphs (recorded by
    ``prewarm``) against the same engine on the CPU, step for step
    (``tests/test_torch_graph.py:drive_graphed``: serial and no-take
    steps, bursts of every tier, two tickets in flight, eager elections
    between replays, a rebase and a rebound state): every result and
    state field bit for bit, ``commit_window`` launched once per
    protocol step, and the steps split by path and reason."""
    _need_card()
    from rdma_paxos_tpu_torch.ops.quorum import commit_window
    from tests.test_torch_graph import ENGINES, VARIANTS, drive_graphed
    make, launches = ENGINES[kind], []

    def build(device, **kw):
        e = make(device, **kw)
        if device == "cuda":
            e.c.prewarm()
            assert set(e.c._graphs) == {"step", "burst"}
            launches.append(commit_window.launches)
        return e
    ea, want = drive_graphed(build, "cuda", "cpu", **VARIANTS[variant])
    a = ea.c
    torch.cuda.synchronize()
    assert commit_window.launches - launches[0] == a.step_index == sum(
        want.values())
    assert a.graph_replays == {"step": want["step"],
                               "burst": want["burst"]}
    assert a.eager_steps == {"elections": want["elections"],
                             "no_capture": 0}
