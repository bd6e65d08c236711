"""Port parity of snapshot recovery, engine and driver.

* Engine: the recovery scenarios of ``tests/test_recovery.py``,
  ``test_durability.py``, ``test_rebase.py`` and ``test_force_pruning.py``
  run as one script on the JAX package's ``SimCluster`` and on the
  port's; the replica state, replay streams, apply cursors, recovery
  flags and snapshots are equal at every recorded point (after each
  install and after catch-up), and each scenario's own checks hold on
  both engines.
* Driver: ``recover_replica`` and the deposition and recovery of a
  flagged leader (``tests/test_driver_failures.py``), step-locked
  against the JAX driver with stores and hard state byte-equal.
* Driver and apps (port only, apps on free ephemeral ports): the
  exactly-once auto-recovery of a live app (``test_force_pruning.py``),
  checkpoint compaction that keeps rejoin cost flat and its quiesce
  fallback (``test_bounded_recovery.py``), and ``reset_app`` after a
  mis-speculation (``test_spec_shim.py``)."""

import functools
import os
import socket
import subprocess
import time

import numpy as np
import pytest
import torch

from rdma_paxos_tpu.config import LogConfig as JCfg
from rdma_paxos_tpu.consensus import snapshot as jsnap
from rdma_paxos_tpu.consensus.membership import MembershipManager as JMM
from rdma_paxos_tpu.runtime.sim import SimCluster as JSim
from rdma_paxos_tpu_torch import convert
from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
from rdma_paxos_tpu_torch.consensus import snapshot as tsnap
from rdma_paxos_tpu_torch.consensus.membership import MembershipManager
from rdma_paxos_tpu_torch.consensus.state import Role
from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver
from rdma_paxos_tpu_torch.runtime.sim import SimCluster

from tests.test_bounded_recovery import toy_dump, toy_probe, toy_restore
from tests.test_torch_driver import Lockstep, make_pair

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

CFG16 = dict(n_slots=16, slot_bytes=32, window_slots=8, batch_slots=4)
CFG64 = dict(n_slots=64, slot_bytes=32, window_slots=16, batch_slots=8)
REBASE = dict(CFG64, rebase_threshold=300)
PKG = {"jax": (JSim, JCfg, jsnap, JMM),
       "port": (functools.partial(SimCluster, device="cpu"), LogConfig,
                tsnap, MembershipManager)}


class Script:
    """One engine running a scenario; ``mark`` records what the other
    engine must match at that point."""

    def __init__(self, pkg, geo, R, group_size=None):
        sim, cfg, self.snap, self.MM = PKG[pkg]
        self.c = sim(cfg(**geo), R, group_size)
        self.marks = []

    def install(self, r, snap, **vote):
        c = self.c
        c.state = self.snap.install_snapshot(c.state, r, snap, **vote)
        c.applied[r] = snap.index

    def mark(self, tag, snap=None):
        c = self.c
        self.marks.append((
            tag, convert.replica_state_to_numpy(c.state),
            [list(s) for s in c.replayed], c.applied.copy(),
            sorted(c.need_recovery), c.rebased_total,
            None if snap is None else convert.snapshot_to_numpy(snap)))


def payloads(c, r):
    return [p for (_, _, _, p) in c.replayed[r]]


def drain(c, lead, items, per_wave=8):
    """tests/test_rebase.py: submit on the leader and step until all
    committed."""
    i = 0
    while i < len(items) or c.pending[lead]:
        for _ in range(per_wave):
            if i < len(items):
                c.submit(lead, items[i])
                i += 1
        c.step()
    for _ in range(3):
        c.step()


def pruned_past_laggard(s):
    c = s.c
    c.run_until_elected(0)
    c.partition([[0, 1], [2]])
    for i in range(40):
        c.submit(0, b"x%02d" % i)
        c.step()
    c.step()
    assert int(c.last["head"][0]) > int(c.last["end"][2])
    c.heal()
    for _ in range(4):
        res = c.step()
    assert int(res["end"][2]) < int(res["end"][0])       # gap reject
    snap = s.snap.take_snapshot(c.state, donor=1)
    assert snap.index > 0 and snap.term > 0
    s.install(2, snap)
    s.mark("install", snap)
    for _ in range(3):
        res = c.step()
    assert int(res["end"][2]) == int(res["end"][0])
    res = c.step()
    assert int(res["commit"][2]) == int(res["commit"][0])
    c.submit(0, b"fresh")
    c.step()
    c.step()
    assert payloads(c, 2)[-1] == b"fresh"
    s.mark("catch-up")


def fresh_learner(s):
    c = s.c
    c.run_until_elected(0)
    for i in range(30):
        c.submit(0, b"h%02d" % i)
        c.step()
    c.step()
    assert int(c.last["head"][0]) > 0
    snap = s.snap.take_snapshot(c.state, donor=0)
    s.install(3, snap)
    s.mark("install", snap)
    for _ in range(3):
        res = c.step()
    assert int(res["end"][3]) == int(res["end"][0])
    c.submit(0, b"seen-by-learner")
    c.step()
    c.step()
    assert payloads(c, 3)[-1] == b"seen-by-learner"
    s.mark("catch-up")


def membership_kept(s):
    c = s.c
    mm = s.MM(c)
    c.run_until_elected(0)
    mm.change(0, 0b11111)
    snap = s.snap.take_snapshot(c.state, donor=0)
    assert snap.bitmask_new == 0b11111
    s.install(6, snap)
    assert mm.current(6)["bitmask_new"] == 0b11111
    s.mark("install", snap)


def elect_with_2_partitioned(c):
    c.partition([[0, 2], [1]])
    res = c.step(timeouts=[0])
    assert res["role"][0] == int(Role.LEADER)
    assert (int(res["term"][0]), int(res["term"][1])) == (1, 0)


def peers_retain_vote_records(s):
    c = s.c
    elect_with_2_partitioned(c)
    assert s.snap.recover_vote(c.state, 2, peers=[0]) == (1, 0)
    assert s.snap.recover_vote(c.state, 0, peers=[2]) == (1, 0)
    assert s.snap.recover_vote(c.state, 1)[0] == 0
    s.mark("votes")


def no_double_vote(s, restore=True):
    c = s.c
    elect_with_2_partitioned(c)
    snap = s.snap.take_snapshot(c.state, donor=0)
    vote = {}
    if restore:
        vt, vf = s.snap.recover_vote(c.state, 2, peers=[0])
        vote = dict(voted_term=vt, voted_for=vf)
    c.state = s.snap.install_snapshot(c.state, 2, snap, **vote)
    s.mark("install", snap)
    c.partition([[1, 2], [0]])
    res = c.step(timeouts=[1])
    # restored: 2 already voted for 0 in term 1 and refuses; the
    # control without the restore elects a second term-1 leader
    assert (res["role"][1] == int(Role.LEADER)) == (not restore)
    s.mark("campaign")


def unrestored_vote_double_votes(s):
    no_double_vote(s, restore=False)


def term_floored_at_recovered_vote(s):
    c = s.c
    elect_with_2_partitioned(c)
    snap = s.snap.take_snapshot(c.state, donor=0)
    c.state = s.snap.install_snapshot(c.state, 2, snap, voted_term=7,
                                      voted_for=0, cur_term=5)
    assert [int(np.asarray(getattr(c.state, k)[2]))
            for k in ("term", "voted_term", "voted_for")] == [7, 7, 0]
    s.mark("install", snap)


def rejoin_between_rebases(s):
    c = s.c
    c.run_until_elected(0)
    first = [b"a%05d" % i for i in range(400)]
    drain(c, 0, first)
    assert c.rebases >= 1
    c.partition([[0, 1], [2]])
    second = [b"b%05d" % i for i in range(120)]
    drain(c, 0, second)
    assert int(c.last["head"][0]) > int(c.last["end"][2])
    snap = s.snap.take_snapshot(c.state, donor=1, index=int(c.applied[1]))
    s.install(2, snap)
    # the host restored the event history as a plain list: the decode
    # extends it entry by entry from here on
    c.replayed[2] = list(c.replayed[1][:])
    s.mark("install", snap)
    c.heal()
    for _ in range(6):
        c.step()
    assert int(c.last["end"][2]) == int(c.last["end"][0])
    third = [b"c%05d" % i for i in range(600)]
    drain(c, 0, third)
    assert c.rebases >= 2
    assert isinstance(c.replayed[2], list)
    for r in range(3):
        assert payloads(c, r) == first + second + third, r
    s.mark("catch-up")


def flood(c, lead, n, tag):
    for i in range(n):
        c.submit(lead, b"%s%04d" % (tag, i))
    for _ in range(250):
        if not c.pending[lead]:
            break
        c.step()
    c.step()


def wedged_follower_recovers(s):
    c = s.c
    c.run_until_elected(0)
    c.step()
    c.wedge_apply(2)
    flood(c, 0, 300, b"w")
    assert not c.pending[0], "leader wedged"
    for r in (0, 1):
        assert [p for p in payloads(c, r) if p.startswith(b"w")] == \
            [b"w%04d" % i for i in range(300)]
    c.unwedge_apply(2)
    c.step()
    assert 2 in c.need_recovery
    s.mark("flagged")
    snap = s.snap.take_snapshot(c.state, 0)
    s.install(2, snap)
    c.need_recovery.discard(2)
    s.mark("install", snap)
    c.submit(0, b"after-recovery")
    c.step()
    c.step()
    assert payloads(c, 2)[-1] == b"after-recovery"
    s.mark("catch-up")


def normal_pressure_respects_laggard(s):
    c = s.c
    c.run_until_elected(0)
    c.step()
    c.wedge_apply(2)
    for i in range(20):
        c.submit(0, b"n%02d" % i)
        c.step()
    c.step()
    assert int(c.last["head"][0]) <= c.applied[2]
    assert 2 not in c.need_recovery
    s.mark("pressure")


def forced_pruning_bounded_by_leader_apply(s):
    c = s.c
    c.run_until_elected(0)
    c.step()
    c.wedge_apply(1)
    c.wedge_apply(2)
    flood(c, 0, 300, b"b")
    assert int(c.last["head"][0]) <= c.applied[0]
    assert not c.pending[0]
    s.mark("flood")


SCENARIOS = {
    "pruned_past_laggard": (pruned_past_laggard, CFG16, 3, None),
    "fresh_learner": (fresh_learner, CFG16, 4, 3),
    "membership_kept": (membership_kept, CFG16, 8, 3),
    "peers_retain_vote_records": (peers_retain_vote_records, CFG64, 3,
                                  None),
    "no_double_vote": (no_double_vote, CFG64, 3, None),
    "unrestored_vote_double_votes": (unrestored_vote_double_votes, CFG64,
                                     3, None),
    "term_floored_at_recovered_vote": (term_floored_at_recovered_vote,
                                       CFG64, 3, None),
    "rejoin_between_rebases": (rejoin_between_rebases, REBASE, 3, None),
    "wedged_follower_recovers": (wedged_follower_recovers, CFG64, 3,
                                 None),
    "normal_pressure_respects_laggard": (normal_pressure_respects_laggard,
                                         CFG64, 3, None),
    "forced_pruning_bounded_by_leader_apply": (
        forced_pruning_bounded_by_leader_apply, CFG64, 3, None),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_recovery_matches_jax(name):
    fn, geo, R, group_size = SCENARIOS[name]
    runs = {}
    for pkg in ("jax", "port"):
        s = Script(pkg, geo, R, group_size)
        fn(s)
        runs[pkg] = s.marks
    assert [m[0] for m in runs["port"]] == [m[0] for m in runs["jax"]]
    for jm, tm in zip(runs["jax"], runs["port"]):
        tag = jm[0]
        for k in jm[1]:
            np.testing.assert_array_equal(jm[1][k], tm[1][k],
                                          err_msg=f"{tag}: {k}")
        assert jm[2] == tm[2], tag
        np.testing.assert_array_equal(jm[3], tm[3], err_msg=tag)
        assert jm[4:] == tm[4:], tag


# ---------------------------------------------------------------------------
# driver, step-locked against the JAX driver
# ---------------------------------------------------------------------------

def assert_device_states_equal(jd, td, tag):
    js = convert.replica_state_to_numpy(jd.cluster.state)
    ts = convert.replica_state_to_numpy(td.cluster.state)
    for k in js:
        np.testing.assert_array_equal(js[k], ts[k], err_msg=f"{tag}: {k}")
    np.testing.assert_array_equal(jd.cluster.applied, td.cluster.applied)
    assert jd.cluster.need_recovery == td.cluster.need_recovery, tag
    assert [rt.replay_cursor for rt in jd.runtimes] == [
        rt.replay_cursor for rt in td.runtimes], tag


def test_recover_replica_matches_jax_driver(tmp_path):
    """tests/test_driver_failures.py: replica 3 is pruned past behind a
    partition, stuck after heal, and ``recover_replica`` (no loop
    thread: served by a step on the caller's thread) installs the
    leader's snapshot and its store; both drivers agree at every step."""
    jd, td = make_pair(tmp_path, R=5, geo=CFG64, pipeline=0)
    s = Lockstep(jd, td, stores=True)
    try:
        s.both(lambda d: d.cluster.run_until_elected(0))
        s.step()
        s.both(lambda d: d.cluster.partition([[0, 1, 2], [3], [4]]))
        for i in range(3 * CFG64["n_slots"]):
            s.both(lambda d: d.cluster.submit(0, b"w%03d" % i))
            s.step()
        s.step()
        assert int(td.cluster.last["head"][0]) > int(
            td.cluster.last["end"][3])
        s.both(lambda d: d.cluster.heal())
        s.step(4)
        assert int(td.cluster.last["end"][3]) < int(
            td.cluster.last["end"][0])
        s.both(lambda d: d.recover_replica(3))
        assert_device_states_equal(jd, td, "after recover_replica")
        for jr, tr in zip(jd.runtimes, td.runtimes):
            assert jr.store.dump() == tr.store.dump(), tr.idx
        assert td.runtimes[3].store.dump() == td.runtimes[0].store.dump()
        s.step(4)
        r = td.cluster.last
        assert int(r["end"][3]) == int(r["end"][0])
        assert_device_states_equal(jd, td, "after catch-up")
    finally:
        jd.stop()
        td.stop()


def test_flagged_leader_is_deposed_and_recovered_like_jax(tmp_path):
    """A force-pruned leader acks and heartbeats normally; the driver
    deposes it by firing a healthy member's timeout, then heals it with
    the new leader's snapshot — the same steps on both drivers."""
    jd, td = make_pair(tmp_path, R=5, geo=CFG64, pipeline=0)
    s = Lockstep(jd, td, stores=True)
    try:
        s.both(lambda d: d.cluster.run_until_elected(0))
        s.step()
        assert td.leader() == 0
        s.both(lambda d: d.cluster.submit(0, b"before"))
        s.step(2)
        s.both(lambda d: d.cluster.need_recovery.add(0))
        for i in range(50):
            s.step()
            if td.leader() not in (-1, 0) and not td.cluster.need_recovery:
                break
        assert td.leader() >= 0 and td.leader() != 0, "never deposed"
        assert not td.cluster.need_recovery, "never recovered"
        assert_device_states_equal(jd, td, "recovered")
        s.both(lambda d: d.cluster.submit(d.leader(), b"after"))
        s.step(3)
        assert payloads(td.cluster, 0)[-1] == b"after"
    finally:
        jd.stop()
        td.stop()


def test_admin_requests_refuse_like_jax():
    """One request per slot at a time, and a checkpoint needs the app
    hooks — the JAX driver's refusals, raised to the caller."""
    d = ClusterDriver(LogConfig(**CFG64), 3, device="cpu")
    try:
        d.cluster.run_until_elected(0)
        d.step()
        d._recover_req = (1, 0, None, [])
        with pytest.raises(RuntimeError, match="already pending"):
            d.recover_replica(2)
        d._recover_req = None
        with pytest.raises(RuntimeError, match="no app_snapshot"):
            d.checkpoint_app(1)
        assert d._ckpt_req is None and d.loop_error is None
    finally:
        d.stop()


# ---------------------------------------------------------------------------
# driver and interposed apps (port only)
# ---------------------------------------------------------------------------

NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
APP_CFG = LogConfig(n_slots=512, slot_bytes=128, window_slots=64,
                    batch_slots=32)
# wide timeouts: no mid-test election is intended, and a slow host's
# long driver iteration must not trigger a spurious deposition that
# severs a drill's sessions
WIDE = TimeoutConfig(elec_timeout_low=2.0, elec_timeout_high=4.0)


@pytest.fixture(scope="module")
def native():
    subprocess.run(["make", "-C", NATIVE], check=True, capture_output=True)


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class Client:
    def __init__(self, port):
        self.s = socket.create_connection(("127.0.0.1", port), timeout=10)
        self.f = self.s.makefile("rb")

    def cmd(self, line: str) -> bytes:
        self.s.sendall(line.encode() + b"\n")
        return self.f.readline().strip()

    def send_only(self, line: str) -> None:
        self.s.sendall(line.encode() + b"\n")

    def close(self):
        for h in (self.f, self.s):
            try:
                h.close()
            except OSError:
                pass


def kv(port, line):
    c = Client(port)
    try:
        return c.cmd(line)
    finally:
        c.close()


def wait_kv(port, key, want, timeout=20.0):
    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        try:
            last = kv(port, f"GET {key}")
            if last == want:
                return last
        except OSError:
            pass
        time.sleep(0.1)
    return last


class Stack:
    """A port driver on the CPU serving three interposed toy apps."""

    def __init__(self, tmp_path, cfg=APP_CFG, timeout_cfg=WIDE, **kw):
        self.wd = str(tmp_path)
        self.ports = free_ports(3)
        self.apps = [None] * 3
        self.d = ClusterDriver(cfg, 3, workdir=self.wd,
                               app_ports=self.ports,
                               timeout_cfg=timeout_cfg, device="cpu", **kw)
        for r in range(3):
            self.spawn(r)
        self.d.run(period=0.002)
        deadline = time.time() + 60
        while self.d.leader() < 0 and time.time() < deadline:
            time.sleep(0.05)
        assert self.d.leader() >= 0, "no leader elected"

    def spawn(self, r, spec=None):
        env = dict(os.environ)
        env["LD_PRELOAD"] = os.path.join(NATIVE, "interpose.so")
        env["RP_PROXY_SOCK"] = os.path.join(self.wd, f"proxy{r}.sock")
        env.pop("RP_SPEC", None)          # default: speculative
        self.apps[r] = subprocess.Popen(
            [os.path.join(NATIVE, "toyserver"), str(self.ports[r])],
            env=env, stderr=subprocess.DEVNULL)
        # a restarted app reuses its port: wait until it accepts
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                socket.create_connection(("127.0.0.1", self.ports[r]),
                                         timeout=1).close()
                return
            except OSError:
                time.sleep(0.05)
        raise AssertionError(f"app {r} never accepted")

    def restart(self, r):
        self.apps[r].kill()
        self.apps[r].wait()
        self.spawn(r)

    def close(self):
        self.d.stop()
        for a in self.apps:
            if a is not None:
                a.kill()
                a.wait()


@pytest.fixture()
def stack_factory(native, tmp_path):
    made = []

    def make(**kw):
        made.append(Stack(tmp_path, **kw))
        return made[-1]
    yield make
    for st in made:
        st.close()


def test_auto_recovery_live_app_exactly_once(stack_factory):
    """A force-pruned follower with a live app: auto-recovery delivers
    only the DELTA into the still-running app (key counts prove
    exactly-once)."""
    st = stack_factory(cfg=LogConfig(**dict(CFG64, slot_bytes=64)))
    d, ports = st.d, st.ports
    lead = d.leader()
    victim = (lead + 1) % 3
    assert kv(ports[lead], "SET pre wedge") == b"+OK"
    time.sleep(0.5)
    d.cluster.wedge_apply(victim)
    c = Client(ports[lead])
    for i in range(300):                # way past the 64-slot ring
        assert c.cmd("SET k%03d v%03d" % (i, i)) == b"+OK"
    c.close()
    d.cluster.unwedge_apply(victim)
    deadline = time.time() + 40
    while (victim in d.cluster.need_recovery
           or d.cluster.applied[victim] < d.cluster.applied[lead] - 20):
        assert time.time() < deadline, "auto-recovery incomplete"
        time.sleep(0.1)
    time.sleep(1.0)
    assert kv(ports[victim], "COUNT") == kv(ports[lead], "COUNT"), \
        "double/missed apply"
    assert kv(ports[victim], "GET k250") == b"v250"
    assert kv(ports[victim], "GET pre") == b"wedge"
    assert not d.runtimes[victim].app_dirty
    assert d.loop_error is None


def test_checkpoint_compaction_keeps_rejoin_cost_flat(stack_factory):
    st = stack_factory(app_snapshot=(toy_dump, toy_restore, toy_probe))
    d, ports = st.d, st.ports
    lead = d.leader()
    victim = next(r for r in range(3) if r != lead)
    other = next(r for r in range(3) if r not in (lead, victim))

    def write_wave(tag, n):
        c = Client(ports[lead])
        for i in range(n):
            assert c.cmd(f"SET {tag}{i} v{i}") == b"+OK"
        c.close()
        for r in range(3):
            if r != lead:
                assert wait_kv(ports[r], f"{tag}{n-1}",
                               b"v%d" % (n - 1)) is not None

    write_wave("a", 120)
    d.checkpoint_app(other)
    store = d.runtimes[other].store
    base1 = store.base
    assert base1 > 0, "compaction did not advance the store base"
    write_wave("b", 120)
    d.checkpoint_app(other)
    base2 = store.base
    assert base2 > base1
    retained2 = len(store) - base2
    write_wave("c", 120)
    d.checkpoint_app(other)
    base3 = store.base
    assert len(store) - base3 <= retained2 + 8, "suffix grew with history"

    st.restart(victim)
    donor_retained = len(store) - store.base
    d.recover_replica(victim, donor=other)
    vst = d.runtimes[victim].store
    assert vst.base == base3, "victim did not inherit the compaction"
    assert len(vst) - vst.base <= donor_retained + 4
    assert kv(ports[victim], "GET a0") == b"v0"       # from the checkpoint
    assert kv(ports[victim], "GET c119") == b"v119"   # from the suffix
    for _ in range(40):
        nl = d.leader()
        try:
            if nl >= 0 and kv(ports[nl], "SET after rejoin") == b"+OK":
                break
        except OSError:
            pass
        time.sleep(0.25)
    else:
        raise AssertionError("no leader accepted the post-rejoin write")
    assert wait_kv(ports[victim], "after", b"rejoin") == b"rejoin"
    assert d.loop_error is None


def test_checkpoint_quiesce_fallback_without_probe(stack_factory):
    """A 2-tuple hook (no probe) checkpoints through the kernel-queue
    quiescence fallback; the app rebuilt by ``reset_app`` from checkpoint
    plus suffix holds the whole state."""
    st = stack_factory(app_snapshot=(toy_dump, toy_restore))
    d, ports = st.d, st.ports
    lead = d.leader()
    fol = next(r for r in range(3) if r != lead)
    c = Client(ports[lead])
    for i in range(80):
        assert c.cmd(f"SET q{i} v{i}") == b"+OK"
    c.close()
    assert wait_kv(ports[fol], "q79", b"v79") == b"v79"
    d.checkpoint_app(fol)
    assert d.runtimes[fol].store.base > 0, "compaction did not advance"
    with pytest.raises(RuntimeError, match="follower"):
        d.checkpoint_app(lead)
    st.restart(fol)
    d.reset_app(fol)
    assert kv(ports[fol], "GET q0") == b"v0"          # from the checkpoint
    assert kv(ports[fol], "GET q79") == b"v79"
    assert d.loop_error is None


def test_misspeculation_quarantine_and_reset(stack_factory):
    """tests/test_spec_shim.py: a deposed speculative leader whose app
    executed uncommittable input is quarantined; ``reset_app`` rebuilds
    the restarted app from the committed store, without the diverged
    write, and it resumes live replication."""
    st = stack_factory(timeout_cfg=TimeoutConfig(elec_timeout_low=0.3,
                                                 elec_timeout_high=0.6))
    d, ports = st.d, st.ports
    lead = d.leader()
    c = Client(ports[lead])
    assert c.cmd("SET committed yes") == b"+OK"
    for r in range(3):
        assert wait_kv(ports[r], "committed", b"yes") == b"yes"
    d.cluster.partition([[lead], [r for r in range(3) if r != lead]])
    c.send_only("SET poison bad")
    deadline = time.time() + 60
    while time.time() < deadline and d.leader() in (-1, lead):
        time.sleep(0.05)
    assert d.leader() != lead, "no failover"
    d.cluster.heal()
    deadline = time.time() + 30
    while time.time() < deadline and not d.runtimes[lead].app_dirty:
        time.sleep(0.05)
    assert d.runtimes[lead].app_dirty, "mis-speculation not flagged"
    c.close()
    st.restart(lead)
    d.reset_app(lead)
    assert not d.runtimes[lead].app_dirty
    assert wait_kv(ports[lead], "committed", b"yes") == b"yes"
    assert kv(ports[lead], "GET poison") == b"-"
    nl = d.leader()
    assert kv(ports[nl], "SET after reset-ok") == b"+OK"
    assert wait_kv(ports[lead], "after", b"reset-ok") == b"reset-ok"
    assert d.loop_error is None
