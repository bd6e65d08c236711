"""Port parity: the per-host ``NodeDaemon`` and the port's launcher.

Three port ``NodeDaemon(device="cpu")`` ranks, each its own OS process
in a gloo world on 127.0.0.1, run scripted drills: an election and
writes through ``_on_event``, a timer failover, a restart on the same
workdirs that restores the hard state, a genesis boot at ``gen > 0``
from ``snapshot.genesis_row``, ``RP_BURST=1`` and ``RP_SCAN=1``,
``RP_GOVERNOR=1`` and a rollover under psum. The same drills drive three
JAX ``NodeDaemon``s in threads of this process, whose
``HostReplicaDriver`` is replaced here (monkeypatch) by ranks of
``tests/test_torch_host.py``'s JAX spmd world. Every iteration's
outputs, the events' statuses, the store bytes, the hard state,
``meta()`` and ``dump_row()`` must be equal: the protocol state is
i32/u32, so equal means exact.

The launcher end to end: three ``python -m
rdma_paxos_tpu_torch.runtime.launch_node --device cpu`` processes, each
with a toy app under ``LD_PRELOAD``; a SET through the leader's app reads
back from every app (the counterpart of
``tests/test_multihost_e2e.py:54``).

Every subprocess wait has its own deadline and every port is a free
ephemeral one."""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import signal
import subprocess
import sys
import threading
import time
import traceback

import numpy as np
import pytest
import torch

from tests.test_torch_elastic import (  # noqa: F401
    built_native, free_ports, kv, wait_kv)
from tests.test_torch_host import GEO, GEO_REBASE, JaxRank, JaxWorld
from tests.test_torch_sim import jax_step_cache_restored  # noqa: F401

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R = 3
RANK_TIMEOUT = 240        # seconds for the three rank processes
GLOO_TIMEOUT = 60         # init and collective timeout of each rank
TIMERS_OFF = dict(elec_timeout_low=1e9, elec_timeout_high=2e9)
CONNECT, SEND, CLOSE = 2, 3, 4          # EntryType in both packages


# ---------------------------------------------------------------------------
# the drills: run by every rank on a package-neutral ``env`` (see
# PortEnv / JaxEnv below); ``rec`` records what must be equal
# ---------------------------------------------------------------------------

class Recorder:
    def __init__(self):
        self.items = {}
        self.events = []

    def it(self, tag: str, res: dict) -> dict:
        n = len(self.items)
        self.items[f"{n:04d}.{tag}"] = {k: int(v) for k, v in res.items()
                                        if np.ndim(v) == 0}
        return res

    def on_event(self, node, etype: int, conn: int, payload: bytes):
        ev = node._on_event(etype, conn, payload)
        self.events.append(ev)
        return ev

    def final(self, node, **extra) -> dict:
        def status(ev):
            if ev is None or isinstance(ev, int):
                return ("verdict", ev)
            return ("event", ev.status if ev.done.is_set() else "pending")
        return dict(
            iterations=self.items,
            events=[status(ev) for ev in self.events],
            store=node.store.dump(), hard=tuple(node.hard.load()),
            meta=node.meta(), row=node.dump_row(), applied=node.applied,
            rebased=node._rebased_total, bursts=node.burst_enabled,
            scans=node.scan_enabled, **extra)


def run(node, rec, tag: str, n: int = 1, fire: bool = False) -> dict:
    """``n`` iterations; ``fire`` expires this rank's timer first."""
    res = None
    for _ in range(n):
        if fire:
            node.timer._deadline = 0.0
            fire = False
        res = rec.it(tag, node.iterate())
    return res


def client(rec, node, conn: int, payloads) -> None:
    """A connection's CONNECT, SENDs (a payload past ``slot_bytes``
    fragments) and CLOSE through the daemon's shim handler."""
    rec.on_event(node, CONNECT, conn, b"")
    for p in payloads:
        rec.on_event(node, SEND, conn, p)
    rec.on_event(node, CLOSE, conn, b"")


def payloads(tag: bytes, n: int) -> list:
    return [tag + b"-%03d-" % i + b"x" * (7 * i % 41) for i in range(n)]


def drill_elect_write(env, pid: int) -> dict:
    node = env.daemon(GEO, "w")
    rec = Recorder()
    run(node, rec, "elect", 2, fire=(pid == 0))
    if pid == 0:
        client(rec, node, 1, payloads(b"a", 5))
    if pid == 1:                 # a follower serves no replicated traffic
        rec.on_event(node, CONNECT, (1 << 24) | 7, b"")
        rec.on_event(node, SEND, (1 << 24) | 7, b"nope")
    run(node, rec, "write", 6)
    return env.close(node, rec.final(node))


def drill_failover(env, pid: int) -> dict:
    node = env.daemon(GEO, "w")
    rec = Recorder()
    run(node, rec, "elect", 1, fire=(pid == 0))
    if pid == 0:
        rec.on_event(node, CONNECT, 1, b"")
        rec.on_event(node, SEND, 1, b"before-0")
        rec.on_event(node, SEND, 1, b"before-1")
    run(node, rec, "write", 3)
    if pid == 0:                 # in flight when replica 1's timer fires
        rec.on_event(node, SEND, 1, b"inflight-" + b"y" * 40)
        rec.on_event(node, SEND, 1, b"inflight-1")
    run(node, rec, "fire", 1, fire=(pid == 1))
    run(node, rec, "settle", 4)
    if pid == 1:
        client(rec, node, (1 << 24) | 1, payloads(b"b", 3))
    run(node, rec, "write", 5)
    return env.close(node, rec.final(node))


def drill_restart(env, pid: int) -> dict:
    node = env.daemon(GEO, "w")
    rec = Recorder()
    run(node, rec, "elect", 1, fire=(pid == 0))
    if pid == 0:
        client(rec, node, 1, payloads(b"c", 4))
    run(node, rec, "write", 4)
    first = env.close(node, rec.final(node))
    # the same workdirs: each daemon restores its HardState file
    node = env.daemon(GEO, "w")
    rec = Recorder()
    restored = dict(row=node.dump_row(), hard=tuple(node.hard.load()))
    run(node, rec, "elect", 1, fire=(pid == 1))
    run(node, rec, "settle", 2)
    if pid == 1:
        client(rec, node, (1 << 24) | 2, payloads(b"d", 3))
    run(node, rec, "write", 4)
    return dict(first=first, restored=restored,
                second=env.close(node, rec.final(node)))


def drill_genesis(env, pid: int) -> dict:
    node = env.daemon(GEO, "w")
    rec = Recorder()
    run(node, rec, "elect", 1, fire=(pid == 0))
    if pid == 0:
        client(rec, node, 1, payloads(b"e", 4))
    run(node, rec, "write", 4)
    if pid == 0:
        env.share("donor", (node.dump_row(), node.applied))
    first = env.close(node, rec.final(node))
    donor, applied = env.share("donor")
    g = env.genesis_row(donor, group_mask=0b111, epoch=3, n_replicas=R,
                        term=int(donor["term"]))
    g["apply"] = np.int32(applied)
    node = env.daemon(GEO, "g", genesis=g, gen=3, seed=3000)
    rec = Recorder()
    booted = node.dump_row()
    run(node, rec, "elect", 1, fire=(pid == 2))
    run(node, rec, "settle", 2)
    if pid == 2:
        client(rec, node, (2 << 24) | 5, payloads(b"f", 3))
    run(node, rec, "write", 4)
    return dict(first=first, booted=booted,
                second=env.close(node, rec.final(node)))


def drill_bursts(env, pid: int) -> dict:
    """Under RP_BURST=1 (and RP_SCAN=1): the prewarm burst, an election,
    then a backlog past three batches that the gathered hint turns into
    padded K = 8 bursts."""
    node = env.daemon(GEO, "w")
    rec = Recorder()
    node.prewarm_burst()
    run(node, rec, "elect", 1, fire=(pid == 0))
    if pid == 0:
        client(rec, node, 1, payloads(b"g", 3 * GEO["batch_slots"]))
    run(node, rec, "drain", 6)
    return env.close(node, rec.final(node))


def drill_governor(env, pid: int) -> dict:
    """Under RP_GOVERNOR=1 and RP_BURST=1: a rising backlog a little
    past one batch per iteration (the coalesce rule, then bursts), then
    idle iterations."""
    node = env.daemon(GEO, "w")
    rec = Recorder()
    node.prewarm_burst()
    run(node, rec, "elect", 1, fire=(pid == 0))
    if pid == 0:
        rec.on_event(node, CONNECT, 1, b"")
    for i in range(6):
        if pid == 0:
            for j in range(GEO["batch_slots"] + i + 1):
                rec.on_event(node, SEND, 1, b"t%d.%d" % (i, j))
        run(node, rec, "trickle", 1)
    run(node, rec, "idle", 4)
    return env.close(node, rec.final(
        node, decisions=dict(node.governor.decisions)))


def drill_rollover(env, pid: int) -> dict:
    """``rebase_threshold=100``: 160 writes in batches of 8; every rank
    applies the gathered rebase_delta in the same iteration."""
    node = env.daemon(GEO_REBASE, "w")
    rec = Recorder()
    run(node, rec, "elect", 1, fire=(pid == 0))
    if pid == 0:
        rec.on_event(node, CONNECT, 1, b"")
    for i in range(20):
        if pid == 0:
            for j in range(8):
                rec.on_event(node, SEND, 1, b"rb%05d" % (8 * i + j))
        run(node, rec, "load", 1)
    run(node, rec, "idle", 10)
    assert node._rebased_total > 0, "no rollover happened"
    return env.close(node, rec.final(node))


# name -> (drill, the RP_* environment it runs under)
DRILLS = dict(
    elect_write=(drill_elect_write, {}),
    failover=(drill_failover, {}),
    restart=(drill_restart, {}),
    genesis=(drill_genesis, {}),
    burst=(drill_bursts, dict(RP_BURST="1")),
    scan=(drill_bursts, dict(RP_BURST="1", RP_SCAN="1")),
    governor=(drill_governor, dict(RP_BURST="1", RP_GOVERNOR="1")),
    rollover=(drill_rollover, {}),
)


@contextlib.contextmanager
def rp_env(env: dict):
    """The drill's RP_* switches, and none of the others."""
    keys = ("RP_BURST", "RP_SCAN", "RP_GOVERNOR", "RP_AUDIT", "RP_CDC",
            "RP_METRICS_PORT", "RP_FENCE", "RP_BURST_DEBUG")
    saved = {k: os.environ.pop(k, None) for k in keys}
    os.environ.update(env)
    try:
        yield
    finally:
        for k in keys:
            os.environ.pop(k, None)
            if saved[k] is not None:
                os.environ[k] = saved[k]


# ---------------------------------------------------------------------------
# the port's side: three rank processes
# ---------------------------------------------------------------------------

class PortEnv:
    """One rank's daemons: each a new gloo world at the next port."""

    def __init__(self, pid: int, ports: list, wd: str):
        from rdma_paxos_tpu_torch.consensus.snapshot import genesis_row
        self.pid, self.ports, self.wd = pid, list(ports), wd
        self.genesis_row = genesis_row

    def daemon(self, geo: dict, sub: str, **kw):
        from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
        from rdma_paxos_tpu_torch.runtime.node import NodeDaemon
        return NodeDaemon(
            LogConfig(**geo), process_id=self.pid, num_processes=R,
            coordinator=f"127.0.0.1:{self.ports.pop(0)}",
            workdir=os.path.join(self.wd, f"r{self.pid}", sub),
            timeout_cfg=TimeoutConfig(**TIMERS_OFF), device="cpu",
            timeout=GLOO_TIMEOUT, **kw)

    def close(self, node, out: dict) -> dict:
        import torch.distributed as dist
        node.close()
        dist.destroy_process_group()
        return out

    def share(self, name: str, value=None):
        path = os.path.join(self.wd, name + ".pkl")
        if value is not None:
            with open(path + ".tmp", "wb") as f:
                pickle.dump(value, f)
            os.replace(path + ".tmp", path)
            return value
        deadline = time.monotonic() + GLOO_TIMEOUT
        while not os.path.exists(path):
            assert time.monotonic() < deadline, f"no {name} shared"
            time.sleep(0.02)
        with open(path, "rb") as f:
            return pickle.load(f)


def rank_main(argv=None) -> None:
    """One rank: ``rank ports_json workdir out.pkl``; every drill in
    :data:`DRILLS` order."""
    pid, ports, wd, out = (argv or sys.argv[1:])[:4]
    pid = int(pid)
    torch.set_num_threads(1)
    res = {}
    ports = json.loads(ports)
    for i, (name, (drill, env)) in enumerate(DRILLS.items()):
        with rp_env(env):
            res[name] = drill(PortEnv(pid, ports[i], os.path.join(wd, name)),
                              pid)
    with open(out, "wb") as f:
        pickle.dump(res, f)
    print(f"RANK{pid} OK", flush=True)


@pytest.fixture(scope="module")
def port_world(tmp_path_factory):
    """The three rank processes, started at once; a function that waits
    for them (each wait bounded) and returns their results."""
    wd = tmp_path_factory.mktemp("node_world")
    ports = free_ports(2 * len(DRILLS))
    ports = json.dumps([ports[2 * i:2 * i + 2] for i in range(len(DRILLS))])
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "from tests.test_torch_node import rank_main; rank_main()",
         str(i), ports, str(wd), str(wd / f"rank{i}.pkl")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(R)]
    done = {}

    def results():
        if not done:
            deadline = time.monotonic() + RANK_TIMEOUT
            for i, p in enumerate(procs):
                out = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0]
                out = out.decode(errors="replace")
                assert p.returncode == 0 and f"RANK{i} OK" in out, (
                    f"rank {i} failed:\n{out[-4000:]}")
            for i in range(R):
                with open(wd / f"rank{i}.pkl", "rb") as f:
                    done[i] = pickle.load(f)
        return done
    results.wd = wd
    try:
        yield results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


# ---------------------------------------------------------------------------
# the JAX side: three JAX NodeDaemons in threads over one JAX spmd world
# ---------------------------------------------------------------------------

class NodeWorld(JaxWorld):
    """:class:`JaxWorld` with the generation the daemons stamp into
    ``M_GEN``."""

    gen = 0

    def _pack(self, batch, gen=0):
        return super()._pack(batch, gen=self.gen)


class NodeRank(JaxRank):
    """A JAX ``HostReplicaDriver`` stand-in for one daemon: passes the
    daemon's ``gen`` and exposes ``_fanout``."""

    def __init__(self, world: NodeWorld, r: int):
        super().__init__(world, r)
        self._fanout = world.fanout

    def step(self, **kw):
        self.w.gen = kw.pop("gen", 0)
        return super().step(**kw)

    def step_burst(self, K, batches=(), **kw):
        self.w.gen = kw.pop("gen", 0)
        return super().step_burst(K, batches, **kw)

    def step_scan(self, K, batches=(), **kw):
        self.w.gen = kw.pop("gen", 0)
        return super().step_scan(K, batches, **kw)


class JaxEnv:
    """One thread's daemons; the three threads meet at each new world."""

    def __init__(self, pid: int, shared: dict, wd: str):
        from rdma_paxos_tpu.consensus.snapshot import genesis_row
        self.pid, self.shared, self.wd = pid, shared, wd
        self.genesis_row = genesis_row

    def daemon(self, geo: dict, sub: str, **kw):
        from rdma_paxos_tpu.config import LogConfig, TimeoutConfig
        from rdma_paxos_tpu.runtime.node import NodeDaemon
        self.shared["geo"] = geo
        self.shared["barrier"].wait()        # the action builds the world
        return NodeDaemon(
            LogConfig(**geo), process_id=self.pid, num_processes=R,
            coordinator="127.0.0.1:1",
            workdir=os.path.join(self.wd, f"r{self.pid}", sub),
            timeout_cfg=TimeoutConfig(**TIMERS_OFF), **kw)

    def close(self, node, out: dict) -> dict:
        node.close()
        return out

    def share(self, name: str, value=None):
        if value is not None:
            self.shared[name] = value
            self.shared["ready"].set()
            return value
        assert self.shared["ready"].wait(GLOO_TIMEOUT), f"no {name} shared"
        return self.shared[name]


def jax_drill(name: str, wd: str, monkeypatch) -> list:
    import rdma_paxos_tpu.runtime.node as jnode
    drill, env = DRILLS[name]
    shared = dict(world=None, ready=threading.Event())

    def new_world():
        shared["world"] = NodeWorld(shared["geo"], "psum")
    shared["barrier"] = threading.Barrier(R, action=new_world,
                                          timeout=GLOO_TIMEOUT)
    monkeypatch.setattr(
        jnode, "HostReplicaDriver",
        lambda cfg, *, process_id, **kw: NodeRank(shared["world"],
                                                  process_id))
    out, errors = [None] * R, []

    def body(r):
        try:
            out[r] = drill(JaxEnv(r, shared, wd), r)
        except Exception:                          # noqa: BLE001
            errors.append(traceback.format_exc())
            shared["barrier"].abort()
            if shared["world"] is not None:
                shared["world"].barrier.abort()
    with rp_env(env):
        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(R)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(RANK_TIMEOUT)
    assert not errors, errors[0]
    assert not any(t.is_alive() for t in threads), "a JAX rank hung"
    return out


def assert_equal(got, want, path: str = "") -> None:
    """Exact equality of nested results (arrays with their dtypes)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (
            path, sorted(got), sorted(want))
        for k in want:
            assert_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("drill", list(DRILLS))
def test_node_daemon_world_matches_jax(port_world, drill, tmp_path,
                                       monkeypatch):
    """Every rank's per-iteration outputs, event statuses, store bytes,
    hard state, ``meta()`` and final row equal to the JAX daemons'."""
    want = jax_drill(drill, str(tmp_path), monkeypatch)
    got = port_world()
    for r in range(R):
        assert_equal(got[r][drill], want[r], f"{drill}/rank{r}")
    if drill == "elect_write":
        events = want[0]["events"]
        assert events and all(e == ("event", 0) for e in events), events
        assert want[1]["events"] == [("verdict", None)] * 2
    if drill == "failover":
        assert ("event", -1) in want[0]["events"]
        assert want[1]["meta"]["leader"] == 1
    if drill in ("burst", "scan", "governor"):
        # a fused call's ``accepted`` sums its K steps' appends
        B = GEO["batch_slots"]
        assert want[0]["bursts"] and want[0]["scans"] == (drill == "scan")
        assert max(it["accepted"] for it in want[0]["iterations"].values()
                   ) > B, drill
    if drill == "governor":
        d = want[0]["decisions"]
        assert d.get("coalesce", 0) > 0 and d.get("burst", 0) > 0, d


def test_console_reads_the_daemons_health_files(port_world, tmp_path,
                                                monkeypatch):
    """The fleet console merges the port daemons' closing
    ``replica<r>.health.json`` files into the cluster row the JAX
    console makes of the JAX daemons' files."""
    from rdma_paxos_tpu.obs import console as jconsole
    from rdma_paxos_tpu_torch.obs import console as tconsole
    jax_drill("elect_write", str(tmp_path), monkeypatch)
    port_world()
    pattern = os.path.join("r*", "w", "replica*.health.json")
    views = [c.fleet_view(c.load_health_files([os.path.join(str(d), pattern)]))
             for c, d in ((tconsole, port_world.wd / "elect_write"),
                          (jconsole, tmp_path))]
    for v in views:
        for g in v["groups"]:
            g.pop("src")
        for h in v["hosts"]:
            h.pop("src"), h.pop("age_s", None)
        v.pop("ts")
    assert views[0] == views[1]
    row = views[0]["groups"][0]
    assert (row["members"], row["leader"], row["term"]) == (R, 0, 1), row


def test_burst_rule_follows_the_device(tmp_path):
    """Bursts default on for the card and off for the CPU, RP_BURST
    overrides, and gather keeps them off: read through a daemon stub."""
    from rdma_paxos_tpu_torch.runtime.node import NodeDaemon

    class HD:
        def __init__(self, dev, fanout="psum"):
            self.device, self._fanout = torch.device(dev), fanout
    node = NodeDaemon.__new__(NodeDaemon)
    cases = [("cpu", "psum", None, False), ("cuda", "psum", None, True),
             ("cpu", "psum", "1", True), ("cuda", "psum", "0", False),
             ("cuda", "gather", "1", False)]
    for dev, fanout, env, want in cases:
        node.hd = HD(dev, fanout)
        with rp_env({} if env is None else dict(RP_BURST=env)):
            assert node.burst_enabled is want, (dev, fanout, env)
            with rp_env(dict(RP_SCAN="1", **({} if env is None
                                            else dict(RP_BURST=env)))):
                assert node.scan_enabled is want


def test_node_daemon_runs_on_the_card_unless_told(tmp_path):
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.runtime.node import NodeDaemon
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NodeDaemon(LogConfig(**GEO), process_id=0, num_processes=1,
                   coordinator="127.0.0.1:1", workdir=str(tmp_path))


# ---------------------------------------------------------------------------
# the launcher, end to end with toy apps
# ---------------------------------------------------------------------------

LAUNCH_CFG = {"log": {"n_slots": 256, "slot_bytes": 64,
                      "window_slots": 32, "batch_slots": 16},
              "timing": {"elec_timeout_low": 0.4, "elec_timeout_high": 0.9}}


def test_launcher_replicates_a_set_to_every_app(tmp_path, built_native):
    coord, *ports = free_ports(R + 1)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(LAUNCH_CFG))
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1",
               group_size=str(R))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rdma_paxos_tpu_torch.runtime.launch_node",
         "--coordinator", f"127.0.0.1:{coord}", "--workdir", str(tmp_path),
         "--app-port", str(ports[i]), "--iterations", "3000",
         "--period", "0.005", "--config", str(cfg), "--device", "cpu"],
        cwd=ROOT, env=dict(env, server_idx=str(i)), start_new_session=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for i in range(R)]
    try:
        leader, deadline = -1, time.monotonic() + 90
        while leader < 0 and time.monotonic() < deadline:
            for r in range(R):
                p = tmp_path / f"replica{r}.log"
                if p.exists() and "] LEADER" in p.read_text():
                    leader = r
            time.sleep(0.1)
        assert leader >= 0, "no leader line found"
        assert kv(ports[leader], b"SET dist yes\n") == b"+OK"
        for r in range(R):
            assert wait_kv(ports[r], b"dist", b"yes") == b"yes", r
        for r in range(R):
            store = tmp_path / f"host{r}.db"
            assert store.exists() and store.stat().st_size > 0, r
    finally:
        # each launcher leads its own process group, with its app in it
        for p in procs:
            os.killpg(p.pid, signal.SIGKILL)
        for p in procs:
            p.communicate(timeout=30)
