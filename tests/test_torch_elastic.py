"""Port parity: the elastic generation plane (``runtime/elastic.py`` and
``runtime/elastic_worker.py``).

* The JAX ``GroupController`` and the port's, given the same scripted
  registrations, failures and polls, answer alike and cut equal
  generation specs: the unusable-survivors and meta-less cases of
  ``tests/test_elastic.py:130,173``, a donor election by
  ``(last_log_term, end)``, a newcomer and a leave.
* ``best_recovery`` (and the dump readers) give equal results on the
  same files, each package reading the other's dumps.
* End to end (the counterpart of ``tests/test_elastic.py:324``): three
  port supervisors whose workers run on the CPU, with toy apps under
  ``LD_PRELOAD``: a write replicates; a host is lost (its worker
  SIGKILLed) and the survivors, whose collective fails at once, cut a
  generation of two that serves a write; the host restarts and rejoins
  with the full history; a brand-new host joins; every acked write reads
  back from every app.

Every wait has its own deadline and every port is a free ephemeral
one."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(ROOT, "native")

FULL = dict(term=5, last_log_term=5, end=10, commit=10, apply=10,
            applied=10, leader=1, usable=1)


# ---------------------------------------------------------------------------
# the controller: scripted ops against both packages
# ---------------------------------------------------------------------------

def scenario_unusable_survivors():
    """``tests/test_elastic.py:130``: a wedged follower (usable=0) and a
    laggard cannot justify a cut; the returning leader can."""
    wedged = dict(FULL, leader=0, usable=0)
    laggard = dict(FULL, leader=0, end=5, commit=5, apply=5, applied=5)
    return ([("register", h, None) for h in range(3)]
            + [("fail", 1), ("register", 1, wedged),
               ("register", 2, laggard), ("poll", 2),
               ("register", 0, dict(FULL)), ("poll", 0), ("poll", 1)])


def scenario_meta_less():
    """``tests/test_elastic.py:173``: every survivor meta-less cuts a
    fresh world; an oversized host id is refused."""
    return ([("register", h, None) for h in range(3)] + [("fail", 0)]
            + [("register", h, None) for h in range(3)]
            + [("poll", 0), ("register", 128, None)])


def scenario_donor_election():
    """A donor by ``(last_log_term, end)`` (a higher term beats a longer
    log; ties go to the lowest host), ``term_base`` the highest term, a
    newcomer breaking the running generation, and a leave."""
    metas = {0: dict(FULL, term=7, last_log_term=6, end=40),
             1: dict(FULL, term=9, last_log_term=7, end=30),
             2: dict(FULL, term=7, last_log_term=7, end=30)}
    return ([("register", h, None) for h in range(3)] + [("fail", 2)]
            + [("register", h, metas[h]) for h in range(3)]
            + [("poll", h) for h in range(3)]
            + [("register", 3, None), ("round", 0, 2, 0)]
            + [("register", h, metas[h]) for h in range(3)]
            + [("poll", 3), ("leave", 1), ("register", 1, metas[1]),
               ("poll", 1)])


SCENARIOS = dict(unusable_survivors=scenario_unusable_survivors,
                 meta_less=scenario_meta_less,
                 donor_election=scenario_donor_election)


def run_controller(cls, ops) -> list:
    """Every response and the spec after each op, the coordinator port
    taken relative to the controller's own (its base is ephemeral)."""
    ctl = cls(expect=3, settle=0.0, barrier_timeout=5.0)
    out = []

    def norm(d):
        if d and "coordinator" in d:
            host, port = d["coordinator"].rsplit(":", 1)
            d = dict(d, coordinator=(host, int(port) - ctl.port))
        return d
    try:
        for op in ops:
            kind, h = op[0], op[1]
            req = {"op": kind, "host": h}
            if kind == "register":
                req.update(addr=f"127.0.0.1:{1000 + h}", meta=op[2])
            if kind == "round":
                req.update(gen=op[2], round=op[3])
            out.append(norm(ctl._handle(req)))
            with ctl._lock:
                out.append(norm(dict(ctl._spec) if ctl._spec else None))
    finally:
        ctl.close()
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_controller_cuts_match_jax(name):
    from rdma_paxos_tpu.runtime.elastic import GroupController as J
    from rdma_paxos_tpu_torch.runtime.elastic import GroupController as T
    ops = SCENARIOS[name]()
    want = run_controller(J, ops)
    assert run_controller(T, ops) == want
    specs = [s for s in want[1::2] if s]
    if name == "unusable_survivors":
        # no cut from one eligible survivor; the leader's return cuts
        # gen 2 with it as donor
        assert [s["gen"] for s in specs][-1] == 2 and specs[-1]["donor"] == 0
    if name == "meta_less":
        assert specs[-1]["gen"] == 2 and specs[-1]["donor"] == -1
        assert "error" in want[-2]
    if name == "donor_election":
        donors = {s["gen"]: (s["donor"], s["term_base"]) for s in specs}
        assert donors[2] == (1, 9), donors


# ---------------------------------------------------------------------------
# recovery points: best_recovery over the same files
# ---------------------------------------------------------------------------

def a_row(rng, end: int) -> dict:
    return dict(log_buf=rng.integers(0, 1 << 20, (16, 12)).astype(np.int32),
                term=np.int32(3), end=np.int32(end),
                bitmask_old=np.uint32(7))


def write_store(wd: str, host: int, n: int) -> None:
    from rdma_paxos_tpu_torch.proxy.stablestore import StableStore
    st = StableStore(os.path.join(wd, f"host{host}.db"))
    try:
        st.reset()
        for i in range(n):
            st.append(b"record-%d" % i)
        st.sync()
    finally:
        st.close()


RECOVERY_CASES = {
    "nothing": [],
    "barrier_only": [("dump", dict(gen=1, applied=4))],
    "rowdump_newer": [("dump", dict(gen=1, applied=4)),
                      ("rowdump", dict(gen=1, applied=6, store_len=5))],
    "rowdump_of_an_older_gen": [("dump", dict(gen=2, applied=1)),
                                ("rowdump", dict(gen=1, applied=9,
                                                 store_len=7))],
    "torn_rowdump": [("dump", dict(gen=1, applied=2)),
                     ("rowdump", dict(gen=1, applied=8, store_len=3)),
                     ("tear", None)],
    "rowdump_only": [("rowdump", dict(gen=3, applied=5, store_len=2))],
}


def assert_recovery_equal(a, b) -> None:
    assert (a is None) == (b is None), (a, b)
    if a is None:
        return
    (ra, sa, ma), (rb, sb, mb) = a, b
    assert sa == sb and ma == mb
    assert sorted(ra) == sorted(rb)
    for k in ra:
        assert ra[k].dtype == rb[k].dtype, k
        np.testing.assert_array_equal(ra[k], rb[k])


@pytest.mark.parametrize("case", list(RECOVERY_CASES))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_best_recovery_matches_jax(tmp_path, case, writer):
    import rdma_paxos_tpu.runtime.elastic as J
    import rdma_paxos_tpu_torch.runtime.elastic as T
    w = J if writer == "jax" else T
    rng = np.random.default_rng(len(case))
    wd, host = str(tmp_path), 4
    write_store(wd, host, 8)
    for kind, meta in RECOVERY_CASES[case]:
        if kind == "dump":
            w.write_dump(wd, host, a_row(rng, 10), b"barrier-store", meta)
        elif kind == "rowdump":
            w.write_rowdump(wd, host, a_row(rng, 12), meta)
        else:
            path = w.rowdump_path(wd, host)
            with open(path, "r+b") as f:
                f.truncate(os.path.getsize(path) - 9)
    for fn in ("read_dump", "read_rowdump"):
        a, b = getattr(J, fn)(wd, host), getattr(T, fn)(wd, host)
        assert (a is None) == (b is None), fn
        if a is not None:
            assert_recovery_equal(tuple(a[:1]) + (b"", a[-1]),
                                  tuple(b[:1]) + (b"", b[-1]))
    a, b = J.best_recovery(wd, host), T.best_recovery(wd, host)
    assert_recovery_equal(a, b)
    if case == "rowdump_newer":
        assert b[2]["applied"] == 6 and len(b[1]) > 0
    if case in ("rowdump_of_an_older_gen", "torn_rowdump"):
        assert b[1] == b"barrier-store"


def test_framing_round_trips_between_packages():
    """A port client against a JAX-framed server and back: the same
    length-prefixed JSON header and blobs on the wire."""
    import rdma_paxos_tpu.runtime.elastic as J
    import rdma_paxos_tpu_torch.runtime.elastic as T
    for server, client in ((J, T), (T, J)):
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)

        def serve():
            conn, _ = srv.accept()
            with conn:
                req, blobs = server._recv_msg(conn)
                server._send_msg(conn, dict(req, echoed=1),
                                 tuple(b[::-1] for b in blobs))
        t = threading.Thread(target=serve)
        t.start()
        resp, blobs = client.call(
            "127.0.0.1:%d" % srv.getsockname()[1], {"op": "x", "n": 3},
            (b"abc", b"", bytes(range(256)) * 9), timeout=10)
        t.join(10)
        srv.close()
        assert not t.is_alive()
        assert resp == {"op": "x", "n": 3, "echoed": 1}
        assert blobs == [b"cba", b"", (bytes(range(256)) * 9)[::-1]]


def test_supervisor_spawns_the_ports_worker(tmp_path, monkeypatch):
    """The worker argv names the port's worker module and hands it the
    supervisor's device; ``--worker-cpu`` means ``--device cpu``."""
    import rdma_paxos_tpu_torch.runtime.elastic as T
    seen = []

    class Child:
        pid = 0

        def __init__(self, argv, **kw):
            seen.append(argv)

        def kill(self):
            pass
    monkeypatch.setattr(T.subprocess, "Popen", Child)
    spec = dict(gen=1, members=[dict(host=5, addr="127.0.0.1:1")])
    for device, want in (("", None), ("cpu", "cpu")):
        sup = T.ElasticSupervisor(host_id=5, controller="127.0.0.1:1",
                                  workdir=str(tmp_path),
                                  worker_device=device)
        try:
            sup._spawn(spec)
        finally:
            sup.stop()
        argv = seen[-1]
        assert argv[1:3] == ["-m",
                             "rdma_paxos_tpu_torch.runtime.elastic_worker"]
        assert (argv[argv.index("--device") + 1]
                if "--device" in argv else None) == want


# ---------------------------------------------------------------------------
# end to end: a CPU elastic world with loss, restart, rejoin and a joiner
# ---------------------------------------------------------------------------

CFG_JSON = json.dumps({
    "log": {"n_slots": 256, "slot_bytes": 64, "window_slots": 32,
            "batch_slots": 16},
    "timing": {"elec_timeout_low": 0.4, "elec_timeout_high": 0.9},
})
BARRIER_TIMEOUT = 60.0
WAIT = 120.0             # seconds for any one generation event


def free_ports(n: int) -> list:
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def kv(port: int, line: bytes, timeout: float = 5.0) -> bytes:
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as s:
        f = s.makefile("rb")
        s.sendall(line)
        out = f.readline().strip()
        f.close()
    return out


def wait_kv(port: int, key: bytes, want: bytes, timeout: float = 30.0):
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            last = kv(port, b"GET %s\n" % key)
            if last == want:
                break
        except OSError:
            pass
        time.sleep(0.2)
    return last


class World:
    """The controller in this process and a port supervisor per host,
    each on a thread, its workers on the CPU."""

    def __init__(self, tmp_path):
        from rdma_paxos_tpu_torch.runtime.elastic import GroupController
        self.ctl = GroupController(expect=3, settle=1.2,
                                   barrier_timeout=BARRIER_TIMEOUT)
        self.tmp = tmp_path
        self.ports = dict(enumerate(free_ports(4)))
        self.sups = {}

    def dir(self, h: int) -> str:
        return str(self.tmp / f"h{h}")

    def start(self, h: int):
        from rdma_paxos_tpu_torch.runtime.elastic import ElasticSupervisor
        sup = ElasticSupervisor(
            host_id=h, controller=f"127.0.0.1:{self.ctl.port}",
            workdir=self.dir(h), app_port=self.ports[h], round_iters=12,
            cfg_json=CFG_JSON, worker_device="cpu",
            worker_env=dict(OMP_NUM_THREADS="1", PYTHONPATH=ROOT))
        threading.Thread(target=sup.run, daemon=True).start()
        self.sups[h] = sup

    def meta(self, h: int):
        from rdma_paxos_tpu_torch.runtime.elastic import read_rowdump
        d = read_rowdump(self.dir(h), h)
        return d[1] if d is not None else None

    def wait_gen(self, g: int) -> dict:
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline:
            with self.ctl._lock:
                if self.ctl._spec is not None and self.ctl._spec["gen"] >= g:
                    return dict(self.ctl._spec)
            time.sleep(0.1)
        raise AssertionError(f"generation {g} never cut")

    def wait_member(self, h: int, after: int) -> dict:
        spec = self.wait_gen(after + 1)
        deadline = time.monotonic() + WAIT
        while h not in [m["host"] for m in spec["members"]]:
            assert time.monotonic() < deadline, f"host {h} never admitted"
            spec = self.wait_gen(spec["gen"] + 1)
        return spec

    def wait_leader(self, hosts, gen: int) -> int:
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline:
            for h in hosts:
                m = self.meta(h)
                if m and m.get("gen") == gen and m.get("leader"):
                    return h
            time.sleep(0.1)
        raise AssertionError(f"no leader dump for gen {gen}")

    def replicated_set(self, hosts, key: bytes, val: bytes) -> int:
        """SET through whichever member leads (retrying across leader
        moves and generation churn) until every member's app serves it."""
        deadline = time.monotonic() + WAIT
        last = None
        while time.monotonic() < deadline:
            order = sorted(hosts, key=lambda h: -(self.meta(h) or {}).get(
                "leader", 0))
            for h in order:
                try:
                    if kv(self.ports[h], b"SET %s %s\n" % (key, val)) \
                            != b"+OK":
                        continue
                except OSError:
                    continue
                last = [wait_kv(self.ports[o], key, val, 20) for o in hosts]
                if all(v == val for v in last):
                    return h
            time.sleep(0.3)
        raise AssertionError(f"{key!r} never replicated to {hosts}: {last}")

    def close(self) -> None:
        for sup in self.sups.values():
            sup.stop()
        self.ctl.close()


@pytest.fixture(scope="module")
def built_native():
    subprocess.run(["make", "-C", NATIVE], check=True, capture_output=True)


def worker_ends(path: str) -> list:
    with open(path) as f:
        return [json.loads(ln.split(" ", 1)[1]) for ln in f
                if ln.startswith("WORKER_END ")]


def test_elastic_loss_restart_rejoin(tmp_path, built_native):
    w = World(tmp_path)
    try:
        for h in range(3):
            w.start(h)
        spec1 = w.wait_gen(1)
        assert [m["host"] for m in spec1["members"]] == [0, 1, 2]
        w.wait_leader([0, 1, 2], 1)
        lead = w.replicated_set([0, 1, 2], b"era", b"first")

        # lose a follower host: stop() SIGKILLs its worker mid-world
        victim = next(h for h in range(3) if h != lead)
        t_kill = time.monotonic()
        w.sups[victim].stop()
        spec2 = w.wait_gen(2)
        cut_s = time.monotonic() - t_kill
        survivors = [m["host"] for m in spec2["members"]]
        assert victim not in survivors and len(survivors) == 2
        # the survivors learn of the loss one of two ways: mid-round,
        # their next collective raises at once (an unclean end); parked
        # at the round barrier, the controller breaks the generation
        # when barrier_timeout runs out (a clean end)
        for h in survivors:
            ends = worker_ends(os.path.join(w.dir(h), f"worker_h{h}.log"))
            assert ends and ends[0]["gen"] == 1, ends
            assert ends[0]["device"] == "cpu" and ends[0]["steps"] > 0
            if ends[0]["clean"]:
                assert cut_s >= BARRIER_TIMEOUT * 0.9, cut_s
            else:
                assert cut_s < BARRIER_TIMEOUT / 2, cut_s
        w.wait_leader(survivors, spec2["gen"])
        w.replicated_set(survivors, b"during", b"outage")

        # the victim restarts and rejoins with the full history
        w.start(victim)
        spec3 = w.wait_member(victim, spec2["gen"])
        assert wait_kv(w.ports[victim], b"era", b"first", WAIT) == b"first"
        assert wait_kv(w.ports[victim], b"during", b"outage") == b"outage"
        members3 = [m["host"] for m in spec3["members"]]
        w.wait_leader(members3, spec3["gen"])
        w.replicated_set(members3, b"back", b"three")

        # a brand-new host joins and serves history it never saw
        w.start(3)
        spec4 = w.wait_member(3, spec3["gen"])
        assert wait_kv(w.ports[3], b"era", b"first", WAIT) == b"first"
        assert wait_kv(w.ports[3], b"back", b"three") == b"three"
        members4 = [m["host"] for m in spec4["members"]]
        w.wait_leader(members4, spec4["gen"])
        w.replicated_set(members4, b"four", b"hosts")
        for h in members4:
            for key, val in ((b"era", b"first"), (b"during", b"outage"),
                             (b"back", b"three"), (b"four", b"hosts")):
                assert wait_kv(w.ports[h], key, val) == val, (h, key)
    finally:
        w.close()



def _barrier_waiter(mod, ctl, out: dict) -> threading.Thread:
    def wait():
        t = time.monotonic()
        out["resp"], _ = mod.call(
            f"127.0.0.1:{ctl.port}",
            {"op": "round", "host": 0, "gen": 1, "round": 0}, timeout=30)
        out["s"] = time.monotonic() - t
    th = threading.Thread(target=wait)
    th.start()
    time.sleep(0.3)                       # parked at the barrier
    return th


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_closing_the_controller_parks_a_barrier_waiter(pkg):
    """Both packages: ``GroupController.close()`` refuses new connections
    but releases no worker already waiting at a round barrier, which
    waits out ``barrier_timeout``; a ``leave`` releases it at once. So a
    drill breaks the generation before it closes the controller
    (``chip_smoke.py`` phase 15b)."""
    if pkg == "jax":
        import rdma_paxos_tpu.runtime.elastic as mod
    else:
        import rdma_paxos_tpu_torch.runtime.elastic as mod
    for end in ("close", "leave"):
        ctl = mod.GroupController(expect=2, settle=0.0, barrier_timeout=2.0)
        try:
            for h in (0, 1):
                ctl._handle({"op": "register", "host": h,
                             "addr": "127.0.0.1:1", "meta": None})
            assert ctl._spec["gen"] == 1
            out = {}
            th = _barrier_waiter(mod, ctl, out)
            if end == "close":
                ctl.close()
            else:
                mod.call(f"127.0.0.1:{ctl.port}", {"op": "leave", "host": 1})
            th.join(30)
            assert not th.is_alive() and out["resp"]["ok"] == 0
            if end == "close":
                assert out["s"] >= 1.5, out       # the 2 s barrier budget
            else:
                assert out["s"] < 1.0, out
        finally:
            ctl.close()


# ---------------------------------------------------------------------------
# a SIGKILLed gloo peer: the survivor's collective raises at once
# ---------------------------------------------------------------------------

def peer_rank_main(argv=None) -> None:
    """``rank port``: a two-rank world of ``HostReplicaDriver(device=
    "cpu")`` stepping until a collective raises (exit 3)."""
    import sys
    pid, port = (int(a) for a in (argv or sys.argv[1:])[:2])
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.runtime.host import HostReplicaDriver
    hd = HostReplicaDriver(
        LogConfig(n_slots=64, slot_bytes=32, window_slots=16,
                  batch_slots=8), process_id=pid, num_processes=2,
        coordinator=f"127.0.0.1:{port}", device="cpu", timeout=60)
    print("READY", flush=True)
    try:
        while True:
            hd.step()
    except RuntimeError as exc:
        print("RAISED " + str(exc).splitlines()[0][:300], flush=True)
        os._exit(3)


def test_a_survivor_raises_when_its_peer_is_sigkilled():
    """gloo closes a SIGKILLed process's connections, so the survivor's
    next collective raises within seconds, far inside the world's 60 s
    timeout: the elastic worker's unclean exit path."""
    import signal
    import sys
    port = free_ports(1)[0]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", "from tests.test_torch_elastic import "
         "peer_rank_main; peer_rank_main()", str(r), str(port)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        ready = procs[0].stdout.readline()
        while ready and not ready.startswith(b"READY"):
            ready = procs[0].stdout.readline()
        assert ready.startswith(b"READY"), "rank 0 never joined"
        time.sleep(0.5)                       # both ranks stepping
        t = time.monotonic()
        procs[1].send_signal(signal.SIGKILL)
        out = procs[0].communicate(timeout=30)[0].decode(errors="replace")
        took = time.monotonic() - t
        assert procs[0].returncode == 3 and "RAISED" in out, out[-2000:]
        assert took < 10, took
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate(timeout=30)
