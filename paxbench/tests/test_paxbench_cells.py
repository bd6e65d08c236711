"""Each cell through the harness's own path on the CPU at a tiny size,
judged by the reference; every planted fault judged incorrect (and the
routing fault on the sharded cell); clients that follow a new leader,
and sharded clients that route by the cluster's map; a one-group cell
making the calls it always made; a new configuration, traffic mix and
per-layer metric found as files alone; and nothing under paxbench/
importing JAX or the JAX package."""

import ast
import json
import shutil
import struct
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from paxbench import cell as C
from paxbench import faults, spec
from paxbench.run import metrics_line

torch.set_num_threads(1)
CELLS = ["apus3.set_c256p16", "apus3.set_c50", "shard8.ycsb_a"]
SHARDED = ["shard8.ycsb_a"]
CARD = dict(name="cpu", power_limit="n/a")


def bench_with_all():
    """BENCHMARK.json with every metric listed for every cell, so that
    each cell's run is checked against all of them."""
    bench = spec.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = CELLS
    return bench


def cell(name):
    return spec.cell(name, bench_with_all())


def tiny(name):
    ce = cell(name)
    ce["config"]["log"] = dict(n_slots=1024, slot_bytes=128,
                               window_slots=64, batch_slots=64)
    t = ce["traffic"]
    t.update(pool=4096, clients=min(t["clients"], 16), warmup_steps=2)
    return ce


def run_tiny(name, fault=None, seconds=1.0):
    ce = tiny(name)
    with tempfile.TemporaryDirectory() as wd:
        res = C.run(ce, seed=2 ** 31 + 99, seconds=seconds, trace=False,
                    device=torch.device("cpu"), workdir=wd,
                    t_start=time.perf_counter(), fault=fault, drain_s=3.0)
    return ce, res


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_cpu_and_is_correct(name):
    ce, res = run_tiny(name)
    line = metrics_line(ce, res, False, CARD, 1)
    assert line["correct"], res["checks"]
    assert res["acked"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"acked_ops_per_s", "commit_p95_ms",
                                    "setup_s"}
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, fault):
    ce, res = run_tiny(name, faults.FAULTS[fault])
    assert not metrics_line(ce, res, False, CARD, 1)["correct"]


@pytest.mark.parametrize("fault", sorted(faults.GROUP_FAULTS))
@pytest.mark.parametrize("name", SHARDED)
def test_a_group_fault_is_not_correct(name, fault):
    ce, res = run_tiny(name, faults.GROUP_FAULTS[fault])
    assert not metrics_line(ce, res, False, CARD, 1)["correct"]
    assert res["checks"]["route_mismatch"] > 0


@pytest.mark.parametrize("name", SHARDED)
def test_every_group_acks_and_each_row_rides_its_group(name):
    ce, res = run_tiny(name)
    G = ce["config"]["groups"]
    by_group = res["diag"]["acked_by_group"]
    assert len(by_group) == G and min(by_group) > 0
    assert sum(by_group) == res["acked"]
    assert res["checks"]["route_mismatch"] == 0
    assert res["checks"]["groups_unacked"] == 0


class Recorder:
    """A driver whose method calls and other attribute reads are logged
    by name."""

    def __init__(self, inner, log):
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_log", log)

    def __getattr__(self, name):
        v = getattr(self._inner, name)
        if not callable(v):
            self._log.append(name)
            return v

        def call(*a, **k):
            self._log.append(name + "()")
            return v(*a, **k)
        return call


def test_a_one_group_cell_makes_the_calls_it_always_made(monkeypatch):
    """``groups: 1`` builds the ``ClusterDriver`` with the same
    arguments, drives it through the same calls in the same order
    (repeats of a poll counted once) and gives the ``ClosedLoop`` the
    same arguments as before the sharded path existed."""
    from rdma_paxos_tpu_torch.runtime import driver as drv
    made, log, loops = [], [], []
    real = drv.ClusterDriver

    def cluster_driver(*a, **k):
        made.append((a, k))
        return Recorder(real(*a, **k), log)
    monkeypatch.setattr(drv, "ClusterDriver", cluster_driver)

    class Loop(C.ClosedLoop):
        def __init__(self, *a):
            loops.append(a)
            super().__init__(*a)
    monkeypatch.setattr(C, "ClosedLoop", Loop)

    def no_groups(**_):
        raise AssertionError("a one-group cell judged by groups")
    monkeypatch.setattr(C.reference, "judge_groups", no_groups)
    ce, res = run_tiny("apus3.set_c50")
    assert metrics_line(ce, res, False, CARD, 1)["correct"]
    (args, kw), = made
    conf = ce["config"]
    assert args[1:] == (3,) and args[0].n_slots == conf["log"]["n_slots"]
    assert sorted(kw) == ["device", "fanout", "pipeline", "timeout_cfg",
                          "workdir"]
    assert (kw["fanout"], kw["pipeline"]) == ("psum", 2)
    assert kw["timeout_cfg"].elec_timeout_low == 0.1
    calls = [x for i, x in enumerate(log) if i == 0 or log[i - 1] != x]
    assert calls == ["prewarm()", "run()", "leader()", "_make_handler()",
                     "leader()", "cluster", "stop()", "cluster"]
    assert log.count("_make_handler()") == 3
    (pay, clients, outstanding, handlers, leader, cap), = loops
    traffic = ce["traffic"]
    assert (clients, outstanding) == (traffic["clients"],
                                      traffic["outstanding"])
    assert len(pay) == traffic["pool"] and len(handlers) == 3
    assert cap == int(traffic["max_rate"] * (1.0 + 60))


class FakeEvent:
    def __init__(self, etype, conn, payload):
        self.etype, self.conn, self.payload = etype, conn, payload
        self.cb = None

    def attach(self, cb):
        self.cb = cb


class FakeFront:
    """Replicas whose handler serves only while ``self.lead`` is theirs,
    as the driver's does."""

    def __init__(self, n):
        self.lead, self.events = 0, []
        self.handlers = [self._handler(r) for r in range(n)]

    def _handler(self, r):
        def on_event(etype, conn, payload):
            if r != self.lead:
                return None if etype == 2 else -1
            ev = FakeEvent(etype, conn, payload)
            self.events.append(ev)
            return ev
        return on_event

    def wait_events(self, n):
        end = time.monotonic() + 5
        while len(self.events) < n and time.monotonic() < end:
            time.sleep(0.001)
        assert len(self.events) >= n, self.events


def test_a_failed_client_reconnects_at_the_new_leader():
    from paxbench.loop import ClosedLoop
    front = FakeFront(3)
    loop = ClosedLoop([b"a", b"b", b"c"], 2, 1, front.handlers,
                      lambda: front.lead, 64)
    rows = loop.connect_all()
    for ev in front.events:
        ev.cb(0)
    loop.start()
    front.wait_events(4)
    first = front.events[2:4]
    assert [e.etype for e in first] == [3, 3]
    front.lead = 2
    first[0].cb(-1)                    # deposed: the waiter fails
    front.wait_events(6)
    re_conn, re_send = front.events[4:6]
    assert (re_conn.etype, re_send.etype) == (2, 3)
    assert re_conn.conn == re_send.conn and re_conn.conn >> 24 == 2
    assert re_conn.conn != first[0].conn
    first[1].cb(0)                     # acked before the change was seen
    front.wait_events(8)               # a refusal at 0, then a reconnect
    assert [e.etype for e in front.events[6:8]] == [2, 3]
    assert all(e.conn >> 24 == 2 for e in front.events[4:])
    loop.close()
    assert loop.join(5)
    n = loop.n_sent
    assert loop.reconnects == 2 and rows == [0, 1]
    assert (loop.pidx[:n] == -1).sum() == 4
    refused = (loop.fired[:n] > 0) & (loop.status[:n] != 0)
    assert refused.sum() == 2          # the failed send and the refused one


def test_the_reference_holds_connects_like_requests():
    from paxbench import reference as ref
    conns = np.array([5, 5, 6, 6, 6])
    pidx = np.array([-1, 0, -1, 1, 0])
    status = np.array([0, 0, 0, 0, -1])
    pay = [b"x" * 130, b"y"]
    exp = ref.expected_streams(conns, pidx, status, pay, 128)
    assert exp[5] == [(2, b"", False), (3, b"x" * 128, False),
                      (3, b"xx", False)]
    assert exp[6][:2] == [(2, b"", False), (3, b"y", False)]
    assert all(opt for _, _, opt in exp[6][2:])
    got = [(2, 5, b""), (3, 5, b"x" * 128), (3, 5, b"xx"), (2, 6, b""),
           (3, 6, b"y")]
    assert ref.stream_errors(got, exp, []) == 0
    assert ref.stream_errors(got[:3] + got[4:], exp, []) == 1
    assert ref.stream_errors(got[1:], exp, []) == 1


def test_the_reference_holds_connects_until_the_first_send():
    from paxbench import reference as ref
    conns = np.array([5, 7, 5, 6, 6, 8, 8])
    pidx = np.array([-1, -1, 0, -1, 1, -1, 0])
    status = np.array([0, 0, 0, 0, -1, 0, 0])
    pay = [b"x" * 130, b"y"]
    exp = ref.expected_held(conns, pidx, status, pay, 128)
    assert exp[5] == [(2, b"", False), (3, b"x" * 128, False),
                      (3, b"xx", False)]
    assert 7 not in exp                       # never sent: no CONNECT
    assert exp[6] == [(2, b"", True), (3, b"y", True)]


def judge_two_groups(g0, g1, store0=None):
    """Two groups of one replica; connections 5 and 8 ride group 0,
    connection 6 group 1."""
    from paxbench import reference as ref
    conns = np.array([5, 6, 8, 5, 6, 8])
    pidx = np.array([-1, -1, -1, 0, 1, 1])
    n = len(conns)

    class Stream:
        def __init__(self, entries):
            self.entries = entries

        def segments_from(self, _i):
            return [[(t, c, 0, p) for t, c, p in self.entries]]
    with tempfile.TemporaryDirectory() as wd:
        path = f"{wd}/replica0.db"
        with open(path, "wb") as f:
            for t, c, p in (g0 + g1 if store0 is None else store0):
                f.write(struct.pack("<IBi", 5 + len(p), t, c) + p)
        return ref.judge_groups(
            conns=conns, pidx=pidx, status=np.zeros(n, np.int16),
            fired=np.ones(n, np.int8), order=np.arange(n),
            groups=np.array([0, 1, 0, 0, 1, 0]), payloads=[b"a", b"b"],
            slot_bytes=128, streams=[[Stream(g0)], [Stream(g1)]],
            stores=[path])


def test_the_reference_judges_each_group_and_its_routing():
    g0 = [(2, 5, b""), (3, 5, b"a"), (2, 8, b""), (3, 8, b"b")]
    g1 = [(2, 6, b""), (3, 6, b"b")]
    ok = judge_two_groups(g0, g1)
    assert all(v == 0 for v in ok.values()), ok
    # the store interleaves the groups as it likes, each in its order
    assert judge_two_groups(g0, g1, g1[:1] + g0[:2] + g1[1:] + g0[2:]) == ok
    moved = judge_two_groups(g0 + g1, [])
    assert moved["route_mismatch"] == 2 and moved["stream_mismatch"] == 2
    late = judge_two_groups(g0[:2] + g0[3:], g1)   # a CONNECT lost
    assert late["stream_mismatch"] == 1 and late["route_mismatch"] == 0


def test_new_parts_are_found_as_files(tmp_path):
    base = tmp_path / "paxbench"
    shutil.copytree(spec.HERE / "configs", base / "configs")
    shutil.copytree(spec.HERE / "traffic", base / "traffic")
    shutil.copytree(spec.HERE / "generators", base / "generators")
    (base / "metrics").mkdir()
    cfg = spec.config("apus3")
    cfg["name"] = "apus5"
    cfg["replicas"] = 5
    (base / "configs" / "apus5.json").write_text(json.dumps(cfg))
    tr = spec.traffic("set_c50")
    tr["clients"] = 7
    (base / "traffic" / "set_c7.json").write_text(json.dumps(tr))
    (base / "metrics" / "sent_per_ack.py").write_text(
        "def read(ctx):\n    return ctx['sent'] / ctx['acked']\n")
    bench = spec.benchmark()
    bench["workloads"].append(dict(name="apus5.set_c7", config="apus5",
                                   traffic="set_c7", chips=1, why="x"))
    bench["per_layer"].append(dict(
        name="sent_per_ack", unit="ratio", better="lower",
        source="program_counter", layer="driver intake and ack release",
        moves="acked_ops_per_s", workloads=["apus5.set_c7"]))
    ce = spec.cell("apus5.set_c7", bench, base)
    assert ce["config"]["replicas"] == 5 and ce["traffic"]["clients"] == 7
    names = [m["name"] for m in ce["per_layer"]]
    assert "sent_per_ack" in names
    assert spec.reader("sent_per_ack", base).read(
        dict(sent=6, acked=3)) == 2
    assert "sent_per_ack" not in [
        m["name"] for m in spec.cell("apus3.set_c256p16", bench)["per_layer"]]
    with pytest.raises(ValueError):
        spec.config("../BENCHMARK")


FORBIDDEN = {"jax", "jaxlib", "flax", "rdma_paxos_tpu", "benchmarks"}


def imported_tops(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_nothing_under_paxbench_imports_jax_or_the_jax_package():
    found = {}
    for path in sorted(spec.HERE.rglob("*.py")):
        bad = sorted(set(imported_tops(path)) & FORBIDDEN)
        if bad:
            found[str(path.relative_to(spec.HERE))] = bad
    assert not found
    # whole top-level names: the port's name begins with the JAX package's
    assert "rdma_paxos_tpu_torch".split(".")[0] not in FORBIDDEN


def test_the_harness_refuses_a_tree_without_the_port(tmp_path):
    import subprocess
    import sys
    shutil.copytree(spec.HERE, tmp_path / "paxbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    pr = subprocess.run(
        [sys.executable, "-m", "paxbench", "--workload", "apus3.set_c50",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert pr.returncode != 0
    assert not pr.stdout.strip()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at a cell's size")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2 ** 31 + 5, 730004, 17])
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_on_the_card(card, name, seed, tmp_path):
    ce = cell(name)
    res = C.run(ce, seed=seed, seconds=spec.benchmark()["run_seconds"],
                trace=False,
                device=card, workdir=str(tmp_path),
                t_start=time.perf_counter(),
                fault=faults.store_drop_followers)
    line = metrics_line(ce, res, False, dict(name="card", power_limit=""),
                        1)
    print(name, seed, "control checks", res["checks"])
    assert not line["correct"] and res["checks"]["store_mismatch"] > 0
