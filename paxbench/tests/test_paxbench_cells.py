"""Each cell through the harness's own path on the CPU at a tiny size,
judged by the reference; every planted fault judged incorrect; clients
that follow a new leader; a new configuration, traffic mix and
per-layer metric found as files alone; and nothing under paxbench/
importing JAX or the JAX package."""

import ast
import json
import shutil
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
CELLS = ["apus3.set_c256p16", "apus3.set_c50"]
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
