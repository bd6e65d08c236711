"""The app runner (``runners/app.py``): a configuration that names its
runner, the interposed toy apps built and run on the CPU with their
clients in a process of their own, the judge of an app's deployment
(``reference.judge_app``) on hand-made outputs, the controls
(``faults.replay_drop_follower`` caught by the app read-back alone,
``faults.early_release`` by ``early_acks`` alone), no process left
behind, and one clock shared by the clients and the harness."""

import ast
import contextlib
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import pytest
import torch

from paxbench import appclient, faults, reference, spec
from paxbench import cell as C
from paxbench.run import metrics_line
from paxbench.tests.test_paxbench_cells import CARD, cell, run_tiny, tiny

torch.set_num_threads(1)
APP = "apus3_app.toy_set_c50"
SEED = 2 ** 31 + 4321


def test_a_configuration_names_its_runner():
    assert spec.runner(None) is None
    mod = spec.runner("app")
    assert callable(mod.run) and mod.__name__ == "paxbench.runners.app"
    assert spec.config("apus3_app")["runner"] == "app"
    assert "runner" not in spec.config("apus3")
    with pytest.raises(FileNotFoundError):
        spec.runner("no_such_runner")
    with pytest.raises(ValueError):
        spec.runner("../cell")


def test_cell_run_hands_a_named_runner_the_run(monkeypatch):
    got = {}

    def fake_run(cell, **kw):
        got.update(kw, cell=cell)
        return "the runner's result"
    monkeypatch.setattr(spec, "runner", lambda name: None if name is None
                        else types.SimpleNamespace(run=fake_run))
    ce = tiny(APP)
    assert C.run(ce, seed=7, seconds=1.0, trace=False, device="cpu",
                 workdir="wd", t_start=0.0) == "the runner's result"
    assert got["cell"] is ce and got["seed"] == 7 and got["fault"] is None
    assert sorted(got) == ["cell", "device", "drain_s", "fault", "seconds",
                           "seed", "t_start", "trace", "trace_s", "workdir"]


class Watch:
    """Records every app and client process a run starts."""

    def __init__(self, monkeypatch):
        app = spec.runner("app")        # one module for the whole run
        monkeypatch.setattr(spec, "runner",
                            lambda name: None if name is None else app)
        self.apps, self.clients = [], []
        for cls, into in ((app.Apps, self.apps),
                          (app.AppLoop, self.clients)):
            def init(obj, *a, _orig=cls.__init__, _into=into, **k):
                _into.append(obj)
                _orig(obj, *a, **k)
            monkeypatch.setattr(cls, "__init__", init)
        self.runner = app

    def all_ended(self):
        procs = [p for a in self.apps for p in a.procs]
        procs += [c.proc for c in self.clients]
        return bool(procs) and all(p.poll() is not None for p in procs)


def test_the_app_cell_runs_on_the_cpu_and_is_correct(monkeypatch):
    w = Watch(monkeypatch)
    ce, res = run_tiny(APP, seconds=1.5)
    line = metrics_line(ce, res, False, CARD, 1)
    assert line["correct"], res["checks"]
    assert all(v == 0 for v in res["checks"].values())
    assert set(res["checks"]) == {
        "unanswered", "bad_reply", "stream_mismatch", "order_divergence",
        "store_mismatch", "log_mismatch", "early_acks", "app_mismatch",
        "overflow"}
    assert res["acked"] > 0 and line["failed"] == 0
    keys = res["diag"]["app_keys"]
    assert len(keys) == 3 and len(set(keys)) == 1 and keys[0] > 16
    assert res["diag"]["child_cpu_s"]["clients"] > 0
    assert {"build", "apps", "connect", "warmup"} <= set(
        res["diag"]["setup_parts_s"])
    for name in ("interpose.so", "toyserver"):
        assert (spec.ROOT / "build" / "paxbench_native" / name).is_file()
    assert w.all_ended()


def test_the_control_is_caught_by_the_app_read_back_alone():
    ce, res = run_tiny(APP, faults.replay_drop_follower, seconds=1.5)
    checks = res["checks"]
    assert checks["app_mismatch"] > 0, checks
    assert all(v == 0 for k, v in checks.items() if k != "app_mismatch")
    assert not metrics_line(ce, res, False, CARD, 1)["correct"]


def test_an_early_release_is_caught_by_early_acks():
    """The bytes still commit, so the stream and store checks see
    nothing; ``early_acks`` counts the answers. (Its speculation runs
    several requests of a connection into one step, which may reorder a
    follower app's SETs of one key from two connections: ``app_mismatch``
    may count too.)"""
    ce, res = run_tiny(APP, faults.early_release, seconds=1.5)
    checks = res["checks"]
    assert checks["early_acks"] > 0, checks
    assert checks["stream_mismatch"] == checks["store_mismatch"] == 0
    assert checks["unanswered"] == checks["bad_reply"] == 0
    assert not metrics_line(ce, res, False, CARD, 1)["correct"]


@pytest.mark.parametrize("where", ["window", "cleanup"])
def test_a_run_that_raises_leaves_no_process(monkeypatch, where):
    """Whether the window raises or a step of the clean-up does, every
    app and client process ends."""
    w = Watch(monkeypatch)

    def broken(*a, **k):
        raise RuntimeError("broken " + where)
    if where == "window":
        monkeypatch.setattr(w.runner, "window", broken)
    else:
        monkeypatch.setattr(w.runner.LeaderFile, "stop", broken)
    with pytest.raises(RuntimeError, match="broken " + where):
        run_tiny(APP)
    assert w.all_ended()


def test_an_app_not_interposed_is_refused_at_once(monkeypatch):
    """Without the shim the app serves its clients unreplicated: the run
    stops before its window, and leaves no process behind."""
    w = Watch(monkeypatch)
    build = w.runner.build_native

    def no_shim(*a, **k):
        return dict(build(*a, **k), **{"interpose.so": ""})
    monkeypatch.setattr(w.runner, "build_native", no_shim)
    monkeypatch.setattr(w.runner, "CONNECT_S", 3.0)
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="app not interposed"):
        run_tiny(APP)
    assert time.monotonic() - t < 60
    assert w.all_ended()


def test_the_native_parts_are_built_again_only_when_a_source_changes(
        tmp_path):
    app = spec.runner("app")
    conf = spec.config("apus3_app")["app"]
    shutil.copytree(spec.ROOT / "native", tmp_path / "native",
                    ignore=shutil.ignore_patterns("*.so", "toyserver",
                                                  "miniev"))
    first = app.build_native(conf, tmp_path)
    stamp = {n: os.stat(p).st_mtime_ns for n, p in first.items()}
    assert app.build_native(conf, tmp_path) == first
    assert {n: os.stat(p).st_mtime_ns for n, p in first.items()} == stamp
    src = tmp_path / "native" / "toyserver.c"
    src.write_text(src.read_text() + "\n/* changed */\n")
    app.build_native(conf, tmp_path)
    assert os.stat(first["toyserver"]).st_mtime_ns != stamp["toyserver"]
    assert os.stat(first["interpose.so"]).st_mtime_ns == \
        stamp["interpose.so"]
    assert not any(p.name.startswith(("toyserver", "interpose"))
                   for p in (tmp_path / "native").iterdir()
                   if p.suffix not in (".c", ".cpp"))


# ---- the judge, on hand-made outputs ----

PAY = [b"SET key:000000000001 aaa\n", b"SET key:000000000002 bbb\n",
       b"SET key:000000000001 ccc\n", b"SET key:000000000003 ddd\n"]


def stream(*conns):
    """A committed stream: each connection's CONNECT, then its SENDs, in
    the order given as (conn, pool index) or (conn, None) for a CONNECT."""
    out = []
    for c, p in conns:
        out.append((reference.CONNECT, c, b"") if p is None
                   else (reference.SEND, c, PAY[p]))
    return out


# client connection 0 sent pool rows 0, 2; connection 1 sent 1, 3; every
# answer came at 5.0
ROWS = dict(conn=np.array([0, 1, 0, 1]), pidx=np.array([0, 1, 2, 3]),
            answer=np.array([1, 1, 1, 1], np.int8), t_ack=np.full(4, 5.0))
GOOD = stream((10, None), (11, None), (10, 0), (11, 1), (10, 2), (11, 3))
STATE = {b"key:000000000001": b"ccc", b"key:000000000002": b"bbb",
         b"key:000000000003": b"ddd"}
# at 1.0 no committed stream held an entry from index 2 on
CLOCK = dict(absent_t=np.array([0.0, 1.0]), absent_n=np.array([0, 2]))


def judge(streams, dumps=None, clock=CLOCK, **rows):
    kw = dict(ROWS, **rows)
    return reference.judge_app(
        extra_replies=0, n_conns=2, payloads=PAY, streams=streams,
        stores=[list(s) for s in streams], log_bad=0, lead=0,
        dumps=[dict(STATE)] * len(streams) if dumps is None else dumps,
        **clock, **kw)


def test_the_judge_passes_a_sound_run():
    out = judge([GOOD, GOOD, GOOD])
    assert all(v == 0 for v in out.values()), out
    assert reference.toy_state(GOOD) == STATE


def test_the_stream_rule_is_on_bytes():
    # the shim forwards what read() returned: two requests in one SEND,
    # and one request cut over two, are the same bytes
    merged = [(reference.CONNECT, 10, b""), (reference.CONNECT, 11, b""),
              (reference.SEND, 10, PAY[0] + PAY[2][:7]),
              (reference.SEND, 10, PAY[2][7:]),
              (reference.SEND, 11, PAY[1] + PAY[3])]
    assert judge([merged])["stream_mismatch"] == 0
    # a byte changed is a prefix of no client's bytes
    bent = merged[:2] + [(reference.SEND, 10, PAY[0].replace(b"a", b"x"))]
    assert judge([bent], [reference.toy_state(bent)])[
        "stream_mismatch"] >= 1
    # unacked bytes may be missing; acked bytes may not
    short = stream((10, None), (11, None), (10, 0), (11, 1), (11, 3))
    dump = [reference.toy_state(short)]
    assert judge([short], dump, answer=np.array([1, 1, 0, 1], np.int8))[
        "stream_mismatch"] == 0
    assert judge([short], dump)["stream_mismatch"] == 1


def test_a_client_matching_two_connections_counts():
    twice = GOOD + stream((12, None), (12, 0))
    assert judge([twice], [reference.toy_state(twice)])[
        "stream_mismatch"] == 2   # a conn too many, twice


def test_an_acked_set_missing_from_one_replica_counts():
    lost = [e for e in GOOD if e != (reference.SEND, 11, PAY[3])]
    out = judge([GOOD, lost, GOOD])
    assert out["stream_mismatch"] == 1 and out["order_divergence"] == 1
    assert out["store_mismatch"] == 0


def test_a_wrong_get_or_count_is_an_app_mismatch():
    """Each key whose value differs, or that one side lacks, counts
    once; an app that gives no state counts every key and one more."""
    stale = {**STATE, b"key:000000000001": b"aaa"}
    out = judge([GOOD] * 3, [STATE, stale, STATE])
    assert out["app_mismatch"] == 1 and out["stream_mismatch"] == 0
    fewer = {k: v for k, v in STATE.items() if k != b"key:000000000003"}
    more = {**STATE, b"key:000000000009": b"zzz"}
    assert judge([GOOD] * 3, [STATE, fewer, more])["app_mismatch"] == 2
    assert judge([GOOD] * 3, [STATE, None, {}])["app_mismatch"] == 4 + 3
    assert judge([GOOD], [stale])["early_acks"] == 0


def test_an_answer_before_its_request_committed_counts():
    # at 6.0 nothing from index 4 on was committed: rows 2 and 3, in
    # entries 4 and 5, were answered at 5.0, before their commit
    late = dict(absent_t=np.array([1.0, 6.0]), absent_n=np.array([2, 4]))
    out = judge([GOOD], clock=late)
    assert out["early_acks"] == 2
    assert all(v == 0 for k, v in out.items() if k != "early_acks"), out
    # an answer the client never got, or one after the stamp, is no fault
    assert judge([GOOD], clock=late, answer=np.array([1, 1, 0, 3], np.int8),
                 t_ack=np.array([5.0, 5.0, 0.0, 0.0]))["early_acks"] == 0
    assert judge([GOOD], clock=late, t_ack=np.full(4, 6.5))[
        "early_acks"] == 0


def test_an_answer_is_timed_at_the_entry_holding_its_last_byte():
    # row 2's bytes are cut over entries 3 and 4: it is committed only
    # with entry 4, which was absent at 6.0
    cut = [(reference.CONNECT, 10, b""), (reference.CONNECT, 11, b""),
           (reference.SEND, 10, PAY[0]), (reference.SEND, 10, PAY[2][:7]),
           (reference.SEND, 10, PAY[2][7:]), (reference.SEND, 11, PAY[1]),
           (reference.SEND, 11, PAY[3])]
    clock = dict(absent_t=np.array([6.0]), absent_n=np.array([4]))
    out = judge([cut], [reference.toy_state(cut)], clock=clock)
    assert out["early_acks"] == 3 and out["stream_mismatch"] == 0
    # no stamp at all: nothing is known absent, nothing counts
    none = dict(absent_t=np.zeros(0), absent_n=np.zeros(0, np.int64))
    assert judge([cut], [reference.toy_state(cut)], clock=none)[
        "early_acks"] == 0


def test_unanswered_and_bad_replies_count():
    out = judge([GOOD], answer=np.array([1, 2, 0, 3], np.int8))
    assert out["unanswered"] == 1 and out["bad_reply"] == 1


class FakeReplay:
    """A replica's replay engine whose app answers ``DUMPALL`` with
    ``listing``."""

    def __init__(self, listing: bytes):
        self.srv = socket.create_server(("127.0.0.1", 0))
        self.listing, self.barriers = listing, 0
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        c, _ = self.srv.accept()
        with c, c.makefile("rb") as f:
            if f.readline() == b"DUMPALL\n":
                c.sendall(self.listing)

    def barrier(self, probe, timeout):
        self.barriers += 1

    @contextlib.contextmanager
    def raw_conn(self):
        with socket.create_connection(self.srv.getsockname()) as s:
            yield s


def test_the_read_back_lists_the_whole_state_after_a_barrier():
    app = spec.runner("app")
    rep = FakeReplay(b"key:1 abc\nkey:2 x y\n.\n")
    assert app.read_back(rep, timeout=10) == {b"key:1": b"abc",
                                              b"key:2": b"x y"}
    assert rep.barriers == 1
    assert app.read_back(FakeReplay(b"key:1 abc\n"), timeout=10) is None


def test_the_commit_clock_stamps_before_each_decode():
    app = spec.runner("app")
    seen = []

    class Cluster:
        replayed = [[1, 2], [1, 2, 3], []]

        def _replay_committed(self, res):
            seen.append((len(clock.t), len(clock.n)))
            self.replayed[0].append(res)
    c = Cluster()
    clock = app.CommitClock(c)
    t0 = time.perf_counter()
    c._replay_committed(7)
    c._replay_committed(8)
    t, n = clock.arrays()
    assert seen == [(1, 1), (2, 2)] and n.tolist() == [3, 3]
    assert t0 <= t[0] <= t[1] <= time.perf_counter()
    assert c.replayed[0] == [1, 2, 7, 8]


# ---- the clients: their own process, the harness's clock ----

def test_the_clients_import_nothing_of_torch_jax_or_the_program():
    tree = ast.parse((spec.HERE / "appclient.py").read_text())
    tops = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    tops |= {(n.module or "").split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert tops - {"__future__", "numpy"} <= set(sys.stdlib_module_names)
    pr = subprocess.run(
        [sys.executable, "-c", "import sys, paxbench.appclient; print("
         "sorted({m.split('.')[0] for m in sys.modules} & {'torch', 'jax',"
         " 'rdma_paxos_tpu', 'rdma_paxos_tpu_torch'}))"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=60)
    assert pr.stdout.strip() == "[]", pr.stderr


def test_the_clients_and_the_harness_share_one_clock():
    assert time.get_clock_info("perf_counter").implementation == \
        "clock_gettime(CLOCK_MONOTONIC)"
    src = (spec.HERE / "appclient.py").read_text()
    clocks = {n.attr for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.Attribute)
              and getattr(n.value, "id", "") == "time"}
    assert clocks <= {"perf_counter", "sleep"}, clocks
    code = ("import time, paxbench.appclient; print(repr(time.perf_counter()"
            "), time.get_clock_info('perf_counter').implementation)")
    t0 = time.perf_counter()
    pr = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                        capture_output=True, text=True, timeout=60)
    t1 = time.perf_counter()
    theirs, impl = pr.stdout.split(maxsplit=1)
    assert t0 < float(theirs) < t1
    assert impl.strip() == "clock_gettime(CLOCK_MONOTONIC)"


def test_the_shared_file_reads_back_what_the_clients_wrote():
    with tempfile.TemporaryDirectory() as wd:
        a = appclient.Shared(f"{wd}/s.bin", 100, create=True)
        a.hdr[appclient.N_ROWS] = 3
        a.t_send[2], a.pidx[2], a.answer[2] = 1.5, 7, appclient.OK
        a.conn_client[5] = 49
        a.flush()
        b = appclient.Shared(f"{wd}/s.bin", 100)
        assert (int(b.hdr[appclient.N_ROWS]), b.t_send[2], int(b.pidx[2]),
                int(b.answer[2]), int(b.conn_client[5])) == \
            (3, 1.5, 7, appclient.OK, 49)
        appclient.write_pool(f"{wd}/pool.bin", PAY)
        assert appclient.read_pool(f"{wd}/pool.bin") == PAY


class FakeApp:
    """A replica's app: accepts, answers ``+OK`` to each line, and can
    sever every connection it holds."""

    def __init__(self):
        self.srv = socket.create_server(("127.0.0.1", 0))
        self.port = self.srv.getsockname()[1]
        self.conns, self.lines = [], 0
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                c, _ = self.srv.accept()
            except OSError:
                return
            self.conns.append(c)
            threading.Thread(target=self._serve, args=(c,),
                             daemon=True).start()

    def _serve(self, c):
        try:
            with c.makefile("rb") as f:
                for _line in f:
                    self.lines += 1
                    c.sendall(b"+OK\n")
        except OSError:
            pass

    def sever(self):
        for c in self.conns:
            c.shutdown(socket.SHUT_RDWR)
            c.close()
        self.conns = []


def test_a_severed_client_reconnects_only_where_the_header_points():
    apps = [FakeApp(), FakeApp()]
    with tempfile.TemporaryDirectory() as wd:
        sh = appclient.Shared(f"{wd}/s.bin", 100000, create=True)
        sh.hdr[appclient.LEADER] = 0
        cl = appclient.Clients(sh, PAY, [a.port for a in apps], 2, 1)
        assert cl.connect(0) and cl.connect(1)
        sh.hdr[appclient.CMD] = appclient.GO
        cl.start()
        t = threading.Thread(target=cl.serve, daemon=True)
        t.start()
        end = time.monotonic() + 10
        while apps[0].lines < 20 and time.monotonic() < end:
            time.sleep(0.01)
        apps[0].sever()                 # the leader is deposed
        time.sleep(0.3)                 # the header still names it
        assert not apps[0].conns and apps[1].lines == 0
        sh.hdr[appclient.LEADER] = 1
        while apps[1].lines < 20 and time.monotonic() < end:
            time.sleep(0.01)
        sh.hdr[appclient.CMD] = appclient.EXIT
        t.join(5)
        assert not t.is_alive() and apps[1].lines >= 20
        n = int(sh.hdr[appclient.N_ROWS])
        assert int(sh.hdr[appclient.RECONNECTS]) == 2
        assert int(sh.hdr[appclient.N_CONNS]) == 4
        assert set(sh.conn_client[:4].tolist()) == {0, 1}
        answers = sh.answer[:n]
        assert (answers == appclient.SEVERED).sum() <= 2
        assert (answers == appclient.OK).sum() >= 40
        cl.close()
        for a in apps:
            a.srv.close()


# ---- on the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2 ** 31 + 5, 730004, 17])
@pytest.mark.parametrize("control, number", [
    ("replay_drop_follower", "app_mismatch"), ("early_release", "early_acks")])
def test_the_app_control_is_not_correct_on_the_card(card, seed, control,
                                                     number, tmp_path):
    ce = cell(APP)
    res = C.run(ce, seed=seed, seconds=spec.benchmark()["run_seconds"],
                trace=False, device=card, workdir=str(tmp_path),
                t_start=time.perf_counter(), fault=getattr(faults, control))
    line = metrics_line(ce, res, False, dict(name="card", power_limit=""),
                        1)
    print(APP, seed, control, "checks", json.dumps(res["checks"]))
    assert not line["correct"] and res["checks"][number] > 0
    assert res["checks"]["stream_mismatch"] == 0
    assert res["checks"]["store_mismatch"] == 0
