"""Port parity of the log-as-product streams: the port's ``streams/``
(tail, scan, watch, CDC) and its wiring in both engines, the driver and
the nemesis runner, on the CPU against the JAX package's, with exact
equality.

* the tail's codec, ``key_range``, ``groups_for_range`` and the CDC
  chain link equal the reference's;
* scans: pagination, the consistent cut across a leader crash with
  overwrites and a delete between pages, pin expiry — equal pages,
  tokens and scan status on both packages;
* watch: token resume with zero dups and zero gaps, resume past the
  retained window, the whole event sequence after the pump caught up;
  the nemesis runner's streams verdict for two seeds;
* CDC: the export file of a single-group run is byte-equal, each
  package's ``verify_export`` accepts both files against either ledger
  dump and names the same ``(term, index)`` for a flipped byte, and the
  port's CLI exits 0 and 1;
* sharded scans and watches (router narrowing, group isolation);
* a hub changes no step output, a wedged watcher delays no point read,
  the driver's wiring (health, stop, off by default, the CDC sink under
  a workdir), and the governor counts watch backlog as demand."""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from rdma_paxos_tpu import streams as jstreams
from rdma_paxos_tpu.chaos.runner import NemesisRunner as JRunner
from rdma_paxos_tpu.config import LogConfig as JCfg
from rdma_paxos_tpu.config import TimeoutConfig as JTO
from rdma_paxos_tpu.models import kvs as jkvs
from rdma_paxos_tpu.models.replicated_kvs import ReplicatedKVS as JKVS
from rdma_paxos_tpu.obs import Observability as JObs
from rdma_paxos_tpu.runtime import governor as jgov
from rdma_paxos_tpu.runtime import reads as jreads
from rdma_paxos_tpu.runtime.driver import ClusterDriver as JDriver
from rdma_paxos_tpu.runtime.sim import SimCluster as JSim
from rdma_paxos_tpu.shard.cluster import ShardedCluster as JSharded
from rdma_paxos_tpu.shard.kvs import ShardedKVS as JSKVS
from rdma_paxos_tpu.shard.router import KeyRouter as JRouter
from rdma_paxos_tpu.shard.router import RangeRule as JRule
from rdma_paxos_tpu.streams import cdc as jcdc
from rdma_paxos_tpu.streams import scan as jscan
from rdma_paxos_tpu.streams import tail as jtail
from rdma_paxos_tpu_torch import streams as tstreams
from rdma_paxos_tpu_torch.chaos.runner import NemesisRunner
from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
from rdma_paxos_tpu_torch.models import kvs as tkvs
from rdma_paxos_tpu_torch.models.replicated_kvs import ReplicatedKVS
from rdma_paxos_tpu_torch.obs import Observability
from rdma_paxos_tpu_torch.obs.health import validate_cluster
from rdma_paxos_tpu_torch.runtime import governor as tgov
from rdma_paxos_tpu_torch.runtime import reads as treads
from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver
from rdma_paxos_tpu_torch.runtime.sim import SimCluster
from rdma_paxos_tpu_torch.shard.cluster import ShardedCluster
from rdma_paxos_tpu_torch.shard.kvs import ShardedKVS
from rdma_paxos_tpu_torch.shard.router import KeyRouter, RangeRule
from rdma_paxos_tpu_torch.streams import cdc as tcdc
from rdma_paxos_tpu_torch.streams import scan as tscan
from rdma_paxos_tpu_torch.streams import tail as ttail
from rdma_paxos_tpu_torch.streams.scan import TokenExpired
from rdma_paxos_tpu_torch.streams.watch import ResumeExpired
from tests.test_torch_sim import jax_step_cache_restored  # noqa: F401

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX streams tests' geometry
GEO = dict(n_slots=128, slot_bytes=128, window_slots=32, batch_slots=16)
TIMERS = dict(elec_timeout_low=1e9, elec_timeout_high=2e9)

SIDES = dict(
    j=dict(Sim=JSim, Sharded=JSharded, SKVS=JSKVS, Router=JRouter,
           Rule=JRule, Cfg=JCfg, KVS=JKVS, Obs=JObs, reads=jreads,
           streams=jstreams, gov=jgov, kw={}),
    t=dict(Sim=SimCluster, Sharded=ShardedCluster, SKVS=ShardedKVS,
           Router=KeyRouter, Rule=RangeRule, Cfg=LogConfig,
           KVS=ReplicatedKVS, Obs=Observability, reads=treads,
           streams=tstreams, gov=tgov, kw=dict(device="cpu")))


def both(scenario):
    """The scenario on both packages: equal results, returned."""
    j = scenario(SIDES["j"])
    t = scenario(SIDES["t"])
    assert t == j
    return t


def cluster(m, audit=False, **stream_kw):
    c = m["Sim"](m["Cfg"](**GEO), 3, audit=audit, **m["kw"])
    c.obs = m["Obs"]()
    m["reads"].attach(c)
    hub = m["streams"].attach(c, **stream_kw)
    return c, hub


def put_committed(c, kv, leader, key, val, req, client=9):
    kv.put(leader, key, val, client_id=client, req_id=req)
    for _ in range(8):
        c.step()
        kv._fold(leader)
        if kv.last_req[leader].get(client, 0) >= req:
            return
    raise AssertionError("put did not commit")


def rm_committed(c, kv, leader, key, req, client=9):
    kv.remove(leader, key, client_id=client, req_id=req)
    for _ in range(8):
        c.step()
        kv._fold(leader)
        if kv.last_req[leader].get(client, 0) >= req:
            return
    raise AssertionError("rm did not commit")


def serve_blocking(c, fn, max_steps=600):
    """Run a blocking client call (a scan) in a thread while stepping
    the cluster so the ReadHub can confirm and serve its pages."""
    box = {}

    def work():
        try:
            box["out"] = fn()
        except BaseException as exc:  # noqa: BLE001 — reraised below
            box["err"] = exc

    th = threading.Thread(target=work)
    th.start()
    for _ in range(max_steps):
        c.step()
        if not th.is_alive():
            break
    th.join(10)
    assert not th.is_alive()
    if "err" in box:
        raise box["err"]
    return box["out"]


def caught_up(hub, groups=(0,)):
    """Flush the watch pump to every group's committed tail."""
    assert hub.watch.wait_caught_up(
        {g: hub.tails[g].length() for g in groups})


def ev(e):
    return (e.group, e.term, e.index, e.pos, e.op, e.key, e.val, e.conn,
            e.req)


def no_artifact(v):
    return {k: x for k, x in v.items() if k != "artifact"}


# ---------------------------------------------------------------------------
# codec, ranges, chain links
# ---------------------------------------------------------------------------

def test_tail_codec_and_key_ranges_match_jax():
    for k in ("KEY_BYTES", "VAL_BYTES", "CMD_BYTES", "OP_PUT", "OP_GET",
              "OP_RM"):
        assert getattr(ttail, k) == getattr(jtail, k), k
    assert ttail.CMD_BYTES == tkvs.CMD_W * 4
    assert (ttail.OP_PUT, ttail.OP_RM) == (tkvs.OP_PUT, tkvs.OP_RM)
    for op, key, val in ((1, b"key", b"val"), (3, b"k" * 32, b""),
                         (2, b"\x00a", b"v" * 32)):
        tp = tkvs.encode_cmd(op, key, val).tobytes()
        assert tp == jkvs.encode_cmd(op, key, val).tobytes()
        assert ttail.decode_kvs(tp) == jtail.decode_kvs(tp)
    assert ttail.decode_kvs(b"short") is None
    cases = [dict(prefix=b"user/"), dict(lo=b"a", hi=b"b"), dict(),
             dict(prefix=b"\xff\xff"), dict(prefix=b"a\xff"),
             dict(lo=b"x")]
    for kw in cases:
        assert tscan.key_range(**kw) == jscan.key_range(**kw), kw
    for mod in (tscan, jscan):
        with pytest.raises(ValueError):
            mod.key_range(prefix=b"p", lo=b"a")
    rules = [(b"pin/", b"pin0", 2), (b"m", None, 1)]
    tr = KeyRouter(4, overrides=[RangeRule(*r) for r in rules])
    jr = JRouter(4, overrides=[JRule(*r) for r in rules])
    for rng in ((b"pin/", b"pin0"), (b"pin/a", b"pin/b"), (b"user/",
                b"user0"), (b"m", None), (b"n", b"o"), (b"", None)):
        assert tscan.groups_for_range(tr, *rng) == \
            jscan.groups_for_range(jr, *rng), rng
    assert tscan.groups_for_range(None, b"", None) is None
    for args in ((0, 0, 1, 5, 3, 9, 1, b"payload"),
                 (0, 0, 1, 6, 3, 9, 1, b"payload"),
                 (1, 2, 7, 1 << 20, 3, 1 << 22, 5, b""),
                 (0xFFFFFFFF, 3, -1, -1, 3, 0, 0, b"x" * 68)):
        assert tcdc.chain_link(*args) == jcdc.chain_link(*args), args


# ---------------------------------------------------------------------------
# ordered range scans
# ---------------------------------------------------------------------------

def test_scan_pagination_matches_jax():
    def scenario(m):
        c, hub = cluster(m)
        c.run_until_elected(0)
        kv = m["KVS"](c, cap=256)
        hub.kvs = kv
        for i in range(10):
            put_committed(c, kv, 0, b"k%02d" % i, b"v%d" % i, i + 1)
        put_committed(c, kv, 0, b"zz", b"out-of-range", 11)
        page = serve_blocking(c, lambda: hub.scan(prefix=b"k", limit=4))
        mid = hub.scans.pin_count()
        rows = serve_blocking(c, lambda: hub.scan_all(prefix=b"k",
                                                       limit=4))
        out = dict(page=page, mid=mid, rows=rows,
                   pins=hub.scans.pin_count(),
                   folded=hub.scans.status()["folded"])
        hub.fail_all("test done")
        return out
    t = both(scenario)
    assert [k for k, _ in t["page"]["items"]] == [b"k00", b"k01", b"k02",
                                                  b"k03"]
    assert t["page"]["token"] is not None and not t["page"]["done"]
    assert [k for k, _ in t["rows"]] == [b"k%02d" % i for i in range(10)]
    assert t["mid"] == 1 and t["pins"] == 0


def test_scan_consistent_cut_across_leader_crash_matches_jax():
    """A scan started under leader 0 keeps serving the at-cut values
    after 0 is cut off and leader 1 commits an overwrite, a delete and
    a new key; a fresh scan sees the new world — equal pages and
    tokens on both packages."""
    def scenario(m):
        c, hub = cluster(m)
        c.run_until_elected(0)
        kv = m["KVS"](c, cap=256)
        hub.kvs = kv
        for i in range(8):
            put_committed(c, kv, 0, b"k%02d" % i, b"A%d" % i, i + 1)
        page1 = serve_blocking(c, lambda: hub.scan(prefix=b"k", limit=3))
        tok = page1["token"]
        c.partition([[0], [1, 2]])
        c.run_until_elected(1)
        put_committed(c, kv, 1, b"k04", b"B4", 1, client=7)
        rm_committed(c, kv, 1, b"k06", 2, client=7)
        put_committed(c, kv, 1, b"k08", b"B8", 3, client=7)
        pages = [page1]
        while tok is not None:
            page = serve_blocking(c, lambda t=tok: hub.scan(token=t))
            pages.append(page)
            tok = page["token"]
        fresh = serve_blocking(c, lambda: hub.scan_all(prefix=b"k",
                                                        limit=16))
        out = dict(pages=pages, fresh=fresh, pins=hub.scans.pin_count(),
                   status=hub.scans.status())
        hub.fail_all("test done")
        return out
    t = both(scenario)
    got = {}
    for p in t["pages"]:
        got.update(dict(p["items"]))
    assert sorted(got) == [b"k%02d" % i for i in range(8)]
    assert got[b"k04"] == b"A4" and got[b"k06"] == b"A6"
    fresh = dict(t["fresh"])
    assert fresh[b"k04"] == b"B4" and b"k06" not in fresh
    assert fresh[b"k08"] == b"B8" and t["pins"] == 0


def test_scan_pin_expiry_matches_jax():
    def scenario(m):
        c, hub = cluster(m, pin_steps=4)
        c.run_until_elected(0)
        kv = m["KVS"](c, cap=256)
        hub.kvs = kv
        for i in range(6):
            put_committed(c, kv, 0, b"k%d" % i, b"v", i + 1)
        page = serve_blocking(c, lambda: hub.scan(prefix=b"k", limit=2))
        for _ in range(8):
            c.step()
        with pytest.raises(RuntimeError) as err:
            serve_blocking(c, lambda: hub.scan(token=page["token"]))
        out = dict(page=page, err=type(err.value).__name__,
                   msg=str(err.value), status=hub.scans.status())
        hub.fail_all("test done")
        return out
    t = both(scenario)
    assert t["err"] == "TokenExpired" and t["msg"] == "token-expired"
    assert t["status"]["pins_expired"] >= 1
    assert issubclass(TokenExpired, RuntimeError)


# ---------------------------------------------------------------------------
# watch: exactly-once resume
# ---------------------------------------------------------------------------

def test_watch_token_resume_matches_jax():
    def scenario(m):
        c, hub = cluster(m)
        c.run_until_elected(0)
        kv = m["KVS"](c, cap=256)
        sub = hub.subscribe(0, prefix=b"u/")
        for i in range(6):
            put_committed(c, kv, 0, b"u/%d" % i, b"v%d" % i, i + 1)
        put_committed(c, kv, 0, b"other", b"x", 7)
        caught_up(hub)
        first = [ev(e) for e in sub.poll(max_n=64)]
        tok = sub.token()
        sub.close()
        for i in range(6, 10):
            put_committed(c, kv, 0, b"u/%d" % i, b"v%d" % i, i + 2)
        rm_committed(c, kv, 0, b"u/0", 12)
        caught_up(hub)
        sub2 = hub.subscribe(0, prefix=b"u/", token=tok)
        rest = [ev(e) for e in sub2.poll(max_n=64)]
        coord = hub.subscribe(0, prefix=b"u/", token=dict(
            group=0, term=tok["term"], index=tok["index"]))
        by_index = [ev(e) for e in coord.poll(max_n=64)]
        out = dict(first=first, tok=tok, rest=rest, by_index=by_index,
                   token2=sub2.token(), status=hub.status()["watch"],
                   delivered=c.obs.metrics.get(
                       "watch_events_delivered_total", group=0))
        hub.fail_all("test done")
        return out
    t = both(scenario)
    assert [e[5] for e in t["first"]] == [b"u/%d" % i for i in range(6)]
    assert [e[5] for e in t["rest"]] == [b"u/%d" % i
                                         for i in range(6, 10)] + [b"u/0"]
    assert t["rest"][-1][4] == tkvs.OP_RM
    assert t["by_index"] == t["rest"]
    idents = [(e[7], e[8]) for e in t["first"] + t["rest"]]
    assert len(idents) == len(set(idents)) == 11


def test_watch_resume_past_retention_matches_jax():
    def scenario(m):
        c, hub = cluster(m, retain=3)
        c.run_until_elected(0)
        kv = m["KVS"](c, cap=256)
        sub = hub.subscribe(0)
        put_committed(c, kv, 0, b"k0", b"v", 1)
        caught_up(hub)
        tok = sub.poll()[0].token()
        sub.close()
        for i in range(1, 8):
            put_committed(c, kv, 0, b"k%d" % i, b"v", i + 1)
        caught_up(hub)
        with pytest.raises(RuntimeError) as err:
            hub.subscribe(0, token=tok)
        with pytest.raises(RuntimeError):
            hub.subscribe(0, token=dict(group=0, term=tok["term"],
                                        index=tok["index"]))
        with pytest.raises(ValueError, match="group mismatch"):
            hub.subscribe(1, token=tok)
        late = hub.subscribe(0, token=dict(tok, pos=5))
        out = dict(tok=tok, err=type(err.value).__name__,
                   msg=str(err.value),
                   late=[ev(e) for e in late.poll(max_n=16)])
        hub.fail_all("test done")
        return out
    t = both(scenario)
    assert t["err"] == "ResumeExpired" and len(t["late"]) == 2
    assert issubclass(ResumeExpired, RuntimeError)


@pytest.mark.parametrize("seed,kinds", [(11, ("crash", "partition")),
                                        (0, None)])
def test_nemesis_streams_verdict_matches_jax(seed, kinds):
    """The watch chaos case: an all-keys watch with two scripted token
    reconnects under a fault schedule delivers the committed PUT/RM
    sequence exactly once, in order; the verdict, history and ledger
    equal the JAX runner's."""
    kw = dict(seed=seed, steps=100, streams=True)
    if kinds:
        kw["fault_kinds"] = kinds
    jr = JRunner(**kw)
    jv = jr.run()
    tr = NemesisRunner(device="cpu", **kw)
    tv = tr.run()
    assert no_artifact(tv) == no_artifact(jv)
    assert tr.history.to_jsonl() == jr.history.to_jsonl()
    assert tv["ok"], tv
    s = tv["streams"]
    assert s["dups"] == 0 and s["gaps"] == 0 and s["ordered"]
    assert s["events"] == s["expected"] > 0 and s["resumes"] == 2
    assert [ev(e) for e in tr._watch_events] == [
        ev(e) for e in jr._watch_events]
    assert tr.streams_hub.status()["stopped"]


# ---------------------------------------------------------------------------
# CDC export
# ---------------------------------------------------------------------------

def test_cdc_export_matches_jax_and_flipped_byte_is_named(tmp_path):
    def scenario(m):
        path = str(tmp_path / ("cdc_%s.jsonl" % id(m)))
        c = m["Sim"](m["Cfg"](**GEO), 3, audit=True, **m["kw"])
        c.obs = m["Obs"]()
        m["reads"].attach(c)
        hub = m["streams"].attach(c, cdc_path=path, auditor=c.auditor)
        c.run_until_elected(0)
        kv = m["KVS"](c, cap=256)
        for i in range(8):
            put_committed(c, kv, 0, b"k%d" % i, b"v%d" % i, i + 1)
        caught_up(hub)
        hub.fail_all("test flush")
        with open(path) as f:
            text = f.read()
        return dict(text=text, dump=c.auditor.dump(),
                    exported=hub.status()["cdc"],
                    lag=c.obs.metrics.get("cdc_lag_entries", group=0))
    j = scenario(SIDES["j"])
    t = scenario(SIDES["t"])
    assert t["text"] == j["text"] and t["exported"] == j["exported"]
    dump = {k: v for k, v in t["dump"].items() if k != "anchor"}
    assert dump == {k: v for k, v in j["dump"].items() if k != "anchor"}
    lines = t["text"].splitlines()
    assert len(lines) == t["exported"]["0"] > 0
    good = str(tmp_path / "good.jsonl")
    with open(good, "w") as f:
        f.write(t["text"])
    rec0 = json.loads(lines[1])
    p = rec0["payload"]
    rec0["payload"] = ("0" if p[0] != "0" else "1") + p[1:]
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        f.write("\n".join(lines[:1] + [json.dumps(rec0)] + lines[2:])
                + "\n")
    for path in (good, bad):
        for d in (t["dump"], j["dump"]):
            vt = tcdc.verify_export(path, [d])
            assert vt == jcdc.verify_export(path, [d])
    vg = tcdc.verify_export(good, [t["dump"]])
    assert vg["ok"] and vg["checked_digests"] > 0
    vb = tcdc.verify_export(bad, [t["dump"]])
    assert not vb["ok"] and vb["bad"] == (rec0["term"], rec0["index"])
    audit = str(tmp_path / "audit.json")
    with open(audit, "w") as f:
        json.dump(t["dump"], f)
    env = dict(os.environ, PYTHONPATH=ROOT)
    ok = subprocess.run(
        [sys.executable, "-m", "rdma_paxos_tpu_torch.streams", "verify",
         good, audit], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=120)
    assert ok.returncode == 0, ok.stderr
    assert ok.stdout.startswith("OK: %d records" % len(lines))
    fail = subprocess.run(
        [sys.executable, "-m", "rdma_paxos_tpu_torch.streams", "verify",
         bad, audit, "--json"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=120)
    assert fail.returncode == 1
    assert json.loads(fail.stdout)["bad"] == [rec0["term"],
                                              rec0["index"]]


# ---------------------------------------------------------------------------
# sharded engines
# ---------------------------------------------------------------------------

def test_sharded_scan_and_watch_match_jax():
    """Router narrowing, a merge-sorted fan-out scan over 4 groups and
    per-group watches that see their own group only."""
    def scenario(m):
        router = m["Router"](4, overrides=[m["Rule"](b"pin/", b"pin0", 2)])
        sc = m["Sharded"](m["Cfg"](**GEO), 3, 4, router=router, **m["kw"])
        sc.obs = m["Obs"]()
        m["reads"].attach(sc)
        hub = m["streams"].attach(sc)
        sc.place_leaders()
        for _ in range(4):
            sc.step()
        holders = sc.leases.holders()
        kvs = m["SKVS"](sc, cap=256)
        hub.kvs = kvs
        subs = [hub.subscribe(g) for g in range(4)]
        keys = ([b"user/%02d" % i for i in range(12)]
                + [b"pin/%02d" % i for i in range(4)])
        req = {}
        for k in keys:
            g = kvs.group_of(k)
            r = req[g] = req.get(g, 0) + 1
            kvs.groups[g].put(holders[g], k, b"V" + k, client_id=5,
                              req_id=r)
            for _ in range(5):
                sc.step()
        rows = serve_blocking(
            sc, lambda: hub.scan_all(prefix=b"user/", limit=5), 2000)
        pins = serve_blocking(
            sc, lambda: hub.scan_all(prefix=b"pin/", limit=8), 2000)
        caught_up(hub, range(4))
        evs = [[ev(e) for e in s.poll(max_n=256)] for s in subs]
        out = dict(owner={k: kvs.group_of(k) for k in keys}, rows=rows,
                   pins=pins, evs=evs,
                   folded=hub.scans.status()["folded"],
                   total=hub.watch.events_total,
                   pages=[sc.obs.metrics.get("scan_pages_total", group=g)
                          for g in range(4)])
        hub.fail_all("test done")
        return out
    t = both(scenario)
    assert len(set(t["owner"].values())) > 1
    assert [k for k, _ in t["rows"]] == sorted(b"user/%02d" % i
                                               for i in range(12))
    assert all(v == b"V" + k for k, v in t["rows"] + t["pins"])
    assert [k for k, _ in t["pins"]] == sorted(b"pin/%02d" % i
                                               for i in range(4))
    for g, evs in enumerate(t["evs"]):
        assert all(e[0] == g for e in evs)
        assert sorted(e[5] for e in evs) == sorted(
            k for k, o in t["owner"].items() if o == g)
    assert t["total"] == 16 and t["pages"][2] >= 1


# ---------------------------------------------------------------------------
# no output changes, decoupled drain, wiring
# ---------------------------------------------------------------------------

RES = ("term", "role", "commit", "end", "apply", "head", "accepted")


def test_outputs_equal_attached_and_detached():
    """The same workload on a plain port engine, a port engine with a
    hub (a watcher and a scan served while it steps) and the JAX engine
    with a hub: equal step outputs every step."""
    def run(m, attach):
        c = m["Sim"](m["Cfg"](**GEO), 3, **m["kw"])
        hub = None
        if attach:
            c.obs = m["Obs"]()
            m["reads"].attach(c)
            hub = m["streams"].attach(c)
        c.run_until_elected(0)
        kv = m["KVS"](c, cap=256)
        sub = hub.subscribe(0) if hub else None
        log = []
        for i in range(5):
            kv.put(0, b"k%d" % i, b"v%d" % i, client_id=3, req_id=i + 1)
            log.append({k: np.asarray(c.step()[k]).tolist() for k in RES})
        for _ in range(3):      # quiescent before the scan's own steps
            log.append({k: np.asarray(c.step()[k]).tolist() for k in RES})
        rows = None
        if hub is not None:
            rows = serve_blocking(c, lambda: hub.scan_all(prefix=b"k",
                                                          limit=2), 100)
        for _ in range(7):
            log.append({k: np.asarray(c.step()[k]).tolist() for k in RES})
        n = None
        if hub is not None:
            caught_up(hub)
            n = len(sub.poll(max_n=64))
            hub.fail_all("test done")
        return log, rows, n
    plain = run(SIDES["t"], False)
    att = run(SIDES["t"], True)
    jatt = run(SIDES["j"], True)
    assert att == jatt
    assert att[0] == plain[0]
    assert len(att[1]) == 5 and att[2] == 5


def test_wedged_watcher_does_not_delay_point_reads_matches_jax():
    def scenario(m):
        c, hub = cluster(m)
        c.run_until_elected(0)
        kv = m["KVS"](c, cap=256)
        hub.kvs = kv
        wedged = hub.subscribe(0, cap=2)
        for i in range(12):
            put_committed(c, kv, 0, b"k%02d" % i, b"v", i + 1)
        caught_up(hub)
        over = wedged.overflowed
        t = c.reads.submit(lambda: kv.serve_local(1, b"k00"), replica=1)
        steps = 0
        for _ in range(4):
            if t.done:
                break
            c.step()
            steps += 1
        out = dict(over=over, steps=steps, st=t.status, val=t.value,
                   backlog=hub.backlogs(),
                   gauge=c.obs.metrics.get("watch_backlog_entries",
                                           group=0))
        hub.fail_all("test done")
        out.update(closed=wedged.closed, reason=wedged.fail_reason,
                   remnant=len(wedged.poll(max_n=16)),
                   nxt=wedged.next(timeout=0.1))
        return out
    t = both(scenario)
    assert t["over"] and t["st"] == "ok" and t["val"] == b"v"
    assert t["steps"] <= 3 and t["backlog"] == [2]
    assert t["closed"] and t["reason"] == "test done"
    assert t["remnant"] == 2 and t["nxt"] is None


def driver_script(m, Driver, TO, wd=None):
    """A step-locked driver with the hub: elected by hand, a few KVS
    commands committed, its health document taken; then stopped with a
    watcher blocked in ``next()``."""
    d = Driver(m["Cfg"](**GEO), 3, timeout_cfg=TO(**TIMERS), audit=True,
               streams=True, workdir=wd, **m["kw"])
    try:
        hub = d.cluster.streams
        d._alert_period = 1e9
        d.runtimes[0].timer._deadline = 0.0
        d.step()
        kv = m["KVS"](d.cluster, cap=256)
        for i in range(4):
            kv.put(0, b"d%d" % i, b"v%d" % i, client_id=4, req_id=i + 1)
            d.step()
        d.step()
        caught_up(hub)
        h = d.health()
        sub = hub.subscribe(0, prefix=b"zz")
        box = {}
        th = threading.Thread(target=lambda: box.setdefault(
            "got", sub.next(timeout=30)))
        th.start()
        time.sleep(0.1)
    finally:
        d.stop()
    th.join(5)
    return d, h, hub, sub, box, th


def test_driver_streams_wiring_health_and_stop_match_jax(tmp_path):
    j = driver_script(SIDES["j"], JDriver, JTO, str(tmp_path / "j"))
    t = driver_script(SIDES["t"], ClusterDriver, TimeoutConfig,
                      str(tmp_path / "t"))
    (_, jh, jhub, _, _, _), (d, h, hub, sub, box, th) = j, t
    assert h["streams"] == jh["streams"]
    assert validate_cluster(h) == []
    assert h["streams"]["stopped"] is False
    assert h["streams"]["cdc"] == {"0": 4}
    assert hub.cdc is not None and hub.cdc.path == str(
        tmp_path / "t" / "cdc.jsonl")
    with open(hub.cdc.path) as f, open(jhub.cdc.path) as g:
        assert f.read() == g.read()
    assert not th.is_alive() and box["got"] is None
    assert sub.closed and sub.fail_reason == "stop"
    assert d.cluster.streams.status()["stopped"] is True
    d.stop()                                     # idempotent


def test_driver_streams_off_by_default_and_opts():
    d = ClusterDriver(LogConfig(**GEO), 3, device="cpu",
                      timeout_cfg=TimeoutConfig(**TIMERS))
    assert d.cluster.streams is None and d.streams is None
    assert d.health()["streams"] is None
    d.stop()
    d = ClusterDriver(LogConfig(**GEO), 3, device="cpu", streams=True,
                      streams_opts=dict(page_size=7, retain=99),
                      timeout_cfg=TimeoutConfig(**TIMERS))
    try:
        assert d.streams is d.cluster.streams
        assert d.streams.page_size == 7 and d.streams.cdc is None
        assert d.streams.watch.retain == 99
        assert d.streams.obs is d.obs
    finally:
        d.stop()


def test_governor_counts_watch_backlog_as_demand_matches_jax():
    def scenario(m):
        c, hub = cluster(m)
        gov = m["gov"].attach_governor(c, obs=c.obs)
        c.run_until_elected(0)
        kv = m["KVS"](c, cap=256)
        hub.subscribe(0, cap=1 << 16)      # deep, never-drained queue
        for i in range(6):
            put_committed(c, kv, 0, b"k%d" % i, b"v", i + 1)
        caught_up(hub)
        backlog = hub.backlogs()
        for _ in range(4):
            c.step()
        out = dict(backlog=backlog, evals=gov.status()["evals"])
        hub.fail_all("test done")
        return out
    t = both(scenario)
    assert t["backlog"] == [6] and t["evals"] > 0
