"""Port parity of the elastic topology plane and the ops console: the
port's ``topology/{transition,policy,chaos}.py``, ``attach_topology``,
``ReplicatedKVS.items_in_range``, the engine and driver wiring, and
``obs/console.py``/``obs/__main__.py``, on the CPU against the JAX
package's, with exact equality.

* the epoch machinery is one module shared by the coordinator and the
  controller;
* a split then a merge of a live key range (values intact, a post-split
  write moved back, leases revoked before each cutover and granted after
  it): the router, the epoch, the controller's status, every replica's
  table walk and the trace's topology and lease events equal the JAX
  run's;
* ``health()['topology']``, the router round trip and the console's
  ``TOPO`` column; ``fleet_view``/``render_table``, the bundle and the
  trace-plane CLI equal the reference's;
* topology attached (a whole split included) changes no step output;
* an in-flight transaction whose key moved aborts with reason
  ``topology``;
* the load policy: its stock rules' hysteresis, proposals, cooldown,
  governor veto and ``min_keys``;
* the topology nemesis, seed 0: the whole verdict equals JAX's;
* the sharded driver: the cutover hook fails the donor's waiters and
  unpins its connections, and a step-locked driver runs a split through
  its drained serial path as the JAX driver does."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rdma_paxos_tpu.config import LogConfig as JCfg
from rdma_paxos_tpu.config import TimeoutConfig as JTO
from rdma_paxos_tpu.obs import AlertEngine as JAlerts
from rdma_paxos_tpu.obs import Observability as JObs
from rdma_paxos_tpu.obs import console as jconsole
from rdma_paxos_tpu.runtime import reads as jreads
from rdma_paxos_tpu.runtime.sharded_driver import (
    ShardedClusterDriver as JSDriver)
from rdma_paxos_tpu.shard import ShardedCluster as JSharded
from rdma_paxos_tpu.shard.kvs import ShardedKVS as JSKVS
from rdma_paxos_tpu.shard.router import RangeRule as JRule
from rdma_paxos_tpu.topology import attach_topology as jattach
from rdma_paxos_tpu.topology import policy as jpolicy
from rdma_paxos_tpu.topology import transition as jtransition
from rdma_paxos_tpu.topology.chaos import run_topology_chaos as jchaos
from rdma_paxos_tpu.txn import attach_coordinator as jcoord
from rdma_paxos_tpu.txn.chaos import keys_for_groups as jkeys
from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
from rdma_paxos_tpu_torch.obs import AlertEngine, Observability
from rdma_paxos_tpu_torch.obs import console as tconsole
from rdma_paxos_tpu_torch.obs import trace as obs_trace
from rdma_paxos_tpu_torch.proxy.proxy import PendingEvent
from rdma_paxos_tpu_torch.runtime import reads as treads
from rdma_paxos_tpu_torch.runtime.sharded_driver import ShardedClusterDriver
from rdma_paxos_tpu_torch.shard import ShardedCluster
from rdma_paxos_tpu_torch.shard.kvs import ShardedKVS
from rdma_paxos_tpu_torch.shard.router import KeyRouter, RangeRule
from rdma_paxos_tpu_torch.topology import attach_topology
from rdma_paxos_tpu_torch.topology import epoch as tepoch
from rdma_paxos_tpu_torch.topology import policy as tpolicy
from rdma_paxos_tpu_torch.topology import transition as ttransition
from rdma_paxos_tpu_torch.topology.chaos import run_topology_chaos
from rdma_paxos_tpu_torch.txn import attach_coordinator
from rdma_paxos_tpu_torch.txn.chaos import keys_for_groups
from tests.test_torch_shard import writable_rebase
from tests.test_torch_sim import jax_step_cache_restored  # noqa: F401

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "router_map.json")

# the JAX topology tests' geometry
GEO = dict(n_slots=256, slot_bytes=128, window_slots=32, batch_slots=8)
TIMERS = dict(elec_timeout_low=1e9, elec_timeout_high=2e9)
RES = ("term", "role", "commit", "end", "apply", "head", "accepted")

SIDES = dict(
    j=dict(Sharded=JSharded, SKVS=JSKVS, Rule=JRule, Cfg=JCfg, Obs=JObs,
           reads=jreads, attach=jattach, keys=jkeys, coord=jcoord,
           policy=jpolicy, transition=jtransition, Alerts=JAlerts,
           console=jconsole, kw={}),
    t=dict(Sharded=ShardedCluster, SKVS=ShardedKVS, Rule=RangeRule,
           Cfg=LogConfig, Obs=Observability, reads=treads,
           attach=attach_topology, keys=keys_for_groups,
           coord=attach_coordinator, policy=tpolicy,
           transition=ttransition, Alerts=AlertEngine, console=tconsole,
           kw=dict(device="cpu")))


def both(scenario):
    """The scenario on both packages: equal results, returned."""
    j = scenario(SIDES["j"])
    t = scenario(SIDES["t"])
    assert t == j
    return t


def cluster(m, G=2, *, geo=GEO, txn=False, **opts):
    """Direct-stepped sharded cluster with obs, leases and topology."""
    shard = m["Sharded"](m["Cfg"](**geo), 3, G, txn=txn, **m["kw"])
    if not m["kw"]:
        writable_rebase(shard)
    obs = m["Obs"]()
    shard.obs = obs
    kv = m["SKVS"](shard, cap=256)
    m["reads"].attach(shard)
    opts.setdefault("cooldown_steps", 4)
    ctl = m["attach"](kv, obs=obs, **opts)
    shard.place_leaders()
    return shard, kv, ctl, obs


def run_window(shard, ctl, max_steps=300):
    """Step + drive until the transition window closes; the steps."""
    for n in range(max_steps):
        shard.step()
        ctl.drive()
        if not ctl.in_window():
            return n + 1
    raise AssertionError(f"transition window did not close: "
                         f"{ctl.status()}")


def seed_keys(m, shard, kv, per_group=6):
    keys = m["keys"](kv.router, per_group)
    for g, ks in enumerate(keys):
        for k in ks:
            kv.put(k, b"v0:" + k, leader=shard.leader_hint(g))
    for _ in range(4):
        shard.step()
    return keys


def tables(shard, kv):
    """Every replica's whole folded table, per group."""
    return [[kv.groups[g].items_in_range(r, b"", None)
             for r in range(shard.R)] for g in range(shard.G)]


def topo_events(obs):
    """The topology and lease events of the trace ring, in order."""
    return [(e.seq, e.kind, e.replica, e.fields) for e in obs.trace.events()
            if e.kind.startswith(("topology_", "lease_"))]


# ---------------------------------------------------------------------------
# the shared epoch machinery
# ---------------------------------------------------------------------------

def test_epoch_machinery_is_shared_and_equal():
    from rdma_paxos_tpu.topology import epoch as jepoch
    from rdma_paxos_tpu_torch.txn import coordinator as tcoord
    assert tcoord._epoch is tepoch and ttransition._epoch is tepoch
    assert tpolicy._epoch is tepoch
    for args in ((-1, 0, 100, 9), (5, 3, 6, 3), (5, 3, 6, 4), (5, 3, 4, 4),
                 (5, 3, 5, 3), (0, 1, 1, 1)):
        assert tepoch.placement_status(*args) == \
            jepoch.placement_status(*args), args
    assert ttransition.TopologyController.SEED_CLIENT_BASE == \
        jtransition.TopologyController.SEED_CLIENT_BASE
    for k in ("IDLE", "SEED", "FROZEN"):
        assert getattr(ttransition, k) == getattr(jtransition, k)
    for k in ("SPLIT_RULE", "MERGE_RULE"):
        assert getattr(tpolicy, k) == getattr(jpolicy, k)
    items = [(b"a", b"1"), (b"b\x00c", b""), (b"k" * 32, b"v" * 32)]
    assert ttransition.range_digest(items) == \
        jtransition.range_digest(items)


def test_router_post_split_golden_fixture():
    with open(GOLDEN) as f:
        doc = json.load(f)
    ps = doc["post_split"]
    live = KeyRouter.from_dict(doc["router"])
    assert live.install_rule(RangeRule.from_dict(ps["rule"])) == 1
    assert live.to_dict() == ps["router"]
    for key, g in ps["mapping"].items():
        assert live.group_of(key) == g, key
    assert live.remove_rule(RangeRule.from_dict(ps["rule"])) == 2
    assert live.to_dict()["overrides"] == doc["router"]["overrides"]


# ---------------------------------------------------------------------------
# split / merge end to end
# ---------------------------------------------------------------------------

def test_split_then_merge_matches_jax():
    def scenario(m):
        shard, kv, ctl, obs = cluster(m)
        keys = seed_keys(m, shard, kv)
        hot = sorted(keys[0])
        lo, hi = hot[len(hot) // 2], hot[-1] + b"\x00"
        moving = [k for k in hot if lo <= k < hi]
        out = dict(moving=moving, open=ctl.propose_split(lo, hi, 1),
                   again=ctl.propose_split(lo, hi, 1))
        out["split_steps"] = run_window(shard, ctl)
        rule = m["Rule"](lo, hi, 1)
        out.update(status1=ctl.status(), router1=kv.router.to_dict(),
                   cooling=ctl.cooling(),
                   refused=ctl.propose_merge(rule),
                   owners1=[kv.group_of(k) for k in hot],
                   vals1=[kv.get(k) for k in hot])
        kv.put(moving[0], b"v1", leader=shard.leader_hint(1))
        for _ in range(4):
            shard.step()
        out["post"] = kv.get(moving[0])
        out["tables1"] = tables(shard, kv)
        while ctl.cooling():
            shard.step()
        out["merge"] = ctl.propose_merge(rule)
        out["merge_steps"] = run_window(shard, ctl)
        out.update(status2=ctl.status(), router2=kv.router.to_dict(),
                   owners2=[kv.group_of(k) for k in hot],
                   vals2=[kv.get(k) for k in hot])
        for _ in range(8):
            shard.step()
        kv.get(moving[0], linearizable=True)
        out.update(tables2=tables(shard, kv), events=topo_events(obs),
                   health=shard.health()["topology"],
                   last={k: np.asarray(shard.last[k]).tolist()
                         for k in RES})
        return out
    t = both(scenario)
    assert t["open"] and not t["again"]
    s1, s2 = t["status1"], t["status2"]
    assert s1["phase"] == "idle" and s1["transitions_total"] == 1
    assert s1["epoch"] == 1 and t["router1"]["version"] == 1
    assert t["cooling"] and not t["refused"] and t["merge"]
    assert s2["transitions_total"] == 2 and s2["abandoned_total"] == 0
    assert t["router2"]["version"] == 2 and not t["router2"]["overrides"]
    n_moving = len(t["moving"])
    assert n_moving and t["owners1"] == [0] * (6 - n_moving) + [1] * n_moving
    assert t["post"] == b"v1"
    assert all(v is not None for v in t["vals1"] + t["vals2"])
    assert set(t["owners2"]) == {0}
    kinds = [e[1] for e in t["events"]]
    cuts = [e for e in t["events"] if e[1] == obs_trace.TOPOLOGY_CUTOVER]
    assert len(cuts) == 2
    for cut in cuts:
        for g in set(cut[3]["donors"]) | set(cut[3]["targets"]):
            assert any(e[1] == obs_trace.LEASE_REVOKED
                       and e[3].get("reason") == "topology_cutover"
                       and e[3].get("group") == g and e[0] < cut[0]
                       for e in t["events"]), (g, cut)
    assert any(e[1] == obs_trace.LEASE_GRANTED and e[0] > cuts[-1][0]
               for e in t["events"])
    assert kinds.index(obs_trace.TOPOLOGY_PROPOSED) < kinds.index(
        obs_trace.TOPOLOGY_SEEDED) < kinds.index(
        obs_trace.TOPOLOGY_FROZEN) < kinds.index(
        obs_trace.TOPOLOGY_VERIFIED) < kinds.index(
        obs_trace.TOPOLOGY_CUTOVER) < kinds.index(obs_trace.TOPOLOGY_DONE)


def test_proposal_refusals_and_would_block_gate():
    def scenario(m):
        shard, kv, ctl, obs = cluster(m)
        with pytest.raises(ValueError, match="rule not installed"):
            ctl.propose_merge(m["Rule"](b"a", b"b", 1))
        out = dict(block=ctl.would_block(b"anything"),
                   window=ctl.in_window(), frozen=ctl.frozen())
        keys = seed_keys(m, shard, kv, 4)
        hot = sorted(keys[0])
        ctl.propose_split(hot[0], hot[-1] + b"\x00", 1)
        blocked = []
        for _ in range(40):
            shard.step()
            ctl.drive()
            blocked.append((ctl.frozen(), ctl.would_block(hot[0]),
                            ctl.would_block(b"\xff")))
            if not ctl.in_window():
                break
        out["blocked"] = blocked
        return out
    t = both(scenario)
    assert not (t["block"] or t["window"] or t["frozen"])
    assert any(f and b and not o for f, b, o in t["blocked"])


# ---------------------------------------------------------------------------
# health, console, CLIs
# ---------------------------------------------------------------------------

def untooled(doc):
    """A merged timeline without its producer's package name (the one
    field where the two packages' timelines differ)."""
    doc = json.loads(json.dumps(doc))
    doc["otherData"].pop("tool")
    return doc


def test_health_console_after_split_match_jax():
    def scenario(m):
        shard, kv, ctl, obs = cluster(m)
        keys = seed_keys(m, shard, kv)
        hot = sorted(keys[0])
        ctl.propose_split(hot[len(hot) // 2], hot[-1] + b"\x00", 1)
        run_window(shard, ctl)
        h = shard.health()
        con = m["console"]
        rebuilt = KeyRouter.from_dict(h["router"])
        h2 = dict(h, ts=1.0)
        view = con.fleet_view([dict(src="local", health=h2)])
        view.pop("ts")
        for host in view["hosts"]:
            host.pop("age_s")
        return dict(
            health=h["topology"], router=h["router"],
            groups=[{k: v for k, v in g.items()
                     if k not in ("anchor", "ts", "ts_monotonic")}
                    for g in h["groups"]],
            owners=[[rebuilt.group_of(k) == kv.group_of(k) for k in ks]
                    for ks in keys],
            col=con._topo_state(h), empty=con._topo_state({}),
            live=con._topo_state(dict(topology=dict(
                epoch=0, transitions_total=0, phase="seed",
                direction="split"))),
            view=view, table=con.render_table(dict(view, ts=2.0)))
    t = both(scenario)
    assert all(all(o) for o in t["owners"])
    assert t["health"]["transitions_total"] == 1
    assert t["health"]["epoch"] == 1 and t["health"]["phase"] == "idle"
    assert t["col"] == "e1/1t" and t["empty"] == "-"
    assert t["live"] == "e0/0t split:seed"
    assert [r["topo"] for r in t["view"]["groups"]] == ["e1/1t", "-"]
    assert "TOPO" in t["table"] and "e1/1t" in t["table"]
    assert tconsole.ROLE_LEADER == jconsole.ROLE_LEADER
    for k in ("BUNDLE_SCHEMA", "BUNDLE_KIND", "REQUIRED_SECTIONS"):
        assert getattr(tconsole, k) == getattr(jconsole, k), k


def test_console_sources_bundle_and_trace_cli_match_jax(tmp_path):
    """The fleet view over a single-group driver document, a member
    snapshot and an unreachable file; a bundle assembled from a
    workdir, verified, tampered; ``python -m rdma_paxos_tpu_torch.obs``
    merge and blame over a span dump with a subsystem trace."""
    from rdma_paxos_tpu_torch.obs.tracectx import TraceContext
    wd = tmp_path / "wd"
    wd.mkdir()
    reps = [dict(replica=r, role=3 if r == 1 else 1, term=4, commit=9,
                 apply=9 - r) for r in range(3)]
    cluster_doc = dict(ts=1.0, leader=1, replicas=reps,
                       leases=dict(holders=[1]),
                       reads=dict(served={"lease": 5, "read_index": 2}),
                       repair=dict(active={}, repairs_done=1),
                       alerts={"leaderless": dict(firing=True,
                                                  severity="page",
                                                  value=1.0,
                                                  duration_s=3.0)})
    for r, rep in enumerate(reps):
        (wd / f"replica{r}.health.json").write_text(json.dumps(
            dict(rep, ts=1.0)))
    (wd / "cluster.health.json").write_text(json.dumps(cluster_doc))
    tc = TraceContext()
    tid = tc.begin("topology", group=1)
    tc.phase(tid, "seed")
    tc.phase(tid, "cutover")
    tc.end(tid, status="done")
    traces = dict(traces=tc.dump()["traces"], anchor=tc.dump()["anchor"])
    (wd / "traces.json").write_text(json.dumps(traces))
    spans = dict(spans=[], anchor=traces["anchor"])
    (wd / "spans.json").write_text(json.dumps(spans))
    (wd / "metrics.json").write_text(json.dumps({"counters": {"x": 1}}))
    (wd / "audit_dump.json").write_text(json.dumps({"groups": []}))
    (wd / "series.jsonl").write_text(json.dumps(
        {"name": "x", "samples": [[0, 1.0, 1]]}) + "\n")
    pats = [str(wd / "replica*.health.json"),
            str(wd / "cluster.health.json"), str(wd / "missing.json")]
    views = []
    for con in (tconsole, jconsole):
        v = con.fleet_view(con.load_health_files(pats))
        v.pop("ts")
        for h in v["hosts"]:
            h.pop("age_s", None)
        views.append(v)
    assert views[0] == views[1]
    assert len(views[0]["groups"]) == 2
    assert views[0]["alerts"][0]["name"] == "leaderless"
    docs = []
    for con in (tconsole, jconsole):
        doc = con.assemble_bundle(reason="test", workdir=str(wd))
        assert con.verify_bundle(doc) == []
        doc["sections"]["perfetto"] = untooled(doc["sections"]["perfetto"])
        docs.append({k: v for k, v in doc.items()
                     if k not in ("created", "anchor", "manifest")})
    assert docs[0] == docs[1]
    assert sorted(docs[0]["sections"]) == [
        "alerts", "audit", "health", "perfetto", "series", "spans",
        "telemetry", "traces"]
    out = str(tmp_path / "b.json")
    env = dict(os.environ, PYTHONPATH=ROOT)

    def cli(*args):
        return subprocess.run([sys.executable, "-m", *args],
                              capture_output=True, text=True, env=env,
                              cwd=ROOT, timeout=120)
    r = cli("rdma_paxos_tpu_torch.obs.console", "bundle", "--workdir",
            str(wd), "--out", out)
    assert r.returncode == 0, r.stderr
    r = cli("rdma_paxos_tpu_torch.obs.console", "bundle", "--verify", out)
    assert r.returncode == 0 and "bundle OK" in r.stdout
    doc = json.loads(open(out).read())
    doc["sections"]["telemetry"]["counters"]["x"] = 2
    bad = str(tmp_path / "bad.json")
    open(bad, "w").write(json.dumps(doc))
    r = cli("rdma_paxos_tpu_torch.obs.console", "bundle", "--verify", bad)
    assert r.returncode == 1 and "digest mismatch" in r.stdout
    r = cli("rdma_paxos_tpu_torch.obs.console", "--health",
            pats[1], "--once", "--strict")
    assert r.returncode == 1 and "TOPO" in r.stdout
    merged = str(tmp_path / "merged.json")
    r = cli("rdma_paxos_tpu_torch.obs", "merge", str(wd / "spans.json"),
            str(wd / "traces.json"), "-o", merged)
    assert r.returncode == 0, r.stderr
    from rdma_paxos_tpu.obs.tracectx import merge_timeline as jmerge
    assert untooled(json.loads(open(merged).read())) == untooled(
        jmerge([spans], [traces]))
    r = cli("rdma_paxos_tpu_torch.obs", "blame", str(wd / "spans.json"),
            str(wd / "traces.json"), "--json")
    assert r.returncode == 0, r.stderr
    from rdma_paxos_tpu.obs.tracectx import blame as jblame
    assert json.loads(r.stdout) == json.loads(json.dumps(
        jblame([spans], [traces])))


# ---------------------------------------------------------------------------
# no output changes
# ---------------------------------------------------------------------------

def test_outputs_equal_with_topology_attached():
    """The same workload on a plain port engine, a port engine with a
    controller and the JAX engine with one: equal step outputs, and the
    split window that follows (seeding included) equal to JAX's."""
    geo = dict(n_slots=64, slot_bytes=128, window_slots=8, batch_slots=4)

    def run(m, attach):
        shard = m["Sharded"](m["Cfg"](**geo), 3, 2, **m["kw"])
        kv = m["SKVS"](shard, cap=64)
        ctl = m["attach"](kv, cooldown_steps=2) if attach else None
        shard.place_leaders()
        keys = m["keys"](kv.router, 4)
        log = []
        for t in range(3):
            for g, ks in enumerate(keys):
                kv.put(ks[t], b"w%d" % t, leader=shard.leader_hint(g))
            res = shard.step()
            log.append({k: np.asarray(res[k]).tolist() for k in RES})
        res = shard.step()
        log.append({k: np.asarray(res[k]).tolist() for k in RES})
        if ctl is None:
            return log, None
        hot = sorted(keys[0])
        ctl.propose_split(hot[len(hot) // 2], hot[-1] + b"\x00", 1)
        steps = run_window(shard, ctl)
        return log, (steps, ctl.transitions_total,
                     {k: np.asarray(shard.last[k]).tolist() for k in RES},
                     tables(shard, kv))
    plain = run(SIDES["t"], False)
    att = run(SIDES["t"], True)
    jatt = run(SIDES["j"], True)
    assert att == jatt
    assert att[0] == plain[0]
    assert att[1][1] == 1


# ---------------------------------------------------------------------------
# txn integration
# ---------------------------------------------------------------------------

def test_inflight_txn_aborts_when_mapping_moves_matches_jax():
    def scenario(m):
        shard, kv, ctl, obs = cluster(m, txn=True)
        m["coord"](kv)
        keys = m["keys"](kv.router, 4)
        h = kv.transact([("put", keys[0][3], b"w"),
                         ("put", keys[1][3], b"w")])
        for _ in range(6):
            if h.done:
                break
            shard.step()
        warm = h.committed
        ka, kb = keys[0][0], keys[1][0]
        h = kv.transact([("put", ka, b"A"), ("put", kb, b"B")])
        kv.router.install_rule(m["Rule"](ka, ka + b"\x00", 1))
        for _ in range(8):
            if h.done:
                break
            shard.step()
        shard.step()
        m_ = shard.obs.metrics.snapshot()["counters"]
        return dict(warm=warm, done=h.done, committed=h.committed,
                    reason=h.abort_reason, a=kv.get(ka), b=kv.get(kb),
                    aborted=m_.get("txn_aborted_total{reason=topology}"))
    t = both(scenario)
    assert t["warm"] and t["done"] and not t["committed"]
    assert t["reason"] == "topology" and t["aborted"] == 1
    assert t["a"] is None and t["b"] is None


# ---------------------------------------------------------------------------
# the load policy
# ---------------------------------------------------------------------------

def test_policy_stock_rules_hysteresis_matches_jax():
    def scenario(m):
        obs = m["Obs"]()
        pol = m["policy"].TopologyPolicy(skew_ratio=2.0, cold_ratio=0.5,
                                         for_evals=3)
        engine = m["Alerts"](obs.metrics, rules=pol.stock_rules())
        fired = []
        engine.add_hook(lambda name, sev: fired.append(name))
        script = [("topology_skew", 3.0), ("topology_override_load", 4.0),
                  None, None, None, None, ("topology_skew", 1.0), None,
                  ("topology_skew", 3.0), None, None, None,
                  ("topology_override_load", 0.2), None, None, None]
        marks = []
        for s in script:
            if s is None:
                engine.evaluate()
                marks.append(list(fired))
            else:
                obs.metrics.set(*s)
        return dict(rules=pol.stock_rules(), marks=marks)
    t = both(scenario)
    assert t["marks"][1] == [] and t["marks"][2] == ["topology_group_skew"]
    assert t["marks"][-1][-1] == "topology_group_cold"
    assert t["marks"][-1].count("topology_group_skew") == 2


def test_policy_proposes_split_cooldown_and_veto_matches_jax():
    def scenario(m):
        pol = m["policy"].TopologyPolicy(window=8, skew_ratio=1.5,
                                         for_evals=2, cooldown_evals=6,
                                         min_keys=2)
        shard, kv, ctl, obs = cluster(m, policy=pol)
        keys = m["keys"](kv.router, 6)
        for t in range(10):
            for k in keys[0]:
                kv.put(k, b"s%d" % t, leader=shard.leader_hint(0))
            shard.step()
        out = dict(st0=pol.status(), gauges=obs.metrics.snapshot()[
            "gauges"])
        pol.on_alert(m["policy"].SPLIT_RULE, "warn")
        out.update(p1=pol.proposals, st1=ctl.status())
        run_window(shard, ctl)
        out["st2"] = pol.status()
        pol.on_alert(m["policy"].SPLIT_RULE, "warn")
        out["p2"] = pol.proposals
        for _ in range(8):
            shard.step()
        shard.governor = SimpleNamespace(
            decision=SimpleNamespace(shed=True))
        pol.on_alert(m["policy"].SPLIT_RULE, "warn")
        out.update(p3=pol.proposals, vetoes=pol.vetoes)
        shard.governor = None
        kv.router.install_rule(m["Rule"](b"\x00op", b"\x00oq", 1))
        with pol._lock:
            pol._mine = []
        pol.on_alert(m["policy"].MERGE_RULE, "warn")
        out.update(p4=pol.proposals, window=ctl.in_window(),
                   st3=pol.status(), tables=tables(shard, kv))
        return out
    t = both(scenario)
    assert t["st0"]["shares"][0] > 0.9
    assert t["gauges"]["topology_skew"] > 1.5
    assert t["p1"] == 1 and t["st1"]["direction"] == "split"
    assert t["st1"]["rule"]["group"] == 1 and t["st2"]["rules"]
    assert t["p2"] == 1 and t["p3"] == 1 and t["vetoes"] == 1
    assert t["p4"] == 1 and not t["window"]


def test_policy_median_range_needs_min_keys_matches_jax():
    def scenario(m):
        pol = m["policy"].TopologyPolicy(min_keys=4)
        shard, kv, ctl, obs = cluster(m, policy=pol)
        keys = m["keys"](kv.router, 2)
        for k in keys[0]:
            kv.put(k, b"x", leader=shard.leader_hint(0))
        for _ in range(4):
            shard.step()
        rng = pol._median_range(0)
        pol.on_alert(m["policy"].SPLIT_RULE, "warn")
        return dict(rng=rng, p=pol.proposals, window=ctl.in_window())
    t = both(scenario)
    assert t == dict(rng=None, p=0, window=False)


def test_attach_topology_wires_policy_into_alerts():
    shard = ShardedCluster(LogConfig(**GEO), 3, 2, device="cpu")
    obs = Observability()
    eng = AlertEngine(obs.metrics, rules=[])
    ctl = attach_topology(ShardedKVS(shard, cap=64), obs=obs, policy=True,
                          alerts=eng)
    assert shard.topology is ctl and ctl.policy.ctl is ctl
    assert [r["name"] for r in eng.rules] == [tpolicy.SPLIT_RULE,
                                              tpolicy.MERGE_RULE]
    attach_topology(ShardedKVS(shard, cap=64), obs=obs, policy=True,
                    alerts=eng)
    assert len(eng.rules) == 2          # registered once
    assert ctl.status()["policy"]["evals"] == 0


# ---------------------------------------------------------------------------
# the topology nemesis
# ---------------------------------------------------------------------------

def test_topology_nemesis_verdict_matches_jax():
    jv = jchaos(seed=0)
    tv = run_topology_chaos(seed=0, device="cpu")
    assert tv == jv
    assert tv["ok"], tv
    assert tv["lease_fence"]["ok"] and tv["lease_fence"]["cutovers"] == 2
    assert tv["topology"]["transitions"] == 2
    assert tv["topology"]["abandoned"] == 0
    assert tv["linearizability"]["ops"] > 200
    assert tv["new_leader"] != tv["crashed_leader"]


# ---------------------------------------------------------------------------
# the sharded driver
# ---------------------------------------------------------------------------

def test_sharded_driver_cutover_fails_donor_waiters():
    d = ShardedClusterDriver(LogConfig(**GEO), 3, 2, device="cpu",
                             timeout_cfg=TimeoutConfig(**TIMERS))
    try:
        assert d.cluster._on_topology_cutover == d._on_topology_cutover
        evs = {}
        with d._lock:
            for g in range(2):
                ev = PendingEvent(3, 11 + g, b"")
                d._inflight_g[0][g].append((ev, 0))
                evs[g] = ev
            d._conn_group.update({11: 0, 12: 1, 13: 0})
        d._on_topology_cutover([0], [1])
        assert evs[0].status == -1 and evs[0].done.is_set()
        assert not evs[1].done.is_set()
        assert d._conn_group == {12: 1}
        assert d.obs.metrics.get("inflight_failed_total", replica=0) == 1
        failed = d.obs.trace.events(obs_trace.INFLIGHT_FAILED)
        assert failed[-1].fields["site"] == "topology cutover"
    finally:
        d.stop()


def test_sharded_driver_split_matches_jax():
    """A step-locked ``ShardedClusterDriver`` with a controller: a
    split proposed after seeding runs through the driver's drained
    serial path (``_drain_admin``), pipelining held while the window is
    open; router, steps, health and tables equal the JAX driver's."""
    def scenario(m, Driver, TO):
        d = Driver(m["Cfg"](**GEO), 3, 2, timeout_cfg=TO(**TIMERS),
                   group_timer_lo=1, group_timer_hi=2, pipeline=2,
                   **m["kw"])
        try:
            if not m["kw"]:
                writable_rebase(d.cluster)
            d._alert_period = 1e9
            kv = m["SKVS"](d.cluster, cap=256)
            ctl = m["attach"](kv, obs=d.obs, cooldown_steps=4)
            for _ in range(20):
                d.step()
                if all(v >= 0 for v in d.leaders()):
                    break
            keys = m["keys"](kv.router, 6)
            for g, ks in enumerate(keys):
                for k in ks:
                    kv.put(k, b"d:" + k, leader=d.cluster.leader_hint(g))
            for _ in range(4):
                d.step()
            hot = sorted(keys[0])
            assert ctl.propose_split(hot[3], hot[-1] + b"\x00", 1)
            held, n = [], 0
            while ctl.in_window() and n < 200:
                held.append(d._pipeline_ready())
                d.step()
                n += 1
            while ctl.cooling():
                d.step()
            h = d.health()
            return dict(n=n, held=held, router=h["router"],
                        topo=h["topology"], busy=d._busy(),
                        vals=[kv.get(k) for k in hot],
                        owners=[kv.group_of(k) for k in hot],
                        tables=tables(d.cluster, kv))
        finally:
            d.stop()
    j = scenario(SIDES["j"], JSDriver, JTO)
    t = scenario(SIDES["t"], ShardedClusterDriver, TimeoutConfig)
    assert t == j
    assert t["topo"]["transitions_total"] == 1 and not any(t["held"])
    assert t["owners"][3:] == [1] * 3 and not t["busy"]
    assert t["vals"] == [b"d:" + k for k in sorted(
        keys_for_groups(KeyRouter(2), 6)[0])]
