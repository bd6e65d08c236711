"""Port parity of the alert and health plane: the port's ``obs/alerts.py``,
``obs/series.py``, ``obs/health.py``, ``obs/export.py`` and
``obs/tracectx.py`` on the CPU against the JAX package's, with exact
equality.

* the same registry mutations, sampled with injected ``step`` and
  ``wall`` stamps, give equal series points, window deltas and rates,
  JSONL merges, alert transitions, hook calls and rule state (the
  wall-clock ``since``/``duration_s`` removed) — the default rules'
  burn-rate pager included;
* health documents equal with their stamps removed, and passing
  ``validate_cluster``, from both packages' drivers step-locked;
* Prometheus rendering (exemplar tails included) and the exporter's
  endpoints on an ephemeral localhost port;
* the trace plane: ``TraceContext`` dumps, ``blame`` and the merged
  timeline under a scripted clock, transaction traces recorded through
  the port's ``tracectx`` as in the JAX coordinator, and step outputs
  identical with tracing on or off."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from rdma_paxos_tpu.config import LogConfig as JCfg, TimeoutConfig as JTO
from rdma_paxos_tpu.obs import Observability as JObs
from rdma_paxos_tpu.obs import alerts as jalerts
from rdma_paxos_tpu.obs import export as jexport
from rdma_paxos_tpu.obs import health as jhealth
from rdma_paxos_tpu.obs import metrics as jmetrics
from rdma_paxos_tpu.obs import series as jseries
from rdma_paxos_tpu.obs import spans as jspans
from rdma_paxos_tpu.obs import tracectx as jtracectx
from rdma_paxos_tpu.runtime.driver import ClusterDriver as JDriver
from rdma_paxos_tpu.runtime.sharded_driver import (
    ShardedClusterDriver as JShardedDriver)
from rdma_paxos_tpu.shard.cluster import ShardedCluster as JSharded
from rdma_paxos_tpu.shard.kvs import ShardedKVS as JKVS
from rdma_paxos_tpu.txn import attach_coordinator as jattach
from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
from rdma_paxos_tpu_torch.obs import Observability
from rdma_paxos_tpu_torch.obs import alerts as talerts
from rdma_paxos_tpu_torch.obs import export as texport
from rdma_paxos_tpu_torch.obs import health as thealth
from rdma_paxos_tpu_torch.obs import metrics as tmetrics
from rdma_paxos_tpu_torch.obs import series as tseries
from rdma_paxos_tpu_torch.obs import spans as tspans
from rdma_paxos_tpu_torch.obs import tracectx as ttracectx
from rdma_paxos_tpu_torch.runtime import driver as tdriver
from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver
from rdma_paxos_tpu_torch.runtime.sharded_driver import ShardedClusterDriver
from rdma_paxos_tpu_torch.runtime.sim import PHASE_FINISH_RULES
from rdma_paxos_tpu_torch.shard.cluster import ShardedCluster
from rdma_paxos_tpu_torch.shard.kvs import ShardedKVS
from rdma_paxos_tpu_torch.txn import attach_coordinator
from rdma_paxos_tpu_torch.txn.chaos import keys_for_groups
from tests.test_torch_sim import jax_step_cache_restored  # noqa: F401

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

GEO = dict(n_slots=64, slot_bytes=32, window_slots=16, batch_slots=8)
TXN_GEO = dict(n_slots=128, slot_bytes=128, window_slots=16,
               batch_slots=4)
TIMERS = dict(elec_timeout_low=1e9, elec_timeout_high=2e9)
# a fixed anchor makes two packages' dumps comparable: no wall clock
# leaks into the documents
ANCHOR = {"monotonic": 0.0, "wall": 1000.0}
# wall-clock stamps a health document or alert state carries (and the
# store's fdatasync count, which follows the wall-clock sync cadence)
STAMPS = ("ts", "ts_monotonic", "anchor", "since", "duration_s",
          "syncs")

PKGS = dict(
    j=dict(alerts=jalerts, series=jseries, metrics=jmetrics,
           health=jhealth, export=jexport, spans=jspans,
           tracectx=jtracectx),
    t=dict(alerts=talerts, series=tseries, metrics=tmetrics,
           health=thealth, export=texport, spans=tspans,
           tracectx=ttracectx))


def strip(doc):
    """``doc`` with every wall-clock stamp removed, recursively."""
    if isinstance(doc, dict):
        return {k: strip(v) for k, v in doc.items() if k not in STAMPS}
    if isinstance(doc, (list, tuple)):
        return [strip(v) for v in doc]
    return doc


def scripted_clock(step_s: float = 0.001):
    t = [0.0]

    def clock():
        t[0] += step_s
        return round(t[0], 6)
    return clock


# ---------------------------------------------------------------------------
# series and alerts under injected step and wall stamps
# ---------------------------------------------------------------------------

def _mutate(reg, i, rng_vals):
    """One tick of registry traffic, the same on both packages."""
    reg.inc("ops_total", int(rng_vals[0]), replica=i % 3)
    reg.inc("audit_divergence_total", 1 if i == 11 else 0)
    reg.set("cluster_leader", -1 if 4 <= i < 12 else 0)
    reg.set("device_log_headroom", int(rng_vals[1]), replica=i % 3)
    reg.inc("rebase_stalled", 1 if i in (7, 8) else 0)
    reg.inc("device_elections_started_total",
            6 if 14 <= i < 18 else 0, replica=1)
    for v in rng_vals[2:]:
        reg.observe("commit_latency_seconds", float(v) / 1000.0,
                    buckets=jmetrics.LATENCY_BUCKETS_S, replica=0)


def _alert_run(side):
    m = PKGS[side]
    reg = m["metrics"].MetricsRegistry()
    store = m["series"].TimeSeriesStore(capacity=32)
    rules = m["alerts"].default_rules(leaderless_evals=3,
                                      log_headroom_floor=40) + [
        dict(name="hot_ops", severity="warn", kind="rate_window",
             metric="ops_total", window_s=10.0, threshold=6.0)]
    eng = m["alerts"].AlertEngine(reg, rules=rules, series=store)
    calls = []
    eng.add_hook(lambda name, sev: calls.append((name, sev)))
    eng.add_rule(dict(name="p99_hot", severity="warn",
                      kind="hist_quantile",
                      metric="commit_latency_seconds", q=0.99, op=">",
                      threshold=0.05, for_evals=2))
    rng = np.random.default_rng(5)
    vals = rng.integers(1, 200, size=(30, 6))
    out = []
    for i in range(30):
        _mutate(reg, i, vals[i])
        store.sample(reg.snapshot(), step=i, wall=100.0 + 2.5 * i)
        tr = eng.evaluate()
        out.append(dict(tr=tr, state=strip(eng.state()),
                        firing=eng.firing(),
                        pages=eng.firing(severity="page")))
    pts = {k: store.points(k) for k in store.names()}
    windows = {k: (store.window_delta(k, wall_s=10.0),
                   store.window_rate(k, wall_s=10.0),
                   store.window_delta(k, steps=4))
               for k in store.names()}
    return dict(out=out, calls=calls, pts=pts, windows=windows,
                doc=strip(store.to_dict()),
                gauges={k: v for k, v in reg.snapshot()["gauges"].items()
                        if k.startswith("alert_firing")})


def test_alert_transitions_hooks_and_series_match_jax():
    j, t = _alert_run("j"), _alert_run("t")
    assert t["out"] == j["out"]
    assert t["calls"] == j["calls"]
    assert t["pts"] == j["pts"]
    assert t["windows"] == j["windows"]
    assert t["doc"] == j["doc"]
    assert t["gauges"] == j["gauges"]
    fired = {n for o in t["out"] for n in o["tr"]["fired"]}
    # the script crosses each kind: latched, gauge hysteresis, counter
    # and window rates, a min-aggregated gauge, a quantile
    assert {"digest_divergence", "leaderless", "rebase_stalled",
            "election_storm", "log_headroom_low", "hot_ops"} <= fired
    assert ("digest_divergence", "page") in t["calls"]


def test_default_rule_names_and_kinds_match_jax():
    assert talerts.default_rules() == jalerts.default_rules()
    assert talerts.KINDS == jalerts.KINDS
    assert (talerts.PAGE, talerts.WARN) == (jalerts.PAGE, jalerts.WARN)
    for bad in (dict(name="x", kind="rate_window", metric="m",
                     threshold=1),
                dict(name="x", kind="burn_rate", metric="m", bound=0.1),
                dict(name="x", kind="nope", metric="m")):
        errs = []
        for m in (jalerts, talerts):
            with pytest.raises(ValueError) as ei:
                m.AlertEngine(jmetrics.MetricsRegistry(), rules=[bad])
            errs.append(str(ei.value))
        assert errs[0] == errs[1]


def _burn_run(side):
    m = PKGS[side]
    reg = m["metrics"].MetricsRegistry()
    store = m["series"].TimeSeriesStore(capacity=256)
    eng = m["alerts"].AlertEngine(reg, rules=m["alerts"].default_rules(),
                                  series=store)
    w = [1000.0]
    trs, vals = [], []

    def drive(n, latency, per=20):
        for _ in range(n):
            for _ in range(per):
                reg.observe("commit_latency_seconds", latency,
                            buckets=m["metrics"].LATENCY_BUCKETS_S,
                            replica=0)
            store.sample(reg.snapshot(), step=store.samples, wall=w[0])
            w[0] += 5.0
            trs.append(eng.evaluate())
            vals.append(eng.state()["commit_latency_slo_burn"]["value"])
    drive(10, 0.01)
    drive(70, 2.0)
    drive(140, 0.01, per=60)
    return trs, vals


def test_burn_rate_pager_fires_and_resolves_as_jax():
    """The scripted latency regression through the DEFAULT
    ``commit_latency_slo_burn`` rule: the same evaluation fires, the
    same one resolves, with equal burn values at every evaluation."""
    (jt, jv), (tt, tv) = _burn_run("j"), _burn_run("t")
    assert tt == jt and tv == jv
    fired = [i for i, o in enumerate(tt)
             if "commit_latency_slo_burn" in o["fired"]]
    resolved = [i for i, o in enumerate(tt)
                if "commit_latency_slo_burn" in o["resolved"]]
    assert fired and resolved and resolved[0] > fired[0]


def test_series_jsonl_concat_merge_matches_jax(tmp_path):
    docs = {}
    for side in ("j", "t"):
        m = PKGS[side]
        paths = []
        for src in ("a", "b"):
            reg = m["metrics"].MetricsRegistry()
            path = str(tmp_path / f"{side}{src}.jsonl")
            store = m["series"].TimeSeriesStore(capacity=8, path=path,
                                                source=src)
            for i in range(5):
                reg.inc("c", i + 1, replica=0)
                reg.observe("lat", 0.001 * (i + 1),
                            buckets=m["metrics"].LATENCY_BUCKETS_S)
                store.sample(reg.snapshot(), step=i, wall=10.0 + i)
            store.close()
            paths.append(path)
        cat = str(tmp_path / f"{side}.jsonl")
        with open(cat, "w") as out:
            for p in paths:
                out.write(open(p).read())
        lines = m["series"].read_jsonl(cat)
        docs[side] = (strip(lines), strip(m["series"].merge_docs(lines)))
    assert docs["t"] == docs["j"]
    assert tseries.split_series_key("lat{replica=0}|le|0.01") == \
        jseries.split_series_key("lat{replica=0}|le|0.01")


# ---------------------------------------------------------------------------
# health documents
# ---------------------------------------------------------------------------

def test_health_schema_and_reporter_match_jax(tmp_path):
    assert thealth.HEALTH_FIELDS == jhealth.HEALTH_FIELDS
    assert thealth.CLUSTER_HEALTH_FIELDS == jhealth.CLUSTER_HEALTH_FIELDS
    fields = dict(replica=1, role=2, term=3, leader_id=1, commit=9,
                  apply=9, end=10, head=0, log_headroom=5, inflight=0)
    for m in (jhealth, thealth):
        snap = m.make_snapshot(**fields)
        assert m.validate(snap) == []
        assert m.validate({"replica": 0}) == jhealth.validate(
            {"replica": 0})
        assert m.validate_cluster(dict(leader=0, ts=1.0)) == \
            jhealth.validate_cluster(dict(leader=0, ts=1.0))
    files = {}
    for side, m in (("j", jhealth), ("t", thealth)):
        wd = tmp_path / side
        wd.mkdir()
        rep = m.HealthReporter(str(wd), period=0.0)
        assert rep.due()
        rep.write({r: m.make_snapshot(**dict(fields, replica=r))
                   for r in range(3)})
        rep.write_cluster(m.make_cluster_snapshot(leader=1, n_replicas=3))
        files[side] = (strip([rep.read(r) for r in range(3)]),
                       strip(json.load(open(rep.cluster_path()))),
                       sorted(p.name for p in wd.iterdir()))
    assert files["t"] == files["j"]


def _driver_script(d):
    d.runtimes[0].timer._deadline = 0.0
    d.step()
    for i in range(6):
        d.cluster.submit(0, b"v%d" % i)
        d.step()
    return d


def test_driver_health_alerts_and_series_match_jax(tmp_path):
    """Both packages' drivers, step-locked through an election and six
    puts: equal alert transitions from ``evaluate_alerts`` (the series
    sampled first at the driver's step), equal ``health()`` documents
    with the stamps removed, each passing ``validate_cluster``, and the
    cadenced health files written under the workdir."""
    kw = dict(pipeline=0, health_period=0.0, audit=True)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jd = JDriver(JCfg(**GEO), 3, timeout_cfg=JTO(**TIMERS),
                 workdir=str(tmp_path / "j"), **kw)
    td = ClusterDriver(LogConfig(**GEO), 3,
                       timeout_cfg=TimeoutConfig(**TIMERS),
                       workdir=str(tmp_path / "t"), device="cpu", **kw)
    try:
        for d in (jd, td):
            # the cadence is wall-clock: past the first step's pass,
            # evaluate explicitly
            d._alert_period = 1e9
            _driver_script(d)
        jo, to = jd.evaluate_alerts(), td.evaluate_alerts()
        assert to == jo
        jh, th = jd.health(), td.health()
        assert thealth.validate_cluster(th) == []
        assert strip(json.loads(json.dumps(th))) == strip(
            json.loads(json.dumps(jh)))
        for rep in th["replicas"]:
            assert thealth.validate(rep) == []
        assert th["leader"] == 0 and th["audit"]["findings"] == 0
        assert th["repair"] is None and th["governor"] is None
        assert "commit_latency_slo_burn" in th["alerts"]
        names = sorted(p.name for p in (tmp_path / "t").iterdir()
                       if "health" in p.name)
        assert names == sorted(p.name for p in (tmp_path / "j").iterdir()
                               if "health" in p.name)
        assert "cluster.health.json" in names
        js, ts = jd.series.to_dict(), td.series.to_dict()
        assert ts["samples"] == js["samples"] == 2
        # the port's driver times the phases of its threads beyond the
        # JAX package's, counts its steps by how they ran (replayed from
        # a CUDA graph, or eager and why), and keeps no
        # timer_device_step_us histogram
        port_phases = {getattr(tdriver, k) for k in vars(tdriver)
                       if k.startswith("PHASE_")} | {PHASE_FINISH_RULES}

        def port_only(key):
            return (key.startswith("step_phase_us{phase=")
                    and key[20:].split(",")[0] in port_phases
                    or key.startswith(("step_eager_total{",
                                       "step_graph_replays_total{")))
        assert any(port_only(k) for k in ts["series"])
        assert sorted(k for k in ts["series"] if not port_only(k)) == \
            sorted(k for k in js["series"]
                   if not k.startswith("timer_device_step_us{"))
    finally:
        jd.stop()
        td.stop()


def test_sharded_driver_health_matches_jax():
    jd = JShardedDriver(JCfg(**GEO), 3, 2, timeout_cfg=JTO(**TIMERS),
                        group_timer_lo=1, group_timer_hi=2)
    td = ShardedClusterDriver(LogConfig(**GEO), 3, 2,
                              timeout_cfg=TimeoutConfig(**TIMERS),
                              group_timer_lo=1, group_timer_hi=2,
                              device="cpu")
    try:
        for _ in range(12):
            jd.step()
            td.step()
        assert td.leaders() == jd.leaders()
        jh, th = jd.health(), td.health()
        assert thealth.validate_cluster(th) == []
        jdoc = strip(json.loads(json.dumps(jh)))
        tdoc = strip(json.loads(json.dumps(th)))
        # the JAX engine names its mesh layout; both run the vmap
        # ("sim") engine here
        assert tdoc == jdoc
        assert len(th["groups"]) == 2 and all(v >= 0
                                              for v in th["leaders"])
        assert tdoc["router"] == jdoc["router"]
    finally:
        jd.stop()
        td.stop()


# ---------------------------------------------------------------------------
# exposition
# ---------------------------------------------------------------------------

def _reg_with_exemplars(m):
    reg = m["metrics"].MetricsRegistry()
    reg.inc("ops_total", 3, replica=0)
    reg.set("role", 1, replica=2)
    for i, v in enumerate((0.01, 0.01, 2.0)):
        reg.observe("lat_seconds", v, buckets=(0.1, 1.0),
                    exemplar=m["spans"].span_trace_id(3, i + 1))
    reg.observe("plain_seconds", 0.2)
    return reg


def test_render_prometheus_matches_jax():
    texts = [PKGS[s]["export"].render_prometheus(
        _reg_with_exemplars(PKGS[s]).snapshot()) for s in ("j", "t")]
    assert texts[1] == texts[0]
    assert 'lat_seconds_bucket{le="+Inf"} 3' in texts[1]
    assert ' # {trace_id="c3/r' in texts[1]


def _get(url):
    with urllib.request.urlopen(url, timeout=10.0) as r:
        return r.status, r.read()


def test_exporter_endpoints_on_an_ephemeral_port():
    reg = tmetrics.MetricsRegistry()
    reg.inc("c", 7)
    store = tseries.TimeSeriesStore(capacity=8)
    store.sample(reg.snapshot(), step=0, wall=1.0)
    eng = talerts.AlertEngine(reg, rules=talerts.default_rules(),
                              series=store)
    eng.evaluate()
    health = {"leader": 0, "loop_error": None}
    exp = texport.OpsExporter(registry=reg, health_fn=lambda: dict(health),
                              alerts=eng, series=store, port=0).start()
    try:
        assert exp.port > 0 and exp.url.startswith("http://127.0.0.1:")
        st, body = _get(exp.url + "/metrics")
        assert st == 200 and b"c 7" in body
        assert json.loads(_get(exp.url + "/metrics.json")[1])[
            "counters"]["c"] == 7
        assert json.loads(_get(exp.url + "/healthz")[1])["leader"] == 0
        assert json.loads(_get(exp.url + "/series")[1])["samples"] == 1
        assert "leaderless" in json.loads(
            _get(exp.url + "/alerts")[1])["state"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(exp.url + "/nope")
        assert ei.value.code == 404
        health["loop_error"] = "RuntimeError('boom')"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(exp.url + "/healthz")
        assert ei.value.code == 503
    finally:
        exp.close()


# ---------------------------------------------------------------------------
# the trace plane
# ---------------------------------------------------------------------------

def _trace_script(m):
    tc = m["tracectx"].TraceContext(capacity=4, clock=scripted_clock())
    a = tc.begin("txn", groups=[0, 1])
    b = tc.begin("txn")
    w = tc.begin("topology", direction="split")
    tc.phase(a, "lock_wait")
    tc.phase(a, "prepare")
    tc.phase(a, "prepare", once=True)
    tc.link(a, 7, 3, 0)
    tc.annotate(a, reason="conflict")
    tc.set_parent(a, w)
    tc.end(a, status="aborted")
    tc.end(b, status="committed")
    for _ in range(4):
        tc.begin("watch")                  # evicts the oldest open
    n = tc.fail_open()
    return tc, dict(ids=(a, b, w), counts=tc.counts(), n=n,
                    dump=tc.dump(anchor=ANCHOR), get=tc.get(a))


def test_tracectx_lifecycle_matches_jax():
    (_, j), (_, t) = (_trace_script(PKGS[s]) for s in ("j", "t"))
    assert t == j
    assert t["ids"] == ("txn-0", "txn-1", "topology-0")
    assert t["counts"]["dropped"] == 1


def _synthetic_pair(m):
    rec = m["spans"].SpanRecorder(sample_every=1, clock=scripted_clock())
    rec.begin(7, 1, 0)
    rec.stamp_append(7, 1, term=3, index=5, leader=0, replicas=(0, 1))
    rec.commit_advance(0, 6)
    rec.apply_advance(0, 6)
    rec.commit_advance(1, 6)
    rec.apply_advance(1, 6)
    rec.ack_release(0, 1)
    tc = m["tracectx"].TraceContext(clock=scripted_clock())
    t = tc.begin("txn", ts=0.0)
    tc.phase(t, "lock_wait", ts=0.0005)
    tc.phase(t, "prepare", ts=0.0505)
    tc.link(t, 7, 1, 0)
    tc.end(t, status="committed", ts=0.06)
    w = tc.begin("topology", ts=0.0, direction="split")
    tc.phase(w, "freeze", ts=0.001)
    tc.phase(w, "cutover", ts=0.004)
    tc.end(w, ts=0.005)
    return rec.dump(anchor=ANCHOR), tc.dump(anchor=ANCHOR)


def test_blame_and_merged_timeline_match_jax():
    out = {}
    for s in ("j", "t"):
        m = PKGS[s]
        sd, td = _synthetic_pair(m)
        doc = m["tracectx"].blame([sd], [td])
        tl = m["tracectx"].merge_timeline([sd], [td])
        tl["otherData"].pop("tool")        # names the package
        out[s] = (sd, td, doc, m["tracectx"].format_blame(doc),
                  m["tracectx"].blame_summary(doc), tl)
    assert out["t"] == out["j"]
    doc = out["t"][2]
    assert all(doc["percentiles"][p]["dominant"] == "txn_lock"
               for p in ("p50", "p95", "p99"))
    assert out["t"][5]["otherData"]["traces"] == 2
    assert ttracectx.BLAME_PHASES == jtracectx.BLAME_PHASES
    assert ttracectx.SUBSYS_PIDS == jtracectx.SUBSYS_PIDS


def test_active_tracer_follows_the_span_switch():
    for obs_cls, m in ((JObs, PKGS["j"]), (Observability, PKGS["t"])):
        on = obs_cls(span_recorder=m["spans"].SpanRecorder(
            sample_every=1))
        off = obs_cls(span_recorder=m["spans"].SpanRecorder(
            sample_every=0))
        assert m["tracectx"].active_tracer(on) is on.tracectx
        assert m["tracectx"].active_tracer(off) is None
        assert m["tracectx"].active_tracer(None) is None
        assert "traces" not in on.snapshot()
        on.tracectx.begin("txn")
        assert on.snapshot()["traces"]["traces"][0]["tid"] == "txn-0"
        assert m["tracectx"].health_blame(on) is None


def _txn_workload(sim, kvs, attach, obs, cfg, **kw):
    sc = sim(cfg, 3, 2, txn=True, **kw)
    if obs is not None:
        sc.obs = obs
    kv = kvs(sc, cap=64)
    coord = attach(kv)
    sc.place_leaders()
    keys = keys_for_groups(kv.router, 3)
    h = kv.transact([("put", keys[0][0], b"w"), ("put", keys[1][0], b"w")])
    for _ in range(8):
        if h.done:
            break
        sc.step()
    assert h.committed
    for _ in range(3):
        sc.step()
    return sc, coord


def _traced_obs(obs_cls, m):
    return obs_cls(
        span_recorder=m["spans"].SpanRecorder(sample_every=1,
                                              clock=scripted_clock()),
        trace_context=m["tracectx"].TraceContext(clock=scripted_clock()))


def test_txn_traces_recorded_as_jax_and_outputs_identical():
    """The coordinator records its transaction traces through the
    port's ``tracectx`` exactly as the JAX coordinator does (under a
    scripted clock: equal dumps), and full tracing changes no step
    output (a traced and an untraced port run are bit-equal)."""
    jsc, _ = _txn_workload(JSharded, JKVS, jattach,
                           _traced_obs(JObs, PKGS["j"]), JCfg(**TXN_GEO))
    tobs = _traced_obs(Observability, PKGS["t"])
    tsc, _ = _txn_workload(ShardedCluster, ShardedKVS, attach_coordinator,
                           tobs, LogConfig(**TXN_GEO), device="cpu")
    plain, _ = _txn_workload(ShardedCluster, ShardedKVS, attach_coordinator,
                             None, LogConfig(**TXN_GEO), device="cpu")
    jdump = jsc.obs.tracectx.dump(anchor=ANCHOR)
    tdump = tsc.obs.tracectx.dump(anchor=ANCHOR)
    assert tdump == jdump
    c = tobs.tracectx.counts()
    assert c["by_kind"].get("txn") == 1 and c["open"] == 0
    assert tdump["traces"][0]["status"] == "committed"
    assert tsc.obs.spans.dump(anchor=ANCHOR) == jsc.obs.spans.dump(
        anchor=ANCHOR)
    for k in ("term", "commit", "end", "apply", "head", "role"):
        np.testing.assert_array_equal(plain.last[k], tsc.last[k], k)
        np.testing.assert_array_equal(np.asarray(jsc.last[k]),
                                      tsc.last[k], k)
