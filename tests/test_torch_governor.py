"""Port parity of the adaptive dispatch governor: the port's
``runtime/governor.py`` and its wiring on the CPU against the JAX
package's, with exact equality.

* the same arrival stream through both packages' governed engines gives
  the same decision sequence (tier, rungs, pipelining, coalesce wait,
  shed latch), the same step outputs and replay streams — on a seeded
  bursty trace (trickle, burst, trickle), with the ladder only ever
  picking a tier the engine prewarms (the port builds no burst or scan
  function outside ``(1,) + K_TIERS``);
* a pinned governor is bit-identical to the static dispatch, and an
  attached, unpinned governor changes no output;
* the SLO shed through ``on_alert``: the burn-rate pager drops the tier
  to serial on its fire transition and the ladder re-climbs after it
  resolves, equal on both packages;
* per-group rungs on ``ShardedCluster``, the G = 1 backlog shape, the
  serial-cap refusal, the coalesce bound, ``HintGovernor``;
* the governed nemesis at ``pipeline=2`` (verdict, history and ledger)
  and a governed driver serving a queued workload."""

import time

import numpy as np
import pytest
import torch

from rdma_paxos_tpu.chaos.runner import NemesisRunner as JRunner
from rdma_paxos_tpu.config import LogConfig as JCfg, TimeoutConfig as JTO
from rdma_paxos_tpu.obs import alerts as jalerts
from rdma_paxos_tpu.obs import metrics as jmetrics
from rdma_paxos_tpu.obs import series as jseries
from rdma_paxos_tpu.runtime import governor as jgov
from rdma_paxos_tpu.runtime.driver import ClusterDriver as JDriver
from rdma_paxos_tpu.runtime.sim import SimCluster as JSim
from rdma_paxos_tpu.shard.cluster import ShardedCluster as JSharded
from rdma_paxos_tpu_torch.chaos.runner import NemesisRunner
from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
from rdma_paxos_tpu_torch.obs import alerts as talerts
from rdma_paxos_tpu_torch.obs import metrics as tmetrics
from rdma_paxos_tpu_torch.obs import series as tseries
from rdma_paxos_tpu_torch.runtime import governor as tgov
from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver
from rdma_paxos_tpu_torch.runtime.sim import SimCluster
from rdma_paxos_tpu_torch.shard.cluster import ShardedCluster
from tests.test_torch_sim import jax_step_cache_restored  # noqa: F401

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

# the JAX governor tests' geometry
GEO = dict(n_slots=512, slot_bytes=128, window_slots=64, batch_slots=16)
BLOB = b"g" * 24
TIMERS = dict(elec_timeout_low=1e9, elec_timeout_high=2e9)
RES = ("term", "role", "commit", "apply", "end", "head", "accepted")

SIDES = dict(
    j=dict(Sim=JSim, Sharded=JSharded, Cfg=JCfg, gov=jgov,
           alerts=jalerts, metrics=jmetrics, series=jseries, kw={}),
    t=dict(Sim=SimCluster, Sharded=ShardedCluster, Cfg=LogConfig,
           gov=tgov, alerts=talerts, metrics=tmetrics, series=tseries,
           kw=dict(device="cpu")))


def outs(res):
    return {k: np.asarray(res[k]).tolist() for k in RES}


def no_artifact(v):
    return {k: x for k, x in v.items() if k != "artifact"}


def both(scenario):
    j = scenario(SIDES["j"])
    t = scenario(SIDES["t"])
    assert t == j
    return t


def bursty_trace(seed: int, n: int = 36, hi: int = 96):
    """A seeded arrival trace: trickle, burst, trickle."""
    rng = np.random.default_rng(seed)
    a, b = n // 3, 2 * n // 3
    return ([int(v) for v in rng.integers(0, 4, a)]
            + [int(v) for v in rng.integers(hi // 2, hi, b - a)]
            + [int(v) for v in rng.integers(0, 4, n - b)])


def drive_governed(c, gov, loads, log):
    """The governed dispatch rule (the driver's contract): serial
    decision -> step(), fused decision -> step_burst(max_k=rung)."""
    for n in loads:
        if n:
            c.submit_many(0, [(3, 1, 0, BLOB)] * n)
        d = gov.decision
        if d.max_k > 1 and max(len(q) for q in c.pending):
            res = c.step_burst(max_k=d.max_k)
        else:
            res = c.step()
        log.append((outs(res), tuple(gov.decision)))
    while int(c.last["commit"].min()) < int(c.last["end"].max()):
        d = gov.decision
        res = c.step_burst(max_k=d.max_k) if d.max_k > 1 else c.step()
        log.append((outs(res), tuple(gov.decision)))


def test_constants_and_labels_match_jax():
    assert tgov.SHED_RULE == jgov.SHED_RULE
    assert tuple(tgov.SERIAL) == tuple(jgov.SERIAL)
    assert tgov.Decision._fields == jgov.Decision._fields
    for kind, k in (("serial", 1), ("burst", 8), ("scan", 16)):
        assert tgov.tier_label(kind, k) == jgov.tier_label(kind, k)


@pytest.mark.parametrize("seed,scan", [(3, False), (4, True)])
def test_arrival_trace_decisions_match_jax(seed, scan):
    """A seeded bursty trace through both governed engines: the same
    decisions, outputs, replay streams and status; the trace itself is
    deterministic per seed; the port builds scan functions for ladder
    rungs only."""
    loads = bursty_trace(seed)
    assert loads == bursty_trace(seed) and loads != bursty_trace(seed + 9)

    def scenario(m):
        c = m["Sim"](m["Cfg"](**GEO), 3, fanout="psum", scan=scan,
                     **m["kw"])
        c.run_until_elected(0)
        gov = m["gov"].attach_governor(c, obs=None)
        log = []
        drive_governed(c, gov, loads, log)
        ks = sorted(getattr(c, "_scans", {}))
        return dict(log=log, status=gov.status(), ks=ks if scan else None,
                    replayed=[[tuple(e) for e in c.replayed[r]]
                              for r in range(3)])
    j = scenario(SIDES["j"])
    t = scenario(SIDES["t"])
    # the JAX engine caches its scan programs globally, not per cluster
    j["ks"] = t["ks"]
    assert t == j
    tiers = {d[1] for _, d in t["log"]}
    assert max(tiers) > 1 and 1 in tiers      # climbed and descended
    if scan:
        assert set(t["ks"]) <= set(SimCluster.K_TIERS) and t["ks"]
        assert t["status"]["tier"] in ("serial",) + tuple(
            f"scan{k}" for k in SimCluster.K_TIERS)


@pytest.mark.parametrize("tier,k", [("serial", 1), ("burst", 4)])
def test_pinned_tier_bit_identity(tier, k):
    """A pinned governor equals the static dispatch of its tier on the
    port, and the JAX governed run."""
    loads = [0, 30, 30, 0, 7, 50, 0, 0, 12, 40, 0, 3]

    def scenario(m, governed=True):
        c = m["Sim"](m["Cfg"](**GEO), 3, fanout="psum", **m["kw"])
        c.run_until_elected(0)
        gov = None
        if governed:
            gov = m["gov"].attach_governor(c, obs=None)
            gov.pin(tier, k)
        log = []
        for n in loads:
            if n:
                c.submit_many(0, [(3, 1, 0, BLOB)] * n)
            kk = gov.decision.max_k if gov is not None else k
            assert kk == k
            if kk > 1 and max(len(q) for q in c.pending):
                res = c.step_burst(max_k=kk)
            else:
                res = c.step()
            log.append(outs(res))
        return log, [[tuple(e) for e in c.replayed[r]] for r in range(3)]
    t = both(scenario)
    assert scenario(SIDES["t"], governed=False) == t


def test_governor_off_outputs_bit_identical():
    loads = [20, 20, 0, 5, 60, 0]

    def scenario(m, attach):
        c = m["Sim"](m["Cfg"](**GEO), 3, fanout="psum", **m["kw"])
        c.run_until_elected(0)
        if attach:
            m["gov"].attach_governor(c, obs=None)
        log = []
        for n in loads:
            if n:
                c.submit_many(0, [(3, 1, 0, BLOB)] * n)
            res = (c.step_burst() if max(len(q) for q in c.pending)
                   else c.step())
            log.append(outs(res))
        return log
    t = scenario(SIDES["t"], True)
    assert t == scenario(SIDES["t"], False) == scenario(SIDES["j"], True)


def test_slo_shed_fires_drops_tier_and_resolves():
    """The burn-rate pager sheds the governor on its fire transition
    (serial, no pipelining, no coalescing); load does not climb while
    shedding; after the pager resolves the ladder re-climbs — the same
    transitions and decisions on both packages."""
    def scenario(m):
        reg = m["metrics"].MetricsRegistry()
        store = m["series"].TimeSeriesStore(capacity=256)
        eng = m["alerts"].AlertEngine(reg, rules=m["alerts"].default_rules(),
                                      series=store)
        c = m["Sim"](m["Cfg"](**GEO), 3, fanout="psum", **m["kw"])
        c.run_until_elected(0)
        gov = m["gov"].attach_governor(c, obs=None, alerts=eng)
        eng.add_hook(gov.on_alert)
        log = []
        drive_governed(c, gov, [50] * 6, log)
        climbed = gov.decision.max_k
        w = [1000.0]
        marks = []

        def drive(n, latency, per=20, stop=None):
            for _ in range(n):
                for _ in range(per):
                    reg.observe("commit_latency_seconds", latency,
                                buckets=m["metrics"].LATENCY_BUCKETS_S,
                                replica=0)
                store.sample(reg.snapshot(), step=store.samples, wall=w[0])
                w[0] += 5.0
                out = eng.evaluate()
                if stop and m["gov"].SHED_RULE in out[stop]:
                    marks.append((stop, store.samples))
                    return
        drive(10, 0.01)
        drive(70, 2.0, stop="fired")
        shed = tuple(gov.decision)
        c.submit_many(0, [(3, 1, 0, BLOB)] * 100)
        c.step()
        held = gov.decision.max_k
        drive(140, 0.01, per=60, stop="resolved")
        drive_governed(c, gov, [80] * 4, log)
        return dict(climbed=climbed, marks=marks, shed=shed, held=held,
                    final=tuple(gov.decision), sheds=gov.sheds,
                    log=log)
    t = both(scenario)
    assert t["climbed"] > 1
    assert [m for m, _ in t["marks"]] == ["fired", "resolved"]
    kind, max_k, pipeline, coalesce, shed, _ = t["shed"]
    assert shed and max_k == 1 and not pipeline and coalesce == 0
    assert t["held"] == 1 and t["sheds"] == 1
    assert not t["final"][4] and t["final"][1] > 1


def test_sharded_per_group_rungs():
    """One loaded group climbs its rung while an idle group stays low;
    the dispatch runs the highest rung — equal per-group decisions."""
    def scenario(m):
        sc = m["Sharded"](m["Cfg"](**GEO), 3, 2, fanout="gather",
                          **m["kw"])
        sc.place_leaders()
        gov = m["gov"].attach_governor(sc, obs=None)
        decs = []
        for _ in range(8):
            lead0 = sc.leader_hint(0)
            sc.submit_many(0, lead0, [(3, 1, 0, BLOB)] * 80)
            d = gov.decision
            res = sc.step_burst(max_k=d.max_k) if d.max_k > 1 \
                else sc.step()
            decs.append((tuple(gov.decision), outs(res)))
        return dict(G=gov.G, decs=decs, status=gov.status())
    t = both(scenario)
    d = t["decs"][-1][0]
    assert t["G"] == 2 and d[5][0] > 1 and d[1] == max(d[5])
    assert d[5][1] <= d[5][0]


def test_single_group_sharded_backlog_shape():
    for m in SIDES.values():
        sc = m["Sharded"](m["Cfg"](**GEO), 3, 1, **m["kw"])
        gov = m["gov"].attach_governor(sc, obs=None)
        assert gov._backlogs(sc) == [0]
        sc.place_leaders()
        sc.submit_many(0, sc.leader_hint(0), [(3, 1, 0, BLOB)] * 7)
        assert gov._backlogs(sc) == [7]


def test_serial_cap_refused_and_ladder_pins():
    c = SimCluster(LogConfig(**GEO), 3, fanout="psum", device="cpu")
    c.run_until_elected(0)
    c.submit_many(0, [(3, 1, 0, BLOB)] * 4)
    with pytest.raises(ValueError, match="serial step"):
        c.step_burst(max_k=1)
    gov = tgov.attach_governor(c, obs=None)
    assert gov.ladder == (1,) + tuple(c.K_TIERS)
    with pytest.raises(ValueError, match="ladder"):
        gov.pin("burst", 3)
    with pytest.raises(ValueError, match="unknown tier"):
        gov.pin("warp", 4)
    before = int(c.last["end"].max())
    c.submit_many(0, [(3, 1, 0, BLOB)] * (GEO["batch_slots"] * 10))
    c.step_burst(max_k=2)
    assert int(c.last["end"].max()) - before <= 2 * GEO["batch_slots"]


class _FakeLock:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _Fake:
    _host_lock = _FakeLock()
    scan = False

    def __init__(self, backlog):
        self.pending = [[0] * backlog]


def test_coalesce_decision_bounded_and_off_while_shed():
    out = []
    for mod in (jgov, tgov):
        gov = mod.DispatchGovernor(batch_slots=16, ladder=(2, 4, 8, 16),
                                   coalesce_us=250)
        decs = []
        for backlog in (100, 100, 40, 3, 0, 0, 0, 0, 0):
            gov.observe(_Fake(backlog),
                        dict(accepted=np.array([16, 0, 0])))
            decs.append(tuple(gov.decision))
        gov.on_alert(mod.SHED_RULE, "page")
        decs.append(tuple(gov.decision))
        out.append((decs, gov.status()))
    assert out[1] == out[0]
    decs = out[1][0]
    assert decs[2][1] == 8 and 0 < decs[2][3] <= 250
    assert decs[-1][4] and decs[-1][3] == 0 and decs[-1][1] == 1


def test_hint_governor_matches_jax_and_bounds_coalesce():
    rng = np.random.default_rng(11)
    hints = [int(rng.choice([0, 0, 3, 7, 12, 16, 40])) for _ in range(200)]
    seqs = [[g.decide(h) for h in hints]
            for g in (jgov.HintGovernor(16), tgov.HintGovernor(16),
                      tgov.HintGovernor(16))]
    assert seqs[0] == seqs[1] == seqs[2]
    g = tgov.HintGovernor(16, coalesce_limit=2)
    assert [g.decide(h) for h in (0, 16, 2, 4, 6, 8, 9)] == [
        "step", "burst", "burst", "coalesce", "coalesce", "burst",
        "coalesce"]


@pytest.mark.chaos
def test_nemesis_pipeline2_with_governor_deterministic():
    kw = dict(n_replicas=3, seed=7, steps=50, pipeline=2, governor=True)
    jr, tr = JRunner(**kw), NemesisRunner(device="cpu", **kw)
    jv, tv = jr.run(), tr.run()
    assert no_artifact(tv) == no_artifact(jv)
    assert tr.history.to_jsonl() == jr.history.to_jsonl()
    assert tv["ok"], tv
    assert tv["governor"]["evals"] > 0
    rerun = NemesisRunner(device="cpu", **kw).run()
    assert no_artifact(rerun) == no_artifact(tv)


def test_governed_driver_step_locked_with_jax():
    """Both packages' governed drivers through ``step()``: the governor's
    decision caps the burst (or routes the serial step) identically."""
    kw = dict(fanout="psum", governor=True, pipeline=0)
    jd = JDriver(JCfg(**GEO), 3, timeout_cfg=JTO(**TIMERS), **kw)
    td = ClusterDriver(LogConfig(**GEO), 3,
                       timeout_cfg=TimeoutConfig(**TIMERS), device="cpu",
                       **kw)
    try:
        for d in (jd, td):
            d.runtimes[0].timer._deadline = 0.0
            d._alert_period = 1e9
        assert outs(jd.step()) == outs(td.step())
        for n in bursty_trace(1, n=30):
            for d in (jd, td):
                if n:
                    d.cluster.submit_many(0, [(3, 1, 0, BLOB)] * n)
            assert outs(jd.step()) == outs(td.step())
            assert tuple(td.governor.decision) == tuple(
                jd.governor.decision)
        assert td.governor.status() == jd.governor.status()
        tiers = {k: v for k, v in
                 td.obs.metrics.snapshot()["counters"].items()
                 if k.startswith("dispatch_tier")}
        assert tiers == {k: v for k, v in
                         jd.obs.metrics.snapshot()["counters"].items()
                         if k.startswith("dispatch_tier")}
        assert td.health()["governor"] == jd.health()["governor"]
    finally:
        jd.stop()
        td.stop()


def test_governed_driver_serves_and_reports():
    """A ``governor=True`` driver serves a queued workload through its
    live loop: everything commits, ``dispatch_tier`` counters show fused
    tiers, and the governor status rides ``health()``."""
    d = ClusterDriver(LogConfig(**GEO), 3, fanout="psum", governor=True,
                      pipeline=2, device="cpu")
    d.prewarm()
    d.run(period=0.01)
    try:
        t0 = time.time()
        while d.leader() < 0:
            assert time.time() - t0 < 60
            time.sleep(0.01)
        lead = d.leader()
        base = int(d.cluster.last["commit"].max()) + d.cluster.rebased_total
        total = 600
        for _ in range(20):
            d.cluster.submit_many(lead, [(3, 1, 0, BLOB)] * 30)
            d._wake.set()
            time.sleep(0.002)
        t0 = time.time()
        while (int(d.cluster.last["commit"].max())
               + d.cluster.rebased_total) < base + total:
            assert time.time() - t0 < 60, "workload never drained"
            time.sleep(0.01)
        tiers = {k: v for k, v in
                 d.obs.metrics.snapshot()["counters"].items()
                 if k.startswith("dispatch_tier")}
        assert any("burst" in k or "scan" in k for k in tiers), tiers
        h = d.health()
        assert h["governor"]["ladder"] == [1] + list(d.cluster.K_TIERS)
    finally:
        d.stop()
    assert d.loop_error is None


def test_sharded_governed_scan_driver_step_locked_with_jax():
    """The sharded driver with ``governor=True`` and ``scan=True``, both
    packages step-locked: the per-group rungs cap the all-groups scan
    dispatch identically and the tiers are labelled ``scanK``."""
    from rdma_paxos_tpu.runtime.sharded_driver import (
        ShardedClusterDriver as JShardedDriver)
    from rdma_paxos_tpu_torch.runtime.sharded_driver import (
        ShardedClusterDriver)
    kw = dict(governor=True, scan=True, pipeline=0, group_timer_lo=1,
              group_timer_hi=2)
    jd = JShardedDriver(JCfg(**GEO), 3, 2, timeout_cfg=JTO(**TIMERS), **kw)
    td = ShardedClusterDriver(LogConfig(**GEO), 3, 2,
                              timeout_cfg=TimeoutConfig(**TIMERS),
                              device="cpu", **kw)
    try:
        for d in (jd, td):
            d._alert_period = 1e9
        for _ in range(12):
            assert outs(jd.step()) == outs(td.step())
        assert td.leaders() == jd.leaders() and min(td.leaders()) >= 0
        for i, n in enumerate(bursty_trace(2, n=24)):
            for d in (jd, td):
                if n:
                    g = i % 2
                    d.cluster.submit_many(g, d.leaders()[g],
                                          [(3, 1, 0, BLOB)] * n)
            assert outs(jd.step()) == outs(td.step()), i
            assert tuple(td.governor.decision) == tuple(
                jd.governor.decision)
        assert td.governor.status() == jd.governor.status()
        tiers = {k for k in td.obs.metrics.snapshot()["counters"]
                 if k.startswith("dispatch_tier")}
        assert any("scan" in k for k in tiers), tiers
        assert td.cluster.scan_dispatches == jd.cluster.scan_dispatches > 0
    finally:
        jd.stop()
        td.stop()

