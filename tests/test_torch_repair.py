"""Port parity of the self-healing repair controller: the port's
``runtime/repair.py`` and its wiring (engines, both drivers, the nemesis
runner) on the CPU against the JAX package's, with exact equality.

Each scenario runs the same script on both packages and compares every
step's outputs, the repair controller's ``status()`` (state, counters,
the step-domain timeline) and the audit ledger's dump:

* the full loop DIVERGENCE → quarantine → digest-verified install →
  range re-digest backfill → probation → re-admit, on ``SimCluster``
  and on ``ShardedCluster`` at G = 4 (the other groups' commit
  frontiers advancing strictly through one group's repair);
* re-admission hysteresis, the corrupted-donor retry, escalation into
  the latched ``repair_failed`` page, the mid-pipeline drain, the
  peer-mask restore that keeps other quarantines, a repeat divergence
  and a multi-replica finding;
* the pipelined repair nemesis with its artifact (verdict, history and
  ledger per seed), and both drivers repairing a corrupted leader;
* the refusals: gather fan-out only, ``audit=True`` required."""

import json

import numpy as np
import pytest
import torch

from rdma_paxos_tpu.chaos.faults import corrupt_slot as jcorrupt
from rdma_paxos_tpu.chaos.runner import NemesisRunner as JRunner
from rdma_paxos_tpu.config import LogConfig as JCfg, TimeoutConfig as JTO
from rdma_paxos_tpu.obs import Observability as JObs
from rdma_paxos_tpu.obs import alerts as jalerts
from rdma_paxos_tpu.obs import audit as jaudit
from rdma_paxos_tpu.runtime import repair as jrepair
from rdma_paxos_tpu.runtime.driver import ClusterDriver as JDriver
from rdma_paxos_tpu.runtime.sharded_driver import (
    ShardedClusterDriver as JShardedDriver)
from rdma_paxos_tpu.runtime.sim import SimCluster as JSim
from rdma_paxos_tpu.shard.cluster import ShardedCluster as JSharded
from rdma_paxos_tpu_torch.chaos.artifact import load_reproducer
from rdma_paxos_tpu_torch.chaos.faults import corrupt_slot
from rdma_paxos_tpu_torch.chaos.runner import NemesisRunner
from rdma_paxos_tpu_torch.config import DIGEST_EPOCH, LogConfig, TimeoutConfig
from rdma_paxos_tpu_torch.obs import Observability
from rdma_paxos_tpu_torch.obs import alerts as talerts
from rdma_paxos_tpu_torch.obs import audit as taudit
from rdma_paxos_tpu_torch.runtime import repair as trepair
from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver
from rdma_paxos_tpu_torch.runtime.sharded_driver import ShardedClusterDriver
from rdma_paxos_tpu_torch.runtime.sim import SimCluster
from rdma_paxos_tpu_torch.shard.cluster import ShardedCluster
from tests.test_torch_sim import jax_step_cache_restored  # noqa: F401

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

GEO = dict(n_slots=64, slot_bytes=32, window_slots=16, batch_slots=8)
TIMERS = dict(elec_timeout_low=1e9, elec_timeout_high=2e9)
RES = ("term", "role", "commit", "apply", "end", "head", "accepted")

# the two packages, side by side: each scenario runs once per entry
SIDES = dict(
    j=dict(Sim=JSim, Sharded=JSharded, Cfg=JCfg, Obs=JObs, RC=jrepair,
           corrupt=jcorrupt, alerts=jalerts, kw={}),
    t=dict(Sim=SimCluster, Sharded=ShardedCluster, Cfg=LogConfig,
           Obs=Observability, RC=trepair, corrupt=corrupt_slot,
           alerts=talerts, kw=dict(device="cpu")))


def no_anchor(doc):
    return {k: v for k, v in doc.items() if k != "anchor"}


def ledger_json(led):
    return json.dumps(no_anchor(led.dump()), sort_keys=True, default=str)


def outs(res):
    return {k: np.asarray(res[k]).tolist() for k in RES}


def pump(c, ctl, steps, traffic=None, log=None, until=None):
    """Drive engine and controller the way the drivers do: step, observe
    every finished step, run due repairs on the drained path."""
    for _ in range(steps):
        if traffic is not None:
            traffic()
        res = c.step()
        ctl.observe()
        if ctl.needs_drain():
            ctl.drive()
        if log is not None:
            log.append(outs(res))
        if until is not None and until():
            break


def no_artifact(v):
    return {k: x for k, x in v.items() if k != "artifact"}


def both(scenario):
    """Run ``scenario(side_dict)`` on both packages; assert the returned
    documents equal and return the port's."""
    j = scenario(SIDES["j"])
    t = scenario(SIDES["t"])
    assert t == j
    return t


def audited_sim(m, n=8, **ctl_kw):
    c = m["Sim"](m["Cfg"](**GEO), 3, audit=True, **m["kw"])
    obs = m["Obs"]()
    c.obs = obs
    ctl = m["RC"].RepairController(c, obs=obs, **ctl_kw)
    c.run_until_elected(0)
    for i in range(n):
        c.submit(0, b"v%d" % i)
    for _ in range(4):
        c.step()
        ctl.observe()
    assert c.auditor.findings == []
    return c, ctl, obs


# ---------------------------------------------------------------------------
# the re-digest pass: built once, keyed apart, backfill equal to JAX's
# ---------------------------------------------------------------------------

def test_redigest_fn_built_once_and_backfill_matches_jax(monkeypatch):
    """``redigest_fn`` builds the pass once per ``(cfg, W)`` under a
    ``"redigest"`` key; a repair-off cluster adds no key; the backfill
    (count, ledger) equals the JAX package's."""
    from rdma_paxos_tpu_torch.runtime import sim as tsim
    geo = dict(n_slots=32, slot_bytes=64, window_slots=8, batch_slots=8)
    built = []
    build = tsim.build_redigest
    monkeypatch.setattr(tsim, "build_redigest", lambda *a, **kw: (
        built.append(kw["window_slots"]) or build(*a, **kw)))
    before = set(tsim.STEP_CACHE)

    def plain_run(m):
        c = m["Sim"](m["Cfg"](**geo), 3, **m["kw"])
        c.run_until_elected(0)
        c.submit(0, b"z")
        c.step()

    def scenario(m):
        plain_run(m)
        if m is SIDES["t"]:
            assert set(tsim.STEP_CACHE) == before     # repair-off: no key
        c = m["Sim"](m["Cfg"](**geo), 3, audit=True, **m["kw"])
        c.run_until_elected(0)
        for i in range(6):
            c.submit(0, b"r%d" % i)
        for _ in range(4):
            c.step()
        commit = int(c.last["commit"].min())
        n = [c.redigest(1, 0, commit), c.redigest(2, 1, commit)]
        return dict(n=n, commit=commit, backfilled=c.auditor.backfilled,
                    findings=list(c.auditor.findings),
                    ledger=ledger_json(c.auditor))
    try:
        t = both(scenario)
        assert t["n"] == [t["commit"], t["commit"] - 1] and not t["findings"]
        added = set(tsim.STEP_CACHE) - before
        assert [k[1:] for k in added] == [("redigest", built[0])], added
        assert built == [built[0]]            # one build for both calls
        key = next(iter(added))
        assert tsim.redigest_fn(key[0], key[2]) is tsim.STEP_CACHE[key]
        plain_run(SIDES["t"])
        assert set(tsim.STEP_CACHE) - before == added and len(built) == 1
    finally:
        for k in set(tsim.STEP_CACHE) - before:
            del tsim.STEP_CACHE[k]


# ---------------------------------------------------------------------------
# the full loop
# ---------------------------------------------------------------------------

def test_full_loop_sim_quarantine_repair_backfill_readmit():
    def scenario(m):
        c, ctl, obs = audited_sim(m, probation_steps=4)
        target = int(c.last["commit"].min()) - 1
        m["corrupt"](c, 2, target)
        log = []
        pump(c, ctl, 30, traffic=lambda: c.submit(0, b"w"), log=log)
        return dict(log=log, status=ctl.status(), ledger=ledger_json(
            c.auditor), target=target, mask=c.peer_mask.tolist(),
            need=sorted(c.need_recovery), read_blocked=sorted(
                c.read_blocked),
            gauge=obs.metrics.get("replica_quarantined", replica=2,
                                  group=0),
            repairs=obs.metrics.get("repairs_total", group=0),
            replayed=[[tuple(e) for e in c.replayed[r]] for r in range(3)])
    t = both(scenario)
    st = t["status"]
    assert st["repairs_done"] == 1 and st["active"] == {}
    core = [e["event"] for e in st["timeline"]
            if e["event"] != "repair_backfill_pending"]
    assert core == ["replica_quarantined", "repair_installed",
                    "repair_backfilled", "repair_readmitted"]
    assert t["gauge"] == 0 and t["repairs"] == 1
    assert np.asarray(t["mask"]).all() and t["need"] == []
    assert t["read_blocked"] == []


def test_readmit_hysteresis_counts_clean_steps():
    def scenario(m):
        c, ctl, _ = audited_sim(m, probation_steps=5)
        m["corrupt"](c, 2, int(c.last["commit"].min()) - 1)
        pump(c, ctl, 6, traffic=lambda: c.submit(0, b"x"),
             until=lambda: ctl.repairs_done)
        blocked = [ctl.serving_blocked(0, 2),
                   ctl.states[(0, 2)]["state"],
                   sorted(c.read_blocked)]
        for _ in range(4):
            c.submit(0, b"y")
            c.step()
            ctl.observe()
            blocked.append(ctl.serving_blocked(0, 2))
        c.step()
        ctl.observe()
        blocked.append(ctl.serving_blocked(0, 2))
        return dict(blocked=blocked, status=ctl.status())
    t = both(scenario)
    assert t["blocked"][:3] == [True, "probation", [2]]
    assert t["blocked"][3:] == [True] * 4 + [False]
    assert t["status"]["timeline"][-1]["event"] == "repair_readmitted"


def test_controller_retries_with_majority_donor_on_donor_corruption():
    def scenario(m):
        c, ctl, _ = audited_sim(m, probation_steps=3)
        for i in range(30):
            c.submit(0, b"pad%d" % i)
            c.step()
            ctl.observe()
        commit = int(c.last["commit"].min())
        m["corrupt"](c, 2, commit - 1)
        m["corrupt"](c, 0, 3)         # the first donor, at an old index
        log = []
        pump(c, ctl, 30, traffic=lambda: c.submit(0, b"t"), log=log)
        return dict(log=log, status=ctl.status(),
                    ledger=ledger_json(c.auditor),
                    repairs=c.auditor.repairs)
    t = both(scenario)
    st = t["status"]
    assert st["repairs_done"] == 1 and st["donors_rejected"] >= 1
    rej = [e for e in st["timeline"]
           if e["event"] == "repair_donor_rejected"]
    assert rej[0]["donor"] == 0 and rej[0]["verify"]
    assert t["repairs"][0]["donor"] == 1


def test_escalation_after_bounded_retries_latches_page():
    def scenario(m):
        c = m["Sim"](m["Cfg"](**GEO), 3, audit=True, **m["kw"])
        obs = m["Obs"]()
        c.obs = obs
        ctl = m["RC"].RepairController(c, obs=obs, probation_steps=3,
                                       max_attempts=2, backoff_steps=2)
        eng = m["alerts"].AlertEngine(obs.metrics,
                                      rules=m["alerts"].default_rules())
        c.run_until_elected(0)
        for i in range(8):
            c.submit(0, b"v%d" % i)
        for _ in range(4):
            c.step()
        for i in range(30):
            c.submit(0, b"pad%d" % i)
            c.step()
        commit = int(c.last["commit"].min())
        m["corrupt"](c, 2, commit - 1)
        m["corrupt"](c, 0, 3)
        m["corrupt"](c, 1, 4)
        pump(c, ctl, 40, traffic=lambda: c.submit(0, b"x"),
             until=lambda: ctl.escalations)
        fired = eng.evaluate()["fired"]
        eng.evaluate()
        return dict(status=ctl.status(), fired=fired,
                    pages=eng.firing(severity="page"),
                    blocked=ctl.serving_blocked(0, 2),
                    drain=ctl.needs_drain(),
                    ledger=ledger_json(c.auditor))
    t = both(scenario)
    assert t["status"]["escalations"] == 1
    assert t["status"]["active"]["0:2"]["state"] == "escalated"
    backoffs = [e for e in t["status"]["timeline"]
                if e["event"] == "repair_backoff"]
    assert backoffs and backoffs[0]["next_try"] > backoffs[0]["step"]
    assert "repair_failed" in t["fired"] and "repair_failed" in t["pages"]
    assert t["blocked"] and not t["drain"]


def test_sharded_repair_other_groups_strictly_advance():
    """G = 4: one group's replica is repaired while every other group's
    commit frontier advances strictly, equal to the JAX engine."""
    G = 4

    def scenario(m):
        sc = m["Sharded"](m["Cfg"](**GEO), 3, G, audit=True, **m["kw"])
        ctl = m["RC"].RepairController(sc, probation_steps=3)
        sc.place_leaders()

        def traffic(n=1):
            for g in range(G):
                lead = sc.leader_hint(g)
                if lead >= 0:
                    for i in range(n):
                        sc.submit(g, lead, b"g%d-%d" % (g, i))
        traffic(4)
        for _ in range(4):
            sc.step()
            ctl.observe()
        target = int(sc.last["commit"][1].min()) - 1
        m["corrupt"](sc, 1, target, group=1)
        fronts, log = [], []

        def front():
            fronts.append([int(sc.last["commit"][g].max())
                           + int(sc.rebased_total[g]) for g in range(G)])
        pump(sc, ctl, 40, traffic=lambda: (front(), traffic()), log=log,
             until=lambda: ctl.repairs_done and not ctl.states)
        return dict(log=log, fronts=fronts, status=ctl.status(),
                    ledger=ledger_json(sc.auditor),
                    repairs=sc.auditor.repairs,
                    unrepaired=sc.auditor.summary()["unrepaired"])
    t = both(scenario)
    assert t["status"]["repairs_done"] == 1 and t["status"]["active"] == {}
    assert t["repairs"][0]["group"] == 1 and t["unrepaired"] == 0
    fr = np.asarray(t["fronts"])
    for g in (0, 2, 3):
        assert (np.diff(fr[:, g]) > 0).all(), g


def test_mesh_engine_repair_smoke():
    """The twin of tests/test_repair.py's mesh smoke, on a 1×3 layout on
    both sides: quarantine, the verified re-install into group 1's
    replica on its entry, the backfill read from its ring, re-admit —
    every step's outputs, the status and the ledger equal to JAX."""
    made = []

    def scenario(m):
        kw = dict(m["kw"], mesh=(1, 3))
        if "device" in kw:
            kw["device"] = ["cpu"] * 3
        sc = m["Sharded"](m["Cfg"](**GEO), 3, 2, audit=True, **kw)
        made.append(sc)
        ctl = m["RC"].RepairController(sc, probation_steps=3)
        sc.place_leaders()
        for g in range(2):
            for i in range(5):
                sc.submit(g, sc.leader_hint(g), b"m%d-%d" % (g, i))
        for _ in range(4):
            sc.step()
            ctl.observe()
        target = int(sc.last["commit"][1].min()) - 1
        m["corrupt"](sc, 1, target, group=1)
        log = []

        def traffic(i=[0]):
            lead = sc.leader_hint(0)
            if lead >= 0:
                sc.submit(0, lead, b"k%d" % i[0])
            i[0] += 1
        pump(sc, ctl, 40, traffic=traffic, log=log,
             until=lambda: ctl.repairs_done and not ctl.states)
        return dict(log=log, status=ctl.status(),
                    ledger=ledger_json(sc.auditor),
                    unrepaired=sc.auditor.summary()["unrepaired"])
    try:
        t = both(scenario)
    finally:
        for c in made:
            getattr(c, "close", lambda: None)()
    assert t["status"]["repairs_done"] == 1 and t["status"]["active"] == {}
    assert t["unrepaired"] == 0


def test_repair_mid_pipeline_requires_drain_then_reengages():
    def scenario(m):
        c, ctl, _ = audited_sim(m, probation_steps=2)
        m["corrupt"](c, 2, int(c.last["commit"].min()) - 1)
        for _ in range(4):            # detect on serial steps only
            c.submit(0, b"d")
            c.step()
            ctl.observe()
            if ctl.states:
                break
        due = ctl.needs_drain()
        t1 = c.begin_step()
        deferred = ctl.drive()
        c.finish(t1)
        done = ctl.drive()
        c.submit(0, b"p1")
        a = c.begin_step()
        b = c.begin_step(take_batch=False)
        inflight = c.inflight_dispatches
        ra, rb = c.finish(a), c.finish(b)
        return dict(due=due, deferred=deferred, done=done,
                    inflight=inflight, outs=[outs(ra), outs(rb)],
                    status=ctl.status())
    t = both(scenario)
    assert t["due"] and t["deferred"] == [] and t["done"] == [(0, 2)]
    assert t["inflight"] == 2


def test_restore_mask_preserves_other_quarantines():
    def scenario(m):
        c, ctl, _ = audited_sim(m)
        fake = dict(type="DIVERGENCE", group=0, index=1, term=1,
                    got_replicas=[1])
        with ctl._lock:
            ctl._quarantine(0, 1, fake)
            ctl._quarantine(0, 2, dict(fake, got_replicas=[2]))
        cut = c.peer_mask.tolist()
        ctl._restore_mask(0, 1)
        return dict(cut=cut, restored=c.peer_mask.tolist(),
                    need=sorted(c.need_recovery),
                    leases=c.leases is None, status=ctl.status())
    t = both(scenario)
    m = np.asarray(t["restored"])
    assert m[1, 0] == 1 and m[0, 1] == 1
    assert m[1, 2] == 0 and m[2, 1] == 0 and m[2, 0] == 0
    # the cut survives the link-model refinement at dispatch: a
    # quarantined replica hears nobody on the port's engine
    c, ctl, _ = audited_sim(SIDES["t"])
    with ctl._lock:
        ctl._quarantine(0, 2, dict(type="DIVERGENCE", group=0, index=1,
                                   term=1, got_replicas=[2]))
    from rdma_paxos_tpu_torch.chaos.faults import LinkModel
    c.link_model = LinkModel(3, seed=1)
    eff = c._effective_mask()
    assert eff[2].tolist() == [0, 0, 1] and eff[:, 2].tolist() == [0, 0, 1]
    # a scripted base-mask heal() re-opens it, on both packages alike:
    # the reference composes quarantine with link models, not with a
    # concurrently scripted partition of the same replica
    healed = []
    for m in SIDES.values():
        c2, ctl2, _ = audited_sim(m)
        with ctl2._lock:
            ctl2._quarantine(0, 2, dict(type="DIVERGENCE", group=0,
                                        index=1, term=1, got_replicas=[2]))
        c2.heal()
        healed.append(np.asarray(c2.peer_mask).tolist())
    assert healed[0] == healed[1] == [[1] * 3] * 3


def test_repair_requires_gather_fanout_and_audit():
    for m in SIDES.values():
        c = m["Sim"](m["Cfg"](**GEO), 3, fanout="psum", audit=True,
                     **m["kw"])
        with pytest.raises(ValueError, match="gather"):
            m["RC"].RepairController(c)
        with pytest.raises(ValueError, match="audit"):
            m["RC"].RepairController(
                m["Sim"](m["Cfg"](**GEO), 3, **m["kw"]))
    with pytest.raises(ValueError, match="gather"):
        ClusterDriver(LogConfig(**GEO), 3, fanout="psum", audit=True,
                      repair=True, device="cpu")
    with pytest.raises(ValueError, match="audit"):
        ClusterDriver(LogConfig(**GEO), 3, repair=True, device="cpu")
    with pytest.raises(ValueError, match="audit"):
        ShardedClusterDriver(LogConfig(**GEO), 3, 2, repair=True,
                             device="cpu")


def test_repair_state_names_match_jax():
    for k in ("QUARANTINED", "PROBATION", "ESCALATED"):
        assert getattr(trepair, k) == getattr(jrepair, k), k


# ---------------------------------------------------------------------------
# the ledger's repair records (host-only)
# ---------------------------------------------------------------------------

def test_repeat_divergence_after_repair_is_redetected():
    out = []
    for mod in (jaudit, taudit):
        led = mod.AuditLedger(3)
        led.record_window(0, 0, [5, 6, 7], [1, 1, 1], 3, step=10)
        led.record_window(1, 0, [5, 6, 7], [1, 1, 1], 3, step=10)
        led.record_window(2, 0, [5, 9, 7], [1, 1, 1], 3, step=10)
        led.record_window(1, 0, [5, 6, 7], [1, 1, 1], 3, backfill=True,
                          step=20)
        led.mark_repaired(0, 2, 0, 3, donor=1, index=3, step=20)
        s1 = led.summary()
        led.record_window(2, 0, [5, 8, 7], [1, 1, 1], 3, step=30)
        out.append((s1, led.summary(), len(led.findings),
                    mod.merge_dumps([led.dump()])["unrepaired"]))
    assert out[1] == out[0]
    assert out[1][0]["unrepaired"] == 0 and out[1][2] == 2
    assert out[1][3] == 1


def test_multi_replica_finding_needs_every_replica_repaired():
    doc = dict(
        digest_epoch=DIGEST_EPOCH,
        findings=[dict(type="DIVERGENCE", mode="merge", group=0,
                       index=5, term=1, expected_digest=1,
                       expected_replicas=[0], got_term=1,
                       got_digest=2, got_replicas=[1, 2], step=None)],
        repairs=[dict(group=0, replica=1, lo=0, hi=10, donor=0,
                      index=10, step=3)],
        groups=[])
    reps = []
    for mod in (jaudit, taudit):
        d = json.loads(json.dumps(doc))
        r1 = mod.merge_dumps([d])
        d["repairs"].append(dict(group=0, replica=2, lo=0, hi=10,
                                 donor=0, index=10, step=7))
        reps.append((r1, mod.merge_dumps([d])))
    assert reps[1] == reps[0]
    assert reps[1][0]["unrepaired"] == 1
    assert reps[1][1]["unrepaired"] == 0


# ---------------------------------------------------------------------------
# the chaos proof
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [3, 5])
def test_repair_nemesis_pipelined_deterministic_with_artifact(seed,
                                                              tmp_path):
    """A seeded schedule bit-corrupts one replica's committed slot
    mid-run at pipeline=2; both runners heal it and end ``ok`` with the
    same verdict (repair timeline included), history and ledger, and
    the port's artifact embeds the closed ledger."""
    kw = dict(n_replicas=3, seed=seed, steps=36, fault_kinds=("drop",),
              repair=True, corrupt_step=12, pipeline=2)
    jr = JRunner(artifact_path=str(tmp_path / "j.json"), **kw)
    tr = NemesisRunner(artifact_path=str(tmp_path / "t.json"),
                       device="cpu", **kw)
    jv, tv = jr.run(), tr.run()
    assert no_artifact(tv) == no_artifact(jv)
    assert tr.history.to_jsonl() == jr.history.to_jsonl()
    assert ledger_json(tr.cluster.auditor) == ledger_json(
        jr.cluster.auditor)
    assert tv["ok"], tv
    assert tv["audit"]["findings"] >= 1 and tv["audit"]["unrepaired"] == 0
    assert tv["repair"]["active"] == {} and tv["audit"]["repairs"] == 1
    events = [e["event"] for e in tv["repair"]["timeline"]]
    assert events[0] == "replica_quarantined"
    assert events[-1] == "repair_readmitted"
    assert tr.cluster.max_inflight_dispatches >= 2
    doc = load_reproducer(tv["artifact"])
    assert doc["reason"] == "divergence repaired (self-healed)"
    rep = taudit.merge_dumps([doc["extra"]["audit"]])
    assert rep["unrepaired"] == 0 and rep["first"]["repaired"]


# ---------------------------------------------------------------------------
# drivers (serial, step-locked)
# ---------------------------------------------------------------------------

def test_driver_repairs_corrupted_leader_end_to_end():
    """Both drivers, step-locked: the corrupted LEADER is deposed,
    repaired from a majority donor through ``_do_recover``, and
    re-admitted; ``digest_divergence`` fires and ``health()`` carries the
    closed repair, equal on both."""
    kw = dict(audit=True, repair=True, pipeline=0,
              repair_opts=dict(probation_steps=4))
    jd = JDriver(JCfg(**GEO), 3, timeout_cfg=JTO(**TIMERS), **kw)
    td = ClusterDriver(LogConfig(**GEO), 3,
                       timeout_cfg=TimeoutConfig(**TIMERS), device="cpu",
                       **kw)
    try:
        for d in (jd, td):
            d.runtimes[0].timer._deadline = 0.0
        assert outs(jd.step()) == outs(td.step())
        assert td.leader() == 0
        for _ in range(4):
            jd.cluster.submit(0, b"w")
            td.cluster.submit(0, b"w")
            assert outs(jd.step()) == outs(td.step())
        target = int(td.cluster.last["commit"].min()) - 1
        jcorrupt(jd.cluster, 0, target)
        corrupt_slot(td.cluster, 0, target)
        refused = []
        for i in range(40):
            lead = td.leader()
            assert lead == jd.leader()
            for d in (jd, td):
                d.cluster.submit(lead if lead >= 0 else 1, b"x%d" % i)
            assert outs(jd.step()) == outs(td.step()), i
            refused.append(td._accepts_clients(0))
            if td.repair.repairs_done and not td.repair.states:
                break
        assert td.repair.status() == jd.repair.status()
        assert td.repair.repairs_done == 1 and td.repair.states == {}
        assert not all(refused)       # the held replica admitted nothing
        for d in (jd, td):
            d._alert_period = 1e9
        jo, to = jd.evaluate_alerts(), td.evaluate_alerts()
        assert to["fired"] == jo["fired"]
        assert "digest_divergence" in td.alerts.firing(severity="page")
        h = td.health()
        assert h["repair"]["repairs_done"] == 1
        assert h["repair"]["active"] == {}
        assert h["audit"]["unrepaired"] == 0
        assert h["repair"] == jd.health()["repair"]
        assert td.audit_artifact is not None
        for r in range(3):
            assert list(td.cluster.replayed[r]) == list(
                jd.cluster.replayed[r])
    finally:
        jd.stop()
        td.stop()


def test_sharded_driver_repairs_group_leader():
    kw = dict(audit=True, repair=True, pipeline=0,
              repair_opts=dict(probation_steps=3))
    jd = JShardedDriver(JCfg(**GEO), 3, 2, timeout_cfg=JTO(**TIMERS), **kw)
    td = ShardedClusterDriver(LogConfig(**GEO), 3, 2,
                              timeout_cfg=TimeoutConfig(**TIMERS),
                              device="cpu", **kw)
    try:
        for _ in range(60):
            assert outs(jd.step()) == outs(td.step())
            if all(v >= 0 for v in td.leaders()):
                break
        assert td.leaders() == jd.leaders()
        for g in range(2):
            for i in range(5):
                for d in (jd, td):
                    d.cluster.submit(g, d.leaders()[g], b"g%d-%d" % (g, i))
        for _ in range(4):
            assert outs(jd.step()) == outs(td.step())
        lead1 = td.leaders()[1]
        target = int(td.cluster.last["commit"][1].min()) - 1
        jcorrupt(jd.cluster, lead1, target, group=1)
        corrupt_slot(td.cluster, lead1, target, group=1)
        g0 = []
        c = td.cluster
        for i in range(80):
            g0.append(int(c.last["commit"][0].max())
                      + int(c.rebased_total[0]))
            assert td.leaders() == jd.leaders()
            for d in (jd, td):
                lv = d.leaders()
                if lv[0] >= 0:
                    d.cluster.submit(0, lv[0], b"k%d" % i)
                if lv[1] >= 0:
                    d.cluster.submit(1, lv[1], b"j%d" % i)
            assert outs(jd.step()) == outs(td.step()), i
            if (td.repair.repairs_done and not td.repair.states
                    and all(v >= 0 for v in td.leaders())):
                break
        assert td.repair.status() == jd.repair.status()
        assert td.repair.repairs_done == 1 and not td.repair.states
        assert td.leaders()[1] >= 0 and g0[-1] > g0[0]
        assert c.auditor.summary()["unrepaired"] == 0
        assert td.health()["repair"]["repairs_done"] == 1
        assert ledger_json(c.auditor) == ledger_json(jd.cluster.auditor)
    finally:
        jd.stop()
        td.stop()


# ---------------------------------------------------------------------------
# quarantine and the read path (digest and storm-policy holds)
# ---------------------------------------------------------------------------

READ_GEO = dict(n_slots=128, slot_bytes=128, window_slots=32,
                batch_slots=8)


def _read_cluster(m):
    from rdma_paxos_tpu.models.replicated_kvs import ReplicatedKVS as JKVS
    from rdma_paxos_tpu.runtime import reads as jreads
    from rdma_paxos_tpu_torch.models.replicated_kvs import ReplicatedKVS
    from rdma_paxos_tpu_torch.runtime import reads as treads
    jax_side = m is SIDES["j"]
    c = m["Sim"](m["Cfg"](**READ_GEO), 3, audit=True, **m["kw"])
    c.obs = m["Obs"]()
    (jreads if jax_side else treads).attach(c)
    return c, (JKVS if jax_side else ReplicatedKVS)


def _put_committed(c, kv, leader, key, val, req):
    kv.put(leader, key, val, client_id=9, req_id=req)
    for _ in range(6):
        c.step()
        kv._fold(leader)
        if kv.last_req[leader].get(9, 0) >= req:
            return
    raise AssertionError("put did not commit")


def test_digest_quarantine_revokes_lease_and_refuses_reads():
    def scenario(m):
        c, KVS = _read_cluster(m)
        ctl = m["RC"].RepairController(c, obs=c.obs, probation_steps=2)
        c.run_until_elected(0)
        kv = KVS(c, cap=256)
        _put_committed(c, kv, 0, b"k", b"v1", 1)
        valid = c.leases.valid(0, 0)
        m["corrupt"](c, 0, int(c.last["commit"].min()) - 1)
        for _ in range(4):
            c.step()
            ctl.observe()
            if ctl.serving_blocked(0, 0):
                break
        return dict(valid=valid, blocked=ctl.serving_blocked(0, 0),
                    after=c.leases.valid(0, 0),
                    read=kv.get(0, b"k", linearizable=True),
                    revoked=c.obs.metrics.get(
                        "lease_revoked_total", replica=0, group=0,
                        reason="quarantine"),
                    leases=c.leases.status(), status=ctl.status())
    t = both(scenario)
    assert t["valid"] and t["blocked"] and not t["after"]
    assert t["read"] is None and t["revoked"] >= 1


def test_storm_policy_quarantine_holds_replica_and_releases():
    """A firing ``election_storm`` page (the device-truth
    ``device_elections_started_total`` series) holds the storming
    replica without a digest finding — lease revoked, reads refused —
    and ``drive()`` releases it to probation with no install."""
    def scenario(m):
        c, KVS = _read_cluster(m)
        ctl = m["RC"].RepairController(c, obs=c.obs, probation_steps=2,
                                       storm_policy=True)
        c.run_until_elected(2)
        kv = KVS(c, cap=256)
        _put_committed(c, kv, 2, b"k", b"v1", 1)
        engine = m["alerts"].AlertEngine(
            c.obs.metrics, m["alerts"].default_rules(), trace=c.obs.trace)
        engine.add_hook(ctl.on_alert)
        trs = [engine.evaluate()]
        for _ in range(2):
            c.obs.metrics.inc("device_elections_started_total", 5,
                              replica=2)
            trs.append(engine.evaluate())
        held = dict(blocked=ctl.serving_blocked(0, 2),
                    lease=c.leases.valid(0, 2),
                    read=kv.get(2, b"k", linearizable=True),
                    read_blocked=sorted(c.read_blocked))
        tk = c.reads.submit(lambda: kv.serve_local(2, b"k"), replica=2)
        c.step()
        ctl.observe()
        hub = (tk.done, tk.status)
        due = ctl.needs_drain()
        ctl.drive()
        release = []
        for _ in range(4):
            c.step()
            ctl.observe()
            release.append(ctl.serving_blocked(0, 2))
        return dict(trs=trs, held=held, hub=hub, due=due,
                    release=release, status=ctl.status(),
                    leases=c.leases.status())
    t = both(scenario)
    assert "election_storm" in t["trs"][-1]["fired"]
    assert t["held"] == dict(blocked=True, lease=False, read=None,
                             read_blocked=[2])
    assert t["hub"] == (True, "failed") and t["due"]
    assert t["release"][-1] is False
    assert t["status"]["policy_quarantines"] == 1
    assert any(e["event"] == "repair_policy_released"
               for e in t["status"]["timeline"])
