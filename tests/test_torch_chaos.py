"""Port parity of the chaos judge: the port's ``chaos`` package and its
engine hooks on the CPU against the JAX package's, with exact equality.

* ``LinkModel`` masks over 64 steps for each fault kind, the step timer
  model, ``generate_schedule`` JSON for several seeds, the history
  recorder, the Wing–Gong checker and the invariant checker on the
  fixtures of ``tests/test_chaos.py``, and the reproducer artifact;
* an engine under a seeded link model (the dispatch clock through serial
  steps and fused bursts) gives bit-equal step outputs and replay
  streams; crash-restart and ``corrupt_slot`` act as on the JAX engine;
* ``NemesisRunner`` verdicts (without ``artifact``), history JSONL and
  audit ledger dumps are equal for seeds {1, 3, 7, 13}, pipelined and
  on the scan tier;
* the psum refusal, the dedup-bug catch with ``replay``, and the modes
  and attachments the port refuses;
* the geometry of ``chip_smoke.py`` phase 9b runs clean on the port.
"""

import json
import logging

import numpy as np
import pytest
import torch

from rdma_paxos_tpu.chaos import artifact as jart
from rdma_paxos_tpu.chaos import faults as jfaults
from rdma_paxos_tpu.chaos import history as jhist
from rdma_paxos_tpu.chaos import invariants as jinv
from rdma_paxos_tpu.chaos import linearize as jlin
from rdma_paxos_tpu.chaos.runner import NemesisRunner as JRunner
from rdma_paxos_tpu.config import LogConfig as JCfg
from rdma_paxos_tpu.models.replicated_kvs import ReplicatedKVS as JKVS
from rdma_paxos_tpu.obs import Observability as JObs
from rdma_paxos_tpu.runtime.sim import SimCluster as JSim
from rdma_paxos_tpu_torch.chaos import artifact as tart
from rdma_paxos_tpu_torch.chaos import faults as tfaults
from rdma_paxos_tpu_torch.chaos import history as thist
from rdma_paxos_tpu_torch.chaos import invariants as tinv
from rdma_paxos_tpu_torch.chaos import linearize as tlin
from rdma_paxos_tpu_torch.chaos.runner import (
    DEFAULT_KV_CFG, NemesisRunner)
from rdma_paxos_tpu_torch.config import LogConfig
from rdma_paxos_tpu_torch.consensus.log import EntryType
from rdma_paxos_tpu_torch.consensus.state import Role
from rdma_paxos_tpu_torch.models.kvs import CMD_W, apply_cmd
from rdma_paxos_tpu_torch.models.replicated_kvs import ReplicatedKVS
from rdma_paxos_tpu_torch.obs import Observability
from rdma_paxos_tpu_torch.runtime.sim import SimCluster
from chip_smoke import CHAOS_A, GEOMETRIES
from tests import test_chaos as jtests

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

GEO = dict(n_slots=DEFAULT_KV_CFG.n_slots,
           slot_bytes=DEFAULT_KV_CFG.slot_bytes,
           window_slots=DEFAULT_KV_CFG.window_slots,
           batch_slots=DEFAULT_KV_CFG.batch_slots)



def _no_anchor(doc):
    return {k: v for k, v in doc.items() if k != "anchor"}


def _verdict(v):
    return {k: x for k, x in v.items() if k != "artifact"}


def _same_runs(jr, tr, jv, tv):
    """Verdict (without the artifact path), history JSONL byte for byte,
    and audit ledger and flight dumps equal across the packages."""
    assert _verdict(tv) == _verdict(jv)
    assert tr.history.to_jsonl() == jr.history.to_jsonl()
    if jr.cluster.auditor is not None:
        assert json.dumps(_no_anchor(tr.cluster.auditor.dump()),
                          sort_keys=True) == json.dumps(
            _no_anchor(jr.cluster.auditor.dump()), sort_keys=True)
        assert json.dumps(_no_anchor(tr.cluster.flight.dump()),
                          sort_keys=True) == json.dumps(
            _no_anchor(jr.cluster.flight.dump()), sort_keys=True)


# ---------------------------------------------------------------------------
# link model, timers, schedules
# ---------------------------------------------------------------------------

LINK_FAULTS = {
    "block": lambda m: m.block(0, 1),
    "partition": lambda m: m.partition([[0, 3], [1]]),
    "drop": lambda m: m.set_drop(0.4),
    "delay": lambda m: (m.set_delay(2, dst=0, src=1),
                        m.set_delay(1, dst=2)),
    "dup": lambda m: (m.set_drop(0.7), m.set_dup(0.5, src=2)),
    "crash": lambda m: m.down.add(3),
    "mixed": lambda m: (m.set_drop(0.3, dst=1), m.set_delay(3, src=0),
                        m.set_dup(0.6), m.block(2, None)),
}


@pytest.mark.parametrize("kind", sorted(LINK_FAULTS))
def test_link_model_masks_match_reference(kind):
    base = np.ones((4, 4), np.int32)
    base[1, 2] = 0
    masks = []
    for mod in (jfaults, tfaults):
        m = mod.LinkModel(4, seed=9)
        LINK_FAULTS[kind](m)
        masks.append([m.effective_mask(base, t) for t in range(64)]
                     + [m.faulty(), m.faults_active])
        m.heal()
        masks[-1].append(m.effective_mask(base, 3))
    for a, b in zip(*masks):
        assert np.array_equal(np.asarray(a), np.asarray(b)), kind


@pytest.mark.parametrize("seed,R,kinds", [
    (0, 3, None), (1, 3, None), (7, 3, None), (42, 5, None),
    (13, 3, ("partition", "crash")), (3, 5, ("drop", "dup", "skew"))])
def test_generate_schedule_matches_reference(seed, R, kinds):
    kw = {} if kinds is None else dict(kinds=kinds)
    j = jfaults.generate_schedule(seed, R, 120, **kw)
    t = tfaults.generate_schedule(seed, R, 120, **kw)
    assert t.to_json() == j.to_json() and len(t) > 0
    assert tfaults.FaultSchedule.from_json(j.to_json()).to_json() == \
        j.to_json()
    assert t.without_mask_faults().to_json() == \
        j.without_mask_faults().to_json()


def test_schedule_validation_matches_reference():
    bad = [lambda s: s.at(0, "meteor"), lambda s: s.at(0, "crash"),
           lambda s: s.at(3, "crash", replica=7).validate(3),
           lambda s: s.at(0, "restart", replica=1).validate(3),
           lambda s: s.at(0, "crash", replica=0).at(
               1, "crash", replica=1).validate(3)]
    for fn in bad:
        msgs = []
        for mod in (jfaults, tfaults):
            with pytest.raises(ValueError) as e:
                fn(mod.FaultSchedule())
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_step_timer_model_matches_reference():
    rng = np.random.default_rng(5)
    models = [mod.StepTimerModel(3, seed=5, lo=4, hi=9)
              for mod in (jfaults, tfaults)]
    for m in models:
        m.skew(0, 0.3)
        m.skew(2, 2.0)
    fired = [[], []]
    for t in range(120):
        res = dict(hb_seen=rng.integers(0, 2, 3) * (rng.random() < 0.3),
                   role=rng.integers(0, 3, 3))
        down = {1} if 40 <= t < 60 else set()
        for i, m in enumerate(models):
            fired[i].append(m.fire(down))
            m.observe(res)
    assert fired[0] == fired[1] and any(fired[0])


# ---------------------------------------------------------------------------
# history, checker, invariants, artifact (the JAX tests' fixtures)
# ---------------------------------------------------------------------------

def _history(mod):
    h = mod.HistoryRecorder()
    h.set_clock(1)
    w = h.invoke("put", b"k", b"v\xff", client=3, req_id=1, replica=0)
    r1 = h.invoke("get", b"k", replica=1, weak=True)
    h.ok(r1, None)
    h.set_clock(2)
    h.retransmit(w, replica=2, network_dup=True)
    h.ok(w)
    r2 = h.invoke("get", b"k", replica=0)
    h.fail(r2, reason="leadership_unverified")
    dangling = h.invoke("put", b"k", b"v2", client=3, req_id=2)
    h.timeout(dangling)
    return h


def test_history_recorder_matches_reference():
    j, t = _history(jhist), _history(thist)
    assert t.to_jsonl() == j.to_jsonl()
    assert t.ops() == j.ops() and t.ops(include_weak=True) == \
        j.ops(include_weak=True)
    assert thist.HistoryRecorder.from_jsonl(j.to_jsonl()).to_jsonl() == \
        j.to_jsonl()
    assert len(t) == len(j) and t.pending() == j.pending() == []


_op = jtests._op
CHECKER_CASES = {
    "legal": [_op("put", value="v1", inv=0, res=1),
              _op("get", out="v1", inv=2, res=3, op_id=1)],
    "concurrent_writes": [_op("put", value="a", inv=0, res=5),
                          _op("put", value="b", inv=1, res=6, op_id=1),
                          _op("get", out="a", inv=7, res=8, op_id=2)],
    "rm_then_absent": [_op("put", value="v", inv=0, res=1),
                       _op("rm", inv=2, res=3, op_id=1),
                       _op("get", out=None, inv=4, res=5, op_id=2)],
    "stale_read": [_op("put", value="v1", inv=0, res=1),
                   _op("put", value="v2", inv=2, res=3, op_id=1),
                   _op("get", out="v1", inv=4, res=5, op_id=2)],
    "timeout_applied": [
        _op("put", value="v1", inv=0, res=1),
        _op("put", value="v2", inv=2, res=None, status="timeout",
            op_id=1),
        _op("get", out="v2", inv=4, res=5, op_id=2)],
    "timeout_never_written": [
        _op("put", value="v1", inv=0, res=1),
        _op("put", value="v2", inv=2, res=None, status="timeout",
            op_id=1),
        _op("get", out="v9", inv=4, res=5, op_id=2)],
    "per_key": [_op("put", value="a", inv=0, res=1, key="x"),
                _op("get", out="a", inv=2, res=3, key="x", op_id=1),
                _op("put", value="b", inv=0, res=1, key="y", op_id=2),
                _op("get", out="stale", inv=2, res=3, key="y", op_id=3)],
}


@pytest.mark.parametrize("case", sorted(CHECKER_CASES))
def test_checker_matches_reference(case):
    ops = CHECKER_CASES[case]
    j = jlin.check_history([dict(o) for o in ops])
    t = tlin.check_history([dict(o) for o in ops])
    assert t == j
    assert tlin.check_key([dict(o) for o in ops if o["key"] == "k"]) == \
        jlin.check_key([dict(o) for o in ops if o["key"] == "k"])
    # a state budget of 1 is exceeded alike: undecided, not a verdict
    assert tlin.check_history([dict(o) for o in ops], max_states=1) == \
        jlin.check_history([dict(o) for o in ops], max_states=1)


_res = jtests._res
L = int(Role.LEADER)
INVARIANT_CASES = {
    "I2": (3, [_res(commit=[5, 0, 0], end=[5, 0, 0], apply=[5, 0, 0]),
               _res(commit=[4, 0, 0], end=[4, 0, 0], apply=[4, 0, 0])]),
    "I4": (3, [_res(role=[L, 1, 1], term=[3, 3, 3]),
               _res(role=[1, L, 1], term=[3, 3, 3])]),
    "I5": (3, [_res(commit=[1, 0, 0])]),
    "restart": (3, [_res(commit=[9, 9, 9], end=[9, 9, 9],
                         apply=[9, 9, 9]), "reset0",
                    _res(commit=[3, 9, 9], end=[3, 9, 9],
                         apply=[3, 9, 9]),
                    (_res(commit=[1, 7, 7], end=[1, 7, 7],
                          apply=[1, 7, 7]), 2)]),
    "I1": (2, ["conv", [[(1, 1, 1, b"a")], [(1, 1, 1, b"b")]]]),
    "I1_prefix": (2, ["conv", [[(1, 1, 1, b"a")],
                               [(1, 1, 1, b"a"), (1, 1, 2, b"b")]]]),
}


def _run_invariants(mod, R, script):
    inv = mod.InvariantChecker(R)
    out = []
    items = iter(script)
    for item in items:
        try:
            if item == "reset0":
                inv.reset_replica(0)
            elif item == "conv":
                inv.check_convergence(next(items))
            elif isinstance(item, tuple):
                inv.check_step(item[0], step=len(out),
                               rebased_total=item[1])
            else:
                inv.check_step(item, step=len(out))
            out.append(None)
        except mod.InvariantViolation as v:
            out.append(v.as_dict())
    return out


@pytest.mark.parametrize("case", sorted(INVARIANT_CASES))
def test_invariant_checker_matches_reference(case):
    R, script = INVARIANT_CASES[case]
    assert _run_invariants(tinv, R, script) == \
        _run_invariants(jinv, R, script)


def test_reproducer_artifact_matches_reference(tmp_path):
    docs = []
    for art, fmod, obs in ((jart, jfaults, JObs()),
                           (tart, tfaults, Observability())):
        sched = fmod.FaultSchedule().at(2, "crash", replica=1).at(
            5, "restart", replica=1)
        path = art.write_reproducer(
            str(tmp_path / f"{art.__name__}.json"), seed=77,
            schedule=sched, reason="unit", config={"n_replicas": 3},
            history='{"t": 0, "ev": "invoke"}',
            violation={"invariant": "I2"}, obs=obs)
        doc = art.load_reproducer(path)
        docs.append({k: v for k, v in doc.items()
                     if k not in ("metrics", "trace", "spans")})
    assert docs[0] == docs[1]
    with pytest.raises(ValueError, match="schema"):
        (tmp_path / "bad.json").write_text('{"schema": 9}')
        tart.load_reproducer(str(tmp_path / "bad.json"))


# ---------------------------------------------------------------------------
# the engine under a link model, crash-restart, corruption
# ---------------------------------------------------------------------------

def _pair(**kw):
    j = JSim(JCfg(**GEO), 3, **kw)
    t = SimCluster(LogConfig(**GEO), 3, device="cpu", **kw)
    links = [jfaults.LinkModel(3, seed=4), tfaults.LinkModel(3, seed=4)]
    j.link_model, t.link_model = links
    return j, t, links


def _same_res(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_engine_under_link_model_matches_reference():
    """Serial steps and fused bursts under drops, dup, a delay and a
    block: the dispatch clock (+1 per step, +K per burst) keys the same
    per-step randomness, so every step's outputs and the replay streams
    are bit-equal."""
    j, t, links = _pair()
    for c in (j, t):
        c.run_until_elected(0)
    script = [("drop", 0.35), ("step", 6), ("dup", 0.5), ("burst", 40),
              ("step", 5), ("delay", 2), ("block", None), ("step", 8),
              ("burst", 70), ("heal", None), ("step", 6)]
    n = 0
    for op, arg in script:
        for c, link in zip((j, t), links):
            if op == "drop":
                link.set_drop(arg)
            elif op == "dup":
                link.set_dup(arg, src=0)
            elif op == "delay":
                link.set_delay(arg, dst=1, src=0)
            elif op == "block":
                link.block(2, 0)
            elif op == "heal":
                link.heal()
        if op == "step":
            for _ in range(arg):
                for c in (j, t):
                    c.submit(0, b"s%d" % n)
                n += 1
                _same_res(j.step(), t.step())
        elif op == "burst":
            for i in range(arg):
                for c in (j, t):
                    c.submit(0, b"b%d" % (n + i))
            n += arg
            _same_res(j.step_burst(), t.step_burst())
        assert t._dispatch_clock == j._dispatch_clock
    assert t._dispatch_clock == t.step_index > 30
    for r in range(3):
        assert list(t.replayed[r]) == list(j.replayed[r])


def test_link_model_is_not_ignored_by_the_engine():
    """A crashed leader is heard by nobody: under the link model it
    commits nothing (an engine that ignored its attachments committed
    here), and the psum check applies to the effective mask."""
    t = SimCluster(LogConfig(**GEO), 3, device="cpu")
    link = tfaults.LinkModel(3, seed=0)
    t.link_model = link
    t.run_until_elected(0)
    commit0 = int(t.last["commit"][0])
    tfaults.crash_replica(t, 0, link)
    for i in range(4):
        t.submit(0, b"lost%d" % i)
        res = t.step()
    assert int(res["commit"][0]) == commit0
    assert int(res["end"][0]) > commit0          # appended, never acked
    assert not any(p.startswith(b"lost") for (_, _, _, p)
                   in t.replayed[0])
    psum = SimCluster(LogConfig(**GEO), 3, fanout="psum", device="cpu")
    psum.run_until_elected(0)
    psum.link_model = tfaults.LinkModel(3, seed=0)
    psum.link_model.block(1, 0)
    clock = psum._dispatch_clock
    with pytest.raises(ValueError, match="psum"):
        psum.step()
    assert psum._dispatch_clock == clock         # a refused dispatch


@pytest.mark.parametrize("name", ["streams", "governor", "txn"])
def test_engine_refuses_unported_attachments(name):
    t = SimCluster(LogConfig(**GEO), 3, device="cpu")
    t.run_until_elected(0)
    setattr(t, name, object())                   # a stand-in subsystem
    with pytest.raises(NotImplementedError, match="item 13"):
        t.begin_step()
    with pytest.raises(NotImplementedError, match="item 13"):
        t.begin_burst()
    assert not t._tickets


def test_crash_restart_dedup_matches_reference():
    """``tests/test_chaos.py``'s crash-restart dedup script on both
    engines: equal outputs, replay streams, dedup counts and reads."""
    out = []
    for sim, kvs, mod, kw in ((JSim, JKVS, jfaults, {}),
                              (SimCluster, ReplicatedKVS, tfaults,
                               dict(device="cpu"))):
        cfg = (JCfg if sim is JSim else LogConfig)(**GEO)
        c = sim(cfg, 3, **kw)
        link = mod.LinkModel(3, seed=0)
        c.link_model = link
        kv = kvs(c, cap=256)
        hard = mod.HardStateTracker(3)
        c.run_until_elected(0)
        hard.observe(c.last)
        sess = kv.session(client_id=7)
        rid = sess.put(0, b"k", b"v1")
        c.step()
        c.step()
        hard.observe(c.last)
        got = [kv.get(0, b"k", linearizable=True)]
        mod.crash_replica(c, 0, link)
        for _ in range(4):
            res = c.step(timeouts=[1])
            hard.observe(res)
            if res["role"][1] == int(Role.LEADER):
                break
        sess.retransmit_put(1, b"k", b"v1", rid)
        sess.retransmit_put(1, b"k", b"v1", rid)
        c.step()
        c.step()
        hard.observe(c.last)
        mod.restart_replica(c, 0, link, hard=hard, kvs=kv)
        for _ in range(6):
            hard.observe(c.step())
        got += [kv.get(r, b"k") for r in range(3)]
        out.append((got, list(kv.deduped), {k: np.asarray(v) for k, v
                                           in c.last.items()},
                    [list(s) for s in c.replayed]))
    assert out[0][0] == out[1][0] == [b"v1"] * 4
    assert out[0][1] == out[1][1] == [2, 2, 2]
    _same_res(out[0][2], out[1][2])
    assert out[0][3] == out[1][3]


def test_corrupt_slot_matches_reference():
    """The corrupted word (an int32 that wraps) lands in the ledger at
    the same step and index as on JAX; the ring is rewritten into a
    fresh tensor, so the previous step's outputs keep their values."""
    j = JSim(JCfg(**GEO), 3, audit=True)
    t = SimCluster(LogConfig(**GEO), 3, audit=True, device="cpu")
    top = np.array([0x7FFFFFFF] * 4, "<i4").tobytes()
    for c in (j, t):
        c.run_until_elected(0)
        for i in range(6):
            c.submit(0, top if i == 3 else b"w%d" % i)
        for _ in range(3):
            c.step()
    g = int(t.last["commit"].min()) - 3
    buf0 = t.state.log.buf
    before = buf0.clone()
    jfaults.corrupt_slot(j, 1, g)
    tfaults.corrupt_slot(t, 1, g)
    assert torch.equal(buf0, before)             # not written in place
    slot = g & (GEO["n_slots"] - 1)
    assert int(t.state.log.buf[1, slot, 0]) == int(
        np.asarray(j.state.log.buf)[1, slot, 0])
    for c in (j, t):
        c.step()
    assert json.dumps(_no_anchor(t.auditor.dump()), sort_keys=True) == \
        json.dumps(_no_anchor(j.auditor.dump()), sort_keys=True)
    assert t.auditor.summary()["findings"] >= 1
    with pytest.raises(NotImplementedError, match="item 12"):
        tfaults.corrupt_slot(t, 1, g, group=0)


# ---------------------------------------------------------------------------
# the nemesis runner
# ---------------------------------------------------------------------------

@pytest.mark.chaos
@pytest.mark.parametrize("seed,steps,kw", [
    (1, 40, {}), (3, 50, {}), (7, 50, {}), (13, 40, {}),
    (7, 50, dict(pipeline=2)), (13, 50, dict(scan=True))],
    ids=["s1", "s3", "s7", "s13", "s7-pipeline2", "s13-scan"])
def test_nemesis_runner_matches_reference(seed, steps, kw):
    jr = JRunner(seed=seed, steps=steps, **kw)
    jv = jr.run()
    tr = NemesisRunner(seed=seed, steps=steps, device="cpu", **kw)
    tv = tr.run()
    assert tv["ok"], tv
    assert tv["linearizability"]["undecided"] == []
    assert tv["reads"]["lease"] > 0
    _same_runs(jr, tr, jv, tv)
    assert tr.schedule.to_json() == jr.schedule.to_json()
    if kw.get("scan"):
        assert tr.cluster.scan_dispatches == jr.cluster.scan_dispatches > 0
    if kw.get("pipeline"):
        assert tr.cluster.max_inflight_dispatches >= 2


@pytest.mark.chaos
def test_runner_psum_refusal_matches_reference(caplog):
    sched = [dict(step=2, op="partition", groups=[[0], [1, 2]]),
             dict(step=6, op="heal"), dict(step=10, op="dup", p=0.5)]
    with pytest.raises(ValueError, match="psum"):
        NemesisRunner(n_replicas=3, seed=0, steps=20, fanout="psum",
                      schedule=tfaults.FaultSchedule(sched), device="cpu")
    runs = []
    with caplog.at_level(logging.WARNING, "rdma_paxos_tpu_torch.chaos"):
        for cls, fmod, kw in ((JRunner, jfaults, {}),
                              (NemesisRunner, tfaults,
                               dict(device="cpu"))):
            r = cls(n_replicas=3, seed=0, steps=20, fanout="psum",
                    schedule=fmod.FaultSchedule(sched),
                    skip_incompatible_faults=True, **kw)
            runs.append((r, r.run()))
    assert any("skipping" in rec.message for rec in caplog.records
               if rec.name == "rdma_paxos_tpu_torch.chaos")
    (jr, jv), (tr, tv) = runs
    assert tr.schedule.mask_affecting() == [] and len(tr.schedule) == 2
    assert tv["ok"], tv
    _same_runs(jr, tr, jv, tv)


def _buggy_fold(self, r):
    """``tests/test_chaos.py:_buggy_fold`` over the port's KVS: the
    dedup skip is gone, so a duplicated PUT re-applies."""
    stream = self.c.replayed[r]
    while self._cursor[r] < len(stream):
        etype, conn, req, payload = stream[self._cursor[r]]
        self._cursor[r] += 1
        if etype != int(EntryType.SEND) or len(payload) != CMD_W * 4:
            continue
        if req > 0 and conn > 0:
            self.last_req[r][conn] = max(self.last_req[r].get(conn, 0),
                                         req)
        cmd = torch.from_numpy(np.frombuffer(payload, "<i4").copy()).to(
            self.device)
        self.tables[r], _ = apply_cmd(self.tables[r], cmd)


@pytest.mark.chaos
def test_dedup_bug_caught_and_replayed_like_reference(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(JKVS, "_fold", jtests._buggy_fold)
    monkeypatch.setattr(ReplicatedKVS, "_fold", _buggy_fold)
    jr = JRunner(seed=1, artifact_path=str(tmp_path / "j.json"),
                 **jtests._BUG_RUN)
    jv = jr.run()
    art = str(tmp_path / "t.json")
    tr = NemesisRunner(seed=1, artifact_path=art, device="cpu",
                       **jtests._BUG_RUN)
    tv = tr.run()
    assert tv["ok"] is False and tv["invariant_violations"] == []
    assert tv["linearizability"]["ok"] is False
    assert tv["artifact"] == art
    _same_runs(jr, tr, jv, tv)
    doc = tart.load_reproducer(art)
    assert doc["extra"]["verdict"] == _verdict(tv)
    assert doc["history"] == tr.history.to_jsonl()
    rv = NemesisRunner.replay(art, device="cpu")
    assert rv["linearizability"]["violations"] == \
        tv["linearizability"]["violations"]
    monkeypatch.undo()
    clean = NemesisRunner(seed=1, device="cpu", **jtests._BUG_RUN).run()
    assert clean["ok"], clean


@pytest.mark.parametrize("mode", ["repair", "governor", "streams"])
def test_runner_refuses_unported_modes(mode):
    with pytest.raises(NotImplementedError, match="item 13"):
        NemesisRunner(seed=0, steps=10, device="cpu", **{mode: True})


@pytest.mark.chaos
def test_geometry_a_runs_clean_on_the_port():
    """``chip_smoke.py`` phase 9b's run, cut to 60 steps: the bench
    geometry with its clients and keys ends ok with every key decided."""
    geom, _fanout = GEOMETRIES["a"]
    tr = NemesisRunner(LogConfig(**geom), device="cpu",
                       **dict(CHAOS_A, steps=60))
    v = tr.run()
    assert v["ok"], v
    assert v["linearizability"]["undecided"] == []
    assert v["linearizability"]["ops"] > 2 * CHAOS_A["n_keys"]
    assert v["audit"]["findings"] == 0


@pytest.mark.slow
@pytest.mark.chaos
@pytest.mark.parametrize("n", [8, 16, 32, 64, 128, 256, 512])
def test_geometry_a_jax_runner_decides_every_key(n):
    """The size search behind ``chip_smoke.py`` phase 9b (run with
    ``-m slow``; up to ~90 s a case): at geometry (a), seed 7, 200
    steps, the JAX runner on the CPU decides every key with ``n``
    clients on ``n`` keys, so the phase's time budget, not the checker,
    bounds 9b's size."""
    geom, _fanout = GEOMETRIES["a"]
    v = JRunner(JCfg(**geom), **dict(CHAOS_A, n_clients=n,
                                     n_keys=n)).run()
    assert v["ok"], v
    assert v["linearizability"]["undecided"] == []
