"""Port parity: the rest of ``obs`` — the spans breakdown and CLI, the
profiler half of ``obs/device.py`` and the drivers' profile hooks.

``breakdown``, ``format_breakdown``, the spans CLI and ``merge_timeline``
must equal the JAX package's on the same span dumps, phase events and
device events (``tests/test_spans.py:272``, ``:284``,
``tests/test_device_obs.py:396``). The driver capture follows
``tests/test_device_obs.py:423`` on the port's ``torch.profiler``
session: one capture at a time, the merged timeline's three layers, a
page starting one bounded capture. ``program_report``'s variants are
JAX's (``:487``, ``:504``); its per-variant numbers are the port's own
(dispatched ops, and kernels on the card), not JAX's cost analysis."""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest
import torch

from rdma_paxos_tpu.obs import device as j_device
from rdma_paxos_tpu.obs import spans as j_spans
from rdma_paxos_tpu_torch.config import LogConfig, TimeoutConfig
from rdma_paxos_tpu_torch.obs import device as t_device
from rdma_paxos_tpu_torch.obs import spans as t_spans
from tests.test_torch_sim import jax_step_cache_restored  # noqa: F401

torch.set_num_threads(1)

GEO = dict(n_slots=64, slot_bytes=32, window_slots=16, batch_slots=8)
CFG = LogConfig(**GEO)
TO = TimeoutConfig(elec_timeout_low=1e9, elec_timeout_high=2e9)  # manual
ANCHORS = ({"monotonic": 0.0, "wall": 10.0}, {"monotonic": 5.0,
                                               "wall": 10.0})


def scripted_dump(mod, anchor) -> dict:
    """One full span, one failover span and a second command with a
    retransmit, on a scripted clock (the JAX tests' scenario, widened)."""
    t = [0.0]

    def clock():
        t[0] += 0.001
        return round(t[0], 6)
    rec = mod.SpanRecorder(sample_every=1, clock=clock)
    rec.begin(7, 1, 0)
    rec.stamp_append(7, 1, term=3, index=5, leader=0, replicas=(0, 1))
    rec.commit_advance(0, 6)
    rec.apply_advance(0, 6)
    rec.commit_advance(1, 6)
    rec.apply_advance(1, 6)
    rec.ack_release(0, 1)
    rec.begin(7, 3, 1)
    rec.stamp_append(7, 3, term=3, index=6, leader=0, replicas=(0, 1))
    rec.commit_advance(0, 7)
    rec.apply_advance(0, 7)
    rec.ack_release(1, 3)
    rec.begin(7, 2, 0)
    rec.fail_open(0)
    return rec.dump(anchor=anchor)


def same_but_tool(a: dict, b: dict) -> None:
    """Documents equal apart from the producer's name."""
    a, b = json.loads(json.dumps(a)), json.loads(json.dumps(b))
    assert a["otherData"].pop("tool") == "rdma_paxos_tpu.obs.spans"
    assert b["otherData"].pop("tool") == "rdma_paxos_tpu_torch.obs.spans"
    assert a == b


@pytest.mark.parametrize("anchor", ANCHORS)
def test_breakdown_matches_jax(anchor):
    jd, td = scripted_dump(j_spans, anchor), scripted_dump(t_spans, anchor)
    assert jd == td
    jb, tb = j_spans.breakdown(jd), t_spans.breakdown(td)
    assert jb == tb and jb["spans"] == {"done": 2, "failover": 1}
    assert t_spans.format_breakdown(tb) == j_spans.format_breakdown(jb)
    both = [scripted_dump(t_spans, a) for a in ANCHORS]
    assert t_spans.breakdown(both) == j_spans.breakdown(both)


def test_spans_cli_matches_jax(tmp_path, capsys):
    files = []
    for i, a in enumerate(ANCHORS):
        f = tmp_path / f"spans{i}.json"
        f.write_text(json.dumps(scripted_dump(t_spans, a)))
        files.append(str(f))
    docs, text = {}, {}
    for name, mod in (("jax", j_spans), ("torch", t_spans)):
        out = tmp_path / f"{name}.json"
        assert mod.main(["merge", *files, "-o", str(out)]) == 0
        docs[name] = json.load(open(out))
        capsys.readouterr()
        assert mod.main(["report", *files]) == 0
        text[name] = capsys.readouterr().out
    same_but_tool(docs["jax"], docs["torch"])
    assert text["jax"] == text["torch"]
    assert "append->quorum" in text["torch"]
    with pytest.raises(SystemExit):
        t_spans.main(["report", str(tmp_path / "torch.json")])


def device_track(n: int = 5) -> list:
    """Synthetic profiler events (``ts`` µs since the capture's start)."""
    ev = [dict(name="process_name", ph="M", pid=3, tid=0,
               args=dict(name="/device:GPU:0")),
          dict(name="thread_name", ph="M", pid=3, tid=7,
               args=dict(name="stream 7"))]
    ev += [dict(name="commit_window_kernel", ph="X", ts=100.0 * i + 3.5,
                dur=5.5, pid=3, tid=7, args={}) for i in range(n)]
    ev += [dict(name="cudaLaunchKernel", ph="X", ts=100.0 * i, dur=2.0,
                pid=9, tid=9, args={}) for i in range(n)]
    ev.append(dict(name="flow", ph="s", ts=1.0, pid=9, tid=9, id=1))
    return ev


@pytest.mark.parametrize("cap", [None, 4])
def test_merge_timeline_matches_jax(cap):
    anchor = {"monotonic": 0.0, "wall": 100.0}
    dumps = [scripted_dump(t_spans, anchor)]
    phases = [("host_encode", 0.0005, 0.0010),
              ("device_dispatch", 0.0010, 0.0030)]
    kw = dict(phase_events=phases, phase_anchor=anchor,
              device_events=device_track(), device_wall_start=100.002)
    if cap is not None:
        kw["max_device_events"] = cap
    j = j_device.merge_timeline(dumps, **kw)
    t = t_device.merge_timeline(dumps, **kw)
    same_but_tool(j, t)
    assert t["otherData"]["device_events"] == (10 if cap is None else cap)
    assert t["otherData"]["host_phase_events"] == 2
    # spans and phases only
    same_but_tool(j_device.merge_timeline(dumps, phase_events=phases,
                                          phase_anchor=anchor),
                  t_device.merge_timeline(dumps, phase_events=phases,
                                          phase_anchor=anchor))


def test_profiler_session_bounds_and_trace(tmp_path):
    s = t_device.ProfilerSession(str(tmp_path / "p"), max_seconds=60)
    assert not s.expired() and s.chrome_events() == []
    s.start()
    with pytest.raises(RuntimeError, match="already active"):
        t_device.ProfilerSession(str(tmp_path / "q")).start()
    x = torch.arange(1000) * 3
    assert int(x.sum()) == 3 * 999 * 1000 // 2
    assert not s.maybe_stop()
    s._deadline = 0.0                      # the bound elapsed
    assert s.expired() and s.maybe_stop() and not s.active
    assert s.stop() is s                   # idempotent
    assert len(s.trace_files) == 1 and s.trace_files[0].endswith(
        ".trace.json.gz")
    ev = s.chrome_events()
    marks = [e for e in ev if e.get("name") == t_device.ANCHOR_EVENT]
    assert len(marks) == 1 and marks[0]["ts"] == 0.0
    assert any(e.get("name", "").startswith("aten::") for e in ev)
    assert t_device.load_profiler_dir(s.log_dir) == ev
    assert s.summary()["trace_files"] == s.trace_files
    # the CLI merges the capture dir
    out = tmp_path / "merged.json"
    assert t_device.main(["merge", "--profile-dir", s.log_dir,
                          "--wall-start", str(s.wall_start),
                          "-o", str(out)]) == 0
    doc = json.load(open(out))
    assert doc["otherData"]["device_events"] > 0
    with pytest.raises(SystemExit):
        t_device.main(["merge", "--profile-dir", s.log_dir, "-o",
                       str(out)])


def test_driver_capture_and_merged_timeline(tmp_path):
    """``tests/test_device_obs.py:423`` on the port: one capture at a
    time; spans, host phases and the capture merge on one epoch; a page
    starts ONE bounded capture, never a second."""
    from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver
    d = ClusterDriver(CFG, 3, timeout_cfg=TO, telemetry=True, device="cpu")
    try:
        d.obs.spans.set_sample_every(1)
        d.runtimes[0].timer._deadline = 0.0
        d.step()
        assert d.leader() == 0
        d._phase_prof.enable_events()
        session = d.start_profile(seconds=120,
                                  log_dir=str(tmp_path / "prof"))
        assert session.active
        with pytest.raises(RuntimeError):
            d.start_profile()             # one capture at a time
        for i in range(3):
            d.obs.spans.begin(7, i + 1, 0)
            d.cluster.submit(0, b"p%d" % i, conn=7, req_id=i + 1)
            d.step()
        d.stop_profile()
        assert not session.active and session.trace_files
        events = session.chrome_events()
        assert events
        doc = t_device.merge_timeline(
            [d.obs.spans.dump()],
            phase_events=list(d._phase_prof.events), profiler=session)
        assert doc["otherData"]["device_events"] > 0
        assert doc["otherData"]["host_phase_events"] > 0
        assert doc["otherData"]["spans"] > 0
        pids = {e["pid"] for e in doc["traceEvents"]}
        assert t_device.HOST_PHASE_PID in pids
        assert any(p >= t_device.DEVICE_PID_BASE for p in pids)
        for e in doc["traceEvents"]:
            if "ts" in e:
                assert e["ts"] >= 0
        json.dumps(doc)
        assert d.obs.metrics.get("device_committed_entries_total",
                                 replica=0) > 0

        # the observe pass expires a bounded capture
        d._profile_on_page = 30.0
        d.obs.metrics.inc("audit_divergence_total")
        d.evaluate_alerts()
        assert d.profile_session is not session
        assert d.profile_session.active
        d.profile_session._deadline = 0.0
        d._poll_profile()
        assert not d.profile_session.active
        # one capture per process: a second page never re-triggers
        d.evaluate_alerts()
        assert not d.profile_session.active
        shutil.rmtree(d.profile_session.log_dir, ignore_errors=True)
    finally:
        d.stop()


def test_sharded_driver_capture(tmp_path):
    from rdma_paxos_tpu_torch.runtime.sharded_driver import (
        ShardedClusterDriver)
    d = ShardedClusterDriver(CFG, 3, 2, device="cpu",
                             timeout_cfg=TimeoutConfig(
                                 elec_timeout_low=0.05,
                                 elec_timeout_high=0.1),
                             group_timer_lo=1, group_timer_hi=2,
                             profile_on_page=5.0)
    try:
        s = d.start_profile(seconds=60, log_dir=str(tmp_path / "prof"))
        for _ in range(6):
            d.step()
        assert d.stop_profile() is s and s.trace_files and s.chrome_events()
    finally:
        d.stop()


def test_program_report_variants_match_jax(tmp_path):
    from rdma_paxos_tpu.config import LogConfig as JCfg
    from rdma_paxos_tpu.runtime.sim import SimCluster as JSim
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    jc = JSim(JCfg(**GEO), 3, telemetry=True)
    jc.run_until_elected(0)
    jrep = j_device.program_report(jc, tiers=(2,))
    c = SimCluster(CFG, 3, telemetry=True, device="cpu")
    c.run_until_elected(0)
    rep = t_device.write_program_report(
        str(tmp_path / "program_report.json"), c, tiers=(2,))
    assert [v["variant"] for v in rep["variants"]] == [
        v["variant"] for v in jrep["variants"]] == [
        "step/full", "step/stable", "burst/K=2"]
    assert set(rep) - {"path"} == set(jrep)
    for k in ("schema", "kind", "engine", "n_replicas", "n_groups",
              "config", "telemetry", "audit"):
        assert rep[k] == jrep[k], k
    assert rep["backend"] == "cpu"
    # the ops of one stable step, counted on a clone of the state
    from rdma_paxos_tpu_torch.consensus.state import clone_state
    from rdma_paxos_tpu_torch.consensus.step import make_step_input
    inp = make_step_input(CFG, 3, device="cpu")
    st = clone_state(c.state)
    ops = t_device.count_ops(lambda: c._steps[False](st, inp))
    stable = rep["variants"][1]
    assert stable["ops"] == ops > 0 and stable["kernels"] is None
    assert rep["variants"][2]["ops"] > 2 * ops * 0.9
    doc = json.load(open(rep["path"]))
    assert doc["kind"] == "program_report" and len(doc["variants"]) == 3
    assert not os.path.exists(rep["path"] + ".tmp")


def test_program_report_sharded_engine_matches_jax():
    from rdma_paxos_tpu.config import LogConfig as JCfg
    from rdma_paxos_tpu.shard.cluster import ShardedCluster as JSharded
    from rdma_paxos_tpu_torch.shard.cluster import ShardedCluster
    jsc = JSharded(JCfg(**GEO), 3, 2)
    jsc.place_leaders()
    jrep = j_device.program_report(jsc)
    sc = ShardedCluster(CFG, 3, 2, device="cpu")
    sc.place_leaders()
    rep = t_device.program_report(sc)
    assert rep["n_groups"] == jrep["n_groups"] == 2
    assert rep["engine"] == jrep["engine"] == "sim"
    assert [v["variant"] for v in rep["variants"]] == [
        v["variant"] for v in jrep["variants"]]
    assert all(v["ops"] > 0 for v in rep["variants"])
    before = np.asarray(sc.state.log.buf).copy()
    t_device.program_report(sc, tiers=(2,))
    assert np.array_equal(before, np.asarray(sc.state.log.buf))
