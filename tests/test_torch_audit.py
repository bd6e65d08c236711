"""Port parity of the audit digest chain: the port's ``audit=`` step
variant, engine ledger, flight ring, snapshot verification and range
re-digest on the CPU against the JAX package's, with exact equality.

* ``digest_fold`` (the port's device form and its numpy form) equals the
  JAX fold bit for bit, i32 negatives and all-ones words included;
* the step's ``audit_*`` outputs equal JAX's on seeded schedules
  (elections, partitions, both fan-outs, windows below index 0);
* engine workloads (``step``, ``step_burst``, the ``scan=True`` tier,
  partitions, psum, ``rebase=300`` rollovers) give equal ledger dumps
  (without ``anchor``), summaries and flight dumps;
* a corrupted word is localized to its exact index, as by JAX;
* ``verify_snapshot``/``install_snapshot(ledger=)`` accept and refuse the
  same donors, across the two packages' snapshots and ledgers;
* ``redigest`` backfills like JAX, and ``merge_dumps`` of a JAX dump and
  a port dump reports no divergence;
* the ledger, flight recorder, artifact and CLI copies behave as the
  reference's on the same inputs."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdma_paxos_tpu.config import LogConfig as JCfg
from rdma_paxos_tpu.consensus import snapshot as jsnap
from rdma_paxos_tpu.consensus.log import Log as JLog
from rdma_paxos_tpu.consensus.step import (
    StepInput as JInput, digest_fold as jfold)
from rdma_paxos_tpu.obs import audit as jaudit
from rdma_paxos_tpu.parallel.mesh import (
    build_sim_step as j_build_step, stack_states as j_stack)
from rdma_paxos_tpu.runtime.sim import SimCluster as JSim
from rdma_paxos_tpu_torch.config import LogConfig
from rdma_paxos_tpu_torch.consensus import snapshot as tsnap
from rdma_paxos_tpu_torch.consensus.step import (
    StepInput, digest_fold, digest_fold_np)
from rdma_paxos_tpu_torch.convert import replica_state_to_numpy
from rdma_paxos_tpu_torch.obs import audit as taudit
from rdma_paxos_tpu_torch.parallel.mesh import build_sim_step, stack_states
from rdma_paxos_tpu_torch.runtime.sim import SimCluster
from tests.test_torch_sim import GEO, run_workload
from tests.test_torch_step import (
    CFG, INPUT_FIELDS, JCFG, assert_same, random_input)
from tests.test_torch_sim import jax_step_cache_restored  # noqa: F401

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

W = GEO["window_slots"]


def _u32(x):
    """A digest array of either package as u32."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def _no_anchor(doc):
    doc = dict(doc)
    doc.pop("anchor")
    return doc


def pair(**kw):
    """A JAX engine and the port's, audited, elected at replica 0."""
    j = JSim(JCfg(**GEO), 3, audit=True, **kw)
    t = SimCluster(LogConfig(**GEO), 3, audit=True, device="cpu", **kw)
    for c in (j, t):
        c.run_until_elected(0)
    return j, t


def traffic(cs, n, steps, tag=b"v"):
    for c in cs:
        for i in range(n):
            c.submit(c.leader(), tag + b"%d" % i)
        for _ in range(steps):
            c.step()


def corrupt(c, replica, g_idx, word=0):
    """Add 1 to one payload word of the slot holding index ``g_idx``."""
    slot = g_idx & (c.cfg.n_slots - 1)
    if isinstance(c, SimCluster):
        c.state.log.buf[replica, slot, word] += 1
    else:
        buf = c.state.log.buf.at[replica, slot, word].add(1)
        c.state = dataclasses.replace(c.state, log=JLog(buf=buf))


# ---------------------------------------------------------------------------
# the fold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slot_words", [8, 32, 128])
def test_digest_fold_matches_jax(slot_words):
    rng = np.random.default_rng(slot_words)
    cols = slot_words + 8
    rows = rng.integers(-2 ** 31, 2 ** 31, (257, cols),
                        dtype=np.int64).astype(np.int32)
    rows[0] = -1                                  # all-ones words
    rows[1] = 0
    rows[2] = np.iinfo(np.int32).min
    rows[3] = rng.integers(-5, 5, cols)
    ref = jfold(rows.astype(np.uint32), xp=np)
    np.testing.assert_array_equal(
        np.asarray(jfold(jnp.asarray(rows.astype(np.uint32)))), ref)
    np.testing.assert_array_equal(digest_fold_np(rows), ref)
    dev = digest_fold(torch.from_numpy(rows))
    assert dev.dtype == torch.int64
    np.testing.assert_array_equal(dev.numpy(), ref.astype(np.int64))
    np.testing.assert_array_equal(_u32(dev.to(torch.int32)), ref)
    # batched [R, W, cols] rows fold row by row
    np.testing.assert_array_equal(
        digest_fold(torch.from_numpy(rows[:255].reshape(3, 85, cols))
                    ).numpy().reshape(-1), ref[:255].astype(np.int64))
    # the gidx column is left out; a flip of any other column changes
    # every digest (the mul-add and the finalizer are bijective)
    gidx = cols - 8 + 5
    flip = rows.copy()
    flip[:, gidx] += 7
    assert torch.equal(digest_fold(torch.from_numpy(flip)), dev)
    for c in (0, slot_words - 1, slot_words + 1, cols - 1):
        flip = rows.copy()
        flip[:, c] ^= 1
        assert (digest_fold(torch.from_numpy(flip)) != dev).all(), c
        np.testing.assert_array_equal(digest_fold_np(flip),
                                      jfold(flip.astype(np.uint32), xp=np))


# ---------------------------------------------------------------------------
# the step variant
# ---------------------------------------------------------------------------

def run_step_schedule(R, fanout, seed, steps=40, **variants):
    """The seeded schedule of tests/test_torch_step.py through both
    packages' step builders with ``variants`` on; every output (the
    variant's included) and the post-state compared after every step.
    Returns the port outputs of every step."""
    rng = np.random.default_rng(seed)
    jsteps = {e: j_build_step(JCFG, R, fanout=fanout, elections=e,
                              **variants) for e in (True, False)}
    tsteps = {e: build_sim_step(CFG, R, fanout=fanout, elections=e,
                                **variants) for e in (True, False)}
    jst = j_stack(JCFG, R, R)
    tst = stack_states(CFG, R, R, device="cpu")
    commit = np.zeros(R, np.int64)
    applied = np.zeros(R, np.int64)
    epoch = [0]
    outs = []
    for step in range(steps):
        inp = random_input(rng, R, fanout, commit, applied, set(), epoch)
        if step == 0:
            inp["timeout_fired"][:] = 0
            inp["timeout_fired"][0] = 1
        elections = bool(inp["timeout_fired"].any()) or rng.random() < 0.3
        jin = JInput(**{k: jnp.asarray(inp[k]) for k in INPUT_FIELDS})
        tin = StepInput(**{k: torch.from_numpy(inp[k])
                           for k in INPUT_FIELDS})
        jst, jout = jsteps[elections](jst, jin)
        tst, tout = tsteps[elections](tst, tin)
        tag = f"step {step} el={elections}"
        assert_same(jst, jout, tst, tout, tag)
        for k in ("audit_start", "audit_term", "telemetry"):
            if getattr(jout, k) is None:
                assert getattr(tout, k) is None, (tag, k)
            elif k == "telemetry":
                np.testing.assert_array_equal(
                    _u32(tout.telemetry), np.asarray(jout.telemetry),
                    err_msg=f"{tag}: {k}")
            else:
                np.testing.assert_array_equal(
                    getattr(tout, k).numpy(), np.asarray(getattr(jout, k)),
                    err_msg=f"{tag}: {k}")
        if jout.audit_digest is not None:
            np.testing.assert_array_equal(
                _u32(tout.audit_digest), np.asarray(jout.audit_digest),
                err_msg=f"{tag}: audit_digest")
        commit = tout.commit.numpy().astype(np.int64)
        outs.append(tout)
    assert commit.max() >= 2 * CFG.window_slots, "schedule never committed"
    return outs


@pytest.mark.parametrize("R,fanout,seed", [
    (3, "gather", 0), (5, "gather", 1), (3, "psum", 2)])
def test_audit_step_schedule_matches_jax(R, fanout, seed):
    outs = run_step_schedule(R, fanout, seed, audit=True)
    # windows reaching below index 0 (commit < W) wrap their slots and
    # are masked, as in JAX
    assert any(int(o.commit.min()) < W for o in outs)
    assert all(int(o.audit_start.min()) >= 0 for o in outs)


# ---------------------------------------------------------------------------
# the engine: ledgers, flight rings
# ---------------------------------------------------------------------------

WORKLOADS = {
    "gather": (3, "gather", 0, {}),
    "scan_wedge": (5, "gather", 1, dict(wedge=True, scan=True)),
    "psum_rebase": (3, "psum", 2, dict(rebase=300, steps=90)),
}


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_engine_ledgers_match_jax(name):
    R, fanout, seed, kw = WORKLOADS[name]
    j, t = run_workload(R, fanout, seed, audit=True, telemetry=True, **kw)
    assert _no_anchor(t.auditor.dump()) == _no_anchor(j.auditor.dump())
    assert t.auditor.summary() == j.auditor.summary()
    assert _no_anchor(t.flight.dump()) == _no_anchor(j.flight.dump())
    np.testing.assert_array_equal(t.device_counters, j.device_counters)
    assert t.auditor.findings == [] and t.auditor.indices_checked > 0
    if kw.get("rebase"):
        assert t.rebases >= 1
    # the windows tile the committed prefix: every index below the
    # lowest commit of a replying replica was digested
    live = [r for r in range(R) if r not in t.need_recovery]
    low = int(min(t.last["commit"][r] for r in live)) + t.rebased_total
    tracked = set(t.auditor._idx[0])
    assert set(range(max(0, low - t.auditor.history), low)) <= tracked


def test_burst_windows_tile_every_entry():
    j, t = pair()
    for c in (j, t):
        c.step()
        for i in range(20):                # > 2 batches: a fused burst
            c.submit(0, b"b%d" % i)
        c.step_burst()
    assert t.auditor.findings == []
    commit = int(t.last["commit"].min())
    assert set(range(commit)) <= set(t.auditor._idx[0])
    assert _no_anchor(t.auditor.dump()) == _no_anchor(j.auditor.dump())
    assert t.flight.dump()["steps"][-1]["burst_k"] == j.flight.dump()[
        "steps"][-1]["burst_k"] >= 2


def test_corruption_is_found_at_the_exact_index_like_jax():
    found = {}
    for c in pair():
        traffic([c], 6, 4)
        target = int(c.last["commit"].min()) - 1
        corrupt(c, 2, target)
        for _ in range(3):
            c.step()
        found[type(c)] = (target, c.auditor.first_divergence())
    (tj, fj), (tt, ft) = found[JSim], found[SimCluster]
    assert ft is not None and ft == fj and tt == tj
    assert ft["index"] == tt and ft["got_replicas"] == [2]
    assert ft["got_digest"] != ft["expected_digest"]


# ---------------------------------------------------------------------------
# verified install
# ---------------------------------------------------------------------------

def test_verified_install_accepts_and_refuses_like_jax():
    j, t = pair()
    traffic((j, t), 6, 4)
    target = int(t.last["commit"].min()) - 1
    for c in (j, t):
        corrupt(c, 2, target)
        for _ in range(3):
            c.step()
    snaps = {}
    for c, mod in ((j, jsnap), (t, tsnap)):
        snaps[mod] = {d: mod.take_snapshot(
            c.state, d, b"blob", index=int(c.applied[d]), digests=True,
            rebased_total=c.rebased_total) for d in (0, 2)}
    for d in (0, 2):
        js, ts = snaps[jsnap][d], snaps[tsnap][d]
        for f in ("index", "term", "epoch", "bitmask_old", "bitmask_new",
                  "cid_state", "digest_epoch", "audit_start"):
            assert getattr(ts, f) == getattr(js, f), (d, f)
        assert ts.audit_digests.dtype == np.uint32
        np.testing.assert_array_equal(ts.audit_digests, js.audit_digests)
    # each package's verdicts, on its own and on the other's snapshots
    # and ledgers
    for mod in (jsnap, tsnap):
        for led in (j.auditor, t.auditor):
            for src in (snaps[jsnap], snaps[tsnap]):
                assert mod.verify_snapshot(src[0], led) == \
                    jsnap.verify_snapshot(snaps[jsnap][0], j.auditor) > 0
                with pytest.raises(mod.SnapshotVerifyError,
                                   match="contradicts"):
                    mod.verify_snapshot(src[2], led)
                with pytest.raises(mod.SnapshotVerifyError,
                                   match="unverifiable"):
                    mod.verify_snapshot(src[0], led, min_verified=10 ** 6)
        bad = dataclasses.replace(snaps[mod][0], digest_epoch=2)
        with pytest.raises(mod.SnapshotEpochError):
            mod.verify_snapshot(bad, t.auditor)
        plain = mod.take_snapshot(j.state if mod is jsnap else t.state, 0)
        with pytest.raises(mod.SnapshotVerifyError, match="no digest"):
            mod.verify_snapshot(plain, t.auditor)
    # the refused install touches nothing; the verified one equals JAX's
    before = replica_state_to_numpy(t.state)
    with pytest.raises(tsnap.SnapshotVerifyError):
        tsnap.install_snapshot(t.state, 1, snaps[tsnap][2],
                               ledger=t.auditor)
    after = replica_state_to_numpy(t.state)
    for k in before:
        np.testing.assert_array_equal(before[k], after[k], err_msg=k)
    j.state = jsnap.install_snapshot(j.state, 1, snaps[jsnap][0],
                                     ledger=j.auditor)
    t.state = tsnap.install_snapshot(t.state, 1, snaps[tsnap][0],
                                     ledger=t.auditor)
    js, ts = replica_state_to_numpy(j.state), replica_state_to_numpy(t.state)
    for k in js:
        np.testing.assert_array_equal(js[k], ts[k], err_msg=k)


def test_take_snapshot_digests_after_rollovers_match_jax():
    geo = dict(GEO, rebase_threshold=300)
    cs = [JSim(JCfg(**geo), 3, audit=True),
          SimCluster(LogConfig(**geo), 3, audit=True, device="cpu")]
    for c in cs:
        c.run_until_elected(0)
        for i in range(500):
            c.submit(0, b"r%d" % i)
            if i % 8 == 7:
                c.step()
        c.step()
    j, t = cs
    assert t.rebases >= 1 and t.rebased_total == j.rebased_total
    js = jsnap.take_snapshot(j.state, 1, digests=True,
                             rebased_total=j.rebased_total)
    ts = tsnap.take_snapshot(t.state, 1, digests=True,
                             rebased_total=t.rebased_total)
    assert (ts.audit_start, ts.index) == (js.audit_start, js.index)
    assert ts.audit_start >= t.rebased_total
    np.testing.assert_array_equal(ts.audit_digests, js.audit_digests)
    assert tsnap.verify_snapshot(ts, t.auditor) == \
        jsnap.verify_snapshot(js, j.auditor) > 0


# ---------------------------------------------------------------------------
# redigest, merge
# ---------------------------------------------------------------------------

def test_redigest_backfills_like_jax():
    j, t = pair()
    traffic((j, t), 12, 5)
    counts = []
    for c in (j, t):
        lo, hi = int(c.last["head"][0]), int(c.last["commit"][0])
        assert hi - lo > 4
        n0 = len(c.auditor.findings)
        counts.append(c.redigest(0, lo, hi))
        assert len(c.auditor.findings) == n0 == 0
    assert counts[0] == counts[1] > 0
    assert t.auditor.summary() == j.auditor.summary()
    assert t.auditor.summary()["backfilled"] == counts[1]
    assert _no_anchor(t.auditor.dump()) == _no_anchor(j.auditor.dump())
    assert t.redigest(0, 5, 5) == 0
    # a range whose slots were recycled is refused by both
    traffic((j, t), 80, 14)
    for c in (j, t):
        with pytest.raises(RuntimeError, match="integrity"):
            c.redigest(0, 0, 4)
    # the serial path only
    tk = t.begin_step()
    with pytest.raises(RuntimeError, match="in-flight"):
        t.redigest(0, 0, 1)
    t.finish(tk)
    with pytest.raises(RuntimeError, match="audit=True"):
        SimCluster(LogConfig(**GEO), 3, device="cpu").redigest(0, 0, 1)


def test_merge_of_a_jax_dump_and_a_port_dump():
    j, t = pair()
    traffic((j, t), 6, 4)
    for merge in (jaudit.merge_dumps, taudit.merge_dumps):
        rep = merge([j.auditor.dump(), t.auditor.dump()])
        assert rep["findings"] == [] and rep["first"] is None
        assert rep["indices"] > 0
    target = int(t.last["commit"].min()) - 1
    corrupt(t, 2, target)
    for _ in range(2):
        t.step()
        j.step()
    reps = [merge([j.auditor.dump(), t.auditor.dump()])
            for merge in (jaudit.merge_dumps, taudit.merge_dumps)]
    assert reps[0] == reps[1]
    assert reps[1]["first"]["index"] == target


# ---------------------------------------------------------------------------
# the host module's copies
# ---------------------------------------------------------------------------

def _ledger_script(mod):
    led = mod.AuditLedger(3, history=16)
    led.record_window(0, 10, [111, 222, 333], [1, 1, 2], 13)
    led.record_window(1, 10, np.array([111, 222, 333], np.uint32),
                      [1, 1, 2], 13)
    led.record_window(2, 10, [111, 999, 333], [1, 1, 2], 13)  # replica
    led.record_window(0, 11, [222, 777], [1, 2], 13)            # self
    led.record_window(0, 11, [222, 777], [1, 2], 13)            # dedup
    led.record_window(1, 13, [5, 6], [2, 2], 15, epoch=99)      # epoch
    led.record_window(1, 0, [9, 9], [1, 1], 2, backfill=True)
    for start in range(20, 200, 4):                             # retain
        led.record_window(2, start, [start] * 4, [3] * 4, start + 4)
    cap = mod.AuditLedger(2)
    cap.MAX_FINDINGS = 4
    cap.record_window(0, 0, list(range(100, 110)), [1] * 10, 10)
    cap.record_window(1, 0, list(range(200, 210)), [1] * 10, 10)
    return led, cap


def test_ledger_and_recorder_copies_match_the_reference(tmp_path):
    (jl, jc), (tl, tc) = _ledger_script(jaudit), _ledger_script(taudit)
    assert taudit.AUDIT_KEYS == jaudit.AUDIT_KEYS
    for a, b in ((jl, tl), (jc, tc)):
        assert _no_anchor(b.dump()) == _no_anchor(a.dump())
        assert b.summary() == a.summary()
        assert b.findings == a.findings
        assert b.first_divergence() == a.first_divergence()
    assert tc.summary()["findings_dropped"] == 6
    merged = [m.merge_dumps([jl.dump(), tl.dump(), jc.dump()])
              for m in (jaudit, taudit)]
    assert merged[0] == merged[1]
    assert taudit.format_report(merged[1]) == jaudit.format_report(merged[0])
    # flight rings and artifacts, and the CLI's verdict on them
    rec = [m.FlightRecorder(2) for m in (jaudit, taudit)]
    for r in rec:
        for s in range(3):
            r.record(dict(step=s, inputs=[[(3, 1, s, b"\x00\xff")]],
                          digests=dict(window=np.arange(3, dtype=np.uint32)
                                       * np.uint32(0x9E3779B1))))
    assert _no_anchor(rec[1].dump()) == _no_anchor(rec[0].dump())
    for name, led, rc in (("clean", tl.__class__(3), 0), ("dirty", tl, 1)):
        path = taudit.write_audit_artifact(
            str(tmp_path / f"{name}.json"), reason=name, ledger=led,
            flight=rec[1])
        doc = json.load(open(path))
        assert doc["kind"] == "audit_artifact" and doc["reason"] == name
        assert taudit.main(["report", path]) == rc
        assert jaudit.main(["report", path]) == rc
