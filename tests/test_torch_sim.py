"""Port parity at engine level: one recorded workload through the JAX
package's ``SimCluster`` and the port's must give equal step results,
replay streams, apply cursors and device state after every dispatch —
through elections, partitions, failovers, fused bursts, CONFIG entries,
a wedged apply (forced pruning, recovery flag) and coordinated i32
rebases at a small ``rebase_threshold``."""

import numpy as np
import torch
import pytest

from rdma_paxos_tpu.config import LogConfig as JCfg
from rdma_paxos_tpu.runtime.sim import SimCluster as JSim
from rdma_paxos_tpu_torch.config import LogConfig
from rdma_paxos_tpu_torch.consensus.log import EntryType
from rdma_paxos_tpu_torch.convert import replica_state_to_numpy
from rdma_paxos_tpu_torch.runtime.sim import (
    SimCluster, cap_tiers, clamp_burst_take, rebase_delta_of,
    requeue_shortfall)

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

GEO = dict(n_slots=64, slot_bytes=32, window_slots=16, batch_slots=8)


@pytest.fixture(autouse=True, scope="module")
def jax_step_cache_restored():
    """Leave the JAX engine's shared step cache as this module found it.
    The JAX package's own tests assert which keys a cluster ADDS to
    ``rdma_paxos_tpu.runtime.sim.STEP_CACHE``; a JAX engine built here
    with the same geometry and variant would have added them first
    when a test worker runs this module before theirs. Every port
    module that builds a JAX variant or group engine imports this
    fixture (autouse), so it deletes only the keys it added."""
    from rdma_paxos_tpu.runtime.sim import STEP_CACHE
    before = set(STEP_CACHE)
    yield
    for k in set(STEP_CACHE) - before:
        del STEP_CACHE[k]


def assert_engines_equal(j, t, tag):
    for k, v in j.last.items():
        if k in t.last:
            np.testing.assert_array_equal(np.asarray(v), t.last[k],
                                          err_msg=f"{tag}: {k}")
    js, ts = replica_state_to_numpy(j.state), replica_state_to_numpy(t.state)
    for k in js:
        np.testing.assert_array_equal(js[k], ts[k], err_msg=f"{tag}: {k}")
    for r in range(j.R):
        assert list(j.replayed[r]) == list(t.replayed[r]), (tag, r)
        assert list(j.frames[r]) == list(t.frames[r]), (tag, r)
    np.testing.assert_array_equal(j.applied, t.applied)
    assert [list(q) for q in j.pending] == [list(q) for q in t.pending]
    assert (j.need_recovery, j.rebases, j.rebased_total) == (
        t.need_recovery, t.rebases, t.rebased_total), tag


def run_workload(R, fanout, seed, *, rebase=None, wedge=False, scan=False,
                 steps=60, spmd=False, **variants):
    """``variants``: the ``audit=``/``telemetry=`` flags, on both;
    ``spmd=True`` runs both engines in ``mode="spmd"`` (the port's on
    ``["cpu"] * R``)."""
    geo = dict(GEO, **({"rebase_threshold": rebase} if rebase else {}))
    mode = "spmd" if spmd else "sim"
    j = JSim(JCfg(**geo), R, fanout=fanout, scan=scan, mode=mode,
             **variants)
    t = SimCluster(LogConfig(**geo), R, fanout=fanout, scan=scan,
                   mode=mode, device=["cpu"] * R if spmd else "cpu",
                   **variants)
    for c in (j, t):
        c.collect_frames = True
    rng = np.random.default_rng(seed)
    full = (1 << R) - 1
    for step in range(steps):
        tmo = []
        if step == 0 or rng.random() < 0.07:
            tmo = sorted({int(x) for x in rng.integers(R, size=2)})
        if fanout == "gather" and rng.random() < 0.06:
            perm = rng.permutation(R)
            cut = int(rng.integers(1, R))
            groups = [sorted(int(x) for x in perm[:cut]),
                      sorted(int(x) for x in perm[cut:])]
            j.partition(groups)
            t.partition(groups)
        if rng.random() < 0.1:
            j.heal()
            t.heal()
        if wedge and step in (8, 45):
            for c in (j, t):
                (c.wedge_apply if step == 8 else c.unwedge_apply)(R - 1)
        for r in range(R):
            for _ in range(int(rng.integers(0, 16))):
                if rng.random() < 0.02:
                    p = np.array([full, full, 0, step + 1], "<i4").tobytes()
                    et = EntryType.CONFIG
                else:
                    p = bytes(rng.integers(0, 256, int(rng.integers(0, 33)),
                                           dtype=np.uint8))
                    et = EntryType.SEND
                j.submit(r, p, etype=et, conn=1 + r, req_id=step)
                t.submit(r, p, etype=et, conn=1 + r, req_id=step)
        if (j.last is not None and j.leader() >= 0 and not tmo
                and rng.random() < 0.35):
            j.step_burst()
            t.step_burst()
        else:
            j.step(timeouts=tmo)
            t.step(timeouts=tmo)
        assert_engines_equal(j, t, f"seed {seed} step {step}")
    return j, t


@pytest.mark.parametrize("R,fanout,seed,kw", [
    (3, "gather", 0, {}),
    (5, "gather", 1, dict(wedge=True, scan=True)),
    (3, "psum", 2, dict(rebase=300, steps=90)),
    (3, "gather", 4, dict(rebase=300, wedge=True, steps=90)),
])
def test_recorded_workload_matches_jax(R, fanout, seed, kw):
    j, t = run_workload(R, fanout, seed, **kw)
    assert max(len(s) for s in t.replayed) > 60, "workload never committed"
    if kw.get("rebase"):
        assert t.rebases >= 1, "traffic never crossed the rebase threshold"


def test_rebase_keeps_streams_exact():
    """The tests/test_rebase.py drain on the port: 900 payloads across
    rollovers, every replica's stream exact and in order."""
    cfg = LogConfig(**GEO, rebase_threshold=300)
    c = SimCluster(cfg, 3, device="cpu")
    c.run_until_elected(0)
    payloads = [b"w%05d" % i for i in range(900)]
    i = 0
    while i < len(payloads) or c.pending[0]:
        for _ in range(8):
            if i < len(payloads):
                c.submit(0, payloads[i])
                i += 1
        c.step()
    for _ in range(3):
        c.step()
    assert c.rebases >= 2
    assert int(c.last["end"].max()) < cfg.rebase_threshold
    for r in range(3):
        assert [p for (_, _, _, p) in c.replayed[r]] == payloads


def test_host_rules():
    assert cap_tiers((2, 4, 8, 16), None) == (2, 4, 8, 16)
    assert cap_tiers((2, 4, 8, 16), 5) == (2, 4)
    with pytest.raises(ValueError):
        cap_tiers((2, 4), 1)
    assert clamp_burst_take(100, 60, 0, 64, 32) == 3
    assert clamp_burst_take(100, 10, 0, 64, 32, reserved=40) == 13
    assert rebase_delta_of([130, 200], 64) == 128
    pending = [4, 5]
    requeue_shortfall(pending, [1, 2, 3], 1)
    assert pending == [2, 3, 4, 5]


def test_engine_guards():
    c = SimCluster(LogConfig(**GEO), 3, fanout="psum", device="cpu")
    with pytest.raises(ValueError):
        c.partition([[0], [1, 2]])
    with pytest.raises(RuntimeError):
        c.step_burst()                      # burst before any step
    t = c.begin_step(timeouts=[0])
    with pytest.raises(RuntimeError):
        c.step()                            # serial while in flight
    c.finish(t)
    assert c.drain() is None
    assert c.leader() == 0
    # the txn lane is ported (tests/test_torch_txn.py): a txn=True engine
    # builds, and only it takes a watch
    assert SimCluster(LogConfig(**GEO), 3, txn=True,
                      device="cpu")._txn_watch == -1
    with pytest.raises(RuntimeError, match="txn=True"):
        c.set_txn_watch(0, 1)
    # the audit and telemetry variants build their host consumers
    v = SimCluster(LogConfig(**GEO), 3, audit=True, telemetry=True,
                   flight_capacity=5, device="cpu")
    assert v.auditor.R == 3 and v.flight.capacity == 5
    assert v.device_counters.shape == (3, 8)
    assert c.auditor is None and c.flight is None
    assert c.device_counters is None
