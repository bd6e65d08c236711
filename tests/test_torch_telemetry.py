"""Port parity of the device telemetry: the port's ``telemetry=`` step
variant and the counter half of ``obs/device.py`` on the CPU against the
JAX package's, with exact equality.

* the ``T_*`` columns, ``obs.device.NAMES`` and the reference agree;
* the step's ``[R, T_N]`` vector equals JAX's on seeded schedules, full
  and stable steps, partitions, both fan-outs;
* engine workloads give equal ``device_counters`` and ``device_*``
  registry series;
* the counter functions equal their originals;
* with ``audit=False`` and ``telemetry=False`` the engine is unchanged:
  its results equal those of a cluster with the variants on, and the
  variant fields are None."""

import numpy as np
import pytest
import torch

from rdma_paxos_tpu.consensus import step as jstep
from rdma_paxos_tpu.obs import device as jdevice
from rdma_paxos_tpu.obs.metrics import MetricsRegistry as JRegistry
from rdma_paxos_tpu_torch.config import LogConfig
from rdma_paxos_tpu_torch.consensus import step as tstep
from rdma_paxos_tpu_torch.convert import replica_state_to_numpy
from rdma_paxos_tpu_torch.obs import Observability
from rdma_paxos_tpu_torch.obs import device as tdevice
from rdma_paxos_tpu_torch.runtime.sim import SimCluster
from tests.test_torch_audit import run_step_schedule
from tests.test_torch_sim import GEO, run_workload
from tests.test_torch_sim import jax_step_cache_restored  # noqa: F401

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

T_COLS = ("T_ELECTIONS", "T_VOTES_GRANTED", "T_VOTES_DENIED", "T_ACCEPTED",
          "T_COMMITTED", "T_UNHEARD", "T_QUORUM_W", "T_HEADROOM", "T_N")


def test_layout_matches_the_reference_and_the_host_consumer():
    assert [getattr(tstep, k) for k in T_COLS] == [
        getattr(jstep, k) for k in T_COLS]
    assert tdevice.NAMES == jdevice.NAMES
    assert (tdevice.COUNTERS, tdevice.GAUGES) == (jdevice.COUNTERS,
                                                  jdevice.GAUGES)
    assert tdevice.WIDTH == tstep.T_N and tdevice.INDEX == jdevice.INDEX
    cols = dict(elections_started="T_ELECTIONS",
                votes_granted="T_VOTES_GRANTED",
                votes_denied="T_VOTES_DENIED",
                accepted_entries="T_ACCEPTED",
                committed_entries="T_COMMITTED",
                links_unheard="T_UNHEARD", quorum_width="T_QUORUM_W",
                log_headroom="T_HEADROOM")
    for name, col in cols.items():
        assert tdevice.INDEX[name] == getattr(tstep, col), name


@pytest.mark.parametrize("R,fanout,seed", [
    (3, "gather", 0), (5, "gather", 1), (3, "psum", 2)])
def test_telemetry_step_schedule_matches_jax(R, fanout, seed):
    outs = run_step_schedule(R, fanout, seed, telemetry=True)
    tv = np.stack([o.telemetry.numpy() for o in outs])
    # the schedule exercised elections, votes and unheard links
    for col in ("T_ELECTIONS", "T_VOTES_GRANTED", "T_ACCEPTED",
                "T_COMMITTED"):
        assert tv[..., getattr(tstep, col)].sum() > 0, col
    if fanout == "gather":
        assert tv[..., tstep.T_UNHEARD].sum() > 0


@pytest.mark.parametrize("R,fanout,seed,kw", [
    (3, "gather", 4, dict(scan=True)),
    (3, "psum", 5, dict(rebase=300, steps=90))])
def test_device_counters_match_jax(R, fanout, seed, kw):
    j, t = run_workload(R, fanout, seed, telemetry=True, **kw)
    np.testing.assert_array_equal(t.device_counters, j.device_counters)
    assert t.auditor is None and t.flight is None
    total = t.device_counters[:, tdevice.INDEX["committed_entries"]]
    np.testing.assert_array_equal(total, t.last["commit"].astype(np.int64)
                                  + t.rebased_total)


def test_counter_functions_match_the_reference():
    rng = np.random.default_rng(3)
    stacked = rng.integers(0, 1 << 20, (5, 2, 3, tdevice.WIDTH))
    np.testing.assert_array_equal(tdevice.reduce_steps(stacked),
                                  jdevice.reduce_steps(stacked))
    accs = [mod.zeros(2, 3) for mod in (jdevice, tdevice)]
    assert accs[1].dtype == np.int64 and accs[1].shape == (2, 3, 8)
    regs = [JRegistry(), Observability().metrics]
    for k in range(5):
        for mod, acc, reg in zip((jdevice, tdevice), accs, regs):
            mod.accumulate(acc, stacked[k])
            mod.ingest(type("O", (), {"metrics": reg})(), stacked[k],
                       group_offset=2)
            mod.ingest(type("O", (), {"metrics": reg})(), stacked[k, 0])
    np.testing.assert_array_equal(accs[1], accs[0])
    for name in tdevice.COUNTERS:
        for g in (None, 2, 3):
            for r in range(3):
                lab = dict(replica=r) if g is None else dict(replica=r,
                                                             group=g)
                key = "device_%s_total" % name
                assert regs[1].get(key, **lab) == regs[0].get(key, **lab)
    for name in tdevice.GAUGES:
        assert regs[1].get("device_" + name, replica=1) == regs[0].get(
            "device_" + name, replica=1)
    tdevice.ingest(None, stacked[0, 0])       # no facade: a no-op


def _script(c):
    c.run_until_elected(0)
    rng = np.random.default_rng(9)
    for step in range(30):
        for _ in range(int(rng.integers(0, 12))):
            c.submit(0, bytes(rng.integers(0, 256, 20, dtype=np.uint8)))
        if step == 12:
            c.partition([[0, 1], [2]])
        if step == 16:
            c.heal()
        if step % 3 == 2 and step != 12:
            c.step_burst()
        else:
            c.step()
    return c


def test_variants_off_leave_the_engine_unchanged():
    """The variants add outputs and change nothing else: a cluster with
    neither, either or both on computes the same results, state and
    replay streams, and only the variant's own fields appear."""
    runs = {}
    for audit in (False, True):
        for telemetry in (False, True):
            runs[audit, telemetry] = _script(SimCluster(
                LogConfig(**GEO), 3, audit=audit, telemetry=telemetry,
                device="cpu"))
    base = runs[False, False]
    assert not any(k.startswith(("audit_", "telemetry")) for k in base.last)
    st0 = replica_state_to_numpy(base.state)
    for (audit, telemetry), c in runs.items():
        assert ("audit_digest" in c.last) == audit
        assert ("telemetry" in c.last) == telemetry
        for k, v in base.last.items():
            np.testing.assert_array_equal(c.last[k], v, err_msg=k)
        st = replica_state_to_numpy(c.state)
        for k in st0:
            np.testing.assert_array_equal(st[k], st0[k], err_msg=k)
        for r in range(3):
            assert list(c.replayed[r]) == list(base.replayed[r])


def test_mesh_telemetry_matches_jax_mesh_and_vmap():
    """The twin of tests/test_device_obs.py's mesh ≡ vmap: the port's
    2×3 mesh engine's per-(group, replica) counter vectors, through the
    sharded script's burst, partition and failover, equal the JAX mesh
    and vmap engines'."""
    import dataclasses

    from rdma_paxos_tpu.shard import ShardedCluster as JSharded
    from rdma_paxos_tpu_torch.shard import ShardedCluster
    from tests.test_device_obs import CFG as JCFG, _run_sharded_script
    t = ShardedCluster(LogConfig(**dataclasses.asdict(JCFG)), 3, 2,
                       mesh=(2, 3), device=["cpu"] * 6, telemetry=True)
    try:
        vm = JSharded(JCFG, 3, 2, telemetry=True)
        ms = JSharded(JCFG, 3, 2, mesh=(2, 3), telemetry=True)
        for sc in (vm, ms, t):
            _run_sharded_script(sc)
        for j in (vm, ms):
            np.testing.assert_array_equal(np.asarray(j.device_counters),
                                          t.device_counters)
            np.testing.assert_array_equal(np.asarray(j.last["telemetry"]),
                                          t.last["telemetry"])
    finally:
        t.close()
