"""Port state conversion: JAX-package state carried into the port and
back, bit for bit — the stacked ReplicaState (u32 bitmasks included),
a KVS table, and a whole SimCluster snapshot that both engines then
continue from identically."""

import jax.numpy as jnp
import numpy as np
import torch

from rdma_paxos_tpu.config import LogConfig as JCfg
from rdma_paxos_tpu.models import kvs as jkvs
from rdma_paxos_tpu.runtime.sim import SimCluster as JSim
from rdma_paxos_tpu_torch.config import LogConfig
from rdma_paxos_tpu_torch.consensus.state import STATE_FIELDS, U32_FIELDS
from rdma_paxos_tpu_torch.convert import (
    kv_state_from_jax, kv_state_to_numpy, replica_state_from_jax,
    replica_state_to_numpy, sim_restore, sim_snapshot)
from rdma_paxos_tpu_torch.runtime.sim import SimCluster

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

GEO = dict(n_slots=64, slot_bytes=32, window_slots=16, batch_slots=8)


def _traffic(c, n, tag):
    for i in range(n):
        c.submit(c.leader(), b"%s-%d" % (tag, i), conn=2, req_id=i + 1)


def test_state_round_trip():
    j = JSim(JCfg(**GEO), 3)
    j.run_until_elected(1)
    _traffic(j, 20, b"a")
    for _ in range(3):
        j.step()
    want = replica_state_to_numpy(j.state)
    assert set(want) == set(STATE_FIELDS)
    t_state = replica_state_from_jax(j.state, "cpu")
    got = replica_state_to_numpy(t_state)
    for k in STATE_FIELDS:
        assert got[k].dtype == want[k].dtype == (
            np.uint32 if k in U32_FIELDS else np.int32)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(
            got[k], np.asarray(j.state.log.buf if k == "log"
                               else getattr(j.state, k)), err_msg=k)
    # from a plain mapping too
    again = replica_state_to_numpy(replica_state_from_jax(got, "cpu"))
    for k in STATE_FIELDS:
        np.testing.assert_array_equal(again[k], want[k])


def test_kv_state_round_trip():
    jt = jkvs.make_kvs(64)
    for i in range(12):
        jt, _ = jkvs.apply_cmd(jt, jnp.asarray(
            jkvs.encode_cmd(jkvs.OP_PUT, b"k%d" % i, b"v%d" % i)))
    tt = kv_state_from_jax(jt, "cpu")
    for k, v in kv_state_to_numpy(tt).items():
        np.testing.assert_array_equal(np.asarray(getattr(jt, k)), v)


def test_sim_snapshot_continues_identically():
    j = JSim(JCfg(**GEO), 3)
    j.run_until_elected(0)
    _traffic(j, 30, b"b")
    j.step()
    j.step_burst()
    j.partition([[0, 1], [2]])
    j.step()
    t = SimCluster(LogConfig(**GEO), 3, device="cpu")
    sim_restore(t, sim_snapshot(j))
    for c in (j, t):
        _traffic(c, 25, b"c")
        c.step()
        c.heal()
        c.step_burst()
        c.step(timeouts=[2])
        c.step()
    js, ts = replica_state_to_numpy(j.state), replica_state_to_numpy(t.state)
    for k in js:
        np.testing.assert_array_equal(js[k], ts[k], err_msg=k)
    for k in t.last:
        np.testing.assert_array_equal(np.asarray(j.last[k]), t.last[k])
    for r in range(3):
        assert list(j.replayed[r]) == list(t.replayed[r])
    np.testing.assert_array_equal(j.applied, t.applied)
    assert j.step_index == t.step_index
