"""Port parity: the device KVS (``apply_cmd`` ops 1-6, ``apply_batch``)
against the JAX package's on seeded command streams, and the
``ReplicatedKVS``/``ClientSession`` scenarios of
tests/test_replicated_kvs.py (dedup, retransmit, late duplicate,
failover, read-index) run on both packages. Exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdma_paxos_tpu.config import LogConfig as JCfg
from rdma_paxos_tpu.models import kvs as jkvs
from rdma_paxos_tpu.models.replicated_kvs import ReplicatedKVS as JKVS
from rdma_paxos_tpu.runtime.sim import SimCluster as JSim
from rdma_paxos_tpu_torch.config import LogConfig
from rdma_paxos_tpu_torch.convert import kv_state_to_numpy
from rdma_paxos_tpu_torch.models import kvs as tkvs
from rdma_paxos_tpu_torch.models.replicated_kvs import (
    TXN_CMD_W, ReplicatedKVS)
from rdma_paxos_tpu_torch.runtime.sim import SimCluster

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

GEO = dict(n_slots=128, slot_bytes=128, window_slots=32, batch_slots=16)


def test_constants_match():
    for k in ("OP_PUT", "OP_GET", "OP_RM", "OP_INCR", "OP_SADD", "OP_MAX",
              "KEY_W", "VAL_W", "CMD_W", "PROBES"):
        assert getattr(tkvs, k) == getattr(jkvs, k), k
    from rdma_paxos_tpu.txn.records import TXN_CMD_W as J_TXN_CMD_W
    assert TXN_CMD_W == J_TXN_CMD_W


def _random_cmds(rng, n, n_keys):
    # keys differing in high bytes only (they share hash buckets) and in
    # low bytes, so probe chains, tombstones and full chains all occur
    keys = [rng.integers(-3, 3, tkvs.KEY_W).astype(np.int32)
            for _ in range(n_keys)]
    cmds = np.zeros((n, tkvs.CMD_W), np.int32)
    cmds[:, 0] = rng.choice([0, 1, 1, 2, 3, 4, 5, 6, 7], n)
    for i in range(n):
        cmds[i, 1:1 + tkvs.KEY_W] = keys[int(rng.integers(n_keys))]
    cmds[:, 1 + tkvs.KEY_W:] = rng.integers(-(1 << 31), (1 << 31) - 1,
                                            (n, tkvs.VAL_W))
    return cmds


@pytest.mark.parametrize("seed,cap", [(0, 64), (1, 256)])
def test_apply_cmd_matches_jax(seed, cap):
    rng = np.random.default_rng(seed)
    cmds = _random_cmds(rng, 300, 40)
    jt = jkvs.make_kvs(cap)
    tt = tkvs.make_kvs(cap, device="cpu")
    japply = jax.jit(jkvs.apply_cmd)
    for i, cmd in enumerate(cmds):
        jt, jout = japply(jt, jnp.asarray(cmd))
        tt, tout = tkvs.apply_cmd(tt, torch.from_numpy(cmd))
        np.testing.assert_array_equal(np.asarray(jout), tout.numpy(),
                                      err_msg=f"cmd {i} out")
        for k, v in kv_state_to_numpy(tt).items():
            np.testing.assert_array_equal(np.asarray(getattr(jt, k)), v,
                                          err_msg=f"cmd {i} {k}")
    assert int(tt.used.sum()) > 0


def test_apply_batch_matches_jax():
    rng = np.random.default_rng(3)
    cmds = _random_cmds(rng, 24, 10)
    jt, jouts = jkvs.apply_batch(jkvs.make_kvs(64), jnp.asarray(cmds),
                                 jnp.int32(17))
    tt, touts = tkvs.apply_batch(tkvs.make_kvs(64, device="cpu"),
                                 torch.from_numpy(cmds), 17)
    np.testing.assert_array_equal(np.asarray(jouts), touts.numpy())
    for k, v in kv_state_to_numpy(tt).items():
        np.testing.assert_array_equal(np.asarray(getattr(jt, k)), v)


# --- ReplicatedKVS scenarios, run on both packages --------------------

def sc_end_to_end(c, kv):
    c.run_until_elected(0)
    kv.put(0, b"city", b"zurich")
    kv.put(0, b"temp", b"7C")
    c.step()
    c.step()
    out = [kv.get(r, k) for r in range(3) for k in (b"city", b"temp")]
    kv.remove(0, b"temp")
    kv.put(0, b"city", b"basel")
    c.step()
    c.step()
    return out + [kv.get(r, k) for r in range(3) for k in (b"city", b"temp")]


def sc_linearizable(c, kv):
    c.run_until_elected(0)
    kv.put(0, b"k", b"v")
    c.step()
    out = [kv.get(0, b"k", linearizable=True),
           kv.get(1, b"k", linearizable=True)]
    c.partition([[0], [1, 2]])
    c.step()
    c.step()
    return out + [kv.get(0, b"k", linearizable=True), kv.get(0, b"k")]


def sc_dedup_retransmit(c, kv):
    c.run_until_elected(0)
    sess = kv.session(client_id=7)
    rid = sess.put(0, b"k", b"v1")
    c.step()
    c.step()
    sess.retransmit_put(0, b"k", b"v1", rid)
    sess.retransmit_put(0, b"k", b"v1", rid)
    c.step()
    c.step()
    return [kv.get(0, b"k", linearizable=True), kv.get(1, b"k"),
            kv.get(2, b"k"), list(kv.deduped)]


def sc_late_duplicate(c, kv):
    c.run_until_elected(0)
    sess = kv.session(client_id=9)
    r1 = sess.put(0, b"x", b"old")
    c.step()
    sess.put(0, b"x", b"new")
    c.step()
    sess.retransmit_put(0, b"x", b"old", r1)
    c.step()
    c.step()
    return [kv.get(0, b"x", linearizable=True), list(kv.deduped)]


def sc_failover(c, kv):
    c.run_until_elected(0)
    sess = kv.session(client_id=3)
    rid = sess.put(0, b"f", b"committed")
    c.step()
    c.step()
    c.partition([[0], [1, 2]])
    c.step(timeouts=[1])
    sess.retransmit_put(1, b"f", b"committed", rid)
    sess.put(1, b"g", b"after")
    sess.merge(1, jkvs.OP_INCR, b"n", np.array([5] + [0] * 7,
                                                 "<i4").tobytes())
    sess.merge(1, jkvs.OP_MAX, b"n", np.array([3, 9] + [0] * 6,
                                                "<i4").tobytes())
    sess.remove(1, b"g")
    c.step()
    c.step()
    c.heal()
    c.step()
    c.step()
    return ([kv.get(r, k) for r in range(3) for k in (b"f", b"g", b"n")]
            + [list(kv.deduped), kv.get_many(2, [b"f", b"n", b"zz"])])


@pytest.mark.parametrize("scenario", [
    sc_end_to_end, sc_linearizable, sc_dedup_retransmit, sc_late_duplicate,
    sc_failover])
def test_replicated_kvs_scenarios_match_jax(scenario):
    jc = JSim(JCfg(**GEO), 3)
    jkv = JKVS(jc, cap=256)
    tc = SimCluster(LogConfig(**GEO), 3, device="cpu")
    tkv = ReplicatedKVS(tc, cap=256)
    jres = scenario(jc, jkv)
    tres = scenario(tc, tkv)
    assert jres == tres
    assert any(v is not None for v in tres if not isinstance(v, list))
    for r in range(3):
        jkv._fold(r)
        tkv._fold(r)
        for k, v in kv_state_to_numpy(tkv.tables[r]).items():
            np.testing.assert_array_equal(
                np.asarray(getattr(jkv.tables[r], k)), v, err_msg=k)
        assert jkv.last_req[r] == tkv.last_req[r]


def test_rebuild_refolds_identically():
    c = SimCluster(LogConfig(**GEO), 3, device="cpu")
    kv = ReplicatedKVS(c, cap=256)
    sc_dedup_retransmit(c, kv)
    before = kv_state_to_numpy(kv.tables[1])
    kv.rebuild(1)
    assert kv.get(1, b"k") == b"v1"
    for k, v in kv_state_to_numpy(kv.tables[1]).items():
        np.testing.assert_array_equal(before[k], v)
    assert kv.deduped[1] == 2


def test_txn_record_raises():
    """A committed transaction record no longer raises: it folds as in
    the JAX package (here a record of no known txn op, which releases no
    write), and the tables and counters equal the JAX KVS's. The txn
    fold's own parity is in tests/test_torch_txn.py."""
    kvs = []
    for sim, kvs_cls, kw in ((JSim, JKVS, {}),
                             (SimCluster, ReplicatedKVS, dict(device="cpu"))):
        c = sim((JCfg if sim is JSim else LogConfig)(**GEO), 3, **kw)
        kv = kvs_cls(c, cap=256)
        c.run_until_elected(0)
        c.submit(0, bytes(TXN_CMD_W * 4), conn=5, req_id=1)
        kv.put(0, b"k", b"v", client_id=6, req_id=1)
        c.step()
        c.step()
        assert kv.get(0, b"k") == b"v"
        kvs.append(kv)
    (jk, tk) = kvs
    assert (tk.txn_applied, tk.txn_discarded, tk.deduped) == (
        jk.txn_applied, jk.txn_discarded, jk.deduped)
    for r in range(3):
        jt, tt = (kv_state_to_numpy(k.tables[r]) for k in kvs)
        for f in jt:
            np.testing.assert_array_equal(jt[f], tt[f], err_msg=f)
