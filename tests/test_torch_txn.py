"""Port parity of the cross-group transaction slice: the port's ``txn=``
lane, coordinator, KVS fold, ``ShardedKVS.transact`` and txn nemesis on
the CPU against the JAX package's, with exact equality (the state is all
i32/u32/bytes).

* the vote lane, step-locked: on ``SimCluster`` (NONE, PREPARED,
  CONFLICT, PENDING, and a watch below the prune head) and per group on
  ``ShardedCluster`` (a prepare overwritten by a failover leader votes
  CONFLICT), every step's results and the state equal JAX's;
* ``txn=False`` against ``txn=True``: equal outputs but ``txn_vote``,
  and a ``txn=False`` step dispatches the ops it did before the lane;
* a watch armed across an i32 rollover (absolute index, log-offset vote);
* ``ReplicatedKVS._fold_txn`` on scripted streams: staging, COMMIT order
  between plain commands, ABORT, duplicates, the done-ring cap;
* the mergeable ops, the 2PC coordinator's scenarios (dispatch count,
  read set, lock conflict, timeout, merge fast path), the refusals;
* the txn nemesis at two seeds; ``ShardedClusterDriver(txn=True)`` live.
"""

import json
import time

import numpy as np
import pytest
import torch

from rdma_paxos_tpu.config import LogConfig as JCfg
from rdma_paxos_tpu.models import replicated_kvs as jrkvs
from rdma_paxos_tpu.obs import Observability as JObs
from rdma_paxos_tpu.runtime.sim import SimCluster as JSim
from rdma_paxos_tpu.shard import ShardedCluster as JSharded
from rdma_paxos_tpu.shard.kvs import ShardedKVS as JKVS
from rdma_paxos_tpu.txn import attach_coordinator as jattach
from rdma_paxos_tpu.txn.chaos import TxnNemesisRunner as JRunner
from rdma_paxos_tpu_torch.config import LogConfig
from rdma_paxos_tpu_torch.consensus.log import EntryType
from rdma_paxos_tpu_torch.convert import (
    kv_state_to_numpy, replica_state_to_numpy)
from rdma_paxos_tpu_torch.models import replicated_kvs as trkvs
from rdma_paxos_tpu_torch.models.kvs import OP_INCR, OP_MAX, OP_PUT, OP_SADD
from rdma_paxos_tpu_torch.obs import Observability
from rdma_paxos_tpu_torch.runtime.sim import SimCluster
from rdma_paxos_tpu_torch.shard import ShardedCluster, ShardedKVS
from rdma_paxos_tpu_torch.shard.chaos import keys_for_groups
from rdma_paxos_tpu_torch.txn import (
    TXN_CONFLICT, TXN_NONE, TXN_PENDING, TXN_PREPARED, attach_coordinator)
from rdma_paxos_tpu_torch.txn.chaos import TxnNemesisRunner, run_txn_chaos
from rdma_paxos_tpu_torch.txn.merge import decode_merge_val, encode_merge_val
from rdma_paxos_tpu_torch.txn.records import (
    encode_abort, encode_commit, encode_merge, encode_prepare)
from rdma_paxos_tpu_torch.models.kvs import encode_cmd
from tests.test_torch_sim import jax_step_cache_restored  # noqa: F401

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

# a geometry tests/test_txn.py does not use (its cache-key check counts
# the JAX step-cache keys a txn=True cluster adds); the ring prunes under
# pressure within a few full batches
GEO = dict(n_slots=64, slot_bytes=128, window_slots=16, batch_slots=8)
# the same with an i32 rollover after a few rings
REBASE_GEO = dict(GEO, rebase_threshold=160)
R = 3


def _engines(geo=GEO, **kw):
    """A JAX SimCluster and the port's, built alike."""
    return (JSim(JCfg(**geo), R, **kw),
            SimCluster(LogConfig(**geo), R, device="cpu", **kw))


def _same_sim(j, t, jres, tres, tag):
    assert set(jres) == set(tres), tag
    for k, v in tres.items():
        np.testing.assert_array_equal(np.asarray(jres[k]), v,
                                      err_msg=f"{tag}: {k}")
    js = replica_state_to_numpy(j.state)
    ts = replica_state_to_numpy(t.state)
    for k in js:
        np.testing.assert_array_equal(js[k], ts[k], err_msg=f"{tag}: {k}")
    assert j.rebased_total == t.rebased_total, tag


# ---------------------------------------------------------------------------
# the vote lane
# ---------------------------------------------------------------------------

def test_vote_lane_sim_matches_jax():
    """NONE, PREPARED, CONFLICT (wrong term), PENDING (future index),
    cleared, and a watch below the prune head (PREPARED even under a
    wrong term): every step of both engines equal."""
    j, t = _engines(txn=True)
    votes = []

    def step(tag, **kw):
        jres, tres = j.step(**kw), t.step(**kw)
        _same_sim(j, t, jres, tres, tag)
        votes.append(tres["txn_vote"].tolist())
        return tres

    step("elect", timeouts=[0])
    term = int(t.last["term"][0])
    idx = int(t.last["end"][0])
    for c in (j, t):
        c.submit(0, b"prep")
    for i in range(3):
        step(f"commit {i}")
    assert int(t.last["commit"][0]) > idx
    for tag, watch in (("none", None), ("prepared", (idx, term)),
                       ("conflict", (idx, term + 5)),
                       ("pending", (idx + 10, term)), ("cleared", ())):
        for c in (j, t):
            if watch:
                c.set_txn_watch(*watch)
            elif watch == ():
                c.clear_txn_watch()
        step(tag)
    assert votes[-5:] == [[TXN_NONE] * R, [TXN_PREPARED] * R,
                          [TXN_CONFLICT] * R, [TXN_PENDING] * R,
                          [TXN_NONE] * R]
    # fill the ring until the leader prunes past idx
    for i in range(8):
        for c in (j, t):
            c.submit_many(0, [(3, 1, 0, b"f%d" % k) for k in range(8)])
        step(f"fill {i}")
    assert int(t.last["head"][0]) > idx
    for c in (j, t):
        c.set_txn_watch(idx, term + 5)
    tres = step("below head")
    assert tres["txn_vote"][0] == TXN_PREPARED


def _failover_workload(c) -> list:
    """G = 2: group 0's leader, partitioned alone, appends a prepare that
    never commits; replica 1 takes over and commits over its index; the
    watch on it votes PENDING on the deposed leader and CONFLICT on the
    others, then CONFLICT everywhere after heal; group 1 commits its
    prepare under its term (PREPARED). Returns every step's results."""
    out = []

    def step(**kw):
        out.append(c.step(**kw))

    c.place_leaders()
    out.append(c.last)
    terms = [int(np.asarray(c.last["term"])[g].max()) for g in range(2)]
    c.partition(0, [[0], [1, 2]])
    idx = [int(np.asarray(c.last["end"])[g, g]) for g in range(2)]
    c.submit(0, 0, b"prepare-0")
    c.submit(1, 1, b"prepare-1")
    step()
    step()
    step(timeouts={0: [1]})
    c.submit(0, 1, b"over")
    for _ in range(3):
        step()
    c.set_txn_watch(0, idx[0], terms[0])
    c.set_txn_watch(1, idx[1], terms[1])
    step()
    c.heal(0)
    for _ in range(3):
        step()
    c.clear_txn_watch(1)
    step()
    return out


def test_vote_lane_sharded_matches_jax():
    cfg = dict(GEO)
    outs = []
    engines = (JSharded(JCfg(**cfg), R, 2, txn=True),
               ShardedCluster(LogConfig(**cfg), R, 2, txn=True,
                              device="cpu"))
    for c in engines:
        outs.append(_failover_workload(c))
    for i, (jr, tr) in enumerate(zip(*outs)):
        assert set(jr) == set(tr), i
        for k, v in tr.items():
            np.testing.assert_array_equal(np.asarray(jr[k]), v,
                                          err_msg=f"step {i}: {k}")
    js = replica_state_to_numpy(engines[0].state)
    ts = replica_state_to_numpy(engines[1].state)
    for k in js:
        np.testing.assert_array_equal(js[k], ts[k], err_msg=k)
    votes = [r["txn_vote"].tolist() for r in outs[1]]
    # the watch step: the deposed leader still PENDING, the new majority
    # CONFLICT; group 1 PREPARED; then CONFLICT everywhere after heal
    watch_step = votes[-5]
    assert watch_step[0] == [TXN_PENDING, TXN_CONFLICT, TXN_CONFLICT]
    assert watch_step[1] == [TXN_PREPARED] * R
    assert votes[-2][0] == [TXN_CONFLICT] * R
    assert votes[-1] == [[TXN_CONFLICT] * R, [TXN_NONE] * R]


def test_vote_lane_mesh_matches_jax():
    """The twin of tests/test_txn.py's mesh ≡ vmap: the port's 2×3 mesh
    engine threads the watch inputs and reports the JAX mesh engine's
    stacked vote matrix; through the failover workload it equals the
    JAX stacked engine step for step."""
    from tests.test_txn import _vote_workload
    mesh = ShardedCluster(LogConfig(**GEO), R, 2, txn=True, mesh=(2, 3),
                          device=["cpu"] * 6)
    again = ShardedCluster(LogConfig(**GEO), R, 2, txn=True, mesh=(2, 3),
                           device=["cpu"] * 6)
    try:
        jm = JSharded(JCfg(**GEO), R, 2, txn=True, mesh=(2, 3))
        for x, y in zip(_vote_workload(jm), _vote_workload(mesh)):
            np.testing.assert_array_equal(x, y)
        for k in ("term", "commit", "end", "apply", "role"):
            np.testing.assert_array_equal(np.asarray(jm.last[k]),
                                          mesh.last[k], err_msg=k)
        jv = JSharded(JCfg(**GEO), R, 2, txn=True)
        for i, (jr, tr) in enumerate(zip(_failover_workload(jv),
                                         _failover_workload(again))):
            assert set(jr) == set(tr), i
            for k, v in tr.items():
                np.testing.assert_array_equal(np.asarray(jr[k]), v,
                                              err_msg=f"step {i}: {k}")
    finally:
        mesh.close()
        again.close()


def test_txn_off_outputs_equal_and_ops_unchanged():
    """A txn=False engine's outputs equal a txn=True engine's but for
    ``txn_vote``, on both engines, and its step() dispatches the PyTorch
    ops it dispatched before the lane existed (counted on the CPU at
    this geometry: 601 for a stable step with one SEND per group, 703
    for an election step)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.n += 1
            return func(*args, **(kwargs or {}))

    def ops(fn):
        with Count() as m:
            fn()
        return m.n

    for G in (None, 2):
        pair = []
        for txn in (False, True):
            if G is None:
                c = SimCluster(LogConfig(**GEO), R, txn=txn, device="cpu")
                c.run_until_elected(0)
            else:
                c = ShardedCluster(LogConfig(**GEO), R, G, txn=txn,
                                   device="cpu")
                c.place_leaders()
            res, n_ops = [], []
            for i in range(4):
                def one():
                    if G is None:
                        c.submit(0, b"x" * 16)
                    else:
                        c.submit(0, 0, b"x" * 16)
                        c.submit(1, 1, b"y" * 16)
                    res.append(c.step())
                n_ops.append(ops(one))
            n_ops.append(ops(lambda: res.append(
                c.step(timeouts={1: [2]} if G else [2]))))
            pair.append((res, n_ops))
        (off, off_ops), (on, on_ops) = pair
        for a, b in zip(off, on):
            assert "txn_vote" not in a and "txn_vote" in b
            assert set(b) - set(a) == {"txn_vote"}
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert off_ops == [601] * 4 + [703], (G, off_ops)
        assert all(x > y for x, y in zip(on_ops, off_ops))


def test_watch_across_rebase_matches_jax():
    """The watch is an ABSOLUTE index: armed before an i32 rollover it
    still names the same entry after (the card compares ``index -
    rebased_total``), on both engines, every step equal."""
    j, t = _engines(REBASE_GEO, txn=True)
    jres, tres = j.step(timeouts=[0]), t.step(timeouts=[0])
    armed = None
    for i in range(40):
        for c in (j, t):
            c.submit_many(0, [(3, 1, 0, b"r%d.%d" % (i, k))
                              for k in range(8)])
        jres, tres = j.step(), t.step()
        _same_sim(j, t, jres, tres, f"step {i}")
        if armed is None and int(tres["end"].max()) >= 140:
            armed = (int(tres["commit"][0]) - 1 + t.rebased_total,
                     int(tres["term"][0]))
            for c in (j, t):
                c.set_txn_watch(*armed)
        if armed is not None and t.rebases:
            break
    assert t.rebases == 1 and t.rebased_total > 0
    # the watched entry is still in the ring, above the new head
    assert armed[0] - t.rebased_total >= int(tres["head"][0])
    for k in range(2):
        jres, tres = j.step(), t.step()
        _same_sim(j, t, jres, tres, f"after rebase {k}")
        assert tres["txn_vote"].tolist() == [TXN_PREPARED] * R
    # a wrong term on the same absolute index is a definitive CONFLICT
    for c in (j, t):
        c.set_txn_watch(armed[0], armed[1] + 1)
    jres, tres = j.step(), t.step()
    _same_sim(j, t, jres, tres, "wrong term after rebase")
    assert tres["txn_vote"].tolist() == [TXN_CONFLICT] * R


# ---------------------------------------------------------------------------
# the state-machine fold of txn records
# ---------------------------------------------------------------------------

class _Stream(list):
    """A replay stream of ``(etype, conn, req, payload)`` rows."""

    def segments_from(self, i):
        return [self[i:]]


class _Fed:
    """The cluster surface ``ReplicatedKVS`` folds from, fed by hand."""

    def __init__(self, device=None):
        self.R = 1
        self.replayed = [_Stream()]
        self.last = None
        self.obs = None
        if device is not None:
            self.device = device


def _send(payload, conn=0, req=0):
    return (int(EntryType.SEND), conn, req, payload)


def _put(key, val, conn=0, req=0):
    return _send(encode_cmd(OP_PUT, key, val).tobytes(), conn, req)


TID_CONN = 1 << 20


def _fold_script(name):
    """Committed rows of one fold scenario, in commit order."""
    k, k2 = b"k", b"k2"
    if name == "stage_then_commit":
        return [_send(encode_prepare(1, OP_PUT, k, b"t1"), TID_CONN, 1),
                _put(k2, b"plain"),
                _send(encode_prepare(1, OP_PUT, k2, b"t1b"), TID_CONN, 2),
                _send(encode_commit(1, 0b11), TID_CONN, 3)]
    if name == "commit_between_plain":
        # PUT before, the txn's write at its COMMIT, PUT after: the later
        # value wins, and the COMMIT's write lands between the two
        return [_put(k, b"before"),
                _send(encode_prepare(2, OP_PUT, k, b"txn"), TID_CONN, 1),
                _put(k2, b"mid"),
                _send(encode_commit(2, 0b1), TID_CONN, 2),
                _put(k, b"after"),
                _send(encode_prepare(3, OP_PUT, k2, b"txn3"), TID_CONN, 3),
                _put(k2, b"before-commit"),
                _send(encode_commit(3, 0b1), TID_CONN, 4)]
    if name == "abort_no_partial":
        return [_put(k, b"base"),
                _send(encode_prepare(4, OP_PUT, k, b"lost"), TID_CONN, 1),
                _send(encode_prepare(4, OP_PUT, k2, b"lost2"), TID_CONN, 2),
                _send(encode_abort(4, 2), TID_CONN, 3),
                # a straggling prepare and a retried commit of the
                # finished tid are dropped
                _send(encode_prepare(4, OP_PUT, k2, b"late"), TID_CONN, 4),
                _send(encode_commit(4, 0b1), TID_CONN, 5)]
    if name == "duplicates":
        p = encode_prepare(5, OP_PUT, k, b"once")
        m = encode_merge(6, 2, OP_INCR, k2, encode_merge_val(OP_INCR, 3))
        m2 = encode_merge(6, 2, OP_INCR, k2, encode_merge_val(OP_INCR, 4))
        return [_send(p, TID_CONN, 1), _send(p, TID_CONN, 1),
                _send(encode_commit(5, 1), TID_CONN, 2),
                _send(encode_commit(5, 1), TID_CONN, 2),
                _send(m, TID_CONN, 3), _send(m, TID_CONN, 3),
                _send(m2, TID_CONN, 4), _send(m2, TID_CONN, 4),
                _send(m, TID_CONN, 3)]
    if name == "done_ring_cap":
        # cap 2 (patched): tid 7 falls out of the ring, so a late
        # duplicate of its merge applies again — the bound's cost
        rows = []
        for tid in (7, 8, 9):
            rows.append(_send(encode_merge(
                tid, 1, OP_INCR, k, encode_merge_val(OP_INCR, tid)),
                TID_CONN, tid))
        rows.append(rows[0])
        rows.append(rows[2])
        return rows
    raise ValueError(name)


@pytest.mark.parametrize("name", ["stage_then_commit",
                                  "commit_between_plain",
                                  "abort_no_partial", "duplicates",
                                  "done_ring_cap"])
def test_fold_txn_matches_jax(name, monkeypatch):
    if name == "done_ring_cap":
        for mod in (jrkvs, trkvs):
            monkeypatch.setattr(mod, "TXN_DONE_CAP", 2)
    rows = _fold_script(name)
    jk = jrkvs.ReplicatedKVS(_Fed(), cap=64)
    tk = trkvs.ReplicatedKVS(_Fed(torch.device("cpu")), cap=64)
    # fold in two slices, so a fold boundary cuts the script
    for hi in (len(rows) // 2, len(rows)):
        for kv in (jk, tk):
            kv.c.replayed[0][:] = rows[:hi]
            kv._fold(0)
        jt, tt = kv_state_to_numpy(jk.tables[0]), kv_state_to_numpy(
            tk.tables[0])
        for f in jt:
            np.testing.assert_array_equal(jt[f], tt[f], err_msg=f)
    for attr in ("txn_applied", "txn_discarded", "deduped", "last_req",
                 "_txn_done"):
        assert getattr(tk, attr) == getattr(jk, attr), attr
    assert list(tk._txn_done_fifo[0]) == list(jk._txn_done_fifo[0])
    assert set(tk._txn_buf[0]) == set(jk._txn_buf[0])
    get = tk.serve_local
    if name == "stage_then_commit":
        assert (get(0, b"k"), get(0, b"k2")) == (b"t1", b"t1b")
    elif name == "commit_between_plain":
        assert (get(0, b"k"), get(0, b"k2")) == (b"after", b"txn3")
    elif name == "abort_no_partial":
        assert (get(0, b"k"), get(0, b"k2")) == (b"base", None)
        assert tk.txn_discarded == [2]
    elif name == "duplicates":
        assert get(0, b"k") == b"once"
        assert decode_merge_val(OP_INCR, get(0, b"k2")) == 7
    else:
        assert decode_merge_val(OP_INCR, get(0, b"k")) == 7 + 8 + 9 + 7
    # a rebuilt replica refolds to the same table
    before = kv_state_to_numpy(tk.tables[0])
    tk.rebuild(0)
    tk._fold(0)
    for f, v in kv_state_to_numpy(tk.tables[0]).items():
        np.testing.assert_array_equal(before[f], v, err_msg=f)


def test_mergeable_ops_match_jax():
    """``tests/test_txn.py``'s INCR/MAX/SADD script and the tombstone
    base, through both engines' KVS: equal tables and values."""
    j, t = _engines()
    kvs = [jrkvs.ReplicatedKVS(j, cap=64), trkvs.ReplicatedKVS(t, cap=64)]
    for c in (j, t):
        c.run_until_elected(0)

    def both(fn):
        for kv, c in zip(kvs, (j, t)):
            fn(kv)
            for _ in range(2):
                c.step()

    both(lambda kv: kv.merge(0, OP_INCR, b"ctr",
                             encode_merge_val(OP_INCR, 5)))
    both(lambda kv: kv.merge(0, OP_INCR, b"ctr",
                             encode_merge_val(OP_INCR, -2)))
    both(lambda kv: kv.merge(0, OP_MAX, b"hi", encode_merge_val(OP_MAX, 10)))
    both(lambda kv: kv.merge(0, OP_MAX, b"hi", encode_merge_val(OP_MAX, 4)))
    for bit in (3, 3, 77):
        both(lambda kv: kv.merge(0, OP_SADD, b"set",
                                 encode_merge_val(OP_SADD, bit)))
    both(lambda kv: kv.put(0, b"ctr2", encode_merge_val(OP_INCR, 99)))
    both(lambda kv: kv.remove(0, b"ctr2"))
    both(lambda kv: kv.merge(0, OP_INCR, b"ctr2",
                             encode_merge_val(OP_INCR, 1)))
    got = [[kv.get(0, k) for k in (b"ctr", b"hi", b"set", b"ctr2")]
           for kv in kvs]
    assert got[0] == got[1]
    assert [decode_merge_val(op, v) for op, v in zip(
        (OP_INCR, OP_MAX, OP_SADD, OP_INCR), got[1])] == [3, 10, 2, 1]
    for r in range(R):
        jt, tt = (kv_state_to_numpy(kv.tables[r]) for kv in kvs)
        for f in jt:
            np.testing.assert_array_equal(jt[f], tt[f], err_msg=f)


# ---------------------------------------------------------------------------
# the 2PC coordinator, step-locked against JAX
# ---------------------------------------------------------------------------

def _txn_cluster(port: bool, G=2, timeout_steps=64):
    if port:
        shard = ShardedCluster(LogConfig(**GEO), R, G, txn=True,
                               device="cpu")
        shard.obs = Observability()
        kv = ShardedKVS(shard, cap=256)
        coord = attach_coordinator(kv, timeout_steps=timeout_steps)
    else:
        shard = JSharded(JCfg(**GEO), R, G, txn=True)
        shard.obs = JObs()
        kv = JKVS(shard, cap=256)
        coord = jattach(kv, timeout_steps=timeout_steps)
    shard.place_leaders()
    return shard, kv, coord, keys_for_groups(kv.router, 4)


def _pump(shard, h, limit=24):
    n = 0
    while not h.done and n < limit:
        shard.step()
        n += 1
    return n


def _scenario(name, port):
    """One coordinator scenario of ``tests/test_txn.py``; returns what is
    compared across the packages."""
    shard, kv, coord, keys = _txn_cluster(
        port, timeout_steps=4 if name == "timeout" else 64)
    out = {}
    if name == "commit_two_dispatches":
        h = kv.transact([("put", keys[0][3], b"w"),
                         ("put", keys[1][3], b"w")])
        _pump(shard, h)
        d0 = shard.dispatches
        h = kv.transact([("put", keys[0][0], b"va"),
                         ("put", keys[1][0], b"vb")])
        _pump(shard, h, 8)
        out["dispatches"] = shard.dispatches - d0
        out["vals"] = [kv.get(keys[0][0]), kv.get(keys[1][0])]
    elif name == "read_set":
        h = kv.transact([("put", keys[0][1], b"base")])
        _pump(shard, h)
        h = kv.transact([("put", keys[1][1], b"x")], reads=[keys[0][1]])
        _pump(shard, h)
        out["reads"] = h.reads
        out["read_key"] = keys[0][1]
    elif name == "lock_conflict":
        a = kv.transact([("put", keys[0][0], b"A0"),
                         ("put", keys[1][0], b"A1")])
        b = kv.transact([("put", keys[0][0], b"B0"),
                         ("put", keys[1][2], b"B1")])
        out["b"] = (b.state, b.abort_reason)
        _pump(shard, a)
        h = a
        out["vals"] = [kv.get(keys[0][0]), kv.get(keys[1][2])]
    elif name == "timeout":
        dead = shard.leader(0)
        shard.partition(0, [[dead], [r for r in range(R) if r != dead]])
        h = kv.transact([("put", keys[0][0], b"lost"),
                         ("put", keys[1][0], b"staged")])
        for _ in range(8):
            shard.step()
        out["decided"] = (h.state, h.abort_reason)
        shard.heal(0)
        shard.step(timeouts={0: [next(r for r in range(R) if r != dead)]})
        _pump(shard, h, 16)
        out["vals"] = [kv.get(keys[1][0]), kv.get(keys[0][0])]
    elif name == "merge_fast_path":
        d0 = shard.dispatches
        h = kv.transact([("incr", keys[0][0], 5), ("incr", keys[1][0], 11)])
        _pump(shard, h, 8)
        out["dispatches"] = shard.dispatches - d0
        h2 = kv.transact([("incr", keys[0][0], 2)])
        _pump(shard, h2)
        out["vals"] = [decode_merge_val(OP_INCR, kv.get(keys[0][0]))]
    out.update(state=(h.state, h.abort_reason, h.committed),
               health=coord.health(), steps=shard.step_index,
               counters={k: v for k, v in
                         shard.obs.metrics.snapshot()["counters"].items()
                         if k.startswith("txn_")},
               tables=[[kv_state_to_numpy(t) for t in g.tables]
                       for g in kv.groups],
               streams=[[list(s) for s in row] for row in shard.replayed])
    return out


@pytest.mark.parametrize("name", ["commit_two_dispatches", "read_set",
                                  "lock_conflict", "timeout",
                                  "merge_fast_path"])
def test_coordinator_matches_jax(name):
    j, t = _scenario(name, port=False), _scenario(name, port=True)
    for k in ("state", "health", "steps", "counters", "streams",
              "dispatches", "vals", "reads", "read_key", "b", "decided"):
        assert j.get(k) == t.get(k), k
    for jg, tg in zip(j["tables"], t["tables"]):
        for jt, tt in zip(jg, tg):
            for f in jt:
                np.testing.assert_array_equal(jt[f], tt[f], err_msg=f)
    want = dict(
        commit_two_dispatches=lambda o: o["dispatches"] == 2
        and o["vals"] == [b"va", b"vb"] and o["state"][2],
        read_set=lambda o: o["reads"] == {o["read_key"]: b"base"},
        lock_conflict=lambda o: o["b"] == ("aborted", "conflict")
        and o["vals"] == [b"A0", None]
        and o["counters"] == {"txn_committed_total": 1,
                              "txn_aborted_total{reason=conflict}": 1},
        timeout=lambda o: o["decided"][1] == "timeout"
        and o["state"] == ("aborted", "timeout", False)
        and o["vals"] == [None, None],
        merge_fast_path=lambda o: o["dispatches"] <= 2
        and o["vals"] == [7] and o["health"]["aborted_total"] == {})
    assert want[name](t), t


def test_attach_and_transact_refusals():
    shard = ShardedCluster(LogConfig(**GEO), R, 2, device="cpu")
    kv = ShardedKVS(shard, cap=64)
    with pytest.raises(ValueError, match="txn=True"):
        attach_coordinator(kv)
    with pytest.raises(RuntimeError, match="attach_coordinator"):
        kv.transact([("put", b"k", b"v")])
    s = ShardedCluster(LogConfig(**GEO), R, 2, txn=True, device="cpu")
    coord = attach_coordinator(ShardedKVS(s, cap=64))
    assert s.txn is coord and coord.health()["active"] == 0
    with pytest.raises(ValueError, match="unknown txn op"):
        ShardedKVS(s, cap=64).transact([("cas", b"k", b"v")])
    for c in (shard, SimCluster(LogConfig(**GEO), R, device="cpu")):
        with pytest.raises(RuntimeError, match="txn=True"):
            c.set_txn_watch(*((0, 1, 1) if c is shard else (1, 1)))


# ---------------------------------------------------------------------------
# the txn nemesis and the live driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5])
def test_txn_nemesis_matches_jax(seed):
    """The txn nemesis at the JAX defaults (coordinator-leader crash
    mid-prepare): the same verdict — serializability, effects, merge
    summary, linearizability, the straddler's abort and the
    coordinator's health — history and committed streams as the JAX
    runner, green, and ``run_txn_chaos`` deterministic."""
    jr, tr = JRunner(seed=seed), TxnNemesisRunner(seed=seed, device="cpu")
    jv, tv = jr.run(), tr.run()
    assert json.dumps(tv, sort_keys=True, default=str) == json.dumps(
        jv, sort_keys=True, default=str)
    assert tr.history.to_jsonl() == jr.history.to_jsonl()
    assert tr._merge_summary() == jr._merge_summary()
    for g in range(tr.G):
        for r in range(tr.R):
            assert list(tr.shard.replayed[g][r]) == list(
                jr.shard.replayed[g][r]), (g, r)
    assert tv["ok"], tv
    assert tv["txns"]["straddler"]["state"] == "aborted"
    assert tv["txns"]["undecided"] == 0 and tv["merge"]["ok"]
    assert run_txn_chaos(seed=seed, device="cpu") == tv


def test_txn_under_live_sharded_driver():
    """The driver's poll loop serves a put-pair and an INCR-pair
    transaction: bursts and pipelining give way while the lane is live,
    and ``status()`` carries the coordinator's health."""
    from rdma_paxos_tpu_torch.runtime.driver import ClusterDriver
    from rdma_paxos_tpu_torch.runtime.sharded_driver import (
        ShardedClusterDriver)
    cfg = LogConfig(n_slots=256, slot_bytes=128, window_slots=32,
                    batch_slots=16)
    d = ShardedClusterDriver(cfg, R, 2, txn=True, pipeline=2,
                             group_timer_lo=1, group_timer_hi=2,
                             device="cpu")
    kv = ShardedKVS(d.cluster, cap=256)
    coord = attach_coordinator(kv, timeout_steps=512)
    d.run(period=0.002)
    try:
        t0 = time.time()
        while time.time() - t0 < 30:
            if all(d.cluster.leader_hint(g) >= 0 for g in range(2)):
                break
            time.sleep(0.02)
        assert all(d.cluster.leader_hint(g) >= 0 for g in range(2))
        keys = keys_for_groups(kv.router, 4)
        h = kv.transact([("put", keys[0][0], b"live-a"),
                         ("put", keys[1][0], b"live-b")])
        t0 = time.time()
        while not h.done and time.time() - t0 < 30:
            time.sleep(0.005)
        assert h.committed, (h.state, h.abort_reason)
        assert kv.get(keys[0][0]) == b"live-a"
        assert kv.get(keys[1][0]) == b"live-b"
        h2 = kv.transact([("incr", keys[0][2], 7),
                          ("incr", keys[1][2], 3)])
        t0 = time.time()
        while not h2.done and time.time() - t0 < 30:
            time.sleep(0.005)
        assert h2.committed
        assert decode_merge_val(OP_INCR, kv.get(keys[0][2])) == 7
        st = d.health()
        assert st["txn"] == coord.health()
        assert st["txn"]["committed_total"] == 2
        assert st["txn"]["active"] == 0 and st["txn"]["locks"] == 0
        assert d.loop_error is None
        m = d.obs.metrics.snapshot()["counters"]
        assert m.get("txn_committed_total") == 2
    finally:
        d.stop()
    # the single-group driver builds the lane and steps with it
    sd = ClusterDriver(LogConfig(**GEO), R, txn=True, pipeline=0,
                       device="cpu")
    try:
        sd.runtimes[0].timer._deadline = 0.0
        sd.step()
        assert sd.leader() == 0
        assert sd.cluster.last["txn_vote"].tolist() == [TXN_NONE] * R
        assert sd.health()["txn"] is None
    finally:
        sd.stop()
