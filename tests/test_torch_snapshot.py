"""Port parity of ``consensus/snapshot.py``: snapshots taken by the JAX
package and by the port from the same seeded engine run carry equal
fields; installing them gives bit-equal replica state (offsets, wiped
ring row, anchor term, election state, committed config); the vote
records read back alike; a snapshot taken by either engine installs
into the other; and the surfaces of later slices raise."""

import dataclasses

import numpy as np
import pytest
import torch

from rdma_paxos_tpu.config import LogConfig as JCfg
from rdma_paxos_tpu.consensus import snapshot as jsnap
from rdma_paxos_tpu.consensus.membership import MembershipManager as JMM
from rdma_paxos_tpu.runtime.sim import SimCluster as JSim
from rdma_paxos_tpu_torch import convert
from rdma_paxos_tpu_torch.config import LogConfig
from rdma_paxos_tpu_torch.consensus import snapshot as tsnap
from rdma_paxos_tpu_torch.consensus.membership import MembershipManager
from rdma_paxos_tpu_torch.obs import trace as obs_trace
from rdma_paxos_tpu_torch.obs.metrics import default_registry
from rdma_paxos_tpu_torch.obs.trace import default_ring
from rdma_paxos_tpu_torch.runtime.sim import SimCluster

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

GEO = dict(n_slots=32, slot_bytes=32, window_slots=8, batch_slots=4)


def pair(R=3, group_size=None, geo=GEO):
    return (JSim(JCfg(**geo), R, group_size),
            SimCluster(LogConfig(**geo), R, group_size, device="cpu"))


def seeded_run(seed, R=3, steps=40):
    """Both engines through one seeded script: an election, traffic, a
    partition that leaves replica R-1 behind the pruned ring, and
    (seed-dependent) a config change. Returns ``(jax, port)``."""
    j, t = pair(R, group_size=3)
    rng = np.random.default_rng(seed)
    for c in (j, t):
        c.run_until_elected(0)
    if seed % 2:
        for c, mm in ((j, JMM(j)), (t, MembershipManager(t))):
            mm.change(0, 0b1111 if R > 3 else 0b111)
    for c in (j, t):
        c.partition([[r for r in range(R - 1)], [R - 1]])
    for i in range(steps):
        p = bytes(rng.integers(0, 256, int(rng.integers(1, 33)),
                               dtype=np.uint8))
        for c in (j, t):
            c.submit(0, p)
            c.step()
    for c in (j, t):
        c.heal()
        c.step()
    return j, t


def assert_states_equal(j_state, t_state, tag=""):
    js = convert.replica_state_to_numpy(j_state)
    ts = convert.replica_state_to_numpy(t_state)
    for k in js:
        np.testing.assert_array_equal(js[k], ts[k], err_msg=f"{tag}: {k}")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("donor,use_host_index", [(0, False), (1, True),
                                                  (2, False)])
def test_take_snapshot_matches_jax(seed, donor, use_host_index):
    j, t = seeded_run(seed)
    idx = int(t.applied[donor]) if use_host_index else None
    blob = b"store-%d" % seed
    js = jsnap.take_snapshot(j.state, donor, blob, index=idx)
    ts = tsnap.take_snapshot(t.state, donor, blob, index=idx)
    assert convert.snapshot_to_numpy(ts) == convert.snapshot_to_numpy(js)
    assert ts.index == (idx if idx is not None
                        else int(t.state.apply[donor]))


def test_take_snapshot_of_a_fresh_cluster_matches_jax():
    j, t = pair()
    js, ts = jsnap.take_snapshot(j.state, 1), tsnap.take_snapshot(t.state, 1)
    assert (ts.index, ts.term) == (0, 0)
    assert convert.snapshot_to_numpy(ts) == convert.snapshot_to_numpy(js)


@pytest.mark.parametrize("seed", [0, 1, 3])
@pytest.mark.parametrize("vote", [dict(), dict(voted_term=1, voted_for=0),
                                  dict(voted_term=7, voted_for=1,
                                       cur_term=5),
                                  dict(cur_term=9)])
def test_install_matches_jax(seed, vote):
    j, t = seeded_run(seed)
    snap = jsnap.take_snapshot(j.state, 1, index=int(j.applied[1]))
    j.state = jsnap.install_snapshot(j.state, 2, snap, **vote)
    t.state = tsnap.install_snapshot(t.state, 2,
                                     convert.snapshot_from_jax(snap),
                                     **vote)
    assert_states_equal(j.state, t.state, f"install {vote}")
    want_term = max(snap.term, vote.get("cur_term", 0),
                    vote.get("voted_term", 0))
    assert int(t.state.term[2]) == want_term
    assert int(t.state.end[2]) == snap.index
    # the recovered replica catches up alike on both engines
    for c in (j, t):
        c.applied[2] = snap.index
    for i in range(4):
        for c in (j, t):
            c.submit(0, b"after%d" % i)
            c.step()
        assert_states_equal(j.state, t.state, f"catch-up {i}")
    assert int(t.last["end"][2]) == int(t.last["end"][0])
    for r in range(3):
        assert list(t.replayed[r]) == list(j.replayed[r]), r


def test_install_of_index_zero_matches_jax():
    """A snapshot of a never-applied donor installs an empty row with no
    anchor stamp."""
    j, t = seeded_run(0)
    jfresh, tfresh = pair()
    snap = jsnap.take_snapshot(jfresh.state, 0)
    j.state = jsnap.install_snapshot(j.state, 1, snap)
    t.state = tsnap.install_snapshot(t.state, 1,
                                     tsnap.take_snapshot(tfresh.state, 0))
    assert_states_equal(j.state, t.state)
    assert int(t.state.log.buf[1].abs().sum()) == 0


@pytest.mark.parametrize("seed,r,peers", [(0, 2, None), (0, 0, [2]),
                                          (1, 1, None), (2, 2, [0]),
                                          (2, 1, [])])
def test_recover_vote_matches_jax(seed, r, peers):
    j, t = seeded_run(seed)
    assert tsnap.recover_vote(t.state, r, peers) == jsnap.recover_vote(
        j.state, r, peers)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_install_between_engines(direction):
    """A snapshot taken by one engine, carried as plain fields, installs
    into the other; both recipients end bit-equal and catch up alike."""
    j, t = seeded_run(5)
    if direction == "jax_to_port":
        js = jsnap.take_snapshot(j.state, 0, b"blob")
        ts = convert.snapshot_from_jax(js)
    else:
        ts = tsnap.take_snapshot(t.state, 0, b"blob")
        js = jsnap.Snapshot(**convert.snapshot_to_numpy(ts))
    assert isinstance(ts, tsnap.Snapshot) and isinstance(js, jsnap.Snapshot)
    j.state = jsnap.install_snapshot(j.state, 2, js)
    t.state = tsnap.install_snapshot(t.state, 2, ts)
    assert_states_equal(j.state, t.state)
    for c in (j, t):
        c.applied[2] = js.index
        c.submit(0, b"x")
        for _ in range(3):
            c.step()
    assert_states_equal(j.state, t.state)
    assert list(t.replayed[2]) == list(j.replayed[2])


def test_snapshot_carries_membership_across_install():
    j, t = pair(R=6, group_size=3)
    for c, mm in ((j, JMM(j)), (t, MembershipManager(t))):
        c.run_until_elected(0)
        mm.change(0, 0b11111)
    js = jsnap.take_snapshot(j.state, 0)
    ts = tsnap.take_snapshot(t.state, 0)
    assert convert.snapshot_to_numpy(ts) == convert.snapshot_to_numpy(js)
    assert ts.bitmask_new == 0b11111
    j.state = jsnap.install_snapshot(j.state, 5, js)
    t.state = tsnap.install_snapshot(t.state, 5, ts)
    assert_states_equal(j.state, t.state)
    assert MembershipManager(t).current(5) == JMM(j).current(5)
    assert MembershipManager(t).current(5)["bitmask_new"] == 0b11111


def test_bit31_member_mask_installs_as_u32():
    """The JAX install casts the masks through i32 and cannot take one
    with bit 31 (OverflowError); the port installs the u32 bit pattern,
    as its config_payload packs such masks."""
    j, t = pair()
    mask = (1 << 31) | 0b111
    snap = dataclasses.replace(jsnap.take_snapshot(j.state, 0),
                               bitmask_old=mask, bitmask_new=mask)
    with pytest.raises(OverflowError):
        jsnap.install_snapshot(j.state, 2, snap)
    t.state = tsnap.install_snapshot(t.state, 2,
                                     convert.snapshot_from_jax(snap))
    row = tsnap.export_row(t.state, 2)
    for k in ("bitmask_old", "bitmask_new", "ccfg_old", "ccfg_new"):
        assert row[k].dtype == np.uint32 and int(row[k]) == mask, k
    back = tsnap.take_snapshot(t.state, 2)
    assert back.bitmask_old == back.bitmask_new == mask


@pytest.mark.parametrize("r", [0, 2])
def test_export_and_genesis_rows_match_jax(r):
    j, t = seeded_run(1)
    jrow, trow = jsnap.export_row(j.state, r), tsnap.export_row(t.state, r)
    assert sorted(jrow) == sorted(trow)
    for k in jrow:
        assert jrow[k].dtype == trow[k].dtype, k
        np.testing.assert_array_equal(jrow[k], trow[k], err_msg=k)
    kw = dict(group_mask=0b101, epoch=4, n_replicas=3)
    jg = jsnap.genesis_row(jrow, **kw, term=9)
    tg = tsnap.genesis_row(trow, **kw, term=9)
    for k in jg:
        assert np.asarray(jg[k]).dtype == np.asarray(tg[k]).dtype, k
        np.testing.assert_array_equal(jg[k], tg[k], err_msg=k)
    np.testing.assert_array_equal(trow["log_buf"], jrow["log_buf"])


def test_snapshot_instrumentation_matches_jax():
    """Both wrappers count into the global registry and trace ring."""
    t = pair()[1]
    t.run_until_elected(0)
    reg, ring = default_registry(), default_ring()
    n0 = reg.get("snapshots_taken_total")
    i0 = reg.get("snapshots_installed_total")
    snap = tsnap.take_snapshot(t.state, 0, b"abc")
    t.state = tsnap.install_snapshot(t.state, 1, snap)
    assert reg.get("snapshots_taken_total") == n0 + 1
    assert reg.get("snapshots_installed_total") == i0 + 1
    taken = ring.events(kind=obs_trace.SNAPSHOT_TAKEN)[-1].fields
    assert taken["store_bytes"] == 3 and taken["index"] == snap.index
    assert ring.events(kind=obs_trace.SNAPSHOT_INSTALLED)[-1].replica == 1


@pytest.mark.parametrize("call,item", [
    (lambda s, sn: tsnap.take_snapshot(s, 0, digests=True), "item 9"),
    (lambda s, sn: tsnap.install_snapshot(s, 1, sn, ledger=object()),
     "items 9 and 12"),
    (lambda s, sn: tsnap.take_snapshot(s, 0, group=0), "item 11"),
    (lambda s, sn: tsnap.install_snapshot(s, 1, sn, group=0), "item 11"),
    (lambda s, sn: tsnap.recover_vote(s, 1, group=0), "item 11")])
def test_later_slices_of_the_snapshot_raise(call, item):
    t = pair()[1]
    t.run_until_elected(0)
    snap = tsnap.take_snapshot(t.state, 0)
    before = convert.replica_state_to_numpy(t.state)
    with pytest.raises(NotImplementedError, match=item):
        call(t.state, snap)
    after = convert.replica_state_to_numpy(t.state)
    for k in before:          # a refused call touched no state
        np.testing.assert_array_equal(before[k], after[k], err_msg=k)
