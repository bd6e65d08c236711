"""Port parity of the sharded engine (``rdma_paxos_tpu_torch.shard``):
the port's ``ShardedCluster`` on the CPU against the JAX package's and
against single-group ``SimCluster`` twins, with exact equality (the
state is all i32/u32).

* G = 1: ``tests/test_shard.py``'s recorded workload through the port's
  ``ShardedCluster(G=1)``, the port's ``SimCluster`` and the JAX
  ``ShardedCluster``;
* G = 4: seeded per-group traffic, elections and partitions through
  serial steps, bursts, the scan tier and pipelined tickets, with a
  wedged apply (rebases and stalled rebases), audit and telemetry —
  every step's results, the state, the streams and the host counters
  equal JAX's, and every group equals its own ``SimCluster`` twin run on
  that group's inputs alone;
* the group step's ``commit_window``: one call per step over N = G·R
  instances, on a view of the ring, equal per instance to the commit
  scan;
* the router copy, ``ShardedKVS``/``ShardedSession``, the shard nemesis,
  snapshot ``group=``, the converters, and the surfaces that raise."""

import json

import numpy as np
import pytest
import torch

from rdma_paxos_tpu.config import LogConfig as JCfg
from rdma_paxos_tpu.consensus import snapshot as jsnap
from rdma_paxos_tpu.obs import Observability as JObs
from rdma_paxos_tpu.shard import (
    KeyRouter as JRouter, RangeRule as JRule, ShardedCluster as JSharded,
    ShardedKVS as JKVS)
from rdma_paxos_tpu.shard.chaos import ShardNemesisRunner as JNemesis
from rdma_paxos_tpu.shard.router import ring_hash as jring_hash
from rdma_paxos_tpu_torch import convert
from rdma_paxos_tpu_torch.config import LogConfig
from rdma_paxos_tpu_torch.consensus import snapshot as tsnap
from rdma_paxos_tpu_torch.consensus import step as tstep
from rdma_paxos_tpu_torch.consensus.log import EntryType, META_W
from rdma_paxos_tpu_torch.consensus.state import Role
from rdma_paxos_tpu_torch.obs import Observability
from rdma_paxos_tpu_torch.ops import quorum
from rdma_paxos_tpu_torch.runtime.sim import SimCluster
from rdma_paxos_tpu_torch.shard import (
    KeyRouter, RangeRule, ShardedCluster, ShardedKVS)
from rdma_paxos_tpu_torch.shard.chaos import (
    ShardNemesisRunner, keys_for_groups)
from rdma_paxos_tpu_torch.shard.router import canon_key, ring_hash
from tests.test_shard import GOLDEN, _recorded_workload
from tests.test_torch_sim import jax_step_cache_restored  # noqa: F401

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

# the recorded workload's geometry (tests/test_shard.py CFG), shared by
# the G = 1 and KVS cases so the JAX programs compile once per module
KV_GEO = dict(n_slots=128, slot_bytes=128, window_slots=32, batch_slots=16)
# the G = 4 parity geometry: the ring recycles and rebases in 40 steps
GEO = dict(n_slots=64, slot_bytes=32, window_slots=16, batch_slots=8,
           rebase_threshold=160)
R, G = 3, 4


def _no_anchor(doc):
    return {k: v for k, v in doc.items() if k != "anchor"}


def _dumps(doc):
    return json.dumps(_no_anchor(doc), sort_keys=True, default=str)


# ---------------------------------------------------------------------------
# G = 1 ≡ SimCluster ≡ the JAX ShardedCluster
# ---------------------------------------------------------------------------

def test_g1_matches_simcluster_and_jax():
    sim = SimCluster(LogConfig(**KV_GEO), 3, device="cpu")
    sh = ShardedCluster(LogConfig(**KV_GEO), 3, 1, device="cpu")
    jsh = JSharded(JCfg(**KV_GEO), 3, 1)
    for ev, tmo in _recorded_workload():
        if ev == ["tmo0"]:
            ev, tmo = [], [0]
        for e in ev:
            if e[0] == "sub":
                sim.submit(e[1], e[2])
                for c in (sh, jsh):
                    c.submit(0, e[1], e[2])
            elif e[0] == "part":
                sim.partition(e[1])
                for c in (sh, jsh):
                    c.partition(0, e[1])
            elif e[0] == "heal":
                for c in (sim, sh, jsh):
                    c.heal()
        a = sim.step(timeouts=tmo)
        b = sh.step(timeouts={0: tmo} if tmo else ())
        c = jsh.step(timeouts={0: tmo} if tmo else ())
        for k in SimCluster.RES_KEYS:
            np.testing.assert_array_equal(a[k], b[k][0], err_msg=k)
            np.testing.assert_array_equal(np.asarray(c[k])[0], b[k][0],
                                          err_msg=k)
    assert [list(s) for s in sim.replayed] == [list(s)
                                               for s in sh.replayed[0]]
    assert [list(s) for s in jsh.replayed[0]] == [list(s)
                                                  for s in sh.replayed[0]]
    assert (sim.applied == sh.applied[0]).all()
    assert (jsh.applied == sh.applied).all()
    assert sim.leader() == sh.leader(0) == jsh.leader(0)
    js = convert.replica_state_to_numpy(jsh.state)
    ts = convert.replica_state_to_numpy(sh.state)
    ss = convert.replica_state_to_numpy(sim.state)
    for k in js:
        np.testing.assert_array_equal(js[k], ts[k], err_msg=k)
        np.testing.assert_array_equal(ss[k], ts[k][0], err_msg=k)


# ---------------------------------------------------------------------------
# G = 4 ≡ JAX, and each group ≡ its SimCluster twin
# ---------------------------------------------------------------------------

def assert_sharded_equal(j, t, tag):
    for k, v in j.last.items():
        np.testing.assert_array_equal(np.asarray(v), t.last[k],
                                      err_msg=f"{tag}: {k}")
    js = convert.replica_state_to_numpy(j.state)
    ts = convert.replica_state_to_numpy(t.state)
    for k in js:
        np.testing.assert_array_equal(js[k], ts[k], err_msg=f"{tag}: {k}")
    for g in range(t.G):
        for r in range(t.R):
            assert list(j.replayed[g][r]) == list(t.replayed[g][r]), (
                tag, g, r)
            assert list(j.frames[g][r]) == list(t.frames[g][r]), (tag, g, r)
    np.testing.assert_array_equal(j.applied, t.applied, tag)
    assert [[list(q) for q in row] for row in j.pending] == [
        [list(q) for q in row] for row in t.pending], tag
    assert j.need_recovery == t.need_recovery, tag
    for k in ("rebases", "rebased_total", "rebase_stall_steps",
              "rebase_stalled"):
        np.testing.assert_array_equal(getattr(j, k), getattr(t, k),
                                      err_msg=f"{tag}: {k}")
    assert j._dispatch_clock == t._dispatch_clock, tag


def assert_twin_equal(t, g, twin, tag):
    """Group ``g`` of the sharded port engine against its single-group
    twin: results, state rows, streams and host counters."""
    for k, v in twin.last.items():
        np.testing.assert_array_equal(v, t.last[k][g],
                                      err_msg=f"{tag} g{g}: {k}")
    ts = convert.replica_state_to_numpy(t.state)
    ws = convert.replica_state_to_numpy(twin.state)
    for k in ws:
        np.testing.assert_array_equal(ws[k], ts[k][g],
                                      err_msg=f"{tag} g{g}: {k}")
    for r in range(t.R):
        assert list(twin.replayed[r]) == list(t.replayed[g][r]), (tag, g, r)
    np.testing.assert_array_equal(twin.applied, t.applied[g], tag)
    assert [list(q) for q in twin.pending] == [list(q)
                                               for q in t.pending[g]], tag
    assert twin.need_recovery == {r for gg, r in t.need_recovery
                                  if gg == g}, tag
    assert (twin.rebases, twin.rebased_total) == (
        t.rebases[g], t.rebased_total[g]), (tag, g)


def writable_rebase(j):
    """The JAX ``ShardedCluster`` rolls offsets over by writing into its
    result arrays (``res[k][g] = ...``), but a serial or burst finish
    reads them back with ``np.asarray`` of device arrays, which numpy
    marks read-only: the first group to cross ``rebase_threshold``
    raises ``ValueError`` there (no JAX test crosses it). Give that
    instance's rollover writable copies — the rule it applies is
    unchanged — so the port's rollover can be held against it."""
    rollover = j._maybe_rebase

    def maybe_rebase(res):
        for k in ("head", "apply", "commit", "end", "audit_start"):
            if k in res:
                res[k] = np.array(res[k])
        rollover(res)
    j._maybe_rebase = maybe_rebase
    return j


def run_groups(seed, *, fanout="gather", steps=44, mesh=None, **variants):
    """The JAX ``ShardedCluster``, the port's (its mesh engine on a CPU
    device list with ``mesh=``) and one port
    ``SimCluster`` twin per group through one seeded script; every
    group gets its own traffic, timeouts and partitions (gather), group
    1's replica 2 is wedged from step 8 to 30, and the dispatch mode
    mixes serial steps, bursts (capped at K = 4), scan bursts and two
    pipelined bursts in flight. Compared after every dispatch."""
    j = writable_rebase(JSharded(JCfg(**GEO), R, G, fanout=fanout,
                                 **variants))
    t = ShardedCluster(LogConfig(**GEO), R, G, fanout=fanout, mesh=mesh,
                       device=("cpu" if mesh is None
                               else ["cpu"] * (mesh[0] * mesh[1])),
                       **variants)
    twins = [SimCluster(LogConfig(**GEO), R, fanout=fanout, device="cpu",
                        **variants) for _ in range(G)]
    for c in [j, t] + twins:
        c.collect_frames = True
    rng = np.random.default_rng(seed)
    full = (1 << R) - 1
    kinds = set()

    def finish_all(tickets_j, tickets_t, tickets_w, tag):
        for tj, tt in zip(tickets_j, tickets_t):
            j.finish(tj)
            t.finish(tt)
        for g in range(G):
            for tw in tickets_w[g]:
                twins[g].finish(tw)
        assert_sharded_equal(j, t, tag)
        for g in range(G):
            assert_twin_equal(t, g, twins[g], tag)

    for step in range(steps):
        tag = f"seed {seed} step {step}"
        tmo = {g: [g % R] for g in range(G)} if step == 0 else {}
        for g in range(G):
            if step and rng.random() < 0.05:
                tmo[g] = sorted({int(x) for x in rng.integers(R, size=2)})
            if fanout == "gather" and (rng.random() < 0.06 or (
                    g == 2 and step == 6)):
                perm = rng.permutation(R)
                cut = int(rng.integers(1, R))
                split = [sorted(int(x) for x in perm[:cut]),
                         sorted(int(x) for x in perm[cut:])]
                for c in (j, t):
                    c.partition(g, split)
                twins[g].partition(split)
            if rng.random() < 0.1 or (g == 2 and step == 11):
                for c in (j, t):
                    c.heal(g)
                twins[g].heal()
            for r in range(R):
                for _ in range(int(rng.integers(0, 10))):
                    if rng.random() < 0.02:
                        p = np.array([full, full, 0, step + 1],
                                     "<i4").tobytes()
                        et = EntryType.CONFIG
                    else:
                        p = bytes(rng.integers(
                            0, 256, int(rng.integers(0, 33)),
                            dtype=np.uint8))
                        et = EntryType.SEND
                    for c in (j, t):
                        c.submit(g, r, p, etype=et, conn=1 + r,
                                 req_id=step)
                    twins[g].submit(r, p, etype=et, conn=1 + r,
                                    req_id=step)
        if step in (8, 30):
            for c in (j, t):
                (c.wedge_apply if step == 8 else c.unwedge_apply)(1, R - 1)
            (twins[1].wedge_apply if step == 8
             else twins[1].unwedge_apply)(R - 1)
        led = (j.last is not None
               and all(j.leader(g) >= 0 for g in range(G)))
        if led and not tmo and rng.random() < 0.45:
            scan = bool(variants.get("scan")) and rng.random() < 0.5
            depth = 2 if rng.random() < 0.3 else 1
            kinds.add(("scan" if scan else "burst", depth))
            for c in [j, t] + twins:
                c.scan = scan
            tj, tt, tw = [], [], [[] for _ in range(G)]
            for _ in range(depth):
                tj.append(j.begin_burst(max_k=4))
                tt.append(t.begin_burst(max_k=4))
                assert tt[-1].K == tj[-1].K
                for g in range(G):
                    # the twin fuses the group's K steps: its own take
                    # fits K (the group's did), so the takes agree
                    twins[g].K_TIERS = (tt[-1].K,)
                    tw[g].append(twins[g].begin_burst())
            finish_all(tj, tt, tw, tag)
        else:
            kinds.add(("step", 1))
            j.step(timeouts=tmo)
            t.step(timeouts=tmo)
            for g in range(G):
                twins[g].step(timeouts=tmo.get(g, []))
            assert_sharded_equal(j, t, tag)
            for g in range(G):
                assert_twin_equal(t, g, twins[g], tag)
    return j, t, twins, kinds


@pytest.mark.parametrize("fanout,seed,variants", [
    ("gather", 3, dict(audit=True, telemetry=True, scan=True)),
    ("psum", 5, {}),
])
def test_g4_matches_jax_and_single_group_twins(fanout, seed, variants):
    j, t, twins, kinds = run_groups(seed, fanout=fanout, **variants)
    assert {("step", 1), ("burst", 1), ("burst", 2)} <= kinds, kinds
    if variants.get("scan"):
        assert {k for k, _ in kinds} >= {"scan"}, kinds
    for g in range(G):
        assert max(len(s) for s in t.replayed[g]) > 40, (
            g, "workload never committed")
    # groups roll over on their own clocks (the stall has its own test)
    assert t.rebases.sum() >= 1 and len(set(t.rebases.tolist())) > 1, \
        t.rebases
    if variants.get("audit"):
        assert _dumps(t.auditor.dump()) == _dumps(j.auditor.dump())
        assert _dumps(t.flight.dump()) == _dumps(j.flight.dump())
        assert t.auditor.summary()["findings"] == 0
        assert t.auditor.summary()["indices_checked"] > 0
        # the range re-digest of one group's replica
        g, r = 2, 0
        lo = int(t.last["head"][g, r])
        hi = int(t.last["commit"][g, r])
        assert t.redigest(g, r, lo, hi) == j.redigest(g, r, lo, hi) > 0
        assert _dumps(t.auditor.dump()) == _dumps(j.auditor.dump())
    if variants.get("telemetry"):
        np.testing.assert_array_equal(t.device_counters,
                                      np.asarray(j.device_counters))
        for g in range(G):
            np.testing.assert_array_equal(twins[g].device_counters,
                                          t.device_counters[g])


def test_g4_rebase_stall_fires_in_one_group_only():
    """A group whose cut-off replica holds its min head below one ring
    while its leader's end crosses the threshold stalls its rollover
    (counted per group) while the other groups roll over."""
    geo = dict(GEO, rebase_threshold=160)
    j = writable_rebase(JSharded(JCfg(**geo), R, G))
    t = ShardedCluster(LogConfig(**geo), R, G, device="cpu")
    for c in (j, t):
        c.place_leaders()
        c.partition(3, [[0, 1], [2]])
    for i in range(40):
        for c in (j, t):
            for g in range(G):
                for k in range(6):
                    c.submit(g, c.leader_hint(g), b"r%d-%d" % (i, k))
            c.step()
        assert_sharded_equal(j, t, f"step {i}")
    assert t.rebase_stall_steps[3] > 0 and t.rebases[3] == 0, (
        t.rebases, t.rebase_stall_steps)
    assert (t.rebases[:3] >= 1).all(), t.rebases


# ---------------------------------------------------------------------------
# the group step's commit_window: one call over N = G·R, on the ring
# ---------------------------------------------------------------------------

def test_group_step_calls_commit_window_once_over_all_instances(
        monkeypatch):
    t = ShardedCluster(LogConfig(**GEO), R, G, device="cpu")
    calls = []
    real = tstep.commit_window

    def spy(buf, peer_acked, my_ack, *, w, **v):
        calls.append(dict(buf=buf, peer_acked=peer_acked.clone(),
                          my_ack=my_ack.clone(), w=w,
                          **{k: x.clone() for k, x in v.items()},
                          ring=buf.clone(),
                          out=real(buf, peer_acked, my_ack, w=w, **v)))
        return calls[-1]["out"]
    monkeypatch.setattr(tstep, "commit_window", spy)
    t.place_leaders()
    rng = np.random.default_rng(11)
    for i in range(8):
        for g in range(G):
            for _ in range(int(rng.integers(1, 9))):
                t.submit(g, t.leader_hint(g), bytes(rng.integers(
                    0, 256, 20, dtype=np.uint8)))
        n0, clock0 = len(calls), t._dispatch_clock
        if i % 2:
            t.step_burst(max_k=2)
        else:
            t.step()
        # one call per protocol step, bursts included
        assert len(calls) - n0 == t._dispatch_clock - clock0 >= 1
    for c in calls:
        # N = G·R instances, the ring as a view of the state's tensor
        assert c["buf"].shape[0] == G * R
        assert c["buf"].data_ptr() == t.state.log.buf.data_ptr()
    # each instance equals the commit scan on its own inputs
    sw = LogConfig(**GEO).slot_words
    checked = 0
    for c in calls:
        commit2, xpos = c["out"]
        W = c["w"]
        for n in range(G * R):
            grp = n // R
            acks = torch.zeros((1, quorum.R_PAD), dtype=torch.int32)
            acks[0, :R] = torch.where(c["peer_acked"][n],
                                      c["my_ack"][grp * R:(grp + 1) * R], 0)
            g_idx = int(c["commit"][n]) + torch.arange(W)
            rows = c["ring"][n][g_idx & (GEO["n_slots"] - 1)]
            terms = rows[:, sw + 1].to(torch.int32)[None].contiguous()
            scal = quorum.pack_scal(*(c[k][n:n + 1] for k in (
                "commit", "my_term", "my_end", "bm_old", "bm_new",
                "transit", "maj_old", "maj_new")))
            scanned = int(quorum.commit_scan_ref(acks, terms, scal)[0])
            want = (max(int(c["commit"][n]), scanned) if c["i_lead"][n]
                    else int(c["commit1"][n]))
            assert int(commit2[n]) == want, (n, want, int(commit2[n]))
            cross = [k for k in range(W)
                     if int(rows[k, sw]) == int(EntryType.CONFIG)
                     and int(rows[k, sw + 5]) == int(g_idx[k])
                     and int(g_idx[k]) < want]
            assert int(xpos[n]) == (cross[-1] if cross else -1)
            checked += 1
    assert checked == len(calls) * G * R


# ---------------------------------------------------------------------------
# the router copy
# ---------------------------------------------------------------------------

def test_router_copy_matches_the_reference_and_the_golden_map():
    with open(GOLDEN) as f:
        doc = json.load(f)
    router = KeyRouter.from_dict(doc["router"])
    for key, want in doc["mapping"].items():
        assert router.group_of(key) == want, key
    assert router.to_dict() == JRouter.from_dict(doc["router"]).to_dict()
    rng = np.random.default_rng(4)
    for n_groups, vnodes in ((1, 64), (4, 64), (8, 16), (13, 128)):
        rules = []
        for _ in range(int(rng.integers(0, 4))):
            lo = bytes(rng.integers(97, 123, 2, dtype=np.uint8))
            hi = lo + b"\xff"
            rules.append((lo, hi, int(rng.integers(0, n_groups))))
        t = KeyRouter(n_groups, vnodes=vnodes, overrides=rules)
        j = JRouter(n_groups, vnodes=vnodes, overrides=rules)
        assert t.to_dict() == j.to_dict()
        assert KeyRouter.from_dict(j.to_dict()).to_dict() == t.to_dict()
        assert JRouter.from_dict(t.to_dict()).to_dict() == j.to_dict()
        for _ in range(300):
            k = bytes(rng.integers(0, 256, int(rng.integers(0, 12)),
                                   dtype=np.uint8))
            assert t.group_of(k) == j.group_of(k), k
            assert ring_hash(k) == jring_hash(k)
    assert canon_key("ключ") == "ключ".encode()
    r8 = KeyRouter(8, overrides=[RangeRule(b"a", b"b", 4)])
    bad = dict(r8.to_dict(), ring_checksum=r8.to_dict()["ring_checksum"] ^ 1)
    for cls in (KeyRouter, JRouter):
        with pytest.raises(ValueError, match="checksum mismatch"):
            cls.from_dict(bad)
        with pytest.raises(ValueError, match="unknown router"):
            cls.from_dict(dict(r8.to_dict(), hash="md5"))
    assert JRule(b"a", b"b", 4).to_dict() == RangeRule(b"a", b"b",
                                                       4).to_dict()


# ---------------------------------------------------------------------------
# ShardedKVS / ShardedSession (tests/test_shard.py:293-431), both packages
# ---------------------------------------------------------------------------

def kvs_both(scenario, *, n_groups=4, obs=False):
    """Run ``scenario(sc, kv, side)`` on a JAX and a port sharded KVS
    (leaders placed round-robin) and compare what it returns, every
    group's committed streams, and every replica's folded table, dedup
    registry and dedup count."""
    sides = {}
    for side, mk_sc, mk_kv, mk_obs in (
            ("jax", lambda: JSharded(JCfg(**KV_GEO), 3, n_groups), JKVS,
             JObs),
            ("port", lambda: ShardedCluster(LogConfig(**KV_GEO), 3,
                                            n_groups, device="cpu"),
             ShardedKVS, Observability)):
        sc = mk_sc()
        if obs:
            sc.obs = mk_obs()
            sc.obs.spans.set_sample_every(1)
        sc.place_leaders()
        kv = mk_kv(sc, cap=256)
        sides[side] = (sc, kv, scenario(sc, kv, side))
    (jsc, jkv, jres), (tsc, tkv, tres) = sides["jax"], sides["port"]
    assert jres == tres
    for g in range(n_groups):
        for r in range(3):
            assert list(jsc.replayed[g][r]) == list(tsc.replayed[g][r])
            jkv.groups[g]._fold(r)
            tkv.groups[g]._fold(r)
            jt = convert.kv_state_to_numpy(jkv.groups[g].tables[r])
            tt = convert.kv_state_to_numpy(tkv.groups[g].tables[r])
            for k in jt:
                np.testing.assert_array_equal(jt[k], tt[k],
                                              err_msg=f"g{g} r{r} {k}")
            assert jkv.groups[g].last_req[r] == tkv.groups[g].last_req[r]
            assert jkv.groups[g].deduped[r] == tkv.groups[g].deduped[r]
    return sides


def test_sharded_kvs_routes_and_reads():
    def scenario(sc, kv, side):
        data = {b"city%d" % i: b"v%d" % i for i in range(24)}
        for k, v in data.items():
            kv.put(k, v)
        for _ in range(3):
            sc.step()
        got = [kv.get(k, linearizable=True) for k in data]
        assert got == list(data.values())
        groups = sorted({kv.group_of(k) for k in data})
        assert len(groups) > 1
        kv.remove(b"city0")
        sc.step()
        sc.step()
        return got, groups, kv.get(b"city0")
    sides = kvs_both(scenario)
    assert sides["port"][2][2] is None


def test_sharded_session_per_group_seqnos_and_dedup():
    def scenario(sc, kv, side):
        sess = kv.session(7)
        placed = {}
        for i in range(12):
            g, rid = sess.put(b"s%d" % i, b"val%d" % i)
            placed.setdefault(g, []).append(rid)
        for g, rids in placed.items():
            assert rids == list(range(1, len(rids) + 1)), (g, rids)
        for _ in range(3):
            sc.step()
        g0 = kv.group_of(b"s0")
        sess.retransmit_put(b"s0", b"val0", req_id=placed[g0][0])
        sc.step()
        sc.step()
        lead = sc.leader_hint(g0)
        kv.groups[g0]._fold(lead)
        assert kv.groups[g0].deduped[lead] >= 1
        return (sorted(placed.items()), [sess.req_id(g) for g in range(4)],
                kv.get(b"s0", linearizable=True))
    kvs_both(scenario)


def test_direct_puts_share_the_session_conn_namespace():
    def scenario(sc, kv, side):
        sess = kv.session(2)
        k = b"alias-probe"
        g = kv.group_of(k)
        assert kv.conn_for(2, g) == sess.conn_for(g) == 2 * 4 + g
        assert kv.conn_for(0, g) == 0
        _, rid = sess.put(k, b"v1")
        for _ in range(3):
            sc.step()
        kv.put(k, b"v1", client_id=2, req_id=rid)
        sc.step()
        sc.step()
        lead = sc.leader_hint(g)
        kv.groups[g]._fold(lead)
        return kv.groups[g].deduped[lead], kv.get(k, linearizable=True)
    sides = kvs_both(scenario)
    assert sides["port"][2] == (1, b"v1")


def test_shared_conn_namespace_reduces_to_single_group_ids_at_g1():
    """With G = 1 the namespace ``c * G + g`` is the client id itself:
    the single-group conn ids the driver parity tests use."""
    sc = ShardedCluster(LogConfig(**KV_GEO), 3, 1, device="cpu")
    kv = ShardedKVS(sc, cap=64)
    assert [kv.conn_for(c, 0) for c in (0, 1, 7, 1 << 20)] == [
        0, 1, 7, 1 << 20]
    assert kv.session(5).conn_for(0) == 5


def test_sharded_session_failover_in_one_group_only():
    def scenario(sc, kv, side):
        sess = kv.session(3)
        seeds = {}
        for i in range(40):
            k = b"f%d" % i
            g = kv.group_of(k)
            if g not in seeds:
                seeds[g] = k
                sess.put(k, b"seed")
            if len(seeds) == 4:
                break
        for _ in range(3):
            sc.step()
        g0 = kv.group_of(b"hotkey")
        old = sc.leader(g0)
        _, rid = sess.put(b"hotkey", b"v1")
        others = [r for r in range(3) if r != old]
        sc.partition(g0, [[old], others])
        sc.step(timeouts={g0: [others[0]]})
        sc.step()
        assert sc.leader_hint(g0) == others[0]
        sess.retransmit_put(b"hotkey", b"v1", rid)
        for _ in range(3):
            sc.step()
        out = [kv.get(b"hotkey", linearizable=True)]
        for g, k in sorted(seeds.items()):
            if g == g0:
                continue
            assert sc.last["role"][g].tolist().count(int(Role.LEADER)) == 1
            out.append(kv.get(k, linearizable=True))
        return out, sc.leaders()
    sides = kvs_both(scenario)
    assert set(sides["port"][2][0][1:]) == {b"seed"}


def test_per_group_metric_series_and_span_keys():
    def scenario(sc, kv, side):
        sess = kv.session(1)
        done = set()
        i = 0
        while len(done) < 4:
            k = b"sp%d" % i
            g = kv.group_of(k)
            if g not in done:
                sess.put(k, b"x")
                done.add(g)
            i += 1
        for _ in range(3):
            sc.step()
        snap = sc.obs.metrics.snapshot()
        series = {k: v for sec in ("gauges", "counters")
                  for k, v in snap[sec].items() if k.startswith("shard_")}
        for g in range(4):
            assert f"shard_commit{{group={g}}}" in series
            assert series[f"shard_committed_entries_total{{group={g}}}"] \
                >= 1
        spans = []
        for s in sc.obs.spans.dump()["spans"]:
            if s.get("term") is None:
                continue
            assert s["origin"] // sc.R == s["group"] == s["leader"] // sc.R
            spans.append((s["conn"], s["req"], s["group"], s["term"],
                          s["index"], s["status"], s["origin"],
                          s["leader"]))
            assert sc.obs.spans.key_for(s["term"], s["index"],
                                        group=s["group"]) in (
                (s["conn"], s["req"]), None)
        assert spans
        return series, sorted(spans)
    kvs_both(scenario, obs=True)


# ---------------------------------------------------------------------------
# the shard nemesis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(seed=0, n_groups=4, steps=40, crash_step=15),
    dict(seed=2, n_groups=4, steps=36, crash_step=14),
    dict(seed=2, n_groups=2, steps=30, crash_step=10),
])
def test_shard_nemesis_matches_jax(kw):
    """The JAX settings of tests/test_shard.py (seed 0), test_reads.py
    and test_audit.py (seed 2): the same verdict dict, history, ledger
    and flight ring."""
    jr = JNemesis(n_replicas=3, **kw)
    tr = ShardNemesisRunner(n_replicas=3, device="cpu", **kw)
    jv, tv = jr.run(), tr.run()
    assert tv["ok"], tv
    assert json.dumps(tv, sort_keys=True) == json.dumps(jv, sort_keys=True)
    assert tr.history.to_jsonl() == jr.history.to_jsonl()
    assert _dumps(tr.shard.auditor.dump()) == _dumps(jr.shard.auditor.dump())
    assert _dumps(tr.shard.flight.dump()) == _dumps(jr.shard.flight.dump())
    f = tv["frontiers"]
    for g in range(kw["n_groups"]):
        if g != tv["target_group"]:
            assert f["at_heal"][g] > f["at_crash"][g]
    assert tv["target_recovered"] and tv["new_leader"] != tv[
        "crashed_leader"]


def test_keys_for_groups_matches_jax():
    from rdma_paxos_tpu.shard.chaos import keys_for_groups as jkeys
    for n in (2, 4, 8):
        assert keys_for_groups(KeyRouter(n), 3) == jkeys(JRouter(n), 3)


# ---------------------------------------------------------------------------
# snapshot group=, corrupt_slot group=, and the converters
# ---------------------------------------------------------------------------

def _audited_groups(seed):
    """Both engines, audited, through seeded traffic in every group with
    one group's replica partitioned and healed."""
    j = JSharded(JCfg(**GEO), R, G, audit=True, telemetry=True)
    t = ShardedCluster(LogConfig(**GEO), R, G, audit=True, telemetry=True,
                       device="cpu")
    rng = np.random.default_rng(seed)
    for c in (j, t):
        c.place_leaders()
    for i in range(24):
        p = [bytes(rng.integers(0, 256, 20, dtype=np.uint8))
             for _ in range(G)]
        for c in (j, t):
            if i == 6:
                c.partition(1, [[0, 1], [2]])
            elif i == 10:
                c.heal(1)
            for g in range(G):
                c.submit(g, c.leader_hint(g), p[g])
            c.step()
    assert_sharded_equal(j, t, "audited groups")
    return j, t


def test_snapshot_group_take_install_vote_verify_match_jax():
    j, t = _audited_groups(7)
    for g in range(G):
        for donor in range(R):
            js = jsnap.take_snapshot(j.state, donor, group=g, digests=True,
                                     rebased_total=int(j.rebased_total[g]))
            ts = tsnap.take_snapshot(t.state, donor, group=g, digests=True,
                                     rebased_total=int(t.rebased_total[g]))
            jn, tn = convert.snapshot_to_numpy(js), convert.snapshot_to_numpy(ts)
            np.testing.assert_array_equal(jn.pop("audit_digests"),
                                          tn.pop("audit_digests"))
            assert jn == tn
            assert tsnap.verify_snapshot(ts, t.auditor, group=g) == \
                jsnap.verify_snapshot(js, j.auditor, group=g)
        for r in range(R):
            assert tsnap.recover_vote(t.state, r, group=g) == \
                jsnap.recover_vote(j.state, r, group=g)
    # a corrupted donor row of group 3 is refused by both; the leader's
    # snapshot installs into group 3's replica 2, equal to JAX's install
    from rdma_paxos_tpu.chaos.faults import corrupt_slot as jcorrupt
    from rdma_paxos_tpu_torch.chaos.faults import corrupt_slot as tcorrupt
    gv = 3
    for c, corrupt in ((j, jcorrupt), (t, tcorrupt)):
        corrupt(c, 2, int(c.applied[gv, 2]) - 1, group=gv)
    before = convert.replica_state_to_numpy(t.state)
    for c, mod in ((j, jsnap), (t, tsnap)):
        bad = mod.take_snapshot(c.state, 2, group=gv, digests=True,
                                index=int(c.applied[gv, 2]),
                                rebased_total=int(c.rebased_total[gv]))
        with pytest.raises(mod.SnapshotVerifyError, match="contradicts"):
            mod.install_snapshot(c.state, 1, bad, group=gv,
                                 ledger=c.auditor, ledger_group=gv)
    after = convert.replica_state_to_numpy(t.state)
    for k in before:
        np.testing.assert_array_equal(before[k], after[k], err_msg=k)
    lead = t.leader_hint(gv)
    for c, mod in ((j, jsnap), (t, tsnap)):
        snap = mod.take_snapshot(c.state, lead, group=gv, digests=True,
                                 rebased_total=int(c.rebased_total[gv]))
        vt, vf = mod.recover_vote(c.state, 2, group=gv)
        c.state = mod.install_snapshot(c.state, 2, snap, group=gv,
                                       voted_term=vt, voted_for=vf,
                                       ledger=c.auditor, ledger_group=gv)
    js = convert.replica_state_to_numpy(j.state)
    ts = convert.replica_state_to_numpy(t.state)
    for k in js:
        np.testing.assert_array_equal(js[k], ts[k], err_msg=k)
    # the installed group catches up; the others never noticed
    for c in (j, t):
        c.applied[gv, 2] = int(np.asarray(c.state.apply)[gv, 2])
        for _ in range(3):
            c.step()
    np.testing.assert_array_equal(
        convert.replica_state_to_numpy(j.state)["commit"],
        convert.replica_state_to_numpy(t.state)["commit"])
    with pytest.raises(ValueError, match="group"):
        tsnap.take_snapshot(t.state, 0)


def test_sharded_state_and_bookkeeping_carry_across_both_ways():
    """A JAX cluster's [G, R] state and host bookkeeping load into the
    port's engine (and the port's into a fresh port engine): stepping on
    from there gives the JAX engine's results."""
    j, t0 = _audited_groups(9)
    t = ShardedCluster(LogConfig(**GEO), R, G, device="cpu")
    convert.sharded_restore(t, convert.sharded_snapshot(j))
    t2 = ShardedCluster(LogConfig(**GEO), R, G, device="cpu")
    convert.sharded_restore(t2, convert.sharded_snapshot(t0))
    jp = JSharded(JCfg(**GEO), R, G)
    import dataclasses
    import jax.numpy as jnp
    from rdma_paxos_tpu.consensus.log import Log as JLog
    st = convert.replica_state_to_numpy(t0.state)
    jp.state = dataclasses.replace(
        jp.state, log=JLog(buf=jnp.asarray(st["log"])),
        **{k: jnp.asarray(v) for k, v in st.items() if k != "log"})
    sn = convert.sharded_snapshot(t0)
    jp.applied = sn["applied"].copy()
    jp.last = {k: v.copy() for k, v in sn["last"].items()}
    jp.rebased_total = sn["rebased_total"].copy()
    for i in range(6):
        for c in (j, t, t2, jp):
            for g in range(G):
                c.submit(g, c.leader_hint(g), b"after%d-%d" % (i, g))
        res = [c.step() for c in (j, t, t2, jp)]
        for k in SimCluster.RES_KEYS:
            for other in res[1:]:
                np.testing.assert_array_equal(np.asarray(res[0][k]),
                                              np.asarray(other[k]),
                                              err_msg=k)


# ---------------------------------------------------------------------------
# what raises
# ---------------------------------------------------------------------------

def test_unported_surfaces_raise():
    cfg = LogConfig(**GEO)
    # ported since: the mesh engine, on a device list only (one device
    # implies no list; tests/test_torch_mesh.py drives it)
    with pytest.raises(ValueError, match="device list"):
        ShardedCluster(cfg, 3, 2, mesh=(2, 3), device="cpu")
    msc = ShardedCluster(cfg, 3, 2, mesh=(2, 3), device=["cpu"] * 6)
    try:
        msc.place_leaders()
        assert [b.log.buf.shape[:2] for b in msc.blocks] == [(1, 1)] * 6
        assert msc.health()["mesh"]["layout"] == "2x3"
    finally:
        msc.close()
    sc = ShardedCluster(cfg, 3, 2, device="cpu")
    # ported since: the health document, the governor, the streams hub
    # and the topology controller, each observed by every finish
    assert [g["group"] for g in sc.health()["groups"]] == [0, 1]
    assert sc.health()["topology"] is None
    for name in ("streams", "governor", "topology"):
        gsc = ShardedCluster(cfg, 3, 2, device="cpu")
        if name == "governor":
            from rdma_paxos_tpu_torch.runtime.governor import (
                attach_governor)
            gov = attach_governor(gsc)
            gsc.step()
            assert gov.evals == 1
        elif name == "streams":
            from rdma_paxos_tpu_torch import streams
            hub = streams.attach(gsc)
            gsc.step()
            assert hub.status()["steps"] == 1 and hub.G == 2
            hub.fail_all("test done")
        else:
            from rdma_paxos_tpu_torch.topology import attach_topology
            ctl = attach_topology(ShardedKVS(gsc, cap=64))
            gsc.step()
            assert gsc.topology is ctl
            assert gsc.health()["topology"] == ctl.status()
    # transactions are ported (tests/test_torch_txn.py): without a
    # coordinator, transact refuses as the JAX KVS does
    with pytest.raises(RuntimeError, match="attach_coordinator"):
        ShardedKVS(sc, cap=64).transact([("put", b"k", b"v")])
    with pytest.raises(RuntimeError):
        sc.step_burst()
    sc.place_leaders()
    assert sc.leaders() == [0, 1]
    psum = ShardedCluster(cfg, 3, 2, fanout="psum", device="cpu")
    with pytest.raises(ValueError):
        psum.partition(0, [[0], [1, 2]])
    assert sc.dispatches >= 1
    # a group step's staging is [G, R, ...]: the same program for any G
    inp = tstep.make_step_input(cfg, 3, n_groups=5, device="cpu")
    assert inp.batch_data.shape == (5, 3, cfg.batch_slots, cfg.slot_words)
    assert inp.batch_meta.shape[-1] == META_W
    assert inp.peer_mask.shape == (5, 3, 3)


def test_group_states_are_clones_not_views():
    from rdma_paxos_tpu_torch.parallel.mesh import stack_group_states
    st = stack_group_states(LogConfig(**GEO), 3, R, R, device="cpu")
    st.log.buf[0, 0, 0, 0] = 7
    st.term[1, 2] = 5
    assert int(st.log.buf[1, 0, 0, 0]) == 0 and int(st.term[0, 2]) == 0
    assert st.log.buf.is_contiguous()
    assert st.vote_rec_term.shape == (3, R, R)
