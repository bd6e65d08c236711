"""Port parity of the driver's host data plane (``runtime/hostpath.py``):
the replay/ack plan, store framing and stream helpers equal the JAX
package's on seeded segments, against both the JAX package's vectorized
and its scalar replay plan. The port's scalar plane (``set_vectorized
(False)``): window encode, decode (with a rebase) and the replay plan
byte-identical across the port's two planes and the JAX scalar plane;
``assemble_frames`` against JAX's and the legacy golden; the engines'
replay streams with both packages' planes off.

Every test restores both packages' switches (``planes_restored``): the
switch is module-global, and a later test in the same worker must never
see the scalar plane."""

import numpy as np
import pytest
import torch

import rdma_paxos_tpu.runtime.hostpath as jhp
import rdma_paxos_tpu_torch.runtime.hostpath as thp
from rdma_paxos_tpu_torch.consensus.log import (
    M_CONN, M_GIDX, M_LEN, M_TYPE, META_W)
from tests.test_torch_sim import jax_step_cache_restored  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def planes_restored():
    """Both packages' host-plane switches as this test found them."""
    prev = jhp.VECTORIZED, thp.VECTORIZED
    yield
    jhp.set_vectorized(prev[0])
    thp.set_vectorized(prev[1])


def columns(seed: int, n: int):
    """Seeded client entries: CONNECT/SEND/CLOSE from three origins, SEND
    runs on few connections (so runs coalesce), payloads of 0-40 B."""
    rng = np.random.default_rng(seed)
    types = rng.choice([2, 3, 3, 3, 3, 4], n).astype(np.int32)
    origin = rng.integers(0, 3, n)
    conns = ((origin << 24) | rng.integers(1, 4, n)).astype(np.int32)
    reqs = np.arange(1, n + 1, dtype=np.int32)
    lens = rng.integers(0, 41, n).astype(np.int64)
    lens[types != 3] = 0
    blob = bytes(rng.integers(0, 256, int(lens.sum()), dtype=np.uint8))
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    return types, conns, reqs, np.zeros(n, np.int32), lens, blob, offs


def batches(seed: int, n: int, start: int):
    """The same batch in both packages, sliced at ``start`` (a slice
    keeps the whole blob and an absolute offset table)."""
    cols = columns(seed, n)
    return (jhp.ReplayBatch(*cols).slice(start),
            thp.ReplayBatch(*cols).slice(start))


def own_of(r):
    return lambda conns, _gens: (conns >> 24) == r


@pytest.mark.parametrize("vectorized", [True, False])
@pytest.mark.parametrize("seed,n,start", [(0, 1, 0), (1, 64, 0),
                                          (2, 257, 0), (3, 64, 17),
                                          (4, 300, 299), (5, 500, 3)])
def test_plan_segment_matches_jax(vectorized, seed, n, start):
    jb, tb = batches(seed, n, start)
    prev = jhp.set_vectorized(vectorized)
    try:
        for r in range(3):
            for want in (True, False):
                want_j = jhp.plan_segment(jb, own_of(r), want_ops=want)
                assert thp.plan_segment(tb, own_of(r),
                                        want_ops=want) == want_j
                own = (tb.conns >> 24) == r
                assert thp.replay_plan(tb, own, want) == jhp.replay_plan(
                    jb, own, want)
            # the plain-tuple form (the materialized part of a stream)
            tup = jb.tuples()
            assert thp.plan_segment(tup, own_of(r)) == jhp.plan_segment(
                tup, own_of(r))
        assert thp.plan_segment([], own_of(0)) == jhp.plan_segment(
            [], own_of(0)) == (-1, [], 0)
    finally:
        jhp.set_vectorized(prev)


@pytest.mark.parametrize("seed,n,start", [(6, 1, 0), (7, 100, 0),
                                          (8, 100, 41)])
def test_frames_match_jax_byte_for_byte(seed, n, start):
    jb, tb = batches(seed, n, start)
    want = jhp.frames_from_cols(jb.types, jb.conns, jb.lens, jb.blob,
                                jb.offs)
    assert thp.frames_from_cols(tb.types, tb.conns, tb.lens, tb.blob,
                                tb.offs) == want
    assert tb.frames() == jb.frames() == want
    assert thp.frames_from_cols([], [], [], b"", [0]) == b""


def test_stream_segments_match_jax():
    """Batches appended to both packages' streams give the same tuple
    view, and the same segments after part of the stream was
    materialized by a reader."""
    cols = columns(9, 40)
    js, ts = jhp.LazyReplayStream(), thp.LazyReplayStream()
    for k in (0, 10, 25):
        js.append_batch(jhp.ReplayBatch(*cols).slice(k))
        ts.append_batch(thp.ReplayBatch(*cols).slice(k))
    assert len(ts) == len(js) == 85
    assert ts[70] == js[70]                     # materializes both
    ts.append_batch(thp.ReplayBatch(*cols).slice(30))
    js.append_batch(jhp.ReplayBatch(*cols).slice(30))
    assert ts == js and list(ts) == list(js)

    def view(stream, start):
        return [s if isinstance(s, list) else s.tuples()
                for s in stream.segments_from(start)]
    for start in (0, 60, 85, 90):
        ts2, js2 = thp.LazyReplayStream(), jhp.LazyReplayStream()
        for k in (0, 10, 25):
            ts2.append_batch(thp.ReplayBatch(*cols).slice(k))
            js2.append_batch(jhp.ReplayBatch(*cols).slice(k))
        assert ts2[0] == js2[0]                 # a reader's materialize
        ts2.append_batch(thp.ReplayBatch(*cols).slice(30))
        js2.append_batch(jhp.ReplayBatch(*cols).slice(30))
        assert view(ts2, start) == view(js2, start)


@pytest.mark.parametrize("materialize", [False, True])
def test_stream_copy_and_extend_match_jax(materialize):
    """The recovery helpers: a structural copy diverges from its donor,
    a decoded batch extends a lazy stream or a plain list in the slot,
    and ``append``/``extend``/``!=`` see the tuple view."""
    cols = columns(10, 30)
    streams = []
    for hp in (jhp, thp):
        donor = hp.LazyReplayStream()
        donor.append_batch(hp.ReplayBatch(*cols))
        if materialize:
            assert donor[0]                 # a reader's materialize
        donor.append_batch(hp.ReplayBatch(*cols).slice(20))
        copy = hp.stream_copy(donor)
        plain = hp.stream_copy(list(donor))
        hp.extend_stream(copy, hp.ReplayBatch(*cols).slice(5))
        lst = list(donor)
        hp.extend_stream(lst, hp.ReplayBatch(*cols).slice(25))
        donor.append((3, 1, 0, b"own"))
        plain.extend([(3, 2, 0, b"a"), (3, 2, 1, b"b")])
        assert isinstance(copy, hp.LazyReplayStream)
        assert isinstance(plain, hp.LazyReplayStream)
        assert len(copy) == 65 and len(donor) == 41 and len(lst) == 45
        assert copy != donor and not (copy != list(copy))
        streams.append([list(copy), list(donor), lst, list(plain)])
    assert streams[0] == streams[1]


# ---------------------------------------------------------------------------
# the device-list engines' replay streams and frames (tests/test_hostpath.py's
# engine-level recorded workloads, spmd and mesh)
# ---------------------------------------------------------------------------

def _port_drive_sim():
    """tests/test_hostpath.py's ``_drive_sim("spmd")`` on the port's spmd
    engine (three CPU entries)."""
    from rdma_paxos_tpu_torch.consensus.log import EntryType
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    from tests.test_hostpath import CFG, _random_take, _rng
    c = SimCluster(_port_cfg(CFG), 3, mode="spmd", device=["cpu"] * 3)
    try:
        c.collect_frames = True
        c.run_until_elected(0)
        rng = _rng(99)
        for i in range(12):
            for p in _random_take(rng, 6, CFG.slot_bytes):
                c.submit(0, p[3], EntryType(p[0] if p[0] in (2, 3, 4)
                                            else 3),
                         conn=p[1], req_id=p[2])
            (c.step_burst if i % 3 else c.step)()
        for _ in range(4):
            c.step()
        return ([list(c.replayed[r]) for r in range(3)],
                [list(c.frames[r]) for r in range(3)], c.applied.copy())
    finally:
        c.close()


def _port_drive_sharded(mesh):
    """tests/test_hostpath.py's ``_drive_sharded(mesh)`` on the port's
    mesh engine (CPU entries)."""
    from rdma_paxos_tpu_torch.consensus.log import EntryType
    from rdma_paxos_tpu_torch.shard import ShardedCluster
    from tests.test_hostpath import CFG, _random_take, _rng
    c = ShardedCluster(_port_cfg(CFG), 2, 2, mesh=mesh,
                       device=["cpu"] * (mesh[0] * mesh[1]))
    try:
        c.collect_frames = True
        c.place_leaders()
        rng = _rng(7)
        for i in range(8):
            for g in range(2):
                lead = c.leader_hint(g)
                for p in _random_take(rng, 5, CFG.slot_bytes):
                    c.submit(g, lead, p[3], EntryType.SEND,
                             conn=p[1], req_id=p[2])
            (c.step_burst if i % 2 else c.step)()
        for _ in range(4):
            c.step()
        return ([[list(c.replayed[g][r]) for r in range(2)]
                 for g in range(2)],
                [[list(c.frames[g][r]) for r in range(2)]
                 for g in range(2)])
    finally:
        c.close()


def _port_cfg(jcfg):
    import dataclasses

    from rdma_paxos_tpu_torch.config import LogConfig
    return LogConfig(**dataclasses.asdict(jcfg))


def test_spmd_engine_streams_and_frames_match_jax():
    from tests.test_hostpath import _drive_sim
    streams_j, frames_j, applied_j = _drive_sim("spmd")
    streams_t, frames_t, applied_t = _port_drive_sim()
    assert streams_t == streams_j
    assert frames_t == frames_j
    assert np.array_equal(applied_t, applied_j)


def test_mesh_engine_streams_and_frames_match_jax():
    from tests.test_hostpath import _drive_sharded
    assert _port_drive_sharded((2, 2)) == _drive_sharded((2, 2))


# ---------------------------------------------------------------------------
# the scalar host data plane: the port's two planes and JAX's scalar plane
# ---------------------------------------------------------------------------

def _planes(fn):
    """``fn(hostpath)`` under the port's scalar plane, the port's
    vectorized plane and the JAX scalar plane."""
    out = []
    for hp, vec in ((thp, False), (thp, True), (jhp, False)):
        prev = hp.set_vectorized(vec)
        try:
            out.append(fn(hp))
        finally:
            hp.set_vectorized(prev)
    return out


def test_set_vectorized_returns_the_previous_setting():
    assert thp.VECTORIZED is True
    assert thp.set_vectorized(False) is True
    assert thp.VECTORIZED is False
    assert thp.set_vectorized(0) is False          # coerced to bool
    assert thp.set_vectorized(True) is False
    assert thp.VECTORIZED is True
    assert set(thp.__all__) == set(jhp.__all__)
    assert all(hasattr(thp, n) for n in thp.__all__)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("gen", [None, 5])
def test_pack_window_planes_match_jax_scalar(seed, gen):
    from tests.test_hostpath import CFG, _random_take, _rng
    take = _random_take(_rng(seed), 1 + seed * 7, CFG.slot_bytes)

    def pack(hp):
        data = np.zeros((len(take) + 3, CFG.slot_bytes // 4), np.int32)
        meta = np.zeros((len(take) + 3, META_W), np.int32)
        du8 = data.view(np.uint8).reshape(data.shape[0], -1)
        n = hp.pack_window(du8, meta, take, CFG.slot_bytes, gen=gen)
        return n, data.tobytes(), meta.tobytes()
    ts, tv, js = _planes(pack)
    assert ts == tv == js
    assert ts[0] == len(take)


def test_pack_window_oversize_raises_on_both_planes():
    from tests.test_hostpath import CFG
    take = [(3, 1, 1, b"x" * (CFG.slot_bytes + 1))]
    for vec in (False, True):
        thp.set_vectorized(vec)
        data = np.zeros((4, CFG.slot_bytes // 4), np.int32)
        with pytest.raises(ValueError, match="slot capacity"):
            thp.pack_window(data.view(np.uint8).reshape(4, -1),
                            np.zeros((4, META_W), np.int32), take,
                            CFG.slot_bytes)


def _batch_view(b):
    if b is None:
        return None
    return (b.tuples(), b.blob, b.offs.tolist(), b.gens.tolist(),
            b.lens.tolist(), b.terms.tolist(), b.gidx.tolist(), b.frames())


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("rebase", [0, 1 << 20, 3 * 8192])
def test_decode_batch_planes_match_jax_scalar(seed, rebase):
    """Every column, the blob, the offset table, the log coordinates
    (the ``rebase`` added to ``M_GIDX`` by both planes) and the frames."""
    from tests.test_hostpath import _random_window, _rng
    wm, wd = _random_window(_rng(seed + 10), 5 + seed * 9)
    wm[:, M_GIDX] = np.arange(wm.shape[0]) + 40        # raw offsets
    n = wm.shape[0]
    for k in (n, n // 2, 1):
        ts, tv, js = _planes(lambda hp: _batch_view(
            hp.decode_batch(wm, wd, k, rebase)))
        assert ts == tv == js, (k, rebase)
        if ts is not None:
            client = np.isin(wm[:k, M_TYPE], (2, 3, 4))
            assert ts[6] == [int(g) + rebase
                             for g in wm[:k, M_GIDX][client]]
    empty = np.zeros((4, META_W), np.int32)
    assert _planes(lambda hp: hp.decode_batch(
        empty, np.zeros((4, 16), np.int32), 4, rebase)) == [None] * 3


@pytest.mark.parametrize("seed,n,start", [(0, 1, 0), (1, 64, 0),
                                          (2, 257, 0), (3, 64, 17),
                                          (4, 300, 299), (5, 500, 3)])
def test_replay_plan_planes_match_jax_scalar(seed, n, start):
    jb, tb = batches(seed, n, start)
    for r in range(3):
        own = (tb.conns >> 24) == r
        for want in (True, False):
            ts, tv, js = _planes(lambda hp: hp.replay_plan(
                jb if hp is jhp else tb, own, want))
            assert ts == tv == js, (r, want)


def test_assemble_frames_matches_jax_and_the_legacy_golden():
    from rdma_paxos_tpu.runtime.sim import assemble_frames as j_frames
    from rdma_paxos_tpu_torch.runtime.sim import assemble_frames
    from tests.test_hostpath import (
        _random_window, _rng, legacy_assemble_frames)
    checked = 0
    for seed in range(6):
        wm, wd = _random_window(_rng(seed + 20), 4 + seed * 11)
        n = wm.shape[0]
        types, conns = wm[:n, M_TYPE], wm[:n, M_CONN]
        idxs = np.nonzero((types >= 2) & (types <= 4))[0]
        if not idxs.size:
            continue
        raw = np.ascontiguousarray(wd[:n]).view(np.uint8).reshape(n, -1)
        lens = np.minimum(wm[:n, M_LEN], raw.shape[1])
        golden = legacy_assemble_frames(types, conns, lens, raw, idxs)
        got = assemble_frames(types, conns, lens, raw, idxs)
        assert got == golden == j_frames(types, conns, lens, raw, idxs)
        # unclipped lengths are clipped to the slot width, as JAX does
        assert assemble_frames(types, conns, wm[:n, M_LEN], raw,
                               idxs) == j_frames(types, conns,
                                                 wm[:n, M_LEN], raw, idxs)
        assert thp.decode_batch(wm, wd, n).frames() == got
        checked += 1
    assert checked >= 5


def _port_drive_stacked():
    """tests/test_hostpath.py's ``_drive_sim("sim")`` on the port's
    stacked engine."""
    from rdma_paxos_tpu_torch.consensus.log import EntryType
    from rdma_paxos_tpu_torch.runtime.sim import SimCluster
    from tests.test_hostpath import CFG, _random_take, _rng
    c = SimCluster(_port_cfg(CFG), 3, device="cpu")
    c.collect_frames = True
    c.run_until_elected(0)
    rng = _rng(99)
    for i in range(12):
        for p in _random_take(rng, 6, CFG.slot_bytes):
            c.submit(0, p[3], EntryType(p[0] if p[0] in (2, 3, 4) else 3),
                     conn=p[1], req_id=p[2])
        (c.step_burst if i % 3 else c.step)()
    for _ in range(4):
        c.step()
    return ([list(c.replayed[r]) for r in range(3)],
            [list(c.frames[r]) for r in range(3)], c.applied.copy())


def _port_drive_groups():
    """tests/test_hostpath.py's ``_drive_sharded(None)`` on the port's
    stacked group engine."""
    from rdma_paxos_tpu_torch.consensus.log import EntryType
    from rdma_paxos_tpu_torch.shard import ShardedCluster
    from tests.test_hostpath import CFG, _random_take, _rng
    c = ShardedCluster(_port_cfg(CFG), 2, 2, device="cpu")
    c.collect_frames = True
    c.place_leaders()
    rng = _rng(7)
    for i in range(8):
        for g in range(2):
            lead = c.leader_hint(g)
            for p in _random_take(rng, 5, CFG.slot_bytes):
                c.submit(g, lead, p[3], EntryType.SEND, conn=p[1],
                         req_id=p[2])
        (c.step_burst if i % 2 else c.step)()
    for _ in range(4):
        c.step()
    return ([[list(c.replayed[g][r]) for r in range(2)] for g in range(2)],
            [[list(c.frames[g][r]) for r in range(2)] for g in range(2)])


def _with_planes(vec: bool, fn):
    prev = jhp.set_vectorized(vec), thp.set_vectorized(vec)
    try:
        return fn()
    finally:
        jhp.set_vectorized(prev[0])
        thp.set_vectorized(prev[1])


def test_sim_streams_with_the_planes_off_match_jax():
    """``SimCluster`` with both packages' planes off: replay streams,
    frames and apply cursors equal to each other and to the planes-on
    run (both packages)."""
    from tests.test_hostpath import _drive_sim
    off_t = _with_planes(False, _port_drive_stacked)
    off_j = _with_planes(False, _drive_sim)
    on_t = _with_planes(True, _port_drive_stacked)
    for a, b in ((off_t, off_j), (off_t, on_t)):
        assert a[0] == b[0] and a[1] == b[1]
        assert np.array_equal(a[2], b[2])
    assert sum(map(len, off_t[0])) > 0


def test_sharded_streams_with_the_planes_off_match_jax():
    """``ShardedCluster(G=2)`` with both packages' planes off: every
    group's replay streams and frames equal to each other and to the
    planes-on run."""
    from tests.test_hostpath import _drive_sharded
    off_t = _with_planes(False, _port_drive_groups)
    off_j = _with_planes(False, lambda: _drive_sharded(None))
    on_t = _with_planes(True, _port_drive_groups)
    assert off_t == off_j == on_t
    assert all(len(s) for g in off_t[0] for s in g)
