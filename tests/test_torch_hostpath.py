"""Port parity of the driver's host data plane (``runtime/hostpath.py``):
the replay/ack plan, store framing and stream helpers equal the JAX
package's on seeded segments, against both the JAX package's vectorized
and its scalar replay plan."""

import numpy as np
import pytest
import torch

import rdma_paxos_tpu.runtime.hostpath as jhp
import rdma_paxos_tpu_torch.runtime.hostpath as thp

torch.set_num_threads(1)


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
