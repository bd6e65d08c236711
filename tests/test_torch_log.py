"""Port parity: the slot-ring log operations against the JAX package's,
replica by replica, on seeded random rings — ring wrap, the capacity
clamp, divergence truncation and the gap gate. Exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdma_paxos_tpu.config import LogConfig as JCfg
from rdma_paxos_tpu.consensus import log as jlog
from rdma_paxos_tpu_torch.config import LogConfig
from rdma_paxos_tpu_torch.consensus import log as tlog

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

GEO = dict(n_slots=16, slot_bytes=16, window_slots=8, batch_slots=4)
CFG, JCFG = LogConfig(**GEO), JCfg(**GEO)
R = 3
COLS = CFG.slot_words + tlog.META_W


def _rand_ring(rng):
    return rng.integers(-50, 50, (R, CFG.n_slots, COLS)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_constants_match():
    assert [int(e) for e in tlog.EntryType] == [int(e) for e in jlog.EntryType]
    assert [e.name for e in tlog.EntryType] == [e.name for e in jlog.EntryType]
    for k in ("M_TYPE", "M_TERM", "M_CONN", "M_REQID", "M_LEN", "M_GIDX",
              "M_GEN", "META_W"):
        assert getattr(tlog, k) == getattr(jlog, k), k


@pytest.mark.parametrize("seed", range(4))
def test_append_batch_random(seed):
    """Ends near the capacity clamp and across the ring wrap."""
    rng = np.random.default_rng(seed)
    for _ in range(6):
        buf = _rand_ring(rng)
        head = rng.integers(0, 40, R).astype(np.int32)
        end = head + rng.integers(0, CFG.n_slots, R).astype(np.int32)
        B = CFG.batch_slots
        data = rng.integers(-9, 9, (R, B, CFG.slot_words)).astype(np.int32)
        meta = rng.integers(-9, 9, (R, B, tlog.META_W)).astype(np.int32)
        count = rng.integers(-1, B + 2, R).astype(np.int32)
        term = rng.integers(0, 9, R).astype(np.int32)
        tl, tend = tlog.append_batch(tlog.Log(_t(buf.copy())), _t(end),
                                     _t(head), _t(data), _t(meta),
                                     _t(count), _t(term))
        for r in range(R):
            jl, jend = jlog.append_batch(
                jlog.Log(jnp.asarray(buf[r])), jnp.int32(end[r]),
                jnp.int32(head[r]), jnp.asarray(data[r]),
                jnp.asarray(meta[r]), jnp.int32(count[r]),
                jnp.int32(term[r]))
            assert int(jend) == int(tend[r])
            np.testing.assert_array_equal(np.asarray(jl.buf),
                                          tl.buf[r].numpy())


@pytest.mark.parametrize("seed", range(3))
def test_extract_window_and_last_term(seed):
    rng = np.random.default_rng(seed)
    buf = _rand_ring(rng)
    start = rng.integers(-3, 60, R).astype(np.int32)
    end = rng.integers(-1, 60, R).astype(np.int32)
    log = tlog.Log(_t(buf))
    wd, wm = tlog.extract_window(log, _t(start), CFG.window_slots)
    lt = tlog.last_term(log, _t(end))
    for r in range(R):
        jl = jlog.Log(jnp.asarray(buf[r]))
        jd, jm = jlog.extract_window(jl, jnp.int32(start[r]),
                                     CFG.window_slots)
        np.testing.assert_array_equal(np.asarray(jd), wd[r].numpy())
        np.testing.assert_array_equal(np.asarray(jm), wm[r].numpy())
        assert int(jlog.last_term(jl, jnp.int32(end[r]))) == int(lt[r])


@pytest.mark.parametrize("seed", range(4))
def test_absorb_window_random(seed):
    """Random overlaps: gap (wstart > my_end), conflicting terms in the
    overlap (truncation), shorter windows that must not truncate."""
    rng = np.random.default_rng(seed)
    W = CFG.window_slots
    for _ in range(6):
        buf = _rand_ring(rng)
        buf[..., CFG.slot_words + tlog.M_TERM] = rng.integers(0, 3, (
            R, CFG.n_slots))
        my_end = rng.integers(0, 40, R).astype(np.int32)
        wstart = my_end + rng.integers(-10, 3, R).astype(np.int32)
        wcount = rng.integers(0, W + 1, R).astype(np.int32)
        wdata = rng.integers(-9, 9, (R, W, CFG.slot_words)).astype(np.int32)
        wmeta = rng.integers(-9, 9, (R, W, tlog.META_W)).astype(np.int32)
        wmeta[..., tlog.M_TERM] = rng.integers(0, 3, (R, W))
        tl, tend = tlog.absorb_window(
            tlog.Log(_t(buf.copy())), _t(my_end), _t(wdata), _t(wmeta),
            _t(wstart), _t(wcount))
        for r in range(R):
            jl, jend = jlog.absorb_window(
                jlog.Log(jnp.asarray(buf[r])), jnp.int32(my_end[r]),
                jnp.asarray(wdata[r]), jnp.asarray(wmeta[r]),
                jnp.int32(wstart[r]), jnp.int32(wcount[r]))
            assert int(jend) == int(tend[r]), (r, my_end[r], wstart[r])
            np.testing.assert_array_equal(np.asarray(jl.buf),
                                          tl.buf[r].numpy())


def test_capacity_clamp_and_wrap_sequence():
    """The tests/test_log.py clamp scenario on both packages: 20 entries
    pushed into a 16-slot ring stop at n_slots-1; a pruned head frees
    room; a later window read crosses the wrap."""
    B = CFG.batch_slots
    tl = tlog.Log(torch.zeros((1, CFG.n_slots, COLS), dtype=torch.int32))
    jl = jlog.make_log(JCFG)
    tend, jend = torch.zeros(1, dtype=torch.int32), jnp.int32(0)
    for k in range(6):
        head = 0 if k < 5 else 4
        data = np.zeros((B, CFG.slot_words), np.int32)
        data[:, 0] = np.arange(B) + 4 * k
        meta = np.zeros((B, tlog.META_W), np.int32)
        meta[:, tlog.M_TYPE] = int(tlog.EntryType.SEND)
        tl, tend = tlog.append_batch(
            tl, tend, torch.tensor([head], dtype=torch.int32),
            _t(data[None]), _t(meta[None]),
            torch.tensor([B], dtype=torch.int32),
            torch.tensor([1], dtype=torch.int32))
        jl, jend = jlog.append_batch(jl, jend, jnp.int32(head),
                                     jnp.asarray(data), jnp.asarray(meta),
                                     jnp.int32(B), jnp.int32(1))
        assert int(jend) == int(tend[0])
    assert int(tend[0]) == 19
    np.testing.assert_array_equal(np.asarray(jl.buf), tl.buf[0].numpy())
    wd, _ = tlog.extract_window(tl, torch.tensor([12], dtype=torch.int32), 6)
    jd, _ = jlog.extract_window(jl, jnp.int32(12), 6)
    np.testing.assert_array_equal(np.asarray(jd), wd[0].numpy())
