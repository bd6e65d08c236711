"""Port parity: the fused K-step burst and the K-window scan tier are K
serial stable steps in the port, and each equals the JAX package's
``build_sim_burst``/``build_sim_scan``; at engine level the port's scan
tier gives the burst path's results and the JAX engine's. Exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdma_paxos_tpu.config import LogConfig as JCfg
from rdma_paxos_tpu.consensus.step import StepInput as JInput
from rdma_paxos_tpu.parallel.mesh import (
    build_sim_burst as j_burst, build_sim_scan as j_scan,
    build_sim_step as j_step, stack_states as j_stack)
from rdma_paxos_tpu.runtime.sim import SimCluster as JSim
from rdma_paxos_tpu_torch.config import LogConfig
from rdma_paxos_tpu_torch.consensus.log import EntryType, M_LEN, M_TYPE, META_W
from rdma_paxos_tpu_torch.consensus.log import extract_window
from rdma_paxos_tpu_torch.consensus.state import clone_state
from rdma_paxos_tpu_torch.consensus.step import (
    OUTPUT_FIELDS, SCAN_KEYS, StepInput, make_step_input, scan_scalars)
from rdma_paxos_tpu_torch.convert import replica_state_to_numpy
from rdma_paxos_tpu_torch.parallel.mesh import (
    build_sim_burst, build_sim_scan, build_sim_step, stack_states)
from rdma_paxos_tpu_torch.runtime.sim import SimCluster
from tests.test_torch_sim import jax_step_cache_restored  # noqa: F401

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

GEO = dict(n_slots=64, slot_bytes=32, window_slots=16, batch_slots=8)
CFG, JCFG = LogConfig(**GEO), JCfg(**GEO)
R, K, REPLAY = 3, 4, 24


def _same_state(a, b, tag=""):
    sa, sb = replica_state_to_numpy(a), replica_state_to_numpy(b)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=f"{tag} {k}")


def _burst_inputs(rng, fanout):
    B, sw = CFG.batch_slots, CFG.slot_words
    datas = rng.integers(-99, 99, (K, R, B, sw)).astype(np.int32)
    metas = np.zeros((K, R, B, META_W), np.int32)
    metas[..., M_TYPE] = int(EntryType.SEND)
    metas[..., M_LEN] = rng.integers(0, 33, (K, R, B))
    counts = rng.integers(0, B + 1, (K, R)).astype(np.int32)
    peer = np.ones((R, R), np.int32)
    if fanout == "gather" and rng.random() < 0.5:
        peer[2, :2] = peer[:2, 2] = 0
    return dict(datas=datas, metas=metas, counts=counts, peer=peer,
                applied=rng.integers(0, 6, R).astype(np.int32),
                qdepth=rng.integers(0, 9, R).astype(np.int32))


@pytest.mark.parametrize("fanout", ["gather", "psum"])
def test_burst_scan_serial_and_jax(fanout):
    rng = np.random.default_rng(5 if fanout == "gather" else 6)
    # warm both engines to a led cluster with entries in the log
    tst = stack_states(CFG, R, R, device="cpu")
    jst = j_stack(JCFG, R, R)
    tstep = build_sim_step(CFG, R, fanout=fanout)
    jstep = j_step(JCFG, R, fanout=fanout)
    for i in range(3):
        inp = make_step_input(CFG, R, device="cpu")
        inp.timeout_fired[0] = int(i == 0)
        inp.batch_count[:] = 5
        inp.batch_meta[..., M_TYPE] = int(EntryType.SEND)
        jin = JInput(**{k: jnp.asarray(getattr(inp, k).numpy())
                        for k in inp.__dataclass_fields__
                        if getattr(inp, k) is not None})
        tst, _ = tstep(tst, inp)
        jst, _ = jstep(jst, jin)
    _same_state(jst, tst, "warm")

    for round_ in range(3):
        x = _burst_inputs(rng, fanout)
        args_t = [torch.from_numpy(x[k]) for k in
                  ("datas", "metas", "counts", "peer", "applied", "qdepth")]
        args_j = [jnp.asarray(x[k]) for k in
                  ("datas", "metas", "counts", "peer", "applied", "qdepth")]
        # port: K serial stable steps
        s_serial = clone_state(tst)
        serial = []
        acc = torch.zeros(R, dtype=torch.int32)
        sstep = build_sim_step(CFG, R, fanout=fanout, elections=False)
        for k in range(K):
            s_serial, out = sstep(s_serial, StepInput(
                batch_data=args_t[0][k], batch_meta=args_t[1][k],
                batch_count=args_t[2][k],
                timeout_fired=torch.zeros(R, dtype=torch.int32),
                peer_mask=args_t[3], apply_done=args_t[4],
                queue_depth=args_t[5]))
            acc = acc + out.accepted
            serial.append((out, scan_scalars(out, acc)))
        # port: burst and scan
        s_burst, bouts = build_sim_burst(CFG, R, fanout=fanout)(
            clone_state(tst), *args_t)
        tst, ys = build_sim_scan(CFG, R, replay_slots=REPLAY,
                                 fanout=fanout)(tst, *args_t)
        _same_state(s_serial, s_burst, "burst")
        _same_state(s_serial, tst, "scan")
        for k, (out, scal) in enumerate(serial):
            for f in OUTPUT_FIELDS:
                assert torch.equal(getattr(bouts, f)[k], getattr(out, f)), f
            assert torch.equal(ys["scal"][k], scal)
            assert torch.equal(ys["peer_acked"][k], out.peer_acked)
        rd, rm = extract_window(tst.log, args_t[4], REPLAY)
        assert torch.equal(ys["replay_data"], rd)
        assert torch.equal(ys["replay_meta"], rm)
        # JAX: burst and scan from the same pre-state
        jst_b, jbouts = j_burst(JCFG, R, fanout=fanout, donate=False)(
            jst, *args_j)
        jst, jys = j_scan(JCFG, R, replay_slots=REPLAY, fanout=fanout)(
            jst, *args_j)
        _same_state(jst_b, tst, f"jax burst {round_}")
        _same_state(jst, tst, f"jax scan {round_}")
        for f in OUTPUT_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(jbouts, f)),
                                          getattr(bouts, f).numpy(), f)
        for f in ("scal", "peer_acked", "replay_data", "replay_meta"):
            np.testing.assert_array_equal(np.asarray(jys[f]),
                                          ys[f].numpy(), f)
    assert list(SCAN_KEYS)[12] == "accepted"


def _drive_engine(c):
    """The tests/test_scan.py workload: bursts of 20 entries, then
    serial steps."""
    c.collect_frames = True
    c.run_until_elected(0)
    outs = []
    for i in range(10):
        for j in range(20):
            c.submit(0, b"p%d-%d" % (i, j))
        outs.append(c.step_burst())
    for _ in range(4):
        outs.append(c.step())
    return outs


def test_engine_scan_equals_burst_and_jax():
    geo = dict(n_slots=128, slot_bytes=64, window_slots=32, batch_slots=8)
    runs = {}
    for name, c in (("t_burst", SimCluster(LogConfig(**geo), 3,
                                           device="cpu")),
                    ("t_scan", SimCluster(LogConfig(**geo), 3, scan=True,
                                          device="cpu")),
                    ("j_scan", JSim(JCfg(**geo), 3, scan=True))):
        runs[name] = (c, _drive_engine(c))
    assert runs["t_scan"][0].scan_dispatches == 10
    base_c, base_o = runs["t_burst"]
    for name in ("t_scan", "j_scan"):
        c, outs = runs[name]
        for a, b in zip(base_o, outs):
            for k in SimCluster.RES_KEYS:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for r in range(3):
            assert list(c.replayed[r]) == list(base_c.replayed[r])
            assert list(c.frames[r]) == list(base_c.frames[r])
        np.testing.assert_array_equal(c.applied, base_c.applied)
        _same_state(c.state, base_c.state, name)


def test_mesh_scan_bit_identical_to_burst_and_jax():
    """The twin of tests/test_scan.py's sharded scan ≡ burst on a 2×2
    mesh: the port's mesh engine with the scan tier equals its burst
    tier and the JAX mesh engine's scan, step for step, with the same
    streams, frames and apply cursors."""
    from rdma_paxos_tpu.shard.cluster import ShardedCluster as JSharded
    from rdma_paxos_tpu_torch.shard import ShardedCluster
    geo = dict(n_slots=128, slot_bytes=64, window_slots=32, batch_slots=8)

    def drive(c):
        c.collect_frames = True
        c.place_leaders()
        outs = []
        for i in range(8):
            for g in range(2):
                lead = c.leader_hint(g)
                for j in range(12):
                    c.submit(g, lead, b"g%d-%d-%d" % (g, i, j))
            outs.append(c.step_burst())
        for _ in range(4):
            outs.append(c.step())
        return outs

    made = [ShardedCluster(LogConfig(**geo), 2, 2, scan=s, mesh=(2, 2),
                           device=["cpu"] * 4) for s in (False, True)]
    try:
        jc = JSharded(JCfg(**geo), 2, 2, scan=True, mesh=(2, 2))
        ob, os_, oj = drive(made[0]), drive(made[1]), drive(jc)
        assert made[1].scan_dispatches == jc.scan_dispatches > 0
        for k, (a, b, c) in enumerate(zip(ob, os_, oj)):
            for key in SimCluster.RES_KEYS:
                assert np.array_equal(a[key], b[key]), (k, key)
                assert np.array_equal(np.asarray(c[key]), b[key]), (k, key)
        for g in range(2):
            for r in range(2):
                assert (made[0].replayed[g][r] == made[1].replayed[g][r]
                        == jc.replayed[g][r]), (g, r)
                assert (list(made[0].frames[g][r])
                        == list(made[1].frames[g][r])
                        == list(jc.frames[g][r])), (g, r)
        assert np.array_equal(made[1].applied, np.asarray(jc.applied))
    finally:
        for c in made:
            c.close()
