"""Port parity: ``replica_step`` over the stacked replica axis against the
JAX package's ``build_sim_step`` on seeded multi-step schedules —
elections (full and stable programs), partitions and asymmetric links
via ``peer_mask``, CONFIG entries, a wedged apply that forces pruning,
both fan-outs. Every StepOutput field and the whole post-state are
compared after every step, with exact equality. ``group_step`` over
``[G, R, ...]`` tensors against the JAX ``group_step`` under its
``vmap``, with its variants off and on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdma_paxos_tpu.config import LogConfig as JCfg
from rdma_paxos_tpu.consensus.step import StepInput as JInput
from rdma_paxos_tpu.consensus.step import group_step as j_group_step
from rdma_paxos_tpu.parallel.mesh import (
    build_sim_step as j_build_step, stack_group_states as j_stack_groups,
    stack_states as j_stack)
from rdma_paxos_tpu_torch.config import LogConfig
from rdma_paxos_tpu_torch.consensus.log import EntryType, M_LEN, M_TYPE, META_W
from rdma_paxos_tpu_torch.consensus.state import ConfigState, clone_state
from rdma_paxos_tpu_torch.consensus.step import (
    I32_MIN, OUTPUT_FIELDS, VARIANT_FIELDS, StepInput, group_step,
    make_step_input, replica_step)
from rdma_paxos_tpu_torch.convert import replica_state_to_numpy
from rdma_paxos_tpu_torch.consensus import step as step_mod
from rdma_paxos_tpu_torch.parallel.mesh import (
    build_sim_group_burst, build_sim_group_step, build_sim_step,
    stack_group_states, stack_states)

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

GEO = dict(n_slots=64, slot_bytes=32, window_slots=16, batch_slots=8)
CFG, JCFG = LogConfig(**GEO), JCfg(**GEO)
INPUT_FIELDS = ("batch_data", "batch_meta", "batch_count",
                "timeout_fired", "peer_mask", "apply_done", "queue_depth")


def random_input(rng, R, fanout, commit, applied, wedged, epoch):
    """One step's host inputs: client batches (a few CONFIG entries),
    timeouts, links, the host apply echo."""
    B, sw = CFG.batch_slots, CFG.slot_words
    data = rng.integers(-99, 99, (R, B, sw)).astype(np.int32)
    meta = np.zeros((R, B, META_W), np.int32)
    meta[..., M_TYPE] = int(EntryType.SEND)
    meta[..., M_LEN] = rng.integers(0, CFG.slot_bytes + 1, (R, B))
    meta[..., 2:4] = rng.integers(0, 9, (R, B, 2))
    full = (1 << R) - 1
    for r, b in zip(*np.nonzero(rng.random((R, B)) < 0.04)):
        meta[r, b, M_TYPE] = int(EntryType.CONFIG)
        epoch[0] += 1
        cid = int(rng.choice([ConfigState.STABLE, ConfigState.TRANSIT,
                              ConfigState.EXTENDED]))
        new = full if rng.random() < 0.6 else full & ~(1 << int(
            rng.integers(R)))
        data[r, b, :4] = [full, new, cid, epoch[0]]
    peer = np.ones((R, R), np.int32)
    if fanout == "gather":
        u = rng.random()
        if u < 0.25:
            cut = int(rng.integers(1, R))
            perm = rng.permutation(R)
            for grp in (perm[:cut], perm[cut:]):
                for i in grp:
                    peer[i] = 0
                    peer[i, grp] = 1
        elif u < 0.35:
            peer = (rng.random((R, R)) < 0.7).astype(np.int32)
            np.fill_diagonal(peer, 1)
    for r in range(R):
        if r not in wedged:
            applied[r] = max(applied[r], commit[r] - rng.integers(0, 3))
    return dict(
        batch_data=data, batch_meta=meta,
        batch_count=rng.integers(0, B + 2, R).astype(np.int32),
        timeout_fired=(rng.random(R) < 0.12).astype(np.int32),
        peer_mask=peer, apply_done=applied.astype(np.int32),
        queue_depth=rng.integers(0, 50, R).astype(np.int32))


def assert_same(jst, jout, tst, tout, tag):
    for k in OUTPUT_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(jout, k)), getattr(tout, k).numpy(),
            err_msg=f"{tag}: output {k}")
    js, ts = replica_state_to_numpy(jst), replica_state_to_numpy(tst)
    for k in js:
        np.testing.assert_array_equal(js[k], ts[k],
                                      err_msg=f"{tag}: state {k}")


@pytest.mark.parametrize("R,fanout,seed", [
    (3, "gather", 0), (5, "gather", 1), (3, "psum", 2), (3, "gather", 3)])
def test_step_schedule_matches_jax(R, fanout, seed):
    rng = np.random.default_rng(seed)
    jsteps = {e: j_build_step(JCFG, R, fanout=fanout, elections=e)
              for e in (True, False)}
    tsteps = {e: build_sim_step(CFG, R, fanout=fanout, elections=e)
              for e in (True, False)}
    jst = j_stack(JCFG, R, R)
    tst = stack_states(CFG, R, R, device="cpu")
    commit = np.zeros(R, np.int64)
    applied = np.zeros(R, np.int64)
    wedged = {R - 1} if seed == 3 else set()
    epoch = [0]
    forced = 0
    for step in range(48):
        inp = random_input(rng, R, fanout, commit, applied, wedged, epoch)
        if step == 0:
            inp["timeout_fired"][:] = 0
            inp["timeout_fired"][0] = 1
        # stable program when no timer fired (as the engine does), and
        # sometimes the full program anyway: both must match JAX
        elections = bool(inp["timeout_fired"].any()) or rng.random() < 0.3
        jin = JInput(**{k: jnp.asarray(inp[k]) for k in INPUT_FIELDS})
        tin = StepInput(**{k: torch.from_numpy(inp[k])
                           for k in INPUT_FIELDS})
        jst, jout = jsteps[elections](jst, jin)
        tst, tout = tsteps[elections](tst, tin)
        assert_same(jst, jout, tst, tout, f"step {step} el={elections}")
        commit = tout.commit.numpy().astype(np.int64)
        head = tout.head.numpy()
        forced += int(any(head[r] > applied[r] for r in wedged))
    assert commit.max() >= 2 * CFG.window_slots, "schedule never committed"
    if wedged:
        assert forced, "the wedged replica was never pruned past"


def test_stable_equals_full_without_timeouts():
    """Within the port: with no timer fired, the stable step and the
    full step give identical results."""
    R = 3
    rng = np.random.default_rng(11)
    a = stack_states(CFG, R, R, device="cpu")
    inp = make_step_input(CFG, R, device="cpu")
    inp.timeout_fired[0] = 1
    a, _ = replica_step(a, inp, cfg=CFG, n_replicas=R)       # elect 0
    for _ in range(6):
        inp = random_input(rng, R, "gather", np.zeros(R, np.int64),
                           np.zeros(R, np.int64), set(), [0])
        inp["timeout_fired"][:] = 0
        b = clone_state(a)
        tin = StepInput(**{k: torch.from_numpy(inp[k])
                           for k in INPUT_FIELDS})
        a, oa = replica_step(a, tin, cfg=CFG, n_replicas=R, elections=True)
        b, ob = replica_step(b, tin, cfg=CFG, n_replicas=R,
                             elections=False)
        for k in OUTPUT_FIELDS:
            assert torch.equal(getattr(oa, k), getattr(ob, k)), k
        sa, sb = replica_state_to_numpy(a), replica_state_to_numpy(b)
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def test_unported_flags_raise():
    """No step flag is refused any more: the audit=, telemetry= and txn=
    variants add their fields (None when off) and change no other
    output. Their parity with JAX is in tests/test_torch_audit.py,
    tests/test_torch_telemetry.py and tests/test_torch_txn.py."""
    R = 3
    st = stack_states(CFG, R, R, device="cpu")
    inp = make_step_input(CFG, R, device="cpu")
    _, off = replica_step(clone_state(st), inp, cfg=CFG, n_replicas=R)
    _, on = replica_step(clone_state(st), inp, cfg=CFG, n_replicas=R,
                         audit=True, telemetry=True, txn=True)
    for k in VARIANT_FIELDS:
        assert getattr(off, k) is None and getattr(on, k) is not None, k
    for k in OUTPUT_FIELDS:
        assert torch.equal(getattr(off, k), getattr(on, k)), k
    assert on.audit_digest.shape == (R, CFG.window_slots)
    assert on.telemetry.shape == (R, 8)
    assert on.txn_vote.tolist() == [0] * R         # no watch: TXN_NONE


# ---------------------------------------------------------------------------
# group_step: G groups of R replicas, [G, R, ...]
# ---------------------------------------------------------------------------

def _as_u32(x) -> np.ndarray:
    """A u32 output (digests, counters) of either package as u32."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def group_input(rng, G, R, commit, applied, epochs, txn, term):
    """Each group's :func:`random_input`, stacked ``[G, R, ...]``; with
    ``txn`` a watch per group (at, below or past its commit, sometimes
    none) under the group's newest term ``term [G]`` or a wrong one,
    repeated over its replicas."""
    per = [random_input(rng, R, "gather", commit[g], applied[g], set(),
                        epochs[g]) for g in range(G)]
    inp = {k: np.stack([p[k] for p in per]) for k in INPUT_FIELDS}
    if txn:
        watch = np.where(rng.random(G) < 0.2, -1,
                         commit.max(1) + rng.integers(-4, 3, G))
        inp["txn_watch"] = np.repeat(watch[:, None], R, 1).astype(np.int32)
        wrong = rng.random(G) < 0.4
        inp["txn_term"] = np.repeat(
            np.where(wrong, term + 1, term)[:, None], R, 1).astype(np.int32)
    return inp


@pytest.mark.parametrize("G", [2, 3])
@pytest.mark.parametrize("variants", [False, True])
def test_group_step_matches_jax(G, variants, monkeypatch):
    """``group_step`` against the JAX ``group_step`` (both vmaps, jitted)
    on the same numpy-made state and inputs: the full and the stable
    program, with ``audit``, ``telemetry`` and ``txn`` all off or all
    on; every output and the whole ``[G, R, ...]`` state equal after
    every step, and one ``commit_window`` call per step over N = G·R."""
    R = 3
    flags = dict(audit=variants, telemetry=variants, txn=variants)
    rng = np.random.default_rng(20 + G + 10 * variants)
    jsteps = {e: jax.jit(j_group_step(cfg=JCFG, n_replicas=R,
                                      elections=e, **flags))
              for e in (True, False)}
    tsteps = {e: group_step(cfg=CFG, n_replicas=R, elections=e, **flags)
              for e in (True, False)}
    jst = j_stack_groups(JCFG, G, R, R)
    tst = stack_group_states(CFG, G, R, R, device="cpu")
    commit = np.zeros((G, R), np.int64)
    applied = np.zeros((G, R), np.int64)
    epochs = [[0] for _ in range(G)]
    names = INPUT_FIELDS + (("txn_watch", "txn_term") if variants else ())
    calls, votes = [], set()
    window = step_mod.commit_window

    def counted(*args, **kw):
        calls.append(args[0].shape[0])              # N instances
        return window(*args, **kw)
    monkeypatch.setattr(step_mod, "commit_window", counted)
    term = np.zeros(G, np.int64)
    for step in range(20):
        inp = group_input(rng, G, R, commit, applied, epochs, variants,
                          term)
        if step == 0:
            inp["timeout_fired"][:] = 0
            inp["timeout_fired"][:, step % R] = 1
        elections = bool(inp["timeout_fired"].any()) or rng.random() < 0.3
        jin = JInput(**{k: jnp.asarray(inp[k]) for k in names})
        tin = StepInput(**{k: torch.from_numpy(inp[k]) for k in names})
        jst, jout = jsteps[elections](jst, jin)
        tst, tout = tsteps[elections](tst, tin)
        tag = f"G={G} step {step} el={elections}"
        assert_same(jst, jout, tst, tout, tag)
        for k in VARIANT_FIELDS:
            jv, tv = getattr(jout, k), getattr(tout, k)
            assert (jv is None) == (tv is None) == (not variants), (tag, k)
            if tv is not None:
                same = (_as_u32(tv), _as_u32(jv)) if k in (
                    "audit_digest", "telemetry") else (tv.numpy(),
                                                       np.asarray(jv))
                np.testing.assert_array_equal(*same, err_msg=f"{tag}: {k}")
        assert tout.term.shape == (G, R)
        if variants:
            votes |= set(tout.txn_vote.flatten().tolist())
        commit = tout.commit.numpy().astype(np.int64)
        term = tout.term.numpy().max(1)
    assert calls == [G * R] * 20
    assert commit.max() >= 2 * CFG.window_slots, "schedule never committed"
    if variants:                 # NONE, PENDING, PREPARED and CONFLICT
        assert votes == {0, 1, 2, 3}, votes


def test_group_builders_run_group_step():
    """``build_sim_group_step`` is ``group_step`` (equal results on one
    stacked state), its burst repeats the stable ``group_step``, and a
    state without its group axis is refused."""
    R, G = 3, 2
    rng = np.random.default_rng(5)
    a = stack_group_states(CFG, G, R, R, device="cpu")
    inp = make_step_input(CFG, R, device="cpu")
    tin = StepInput(**{k: getattr(inp, k).expand(
        (G,) + tuple(getattr(inp, k).shape)).clone() for k in INPUT_FIELDS})
    tin.timeout_fired[:, 0] = 1
    b = clone_state(a)
    a, oa = group_step(cfg=CFG, n_replicas=R)(a, tin)
    b, ob = build_sim_group_step(CFG, R)(b, tin)
    for k in OUTPUT_FIELDS:
        assert torch.equal(getattr(oa, k), getattr(ob, k)), k
    assert oa.role.tolist() == [[3, 1, 1]] * G      # 0 leads each group
    K = 2
    datas = torch.from_numpy(rng.integers(
        -9, 9, (K, G, R, CFG.batch_slots, CFG.slot_words)).astype(np.int32))
    metas = torch.zeros((K, G, R, CFG.batch_slots, META_W), dtype=torch.int32)
    metas[..., M_TYPE] = int(EntryType.SEND)
    counts = torch.zeros((K, G, R), dtype=torch.int32)
    counts[:, :, 0] = CFG.batch_slots
    zeros = torch.zeros((G, R), dtype=torch.int32)
    c = clone_state(a)
    a, outs = build_sim_group_burst(CFG, R)(
        a, datas, metas, counts, tin.peer_mask, zeros, zeros)
    stable = group_step(cfg=CFG, n_replicas=R, elections=False)
    for k in range(K):
        c, ok = stable(c, StepInput(
            batch_data=datas[k], batch_meta=metas[k], batch_count=counts[k],
            timeout_fired=zeros, peer_mask=tin.peer_mask, apply_done=zeros,
            queue_depth=zeros))
        for f in OUTPUT_FIELDS:
            assert torch.equal(getattr(outs, f)[k], getattr(ok, f)), (k, f)
    sa, sc = replica_state_to_numpy(a), replica_state_to_numpy(c)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sc[k], err_msg=k)
    with pytest.raises(ValueError, match="group_step takes"):
        group_step(cfg=CFG, n_replicas=R)(
            stack_states(CFG, R, R, device="cpu"),
            make_step_input(CFG, R, device="cpu"))
    with pytest.raises(ValueError, match="fanout"):
        group_step(cfg=CFG, n_replicas=R, fanout="ring")
    assert I32_MIN == int(np.iinfo(np.int32).min)
