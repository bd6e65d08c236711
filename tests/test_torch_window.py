"""Port parity: the commit window (the replica step's phase F plus phase
G's commit-crossing CONFIG search) against an oracle built from the JAX
package — ``commit_scan_pallas`` in interpret mode per instance, then the
JAX step's ``crossed`` / ``_lex_argmax`` expressions over the same numpy
ring. Exact equality (integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdma_paxos_tpu.consensus.log import (
    EntryType as JEntryType, M_GIDX as J_GIDX, M_TERM as J_TERM,
    M_TYPE as J_TYPE, slot_of as j_slot_of)
from rdma_paxos_tpu.consensus.step import _lex_argmax as j_lex_argmax
from rdma_paxos_tpu.ops.quorum import commit_scan_pallas
from rdma_paxos_tpu_torch.consensus.log import (
    EntryType, M_GIDX, M_TERM, M_TYPE, META_W)
from rdma_paxos_tpu_torch.consensus.state import clone_state
from rdma_paxos_tpu_torch.consensus.step import make_step_input, replica_step
from rdma_paxos_tpu_torch.ops import quorum
from rdma_paxos_tpu_torch.ops.quorum import (
    R_PAD, commit_window, commit_window_ref)

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

SW = 8                  # payload words of a ring row
N_SLOTS, W = 64, 32
CONFIG = int(EntryType.CONFIG)
assert CONFIG == int(JEntryType.CONFIG)
assert (M_TYPE, M_TERM, M_GIDX) == (J_TYPE, J_TERM, J_GIDX)


def wrap(a):
    """int64 values -> the i32 values they wrap to."""
    return ((np.asarray(a, np.int64) + (1 << 31)) % (1 << 32)) - (1 << 31)


def make_case(rng, *, G=4, R=3, commit=None, lead_p=0.6, cfg_p=0.15,
              transit_p=0.3, bit31=False):
    """N = G * R seeded instances over a random ring whose window rows
    carry terms near ``my_term``, CONFIG rows (most stamped with their
    own index, some not) and acks near the window."""
    N = G * R
    buf = rng.integers(-50, 50, (N, N_SLOTS, SW + META_W)).astype(np.int64)
    commit = (rng.integers(0, 3 * N_SLOTS, N) if commit is None
              else np.full(N, commit, np.int64))
    my_term = rng.integers(1, 4, N)
    g = wrap(commit[:, None] + np.arange(W))                    # [N, W]
    meta = buf[..., SW:]
    for n in range(N):
        s = g[n] & (N_SLOTS - 1)
        meta[n, s, M_TERM] = my_term[n] + rng.integers(-1, 2, W)
        meta[n, s, M_TYPE] = np.where(rng.random(W) < cfg_p, CONFIG,
                                      int(EntryType.SEND))
        meta[n, s, M_GIDX] = wrap(np.where(
            rng.random(W) < 0.8, g[n], g[n] + N_SLOTS * rng.integers(1, 4, W)))
    full = (1 << R) - 1
    bm_old = full & rng.integers(0, 1 << R, N) | (rng.random(N) < 0.5) * full
    bm_new = full & rng.integers(0, 1 << R, N) | (rng.random(N) < 0.5) * full
    if bit31:
        bm_new |= (rng.random(N) < 0.7).astype(np.int64) << 31
        bm_old |= (rng.random(N) < 0.3).astype(np.int64) << 31

    def maj(bm):
        return np.array([bin(int(b)).count("1") // 2 + 1 for b in bm])
    return dict(
        buf=buf, peer_acked=rng.random((N, R)) < 0.8,
        my_ack=wrap(commit + rng.integers(-3, W + 4, N)),
        commit=commit, my_term=my_term,
        my_end=wrap(commit + rng.integers(0, W + 6, N)),
        bm_old=bm_old, bm_new=bm_new,
        transit=(rng.random(N) < transit_p).astype(np.int64),
        maj_old=maj(bm_old), maj_new=maj(bm_new),
        i_lead=rng.random(N) < lead_p,
        commit1=wrap(commit + rng.integers(0, W, N)))


def oracle(c):
    """Per instance: the JAX package's phase-F/G window code."""
    N, R = c["peer_acked"].shape
    out = []
    for n in range(N):
        grp = n // R * R
        acks = np.zeros(R_PAD, np.int64)
        acks[:R] = np.where(c["peer_acked"][n], c["my_ack"][grp:grp + R], 0)
        meta = jnp.asarray(c["buf"][n, :, SW:], jnp.int32)
        commit = jnp.int32(c["commit"][n])
        cwin_g = commit + jnp.arange(W, dtype=jnp.int32)
        cwin_meta = meta[j_slot_of(cwin_g, N_SLOTS)]
        scanned = commit_scan_pallas(
            jnp.asarray(acks, jnp.int32), commit, jnp.int32(c["my_term"][n]),
            jnp.int32(c["my_end"][n]), cwin_meta[:, J_TERM],
            jnp.uint32(c["bm_old"][n]), jnp.uint32(c["bm_new"][n]),
            jnp.int32(c["transit"][n]), jnp.int32(c["maj_old"][n]),
            jnp.int32(c["maj_new"][n]), interpret=True)
        commit2 = jnp.where(bool(c["i_lead"][n]),
                            jnp.maximum(commit, scanned),
                            jnp.int32(c["commit1"][n]))
        crossed = ((cwin_meta[:, J_TYPE] == CONFIG)
                   & (cwin_meta[:, J_GIDX] == cwin_g) & (cwin_g < commit2))
        out.append((int(commit2), int(j_lex_argmax(crossed, [cwin_g]))))
    return np.array(out, np.int64).T


def port_args(c):
    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(wrap(a)).astype(np.int32))
    kw = {k: i32(c[k]) for k in ("commit", "my_term", "my_end", "transit",
                                  "maj_old", "maj_new", "commit1")}
    kw.update(bm_old=torch.from_numpy(c["bm_old"].astype(np.int64)),
              bm_new=torch.from_numpy(c["bm_new"].astype(np.int64)),
              i_lead=torch.from_numpy(c["i_lead"]))
    return (i32(c["buf"]), torch.from_numpy(c["peer_acked"]),
            i32(c["my_ack"])), kw


CASES = {
    "random": dict(),
    "ring_wrap": dict(commit=2 * N_SLOTS - 7),      # slots wrap mid-window
    "i32_wrap": dict(commit=(1 << 31) - 9),          # commit + j crosses 2^31
    "transit": dict(transit_p=1.0),
    "bit31": dict(bit31=True),
    "no_leader": dict(lead_p=0.0),
    "no_config": dict(cfg_p=0.0),                    # xpos = -1 throughout
    "all_config": dict(cfg_p=1.0),
    "five_replicas": dict(G=2, R=5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_ref_matches_jax_oracle(name):
    c = make_case(np.random.default_rng(sorted(CASES).index(name)),
                  **CASES[name])
    want_commit2, want_xpos = oracle(c)
    (buf, pa, ack), kw = port_args(c)
    for fn in (commit_window_ref, commit_window):
        commit2, xpos = fn(buf, pa, ack, w=W, **kw)
        assert commit2.dtype == xpos.dtype == torch.int32
        np.testing.assert_array_equal(commit2.numpy(), want_commit2)
        np.testing.assert_array_equal(xpos.numpy(), want_xpos)
    if name == "no_config":
        assert (want_xpos == -1).all()
    if name == "no_leader":
        np.testing.assert_array_equal(want_commit2, wrap(c["commit1"]))
    if name in ("random", "all_config", "i32_wrap"):
        assert (want_xpos >= 0).any() and (want_xpos == -1).any()
    if name not in ("no_leader", "i32_wrap"):
        assert (want_commit2 > c["commit"])[c["i_lead"]].any(), \
            "no leader instance committed anything"


@pytest.mark.parametrize("groups", [range(0, 1), range(1, 3),
                                    range(0, 4)])
def test_window_rows_layout_matches_jax_oracle(groups):
    """A device-list entry's call: replica r of several groups, one
    instance per group, each reading its own group's R acks as a row
    (``my_ack [N * R]``); equal to the JAX oracle's instances."""
    c = make_case(np.random.default_rng(7))
    want = oracle(c)
    (buf, pa, ack), kw = port_args(c)
    acks = ack.view(-1, 3)[groups.start:groups.stop].reshape(-1)
    for r in range(3):
        idx = torch.tensor([g * 3 + r for g in groups])
        args = (buf[idx].contiguous(), pa[idx].contiguous(), acks)
        k = {n: v[idx].contiguous() for n, v in kw.items()}
        for fn in (commit_window_ref, commit_window):
            commit2, xpos = fn(*args, w=W, **k)
            np.testing.assert_array_equal(commit2.numpy(), want[0][idx])
            np.testing.assert_array_equal(xpos.numpy(), want[1][idx])


def test_window_wrapper_checks_inputs():
    (buf, pa, ack), kw = port_args(make_case(np.random.default_rng(5)))
    assert [t.shape for t in commit_window(buf, pa, ack, w=W, **kw)] == [
        (12,), (12,)]
    bad = [
        (TypeError, (buf, pa, ack), dict(kw, commit=kw["commit"].long())),
        (TypeError, (buf, pa, ack), dict(kw, bm_old=kw["bm_old"].int())),
        (TypeError, (buf, pa.int(), ack), kw),
        (TypeError, (buf, pa, ack), {k: v for k, v in kw.items()
                                     if k != "commit1"}),
        (ValueError, (buf, pa, ack[:6]), kw),
        (ValueError, (buf[:, :48].contiguous(), pa, ack), kw),   # 48 slots
        (ValueError, (buf[:, :, :META_W - 1].contiguous(), pa, ack), kw),
        (ValueError, (buf.transpose(1, 2), pa, ack), kw),
        (ValueError, (buf, pa[:, 0].contiguous(), ack), kw),       # 1-D
        (ValueError, (buf, torch.ones((12, 5), dtype=torch.bool), ack),
         kw),                                                    # 12 % 5
    ]
    for err, args, k in bad:
        with pytest.raises(err):
            commit_window(*args, w=W, **k)
    for w in (0, N_SLOTS + 1):
        with pytest.raises(ValueError):
            commit_window(buf, pa, ack, w=w, **kw)
    with pytest.raises(ValueError):
        commit_window(buf.to("meta"), pa.to("meta"), ack.to("meta"), w=W,
                      **{k: v.to("meta") for k, v in kw.items()})


def test_replica_step_runs_one_commit_window(monkeypatch):
    """The step calls the commit window once and the stand-alone scan
    never."""
    from rdma_paxos_tpu_torch.config import LogConfig
    from rdma_paxos_tpu_torch.consensus import step as tstep
    from rdma_paxos_tpu_torch.parallel.mesh import stack_states
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return commit_window(*a, **k)

    def forbidden(*a, **k):
        raise AssertionError("commit_scan on the step's path")
    monkeypatch.setattr(tstep, "commit_window", counted)
    monkeypatch.setattr(quorum, "commit_scan", forbidden)
    cfg = LogConfig(n_slots=64, slot_bytes=32, window_slots=16, batch_slots=8)
    st = stack_states(cfg, 3, 3, device="cpu")
    inp = make_step_input(cfg, 3, device="cpu")
    inp.timeout_fired[0] = 1
    st, out = replica_step(clone_state(st), inp, cfg=cfg, n_replicas=3)
    assert calls == [1] and int(out.role[0]) == 3


def test_kernel_source_constants_match_the_log_layout():
    """The CUDA source keeps its own copies of the ring's metadata
    columns and of EntryType.CONFIG; they must equal the port's (and so
    the JAX package's, pinned in test_torch_hygiene.py)."""
    import re
    from pathlib import Path
    src = (Path(quorum.__file__).resolve().parents[1] / "csrc"
           / "commit_scan.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"\b(k\w+) = (\d+)\b", src)}
    assert (consts["kMetaW"], consts["kType"], consts["kTerm"],
            consts["kGidx"], consts["kConfig"]) == (
        META_W, M_TYPE, M_TERM, M_GIDX, CONFIG)
