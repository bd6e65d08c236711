"""Port parity: the commit scan's plain PyTorch version against the JAX
package's Pallas kernel (interpret mode) and jnp reference, and against
the NumPy oracle of tests/test_quorum.py — exact equality (integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdma_paxos_tpu.ops.quorum import (
    R_PAD as J_R_PAD, commit_scan_pallas, commit_scan_ref as j_scan_ref)
from rdma_paxos_tpu_torch.ops.quorum import (
    R_PAD, commit_scan, commit_scan_ref, pack_scal)
from tests.test_quorum import W as ORACLE_W, oracle

# tiny tensors: one intra-op thread per process keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

assert R_PAD == J_R_PAD


def _port(ends, commit, my_term, my_end, terms, bm_old, bm_new, transit,
          maj_old, maj_new):
    """Port scan of N instances given numpy columns."""
    t = lambda a, d=torch.int32: torch.as_tensor(np.asarray(a), dtype=d)
    scal = pack_scal(t(commit), t(my_term), t(my_end),
                     t(bm_old, torch.int64), t(bm_new, torch.int64),
                     t(transit), t(maj_old), t(maj_new))
    return commit_scan(t(ends), t(terms), scal).numpy()


def _jax_args(ends, commit, my_term, my_end, terms, bm_old, bm_new,
              transit, maj_old, maj_new):
    return (jnp.asarray(ends, jnp.int32), jnp.int32(commit),
            jnp.int32(my_term), jnp.int32(my_end),
            jnp.asarray(terms, jnp.int32), jnp.uint32(bm_old),
            jnp.uint32(bm_new), jnp.int32(transit), jnp.int32(maj_old),
            jnp.int32(maj_new))


def _random_cases(seed, N, W):
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(N):
        nrep = int(rng.integers(1, 14))
        commit = int(rng.integers(0, 500))
        ends = np.zeros(R_PAD, np.int64)
        ends[:nrep] = commit + rng.integers(-3, W + 4, nrep)
        ends[:nrep] *= rng.random(nrep) < 0.9
        bm_old = int(rng.integers(0, 1 << 13))
        bm_new = int(rng.integers(0, 1 << 13))
        if rng.random() < 0.3:
            bm_new |= 1 << int(rng.integers(13, 32))
        cases.append(dict(
            ends=ends, commit=commit, my_term=int(rng.integers(1, 4)),
            my_end=commit + int(rng.integers(0, W + 6)),
            terms=rng.integers(0, 4, W), bm_old=bm_old, bm_new=bm_new,
            transit=int(rng.random() < 0.3),
            maj_old=bin(bm_old).count("1") // 2 + 1,
            maj_new=bin(bm_new).count("1") // 2 + 1))
    return cases


def _batch(cases):
    keys = ("ends", "commit", "my_term", "my_end", "terms", "bm_old",
            "bm_new", "transit", "maj_old", "maj_new")
    return [np.stack([np.asarray(c[k]) for c in cases]) for k in keys]


@pytest.mark.parametrize("seed,W", [(0, 16), (1, 64), (2, 128)])
def test_ref_matches_jax_ref_and_oracle_random(seed, W):
    cases = _random_cases(seed, 48, W)
    got = _port(*_batch(cases))
    for c, g in zip(cases, got):
        args = [c[k] for k in ("ends", "commit", "my_term", "my_end",
                               "terms", "bm_old", "bm_new", "transit",
                               "maj_old", "maj_new")]
        want = int(j_scan_ref(*_jax_args(*args)))
        assert int(g) == want, (c, int(g), want)
        if W == ORACLE_W:
            assert want == oracle(*args)


def test_ref_matches_pallas_interpret():
    cases = _random_cases(7, 6, ORACLE_W)
    got = _port(*_batch(cases))
    for c, g in zip(cases, got):
        args = [c[k] for k in ("ends", "commit", "my_term", "my_end",
                               "terms", "bm_old", "bm_new", "transit",
                               "maj_old", "maj_new")]
        pal = int(commit_scan_pallas(*_jax_args(*args), interpret=True))
        assert int(g) == pal == oracle(*args)


# the hand-written cases of tests/test_quorum.py, each against the oracle
QUORUM_CASES = [
    (([5, 5, 2], 0, 3, 5, [3] * 16), {}, 5),
    (([0, 0, 0], 4, 3, 10, [3] * 16), {}, 4),
    (([7, 0, 0], 0, 3, 7, [3] * 16), {}, 0),
    (([9, 9, 9], 0, 3, 6, [3] * 16), {}, 6),
    (([3, 3, 3], 0, 5, 3, [2, 2, 2] + [0] * 13), {}, 0),
    (([3, 3, 3], 0, 5, 3, [2, 2, 5] + [0] * 13), {}, 3),
    (([5, 2, 2], 0, 3, 5, [3] * 16), {}, 2),
    (([4, 4, 0, 0, 0], 0, 7, 4, [7] * 16),
     dict(bm_old=0b00111, bm_new=0b11001, transit=1), 0),
    (([4, 4, 0, 4, 0], 0, 7, 4, [7] * 16),
     dict(bm_old=0b00111, bm_new=0b11001, transit=1), 4),
    (([8, 8, 3], 3, 4, 8, [4] * 16), {}, 8),
]


@pytest.mark.parametrize("case", range(len(QUORUM_CASES)))
def test_quorum_cases(case):
    (ends_l, commit, my_term, my_end, terms), kw, expect = \
        QUORUM_CASES[case]
    kw = dict(dict(bm_old=0b111, bm_new=0b111, transit=0, maj_old=2,
                   maj_new=2), **kw)
    ends = np.zeros(R_PAD, np.int64)
    ends[:len(ends_l)] = ends_l
    args = [ends, commit, my_term, my_end, np.array(terms), kw["bm_old"],
            kw["bm_new"], kw["transit"], kw["maj_old"], kw["maj_new"]]
    got = int(_port(*[np.asarray(a)[None] for a in args])[0])
    assert got == expect == oracle(*args)


def test_wrap_and_high_bits():
    """i32 wrap of commit + j and bitmask bits >= 13 (bit 31 included)
    match the jnp reference exactly."""
    big = (1 << 31) - 4
    ends = np.zeros(R_PAD, np.int64)
    ends[:3] = -(1 << 31) + 8
    for bm_new, maj in ((0xFFFFFFFF, 17), (1 << 31, 1), (0b111, 2)):
        args = [ends, big, 1, -(1 << 31) + 8, np.ones(16, np.int64), 0,
                bm_new, 0, 1, maj]
        got = int(_port(*[np.asarray(a)[None] for a in args])[0])
        assert got == int(j_scan_ref(*_jax_args(*args)))


def test_wrapper_checks_inputs():
    ends = torch.zeros((2, R_PAD), dtype=torch.int32)
    terms = torch.zeros((2, 16), dtype=torch.int32)
    scal = torch.zeros((2, 8), dtype=torch.int32)
    assert commit_scan(ends, terms, scal).shape == (2,)
    with pytest.raises(TypeError):
        commit_scan(ends.long(), terms, scal)
    with pytest.raises(ValueError):
        commit_scan(ends[:, :64], terms, scal)
    with pytest.raises(ValueError):
        commit_scan(ends, terms.t().contiguous().t(), scal)
    with pytest.raises(ValueError):
        commit_scan(ends.to("meta"), terms.to("meta"), scal.to("meta"))
