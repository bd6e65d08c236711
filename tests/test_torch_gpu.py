"""Kernel checks that need the card: each CUDA kernel of the port against
its plain PyTorch version, on the card. Marked ``gpu``; each test
decides at run time and skips without a CUDA device. On the card
(which has no JAX, so tests/conftest.py is skipped):
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.mark.parametrize("N,W", [(3, 16), (13, 128), (192, 2048)])
def test_commit_scan_kernel_equals_plain(N, W):
    _need_card()
    from rdma_paxos_tpu_torch.ops.quorum import (
        R_PAD, commit_scan, commit_scan_cuda, commit_scan_ref)
    rng = np.random.default_rng(N * W)
    commit = rng.integers(0, 1000, N)
    ends = np.zeros((N, R_PAD), np.int64)
    ends[:, :13] = commit[:, None] + rng.integers(-3, W + 4, (N, 13))
    ends[:, :13] *= rng.random((N, 13)) < 0.9
    bm = rng.integers(0, 1 << 13, (N, 2))
    bm[:, 1] |= (rng.random(N) < 0.3) << 31
    scal = np.stack([commit, rng.integers(1, 3, N),
                     commit + rng.integers(0, W + 4, N), bm[:, 0], bm[:, 1],
                     rng.integers(0, 2, N), np.full(N, 2), np.full(N, 3)], 1)
    dev = torch.device("cuda")

    def t(a):
        return torch.from_numpy((np.asarray(a) & 0xFFFFFFFF).astype(
            np.uint32).view(np.int32)).to(dev)
    e, tm, s = t(ends), t(rng.integers(0, 3, (N, W))), t(scal)
    want = commit_scan_ref(e, tm, s)
    assert torch.equal(commit_scan_cuda(e, tm, s), want)
    before = commit_scan.launches
    assert torch.equal(commit_scan(e, tm, s), want)
    assert commit_scan.launches == before + 1
    torch.cuda.synchronize()


@pytest.mark.parametrize("G,R,W", [(1, 3, 2048), (1, 13, 128), (64, 3, 2048)])
def test_commit_window_kernel_equals_plain(G, R, W):
    """N = G x R instances in {3, 13, 192}, on the seeded rings of
    ``chip_smoke.py`` (main-path width: 2048-row window, 8192 slots)."""
    _need_card()
    from chip_smoke import window_case
    from rdma_paxos_tpu_torch.ops.quorum import (
        commit_window, commit_window_cuda, commit_window_ref)
    rng = np.random.default_rng(G * R * W)
    args, kw = window_case(rng, torch.device("cuda"), G=G, R=R, W=W,
                           n_slots=4 * W)
    want = commit_window_ref(*args, w=W, **kw)
    got = commit_window_cuda(*args, w=W, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    before = commit_window.launches
    got = commit_window(*args, w=W, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert commit_window.launches == before + 1
    torch.cuda.synchronize()


def test_front_door_pipelined_driver_on_the_card():
    """Phase (6a) of ``chip_smoke.py`` at a small size: a pre-queued
    record through the pipelined driver on the card acks every event
    once, commits the CPU serial run's stream, overlaps dispatches and
    launches the commit-window kernel once per protocol step."""
    _need_card()
    from chip_smoke import drive_front_door, front_record
    geom = dict(n_slots=1024, slot_bytes=128, window_slots=256,
                batch_slots=256)
    payloads = front_record(3000, 100)
    gpu = drive_front_door(torch.device("cuda", 0), geom, "psum", payloads,
                           4, 2)
    cpu = drive_front_door(torch.device("cpu"), geom, "psum", payloads, 4, 0)
    for run in (gpu, cpu):
        assert run["statuses"] == [0] * len(payloads)
        assert (run["fired"] == 1).all()
    assert gpu["streams"] == cpu["streams"]
    assert [p for (t, _c, _q, p) in gpu["streams"][0] if t == 3] == payloads
    assert gpu["max_inflight"] >= 2
    assert gpu["launches"] == gpu["steps"] > 0


def test_snapshot_recovery_on_the_card():
    """Phase (7a) of ``chip_smoke.py`` at a small size: a laggard pruned
    past the ring and a fresh learner recover by snapshot install on the
    card, with replica state and replay streams bit-equal to the CPU run
    at every mark and one commit-window launch per protocol step."""
    _need_card()
    from chip_smoke import drive_recovery
    from rdma_paxos_tpu_torch.ops.quorum import commit_scan, commit_window
    geom = dict(n_slots=1024, slot_bytes=128, window_slots=256,
                batch_slots=256)
    w0, s0 = commit_window.launches, commit_scan.launches
    gpu = drive_recovery(torch.device("cuda", 0), geom, "gather", 3000, True)
    assert commit_window.launches - w0 == gpu["steps"] > 0
    assert commit_scan.launches == s0
    cpu = drive_recovery(torch.device("cpu"), geom, "gather", 3000, True)
    assert gpu["pruned"] and gpu["catch_up"] == cpu["catch_up"]
    assert gpu["marks"] == cpu["marks"]
