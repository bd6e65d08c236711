"""Quorum commit scan — the hot op of the consensus core, batched.

Reference: the DARE leader counts per-entry ACK bytes in ``(commit,
end]`` and commits the majority-acked prefix, both majorities during a
membership transition (``dare_ibv_rc.c:1725-1758``, ``:2799-2957``).
As in the JAX package, followers acknowledge by advertising their
``end``, so ``ack[j, r] = ends[r] > commit + j``; the scan takes the
contiguous committed prefix and applies the Raft current-term guard.

Two versions of one function over N scan instances (every replica of a
step in one call):

* :func:`commit_scan_ref` — plain PyTorch, the CPU path and the oracle
  the CUDA kernel is held against;
* the CUDA kernel ``csrc/commit_scan.cu`` (hand-written for sm_90a,
  replacing ``rdma_paxos_tpu/ops/quorum.py:commit_scan_pallas``).

:func:`commit_scan` runs the plain version for CPU tensors and the
kernel for CUDA tensors — never one in place of the other.
"""

from __future__ import annotations

import ctypes

import torch

R_PAD = 128   # replica-axis padding of ``ends`` (MAX_SERVER_COUNT = 13)
N_SCAL = 8    # commit, my_term, my_end, bm_old, bm_new, transit, maj_old, maj_new
U32_BITS = 32


def pack_scal(commit, my_term, my_end, bm_old, bm_new, transit, maj_old,
              maj_new) -> torch.Tensor:
    """``[N, 8]`` i32 scalar block; the u32 bitmasks (int64 values in
    ``[0, 2**32)``) travel as their i32 bit pattern."""
    def bits(m):
        return torch.where(m >= 1 << 31, m - (1 << 32), m).to(torch.int32)
    return torch.stack([commit.to(torch.int32), my_term.to(torch.int32),
                        my_end.to(torch.int32), bits(bm_old), bits(bm_new),
                        transit.to(torch.int32), maj_old.to(torch.int32),
                        maj_new.to(torch.int32)], dim=1)


def commit_scan_ref(ends: torch.Tensor, terms: torch.Tensor,
                    scal: torch.Tensor) -> torch.Tensor:
    """Plain version: ``ends [N, R_PAD]``, ``terms [N, W]``, ``scal
    [N, 8]`` i32 -> new commit ``[N]`` i32 (>= commit). The u32 bitmask
    ops run in int64; bit r >= 32 of a u32 is 0, as XLA's shift gives."""
    W = terms.shape[1]
    commit, my_term, my_end = scal[:, 0], scal[:, 1], scal[:, 2]
    transit, maj_old, maj_new = scal[:, 5], scal[:, 6], scal[:, 7]
    r = torch.arange(ends.shape[1], device=ends.device)
    shift = torch.clamp(r, max=U32_BITS - 1)

    def member(word):
        bm = word.to(torch.int64) & 0xFFFFFFFF
        return ((bm[:, None] >> shift) & 1).bool() & (r < U32_BITS)

    j = torch.arange(W, dtype=torch.int32, device=ends.device)
    g = commit[:, None] + j                                     # [N, W]
    ack = ends[:, None, :] > g[:, :, None]                      # [N, W, R_PAD]
    cnt_old = (ack & member(scal[:, 3])[:, None, :]).sum(-1)
    cnt_new = (ack & member(scal[:, 4])[:, None, :]).sum(-1)
    ok = ((cnt_new >= maj_new[:, None]) & (g < my_end[:, None])
          & ((transit[:, None] <= 0) | (cnt_old >= maj_old[:, None])))
    prefix = torch.where(ok, W, j).min(1).values
    eligible = (j < prefix[:, None]) & (terms == my_term[:, None])
    lastj = torch.where(eligible, j, -1).max(1).values.to(torch.int32)
    return torch.where(lastj >= 0, commit + lastj + 1, commit).to(torch.int32)


def _check(ends, terms, scal) -> None:
    N = ends.shape[0] if ends.dim() == 2 else -1
    for name, t, shape in (("ends", ends, (N, R_PAD)),
                           ("terms", terms, (N, terms.shape[-1])),
                           ("scal", scal, (N, N_SCAL))):
        if t.dtype != torch.int32:
            raise TypeError(f"commit_scan: {name} must be int32, got {t.dtype}")
        if t.dim() != 2 or tuple(t.shape) != shape:
            raise ValueError(f"commit_scan: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.device != ends.device:
            raise ValueError("commit_scan: inputs on different devices")
        if not t.is_contiguous():
            raise ValueError(f"commit_scan: {name} must be contiguous")
    if terms.shape[1] < 1:
        raise ValueError("commit_scan: empty terms window")


def _kernel():
    from rdma_paxos_tpu_torch.ops import _build
    lib = _build.load("commit_scan")
    fn = lib.commit_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def commit_scan_cuda(ends: torch.Tensor, terms: torch.Tensor,
                     scal: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no count kept:
    the main path goes through :func:`commit_scan`)."""
    _check(ends, terms, scal)
    if ends.device.type != "cuda":
        raise ValueError("commit_scan_cuda needs CUDA tensors")
    out = torch.empty(ends.shape[0], dtype=torch.int32, device=ends.device)
    with torch.cuda.device(ends.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel()(ends.data_ptr(), terms.data_ptr(), scal.data_ptr(),
                       out.data_ptr(), ends.shape[0], terms.shape[1],
                       ends.shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"commit_scan kernel launch failed: CUDA error {rc}")
    return out


def commit_scan(ends: torch.Tensor, terms: torch.Tensor,
                scal: torch.Tensor) -> torch.Tensor:
    """The commit scan of N instances: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (counted in
    ``commit_scan.launches``); any other device raises."""
    if ends.device.type == "cpu":
        _check(ends, terms, scal)
        return commit_scan_ref(ends, terms, scal)
    out = commit_scan_cuda(ends, terms, scal)
    commit_scan.launches += 1
    return out


commit_scan.launches = 0
