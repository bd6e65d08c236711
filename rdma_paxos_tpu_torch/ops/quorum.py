"""Quorum commit scan — the hot op of the consensus core, batched.

Reference: the DARE leader counts per-entry ACK bytes in ``(commit,
end]`` and commits the majority-acked prefix, both majorities during a
membership transition (``dare_ibv_rc.c:1725-1758``, ``:2799-2957``).
As in the JAX package, followers acknowledge by advertising their
``end``, so ``ack[j, r] = ends[r] > commit + j``; the scan takes the
contiguous committed prefix and applies the Raft current-term guard.

Two functions over N scan instances (every replica of a step in one
call), each in two versions:

* the commit scan — :func:`commit_scan_ref` (plain PyTorch) and the
  CUDA kernel behind :func:`commit_scan`, the one-to-one counterpart of
  ``rdma_paxos_tpu/ops/quorum.py:commit_scan_pallas``;
* the commit window — what the replica step runs: the scan plus the
  step's phase-F/G window work around it (the ack gather, the window's
  terms read from the ring, the leader's commit select and the
  commit-crossing CONFIG search). :func:`commit_window_ref` is the plain
  version; :func:`commit_window` launches one kernel that reads the ring
  in place.

Both kernels are hand-written for sm_90a in ``csrc/commit_scan.cu``. A
wrapper runs the plain version for CPU tensors and its kernel for CUDA
tensors — never one in place of the other — and counts its launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from rdma_paxos_tpu_torch.consensus.log import (
    EntryType, M_GIDX, M_TERM, M_TYPE, META_W, gather_rows)

R_PAD = 128   # replica-axis padding of ``ends`` (MAX_SERVER_COUNT = 13)
N_SCAL = 8    # commit, my_term, my_end, bm_old, bm_new, transit, maj_old, maj_new
U32_BITS = 32
I32 = torch.int32
I32_MIN = -(1 << 31)


def lex_argmax(valid: torch.Tensor, keys) -> torch.Tensor:
    """Per row of ``valid [..., n]``: index of the lexicographically
    largest ``keys`` among valid entries, ties to the SMALLEST index;
    -1 if none is valid."""
    v = valid
    for k in keys:
        kk = torch.where(v, k, I32_MIN)
        v = v & (kk == kk.max(-1, keepdim=True).values)
    n = v.shape[-1]
    idx = torch.arange(n, dtype=I32, device=v.device)
    first = torch.where(v, idx, n).min(-1).values
    return torch.where(first < n, first, -1).to(I32)


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


def commit_window_ref(buf, peer_acked, my_ack, *, commit, my_term, my_end,
                      bm_old, bm_new, transit, maj_old, maj_new, i_lead,
                      commit1, w: int):
    """Plain version of the commit window, N instances of R replicas.

    ``buf [N, n_slots, cols]`` is the fused ring; ``peer_acked [N, R]``
    bool says whose ack instance n counts; ``my_ack [N]`` is each
    replica's own ack offset (instance n reads the R entries of its
    group, ``n // R``) — or ``my_ack [N * R]`` holds each instance's own
    row of R gathered acks (instance n reads row n: the replica of a
    process-group step, ``N = 1``, or a device-list entry's rows of
    distinct groups); ``i_lead`` is bool, ``bm_*`` int64 holding a u32,
    the rest ``[N]`` i32. Returns ``(commit2, xpos)``, both ``[N]``
    i32: the leader's scanned commit (else ``commit1``) and the window
    row of the newest CONFIG entry crossing below ``commit2`` (-1 if
    none)."""
    N, R = peer_acked.shape
    sw = buf.shape[2] - META_W
    acks_pad = torch.zeros((N, R_PAD), dtype=I32, device=buf.device)
    acks = my_ack.view(-1, R)
    if acks.shape[0] * R == N:       # whole groups: n reads group n // R
        acks = acks.repeat_interleave(R, 0)
    acks_pad[:, :R] = torch.where(peer_acked, acks, 0)
    cwin_g = commit[:, None] + torch.arange(w, dtype=I32, device=buf.device)
    cwin_meta = gather_rows(buf, cwin_g)[..., sw:]           # [N, W, MW]
    scanned = commit_scan_ref(
        acks_pad, cwin_meta[..., M_TERM].contiguous(),
        pack_scal(commit, my_term, my_end, bm_old, bm_new, transit,
                  maj_old, maj_new))
    commit2 = torch.where(i_lead, torch.maximum(commit, scanned), commit1)
    crossed = ((cwin_meta[..., M_TYPE] == int(EntryType.CONFIG))
               & (cwin_meta[..., M_GIDX] == cwin_g)
               & (cwin_g < commit2[:, None]))
    return commit2, lex_argmax(crossed, [cwin_g])


# ---------------------------------------------------------------------------
# the wrappers: checks, then the plain version (CPU) or the kernel (CUDA)
# ---------------------------------------------------------------------------

def _check(who, tensors, device) -> None:
    """``tensors``: ``(name, tensor, dtype, shape)``; every tensor must
    match and be contiguous on ``device``."""
    for name, t, dtype, shape in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{who}: {name} must be {dtype}, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != device:
            raise ValueError(f"{who}: inputs on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")


def _check_scan(ends, terms, scal) -> None:
    N = ends.shape[0] if ends.dim() == 2 else -1
    W = terms.shape[-1]
    _check("commit_scan", (("ends", ends, I32, (N, R_PAD)),
                           ("terms", terms, I32, (N, W)),
                           ("scal", scal, I32, (N, N_SCAL))), ends.device)
    if W < 1:
        raise ValueError("commit_scan: empty terms window")


_WINDOW_I32 = ("commit", "my_term", "my_end", "transit", "maj_old",
               "maj_new", "commit1")
_WINDOW_KEYS = frozenset(_WINDOW_I32 + ("i_lead", "bm_old", "bm_new"))


def _check_window(buf, peer_acked, my_ack, w, v) -> None:
    who = "commit_window"
    if v.keys() != _WINDOW_KEYS:
        raise TypeError(f"{who}: takes the keywords {sorted(_WINDOW_KEYS)},"
                        f" got {sorted(v)}")
    if buf.dtype != I32 or buf.dim() != 3 or not buf.is_contiguous():
        raise ValueError(f"{who}: buf must be a contiguous [N, n_slots, "
                         f"cols] int32 ring")
    N, n_slots, cols = buf.shape
    if n_slots & (n_slots - 1) or cols < META_W:
        raise ValueError(f"{who}: ring of {n_slots} slots x {cols} columns "
                         f"(a power of two, >= {META_W} columns)")
    if not 1 <= w <= n_slots:
        raise ValueError(f"{who}: window {w} outside 1..{n_slots}")
    R = peer_acked.shape[-1] if peer_acked.dim() == 2 else 0
    rows = R > 1 and my_ack.numel() == N * R
    if R < 1 or (N % R and not rows):
        raise ValueError(f"{who}: peer_acked shape {tuple(peer_acked.shape)}"
                         f" does not split {N} instances into groups")
    n = (N,)
    # instances outside whole groups (a process's replica, a device-list
    # entry's group rows) each read their own row of R gathered acks
    n_ack = (N * R,) if rows else n
    _check(who, (("peer_acked", peer_acked, torch.bool, (N, R)),
                 ("my_ack", my_ack, I32, n_ack),
                 ("i_lead", v["i_lead"], torch.bool, n),
                 ("bm_old", v["bm_old"], torch.int64, n),
                 ("bm_new", v["bm_new"], torch.int64, n))
           + tuple((k, v[k], I32, n) for k in _WINDOW_I32), buf.device)


_ARGTYPES = {
    "commit_scan_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    "commit_window_launch": [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
}
_fns: dict = {}


def _kernel(name: str):
    """The ctypes entry ``name`` of ``csrc/commit_scan.cu``, built and
    typed on first use."""
    fn = _fns.get(name)
    if fn is None:
        from rdma_paxos_tpu_torch.ops import _build
        fn = getattr(_build.load("commit_scan"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _stream(dev: torch.device) -> int:
    """The current stream of ``dev``, which must be the current device
    (the kernels launch there; no device switch per call)."""
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {dev}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream(dev).cuda_stream


def _launched(who: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{who} kernel launch failed: CUDA error {rc}")


def commit_scan_cuda(ends: torch.Tensor, terms: torch.Tensor,
                     scal: torch.Tensor) -> torch.Tensor:
    """Launch the commit-scan kernel on the current stream (no count
    kept: :func:`commit_scan` counts)."""
    _check_scan(ends, terms, scal)
    stream = _stream(ends.device)
    out = torch.empty(ends.shape[0], dtype=I32, device=ends.device)
    _launched("commit_scan", _kernel("commit_scan_launch")(
        ends.data_ptr(), terms.data_ptr(), scal.data_ptr(), out.data_ptr(),
        ends.shape[0], terms.shape[1], ends.shape[1], stream))
    return out


def commit_scan(ends: torch.Tensor, terms: torch.Tensor,
                scal: torch.Tensor) -> torch.Tensor:
    """The commit scan of N instances: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors (counted in
    ``commit_scan.launches``); any other device raises."""
    if ends.device.type == "cpu":
        _check_scan(ends, terms, scal)
        return commit_scan_ref(ends, terms, scal)
    out = commit_scan_cuda(ends, terms, scal)
    with _COUNT_LOCK:
        commit_scan.launches += 1
    return out


commit_scan.launches = 0
# the launch counts are exact under threads (a device-list engine steps
# every entry on its own thread)
_COUNT_LOCK = threading.Lock()


def commit_window_cuda(buf, peer_acked, my_ack, *, w: int, **v):
    """Launch the commit-window kernel on the current stream (no count
    kept: :func:`commit_window` counts). Same arguments and results as
    :func:`commit_window_ref`."""
    _check_window(buf, peer_acked, my_ack, w, v)
    stream = _stream(buf.device)
    N, n_slots, cols = buf.shape
    out = torch.empty((2, N), dtype=I32, device=buf.device)
    _launched("commit_window", _kernel("commit_window_launch")(
        buf.data_ptr(), peer_acked.data_ptr(), my_ack.data_ptr(),
        v["commit"].data_ptr(), v["my_term"].data_ptr(),
        v["my_end"].data_ptr(), v["bm_old"].data_ptr(),
        v["bm_new"].data_ptr(), v["transit"].data_ptr(),
        v["maj_old"].data_ptr(), v["maj_new"].data_ptr(),
        v["i_lead"].data_ptr(), v["commit1"].data_ptr(), out.data_ptr(),
        N, peer_acked.shape[1], w, n_slots, cols, cols - META_W,
        int(my_ack.numel() != N), stream))
    return out[0], out[1]


def commit_window(buf, peer_acked, my_ack, *, w: int, **v):
    """The commit window of N instances (see :func:`commit_window_ref`):
    the plain version for CPU tensors, the CUDA kernel for CUDA tensors
    (counted in ``commit_window.launches``); any other device raises."""
    if buf.device.type == "cpu":
        _check_window(buf, peer_acked, my_ack, w, v)
        return commit_window_ref(buf, peer_acked, my_ack, w=w, **v)
    out = commit_window_cuda(buf, peer_acked, my_ack, w=w, **v)
    with _COUNT_LOCK:
        commit_window.launches += 1
    return out


commit_window.launches = 0
