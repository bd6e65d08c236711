"""The replicated log as fixed-shape tensors, batched over replicas.

Reference: the DARE log is a byte-granular 64 MB circular buffer with
four offsets ``head/apply/commit/end`` (``dare_log.h:33-47,76-103``).
Here, as in the JAX package, it is a slot ring: payload words and
framing metadata live FUSED in one ``[R, n_slots, slot_words + META_W]``
int32 tensor, the slot of global index ``g`` is ``g % n_slots``, and
every offset is a global monotone int32 entry index.

Every function takes the replica axis as an explicit dimension, after
any leading batch axes: ``[..., R, ...]`` tensors and ``[..., R]``
offsets, so one call serves R replicas (``[R, ...]``) or G groups of R
(``[G, R, ...]``). Per-replica work runs on the N = G·R instances as
rows of the ring viewed ``[N, n_slots, cols]`` (a view, never a copy:
the ring must be contiguous). The ring is updated IN PLACE —
the JAX version donates its buffers, so no caller there could observe
the old ring either. Rows outside a batch's valid prefix are written
back with the values they already hold (the JAX code drops them with a
``mode="drop"`` scatter to index ``n_slots``, which torch indexing
rejects); the B (or W) target slots of one call are distinct because
B <= W <= n_slots, so no write races another.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import torch


class EntryType(enum.IntEnum):
    """Log entry types (reference ``dare_log.h:22-25`` plus the proxy
    event types CONNECT/SEND/CLOSE)."""

    EMPTY = 0
    NOOP = 1
    CONNECT = 2
    SEND = 3
    CLOSE = 4
    CONFIG = 5


# metadata columns of a fused slot row (after the payload words)
M_TYPE, M_TERM, M_CONN, M_REQID, M_LEN, M_GIDX = 0, 1, 2, 3, 4, 5
M_GEN = 6
META_W = 8


@dataclasses.dataclass
class Log:
    """Fused ring ``buf [..., n_slots, slot_words + META_W]`` int32;
    ``data``/``meta`` are column views."""

    buf: torch.Tensor

    @property
    def n_slots(self) -> int:
        return self.buf.shape[-2]

    @property
    def slot_words(self) -> int:
        return self.buf.shape[-1] - META_W

    @property
    def data(self) -> torch.Tensor:
        return self.buf[..., :self.slot_words]

    @property
    def meta(self) -> torch.Tensor:
        return self.buf[..., self.slot_words:]


def make_log(cfg, device) -> Log:
    return Log(buf=torch.zeros((cfg.n_slots, cfg.slot_words + META_W),
                               dtype=torch.int32, device=device))


def slot_of(g: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Slot index of global entry index ``g`` (n_slots a power of two)."""
    return g & (n_slots - 1)


def _flat(buf: torch.Tensor) -> torch.Tensor:
    """The ring ``[..., n_slots, cols]`` as ``[N, n_slots, cols]``, one
    row per instance — a view, so writes land in ``buf``."""
    return buf.view(-1, buf.shape[-2], buf.shape[-1])


def _rows(buf: torch.Tensor) -> torch.Tensor:
    """``[N, 1]`` instance index column for gathers from ``buf [N, ...]``."""
    return torch.arange(buf.shape[0], device=buf.device)[:, None]


def gather_rows(buf: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Fused rows of global indices ``g [..., R, n]`` -> ``[..., R, n,
    cols]``."""
    fb = _flat(buf)
    s = slot_of(g, fb.shape[1]).long().reshape(fb.shape[0], -1)
    return fb[_rows(fb), s].view(*g.shape, fb.shape[2])


def term_at(log: Log, g: torch.Tensor) -> torch.Tensor:
    """``M_TERM`` of the entry at global index ``g [..., R]`` -> ``[...,
    R]``."""
    fb = _flat(log.buf)
    r = torch.arange(fb.shape[0], device=g.device)
    return fb[r, slot_of(g, log.n_slots).long().reshape(-1),
              log.slot_words + M_TERM].view(g.shape)


def last_term(log: Log, end: torch.Tensor) -> torch.Tensor:
    """Term of the last entry (0 for an empty log) — the election
    up-to-date check (reference ``dare_server.c:1596-1652``)."""
    return torch.where(end > 0, term_at(log, end - 1),
                       torch.zeros_like(end))


def _scatter_rows(buf: torch.Tensor, g: torch.Tensor, rows: torch.Tensor,
                  keep: torch.Tensor) -> None:
    """Write ``rows [..., R, n, cols]`` to the slots of ``g [..., R, n]``
    where ``keep`` holds; elsewhere the slot keeps its value (distinct
    slots per replica, so the masked write-back never clobbers a kept
    row)."""
    fb = _flat(buf)
    N = fb.shape[0]
    r = _rows(fb)
    s = slot_of(g, fb.shape[1]).long().reshape(N, -1)
    rows = rows.reshape(N, s.shape[1], -1)
    keep = keep.reshape(N, -1)
    fb[r, s] = torch.where(keep[..., None], rows, fb[r, s])


def append_batch(log: Log, end: torch.Tensor, head: torch.Tensor,
                 batch_data: torch.Tensor, batch_meta: torch.Tensor,
                 count: torch.Tensor, term: torch.Tensor
                 ) -> Tuple[Log, torch.Tensor]:
    """Append up to ``count [..., R]`` entries of ``batch_* [..., R, B,
    ...]`` at
    ``end`` stamped with ``term`` (and their global index in M_GIDX).
    Capacity is n_slots-1 (one slot stays free so the prev-term check
    never reads a recycled slot); entries that do not fit are dropped
    and the proxy retries them. Returns ``(log, new_end)``."""
    n_slots = log.n_slots
    B = batch_data.shape[-2]
    avail = (n_slots - 1) - (end - head)
    n = torch.clamp(torch.minimum(count, avail), 0, B).to(torch.int32)
    offs = torch.arange(B, dtype=torch.int32, device=end.device)
    g = end[..., None] + offs
    meta = batch_meta.clone()
    meta[..., M_TERM] = term[..., None]
    meta[..., M_GIDX] = g
    _scatter_rows(log.buf, g, torch.cat([batch_data, meta], -1),
                  offs < n[..., None])
    return log, end + n


def extract_window(log: Log, start: torch.Tensor, window_slots: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather ``window_slots`` consecutive entries from ``start [...,
    R]``: ``([..., R, W, slot_words], [..., R, W, META_W])`` — the
    leader's broadcast
    payload (the modular gather absorbs the ring wrap)."""
    g = start[..., None] + torch.arange(window_slots, dtype=torch.int32,
                                      device=start.device)
    w = gather_rows(log.buf, g)
    return w[..., :log.slot_words], w[..., log.slot_words:]


def absorb_window(log: Log, my_end: torch.Tensor, wdata: torch.Tensor,
                  wmeta: torch.Tensor, wstart: torch.Tensor,
                  wcount: torch.Tensor) -> Tuple[Log, torch.Tensor]:
    """Follower-side accept of a leader window (``log_adjustment``,
    ``dare_ibv_rc.c:1292-1451``): a gap (``wstart > my_end``) ignores
    the window; the first per-entry term mismatch in the overlap
    truncates the local suffix to the window end; every valid window
    row is copied in. Returns ``(log, new_end)``."""
    W = wdata.shape[-2]
    offs = torch.arange(W, dtype=torch.int32, device=wstart.device)
    g = wstart[..., None] + offs
    valid = offs < wcount[..., None]
    wend = wstart + wcount
    accept = wstart <= my_end

    local_terms = gather_rows(log.buf, g)[..., log.slot_words + M_TERM]
    in_overlap = valid & (g < my_end[..., None])
    any_conflict = (in_overlap & (local_terms != wmeta[..., M_TERM])
                    ).any(-1)

    _scatter_rows(log.buf, g, torch.cat([wdata, wmeta], -1),
                  valid & accept[..., None])
    new_end = torch.where(
        accept,
        torch.where(any_conflict, wend, torch.maximum(my_end, wend)),
        my_end).to(torch.int32)
    return log, new_end
