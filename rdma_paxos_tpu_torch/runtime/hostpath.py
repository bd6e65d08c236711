"""Vectorized host data plane: window encode and decode in numpy.

The engine packs a whole window of client payloads into its staging
buffers in one pass and decodes each fetched committed window into one
columnar :class:`ReplayBatch` (one compacted payload blob + a cumsum
offset table), appended to a :class:`LazyReplayStream` that shows the
legacy ``(etype, conn, req, payload)`` tuple view on demand. Byte for
byte the JAX package's ``runtime/hostpath.py`` vectorized path; the log
constants are this package's own copy. numpy only.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from rdma_paxos_tpu_torch.consensus.log import (
    EntryType, M_CONN, M_GEN, M_GIDX, M_LEN, M_REQID, M_TERM, M_TYPE)


def ragged_arange(lens: np.ndarray) -> np.ndarray:
    """``concatenate([arange(l) for l in lens])`` without the loop."""
    total = int(lens.sum())
    if not total:
        return np.zeros(0, np.int64)
    ends = np.cumsum(lens)
    return (np.arange(total, dtype=np.int64)
            - np.repeat(ends - lens, lens))


def pack_window(du8: np.ndarray, meta: np.ndarray,
                take: Sequence[Tuple], slot_bytes: int) -> int:
    """Pack ``take`` rows of ``(etype, conn, req, payload)`` into one
    window's staging buffers (``du8``: the ``[B, slot_bytes]`` u8 view
    of the payload words, ``meta``: ``[B, META_W]`` i32), assumed
    pre-zeroed. Returns the number of rows written."""
    n = len(take)
    if not n:
        return 0
    cols = np.array([(t, c, q) for (t, c, q, _p) in take], np.int32)
    payloads = [p for (_t, _c, _q, p) in take]
    lens = np.fromiter(map(len, payloads), np.int64, count=n)
    if int(lens.max()) > slot_bytes:
        raise ValueError("payload exceeds slot capacity; fragment first")
    meta[:n, M_TYPE] = cols[:, 0]
    meta[:n, M_CONN] = cols[:, 1]
    meta[:n, M_REQID] = cols[:, 2]
    meta[:n, M_LEN] = lens
    if int(lens.sum()):
        src = np.frombuffer(b"".join(payloads), np.uint8)
        row = du8.shape[1]
        pos = (np.repeat(np.arange(n, dtype=np.int64) * row, lens)
               + ragged_arange(lens))
        du8.reshape(-1)[pos] = src
    return n


class ReplayBatch:
    """One decoded window's client entries, columnar: metadata columns
    plus ONE compacted payload blob (entry i is
    ``blob[offs[i]:offs[i + 1]]``), with the log coordinates (term,
    absolute index) of every entry."""

    __slots__ = ("types", "conns", "reqs", "gens", "lens", "blob",
                 "offs", "terms", "gidx")

    def __init__(self, types, conns, reqs, gens, lens, blob, offs,
                 terms=None, gidx=None):
        self.types = types
        self.conns = conns
        self.reqs = reqs
        self.gens = gens
        self.lens = lens
        self.blob = blob
        self.offs = offs
        self.terms = terms
        self.gidx = gidx

    def __len__(self) -> int:
        return len(self.types)

    def tuples(self) -> List[Tuple[int, int, int, bytes]]:
        t, c, q, o, b = (self.types, self.conns, self.reqs, self.offs,
                         self.blob)
        return [(int(t[i]), int(c[i]), int(q[i]), b[o[i]:o[i + 1]])
                for i in range(len(t))]

    def slice(self, start: int) -> "ReplayBatch":
        """The tail batch from entry ``start`` on (the full blob is kept;
        the offset table stays absolute)."""
        if start <= 0:
            return self
        return ReplayBatch(
            self.types[start:], self.conns[start:], self.reqs[start:],
            self.gens[start:], self.lens[start:], self.blob,
            self.offs[start:],
            None if self.terms is None else self.terms[start:],
            None if self.gidx is None else self.gidx[start:])

    def frames(self) -> bytes:
        """Store-ready framed blob ``([u32 len][u8 etype][u32 conn]
        [payload])*`` of a batch as decoded (a :meth:`slice` shares the
        whole blob and is framed by no caller)."""
        return frames_from_cols(self.types, self.conns, self.lens,
                                self.blob)


def frames_from_cols(types, conns, lens, blob: bytes) -> bytes:
    """Frame entries whose payloads lie back to back in ``blob``."""
    n = len(types)
    if not n:
        return b""
    lens = np.asarray(lens, np.int64)
    rec = 9 + lens
    out = np.zeros(int(rec.sum()), np.uint8)
    starts = np.cumsum(rec) - rec
    out[starts[:, None] + np.arange(4)] = (
        (lens + 5).astype("<u4").view(np.uint8).reshape(n, 4))
    out[starts + 4] = np.asarray(types).astype(np.uint8)
    out[starts[:, None] + 5 + np.arange(4)] = (
        np.asarray(conns).astype("<i4").view(np.uint8).reshape(n, 4))
    if int(lens.sum()):
        out[np.repeat(starts + 9, lens) + ragged_arange(lens)] = \
            np.frombuffer(blob, np.uint8)
    return out.tobytes()


def decode_batch(wm: np.ndarray, wd: np.ndarray, n: int,
                 rebase: int = 0) -> Optional[ReplayBatch]:
    """Decode the first ``n`` fetched entries of a window into a
    :class:`ReplayBatch` of its CLIENT entries (CONNECT/SEND/CLOSE);
    None when there are none. ``rebase`` is added to ``M_GIDX`` so the
    batch carries absolute log indices."""
    if n <= 0:
        return None
    types = wm[:n, M_TYPE]
    idxs = np.nonzero((types >= int(EntryType.CONNECT))
                      & (types <= int(EntryType.CLOSE)))[0]
    if not idxs.size:
        return None
    raw = np.ascontiguousarray(wd[:n]).view(np.uint8).reshape(n, -1)
    row = raw.shape[1]
    full = idxs.size == n
    sel = (lambda col: wm[:n, col]) if full else (
        lambda col: wm[idxs, col])
    lens = np.minimum(sel(M_LEN).astype(np.int64), row)
    keep = np.arange(row, dtype=np.int64) < lens[:, None]
    blob = (raw[keep] if full else raw[idxs][keep]).tobytes()
    offs = np.zeros(idxs.size + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    return ReplayBatch(
        sel(M_TYPE).astype(np.int32), sel(M_CONN).astype(np.int32),
        sel(M_REQID).astype(np.int32), sel(M_GEN).astype(np.int32),
        lens, blob, offs, sel(M_TERM).astype(np.int64),
        sel(M_GIDX).astype(np.int64) + int(rebase))


class LazyReplayStream:
    """List-compatible committed-entry stream backed by
    :class:`ReplayBatch` windows; the tuple view is materialized lazily."""

    __slots__ = ("_flat", "_tail", "_tail_n")

    def __init__(self, initial=None):
        self._flat: list = list(initial) if initial else []
        self._tail: List[ReplayBatch] = []
        self._tail_n = 0

    def append_batch(self, batch: ReplayBatch) -> None:
        self._tail.append(batch)
        self._tail_n += len(batch)

    def __len__(self) -> int:
        return len(self._flat) + self._tail_n

    def _materialize(self) -> list:
        if self._tail:
            for b in self._tail:
                self._flat.extend(b.tuples())
            self._tail = []
            self._tail_n = 0
        return self._flat

    def __getitem__(self, i):
        return self._materialize()[i]

    def __iter__(self):
        return iter(self._materialize())

    def __eq__(self, other):
        if isinstance(other, LazyReplayStream):
            other = other._materialize()
        return self._materialize() == other

    def __repr__(self):
        return f"LazyReplayStream(n={len(self)})"

    def segments_from(self, start: int):
        """The entries ``[start, len)`` as segments: :class:`ReplayBatch`
        objects plus at most one leading plain tuple list."""
        segs = []
        flat_n = len(self._flat)
        if start < flat_n:
            segs.append(self._flat[start:])
            start = flat_n
        off = start - flat_n
        for b in self._tail:
            nb = len(b)
            if off >= nb:
                off -= nb
                continue
            segs.append(b.slice(off) if off else b)
            off = 0
        return segs

