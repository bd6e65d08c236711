"""Vectorized host data plane: window encode and decode, replay and ack
planning, in numpy.

The engine packs a whole window of client payloads into its staging
buffers in one pass and decodes each fetched committed window into one
columnar :class:`ReplayBatch` (one compacted payload blob + a cumsum
offset table), appended to a :class:`LazyReplayStream` that shows the
legacy ``(etype, conn, req, payload)`` tuple view on demand. The driver
plans each replica's apply from those batches (:func:`plan_segment`):
the own-entry ack frontier and the remote replay ops, with consecutive
same-connection SENDs coalesced. Byte for byte the JAX package's
``runtime/hostpath.py``; the log constants are this package's own copy.
Every operation keeps its scalar reference loop beside the vectorized
one, and the module-wide :data:`VECTORIZED` switch (:func:`set_vectorized`)
selects between them. Both planes give the same bytes, so flipping the
switch (from any thread, even while a driver's dispatch and readback
threads run) changes no result, only the host time. numpy only.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from rdma_paxos_tpu_torch.consensus.log import (
    EntryType, M_CONN, M_GEN, M_GIDX, M_LEN, M_REQID, M_TERM, M_TYPE)

# module-wide switch between the vectorized hot path and the scalar
# reference loops: a pure performance knob, never a semantics one (the
# two planes are pinned byte-identical)
VECTORIZED = True


def set_vectorized(flag: bool) -> bool:
    """Select the vectorized (True) or scalar-reference (False) host
    data plane; returns the previous setting."""
    global VECTORIZED
    prev = VECTORIZED
    VECTORIZED = bool(flag)
    return prev


def ragged_arange(lens: np.ndarray) -> np.ndarray:
    """``concatenate([arange(l) for l in lens])`` without the loop."""
    total = int(lens.sum())
    if not total:
        return np.zeros(0, np.int64)
    ends = np.cumsum(lens)
    return (np.arange(total, dtype=np.int64)
            - np.repeat(ends - lens, lens))


def pack_window(du8: np.ndarray, meta: np.ndarray,
                take: Sequence[Tuple], slot_bytes: int,
                gen: Optional[int] = None) -> int:
    """Pack ``take`` rows of ``(etype, conn, req, payload)`` into one
    window's staging buffers (``du8``: the ``[B, slot_bytes]`` u8 view
    of the payload words, ``meta``: ``[B, META_W]`` i32), assumed
    pre-zeroed, stamping ``gen`` into ``M_GEN`` when given. Returns the
    number of rows written."""
    n = len(take)
    if not n:
        return 0
    if VECTORIZED:
        _pack_vec(du8, meta, take, slot_bytes, gen)
    else:
        _pack_scalar(du8, meta, take, slot_bytes, gen)
    return n


def _pack_scalar(du8, meta, take, slot_bytes, gen) -> None:
    """The per-entry loop: the bit-identity reference."""
    for i, (t, conn, req, payload) in enumerate(take):
        ln = len(payload)
        if ln > slot_bytes:
            raise ValueError("payload exceeds slot capacity; "
                             "fragment first")
        if ln:
            du8[i, :ln] = np.frombuffer(payload, np.uint8)
        row = meta[i]
        row[M_TYPE] = t
        row[M_CONN] = conn
        row[M_REQID] = req
        row[M_LEN] = ln
        if gen is not None:
            row[M_GEN] = gen


def _pack_vec(du8, meta, take, slot_bytes, gen) -> None:
    n = len(take)
    cols = np.array([(t, c, q) for (t, c, q, _p) in take], np.int32)
    payloads = [p for (_t, _c, _q, p) in take]
    lens = np.fromiter(map(len, payloads), np.int64, count=n)
    if int(lens.max()) > slot_bytes:
        raise ValueError("payload exceeds slot capacity; fragment first")
    meta[:n, M_TYPE] = cols[:, 0]
    meta[:n, M_CONN] = cols[:, 1]
    meta[:n, M_REQID] = cols[:, 2]
    meta[:n, M_LEN] = lens
    if gen is not None:
        meta[:n, M_GEN] = gen
    if int(lens.sum()):
        src = np.frombuffer(b"".join(payloads), np.uint8)
        row = du8.shape[1]
        pos = (np.repeat(np.arange(n, dtype=np.int64) * row, lens)
               + ragged_arange(lens))
        du8.reshape(-1)[pos] = src


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
        [payload])*`` built over the offset table."""
        return frames_from_cols(self.types, self.conns, self.lens,
                                self.blob, self.offs)


def frames_from_cols(types, conns, lens, blob: bytes, offs) -> bytes:
    """See :meth:`ReplayBatch.frames`. A blob longer than ``lens.sum()``
    (a :meth:`ReplayBatch.slice`, whose offset table stays absolute) is
    gathered through ``offs``."""
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
    total = int(lens.sum())
    if total:
        src = np.frombuffer(blob, np.uint8)
        if len(src) != total:                   # non-compacted offsets
            o = np.asarray(offs, np.int64)
            src = src[np.repeat(o[:n], lens) + ragged_arange(lens)]
        out[np.repeat(starts + 9, lens) + ragged_arange(lens)] = src
    return out.tobytes()


def decode_batch(wm: np.ndarray, wd: np.ndarray, n: int,
                 rebase: int = 0) -> Optional[ReplayBatch]:
    """Decode the first ``n`` fetched entries of a window into a
    :class:`ReplayBatch` of its CLIENT entries (CONNECT/SEND/CLOSE);
    None when there are none. ``rebase`` is added to ``M_GIDX`` so the
    batch carries absolute log indices, by either plane."""
    if n <= 0:
        return None
    if VECTORIZED:
        return _decode_vec(wm, wd, n, rebase)
    return _decode_scalar(wm, wd, n, rebase)


def _client_rows(wm, n):
    types = wm[:n, M_TYPE]
    client = ((types >= int(EntryType.CONNECT))
              & (types <= int(EntryType.CLOSE)))
    return types, np.nonzero(client)[0]


def _decode_scalar(wm, wd, n, rebase=0) -> Optional[ReplayBatch]:
    """Per-entry reference decode: one bytes slice per entry, joined."""
    _types, idxs = _client_rows(wm, n)
    if not idxs.size:
        return None
    raw = np.ascontiguousarray(wd[:n]).view(np.uint8).reshape(n, -1)
    row = raw.shape[1]
    buf = raw.tobytes()
    parts, lens = [], []
    for j in idxs:
        ln = min(int(wm[j, M_LEN]), row)
        o = int(j) * row
        parts.append(buf[o:o + ln])
        lens.append(ln)
    lens_a = np.asarray(lens, np.int64)
    offs = np.zeros(len(idxs) + 1, np.int64)
    np.cumsum(lens_a, out=offs[1:])
    return ReplayBatch(
        wm[idxs, M_TYPE].astype(np.int32),
        wm[idxs, M_CONN].astype(np.int32),
        wm[idxs, M_REQID].astype(np.int32),
        wm[idxs, M_GEN].astype(np.int32),
        lens_a, b"".join(parts), offs,
        wm[idxs, M_TERM].astype(np.int64),
        wm[idxs, M_GIDX].astype(np.int64) + int(rebase))


def _decode_vec(wm, wd, n, rebase=0) -> Optional[ReplayBatch]:
    _types, idxs = _client_rows(wm, n)
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

    def append(self, entry) -> None:
        self._materialize()
        self._flat.append(entry)

    def extend(self, entries) -> None:
        self._materialize()
        self._flat.extend(entries)

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

    def __ne__(self, other):
        return not self.__eq__(other)

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


def stream_copy(stream) -> LazyReplayStream:
    """A donor's replay stream as a fresh lazy stream for a recipient:
    the copy diverges from the donor's from here on and stays
    batch-appendable. A lazy donor is copied structurally (batches are
    immutable, so sharing them is safe, and a later donor
    ``_materialize`` cannot reach into the copy)."""
    if isinstance(stream, LazyReplayStream):
        out = LazyReplayStream(stream._flat)
        out._tail = list(stream._tail)
        out._tail_n = stream._tail_n
        return out
    return LazyReplayStream(list(stream))


def extend_stream(stream, batch: ReplayBatch) -> None:
    """Append a decoded batch to a replay stream: batched onto a
    :class:`LazyReplayStream`, tuple-extended onto the plain list a
    recovery path may have left in the slot."""
    if isinstance(stream, LazyReplayStream):
        stream.append_batch(batch)
    else:
        stream.extend(batch.tuples())


# ---------------------------------------------------------------------------
# replay/ack planning (the driver's per-connection release)
# ---------------------------------------------------------------------------

def replay_plan(seg, own_mask: np.ndarray, want_ops: bool = True
                ) -> Tuple[int, List[Tuple[int, int, bytes]]]:
    """One window's apply plan: ``(own_max, ops)`` where ``own_max``
    is the highest req of this replica's OWN entries (-1 when none —
    the ack-release frontier) and ``ops`` is the remote replay
    sequence with consecutive same-connection SENDs coalesced into one
    ``(SEND, conn, joined_payload)`` op — byte-stream identical to the
    per-entry loop (own entries never break a run; any non-SEND does).
    ``seg`` is a :class:`ReplayBatch`. ``want_ops=False`` (a dirty or
    absent app: nothing will be replayed) returns only the ack
    frontier."""
    if not want_ops:
        own_idx = np.flatnonzero(own_mask)
        return (int(seg.reqs[own_idx[-1]]) if own_idx.size else -1,
                [])
    if VECTORIZED:
        return _plan_vec(seg, own_mask)
    return _plan_scalar(seg, own_mask)


def _plan_scalar(seg, own_mask):
    """The per-entry release loop, as a pure plan: the bit-identity
    reference."""
    own_max = -1
    ops: list = []
    run_conn = -1
    run_parts: list = []

    def flush():
        nonlocal run_conn, run_parts
        if run_conn >= 0 and run_parts:
            ops.append((int(EntryType.SEND), run_conn,
                        b"".join(run_parts)))
        run_conn, run_parts = -1, []

    for i, (etype, conn, req, payload) in enumerate(seg.tuples()):
        if not own_mask[i]:
            if etype == int(EntryType.SEND):
                if conn != run_conn:
                    flush()
                    run_conn = conn
                run_parts.append(payload)
            else:
                flush()
                ops.append((etype, conn, payload))
        else:
            own_max = req
    flush()
    return own_max, ops


def _plan_vec(seg, own_mask):
    own_idx = np.flatnonzero(own_mask)
    own_max = int(seg.reqs[own_idx[-1]]) if own_idx.size else -1
    rem = np.flatnonzero(~own_mask)
    if not rem.size:
        return own_max, []
    t_r = seg.types[rem]
    c_r = seg.conns[rem]
    l_r = seg.lens[rem]
    if rem.size == len(seg):
        blob_r, off_r = seg.blob, seg.offs
    else:
        src = np.frombuffer(seg.blob, np.uint8)
        pos = np.repeat(seg.offs[rem], l_r) + ragged_arange(l_r)
        blob_r = src[pos].tobytes()
        off_r = np.zeros(rem.size + 1, np.int64)
        np.cumsum(l_r, out=off_r[1:])
    is_send = t_r == int(EntryType.SEND)
    brk = np.empty(rem.size, bool)
    brk[0] = True
    if rem.size > 1:
        brk[1:] = (~is_send[1:] | ~is_send[:-1]
                   | (c_r[1:] != c_r[:-1]))
    starts = np.flatnonzero(brk)
    ends = np.append(starts[1:], rem.size)
    return own_max, [
        (int(t_r[s]), int(c_r[s]),
         blob_r[off_r[s]:off_r[e]])
        for s, e in zip(starts, ends)]


def plan_segment(seg, own_of, want_ops: bool = True
                 ) -> Tuple[int, list, int]:
    """Plan one stream segment (a ReplayBatch, or the plain tuple list
    that :meth:`LazyReplayStream.segments_from` yields for the entries a
    reader already materialized or a converted snapshot seeded): returns ``(own_max, ops,
    n_remote)``. ``own_of(conns, gens)`` maps the columns to the
    own-entry boolean mask; ``want_ops=False`` skips building the
    replay ops (see :func:`replay_plan`)."""
    if isinstance(seg, ReplayBatch):
        own = own_of(seg.conns, seg.gens)
        own_max, ops = replay_plan(seg, own, want_ops)
        return own_max, ops, int(len(seg) - own.sum())
    # plain tuples: wrap them into a batch so the one plan implementation serves both
    n = len(seg)
    if not n:
        return -1, [], 0
    types = np.fromiter((e[0] for e in seg), np.int32, n)
    conns = np.fromiter((e[1] for e in seg), np.int32, n)
    reqs = np.fromiter((e[2] for e in seg), np.int32, n)
    lens = np.fromiter((len(e[3]) for e in seg), np.int64, n)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    batch = ReplayBatch(types, conns, reqs, np.zeros(n, np.int32),
                        lens, b"".join(e[3] for e in seg), offs)
    own = own_of(batch.conns, batch.gens)
    own_max, ops = replay_plan(batch, own, want_ops)
    return own_max, ops, int(n - own.sum())


__all__ = [
    "LazyReplayStream", "ReplayBatch", "VECTORIZED", "decode_batch",
    "extend_stream", "frames_from_cols", "pack_window", "plan_segment",
    "ragged_arange", "replay_plan", "set_vectorized", "stream_copy",
]
