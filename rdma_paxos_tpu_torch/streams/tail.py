"""Tail-follower core — positioned record reads over the committed
replay streams.

The port's copy of the JAX package's ``streams/tail.py``.

The engines already replay every committed client entry into per
replica ``LazyReplayStream``s (runtime/hostpath.py): an ordered,
append-only, prefix-identical-across-replicas event stream. This
module opens that stream as a consumable product: a
:class:`GroupTail` snapshots one group's stream under the engine host
lock and decodes it into :class:`Record`s carrying the log's OWN
coordinates — ``(term, absolute index)`` from the decode-time meta
columns (``ReplayBatch.terms``/``gidx``) — plus the stream POSITION,
which is stable across leader failover and i32 rebases (the committed
prefix never shrinks and rebase renumbers slots, not stream entries).

All three serving surfaces (scan cuts, watch resume tokens, CDC
records) are built on these two coordinate systems: positions anchor
host-side cursors and consistent cuts; ``(term, index)`` names the
same entry in the AuditLedger's coordinates for cross-host and
cross-artifact verification.

Host-pure: this module never imports torch or numpy.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from rdma_paxos_tpu_torch.consensus.log import EntryType

# KVS command byte layout — pinned to the state machine's codec
# (models/kvs.py: CMD_W = 1 + KEY_W + VAL_W i32 words). Redeclared
# here so the host-pure streams plane never imports the device
# state-machine module; tests/test_torch_hygiene.py pins the equality.
KEY_BYTES = 32
VAL_BYTES = 32
CMD_BYTES = 4 + KEY_BYTES + VAL_BYTES
OP_PUT, OP_GET, OP_RM = 1, 2, 3

_SEND = int(EntryType.SEND)


def decode_kvs(payload: bytes) -> Optional[Tuple[int, bytes, bytes]]:
    """``(op, key, val)`` of a KVS command payload, or None when the
    payload is not one (wrong size — the same length gate the apply
    fold uses). Key/value unpadding mirrors ``models.kvs.decode_val``
    (trailing NULs stripped)."""
    if len(payload) != CMD_BYTES:
        return None
    op = int.from_bytes(payload[0:4], "little", signed=True)
    key = payload[4:4 + KEY_BYTES].rstrip(b"\x00")
    val = payload[4 + KEY_BYTES:CMD_BYTES].rstrip(b"\x00")
    return op, key, val


class Record:
    """One committed client entry with its log coordinates. ``term``
    and ``index`` are -1 for entries whose batch coordinates were lost
    to a legacy tuple materialization (cold paths only — the live
    decode always carries them)."""

    __slots__ = ("group", "term", "index", "etype", "conn", "req",
                 "payload", "pos")

    def __init__(self, group: int, term: int, index: int, etype: int,
                 conn: int, req: int, payload: bytes, pos: int):
        self.group = group
        self.term = term
        self.index = index      # absolute log index (rebase-corrected)
        self.etype = etype
        self.conn = conn
        self.req = req
        self.payload = payload
        self.pos = pos          # stream position (failover-stable)

    def __repr__(self) -> str:
        return (f"Record(g={self.group} t={self.term} i={self.index} "
                f"e={self.etype} c={self.conn} q={self.req} "
                f"pos={self.pos})")


class DedupFold:
    """The app fold's exactly-once acceptance rule, mirrored for
    stream consumers (``ReplicatedKVS._fold``): only SEND entries of
    command size count; stamped entries (``conn > 0 and req > 0``)
    are accepted once per ``(conn, req)`` high-water mark — a
    retransmitted duplicate occupying a later log slot is skipped
    exactly like the app skips it."""

    def __init__(self):
        self.last_req = {}
        self.deduped = 0

    def accept(self, rec: Record) -> bool:
        if rec.etype != _SEND or len(rec.payload) != CMD_BYTES:
            return False
        if rec.req > 0 and rec.conn > 0:
            if rec.req <= self.last_req.get(rec.conn, 0):
                self.deduped += 1
                return False
            self.last_req[rec.conn] = rec.req
        return True


def _group_streams(cluster, group: int):
    """The per-replica replay streams of ``group`` — the sharded
    engine nests them as ``replayed[g][r]``; SimCluster is flat
    ``[r]`` (branch on engine shape, never on the group count)."""
    rep = cluster.replayed
    if hasattr(cluster, "G"):
        rep = rep[group]
    return rep


class GroupTail:
    """Position-cursor reader over ONE group's committed stream.

    Replicas' streams are prefix-identical (they replay the same
    committed prefix), so positions are replica-independent — the
    tail always reads from whichever replica has applied the most
    (quarantined or lagging replicas simply aren't the longest).
    Snapshots take the engine host lock; decode happens outside it
    (segments are immutable batches plus list-slice copies).
    """

    def __init__(self, cluster, group: int = 0):
        self._cluster = cluster
        self.group = int(group)

    def length(self) -> int:
        """Longest replica stream length — cheap (``__len__`` never
        materializes a lazy stream)."""
        return max((len(s) for s in
                    _group_streams(self._cluster, self.group)),
                   default=0)

    def snapshot(self, lo: int, hi: Optional[int] = None):
        """``(segments, n)`` covering positions ``[lo, min(hi, len))``
        of the longest stream, snapshotted under the engine host lock
        (appends happen under it on the readback thread)."""
        with self._cluster._host_lock:
            streams = _group_streams(self._cluster, self.group)
            best, best_len = None, 0
            for s in streams:
                if len(s) > best_len:
                    best, best_len = s, len(s)
            end = best_len if hi is None else min(int(hi), best_len)
            if best is None or lo >= end:
                return [], 0
            if hasattr(best, "segments_from"):
                segs = best.segments_from(lo)
            else:                       # plain list (tests, recovery)
                segs = [list(best[lo:])]
        return segs, end - lo

    def records(self, lo: int, hi: Optional[int] = None
                ) -> List[Record]:
        """Decode positions ``[lo, hi)`` (``hi`` None = current end)
        into :class:`Record`s."""
        segs, n = self.snapshot(lo, hi)
        out: List[Record] = []
        pos = lo
        g = self.group
        for seg in segs:
            if n <= 0:
                break
            if isinstance(seg, list):
                for etype, conn, req, payload in seg:
                    if n <= 0:
                        break
                    out.append(Record(g, -1, -1, int(etype),
                                      int(conn), int(req), payload,
                                      pos))
                    pos += 1
                    n -= 1
                continue
            t, c, q, o, b = (seg.types, seg.conns, seg.reqs, seg.offs,
                             seg.blob)
            terms, gidx = seg.terms, seg.gidx
            take = min(len(seg), n)
            for i in range(take):
                out.append(Record(
                    g,
                    -1 if terms is None else int(terms[i]),
                    -1 if gidx is None else int(gidx[i]),
                    int(t[i]), int(c[i]), int(q[i]),
                    b[o[i]:o[i + 1]], pos))
                pos += 1
            n -= take
        return out
