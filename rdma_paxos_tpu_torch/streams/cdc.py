"""CDC export — digest-verified JSONL change-data-capture.

The port's copy of the JAX package's ``streams/cdc.py``: an export
of either package verifies under either package's ``verify``.

A :class:`CDCWriter` drains committed client entries into an external
JSONL sink in the ops plane's concat-mergeable style (one
self-describing record per line; per-host files merge by concat, the
same convention as ``replica<me>.series.jsonl``). Every record
carries:

* the audit chain's coordinates — ``(group, term, absolute index)``;
* the raw entry — etype/conn/req plus the payload hex;
* a running per-group FNV-1a **chain** over the canonical record
  bytes (each link folds the previous link in, so flipping one
  exported byte breaks every later link);
* the AuditLedger's **window digest** for the index, when the ledger
  retains it (the device-side fold covers full slot rows, so an
  exporter cannot recompute it — carrying it ties the export to the
  quorum-compared digest record).

``python -m rdma_paxos_tpu_torch.streams verify EXPORT [AUDIT...]`` proves
an export end-to-end: per-group strictly-increasing indices (client
entries never share a slot; NOOP/CONFIG legitimately occupy the
index gaps), chain recomputation, and — against one or more ledger
dumps — term + digest agreement per retained index. The first bad
record is named by its ``(term, index)`` and the process exits 1.

Host-pure; single-writer by design (the watch pump thread or the
NodeDaemon apply loop), so the only lock is around flush/close.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List, Optional, Tuple

_FNV_OFF = 2166136261
_FNV_PRIME = 16777619
_MASK = 0xFFFFFFFF


def _fnv1a(data: bytes, h: int = _FNV_OFF) -> int:
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK
    return h


def chain_link(prev: int, group: int, term: int, index: int,
               etype: int, conn: int, req: int,
               payload: bytes) -> int:
    """One chain link: FNV-1a over the previous link plus the
    record's canonical field encoding."""
    head = b"%d|%d|%d|%d|%d|%d|" % (group, term, index, etype, conn,
                                    req)
    return _fnv1a(payload, _fnv1a(head, _fnv1a(
        prev.to_bytes(4, "little"))))


class CDCWriter:
    """Append-only JSONL exporter (see module doc). ``write_batch``
    consumes a decoded ``ReplayBatch`` (the NodeDaemon apply loop);
    ``write_records`` consumes :class:`~...tail.Record`s (the hub
    pump). Both stamp the running chain and the ledger digest."""

    def __init__(self, path: str, *, auditor=None, obs=None,
                 group: int = 0):
        self.path = path
        self.auditor = auditor
        self.obs = obs
        self.default_group = int(group)
        self._chain = {}          # group -> last link value
        self._count = {}          # group -> records written
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")

    def _digest_for(self, group: int, index: int
                    ) -> Tuple[Optional[int], Optional[int]]:
        if self.auditor is None or index < 0:
            return None, None
        ent = self.auditor.digest_at(group, index)
        if ent is None:
            return None, None
        return int(ent[0]), int(ent[1])     # (term, digest)

    def _emit(self, group: int, term: int, index: int, etype: int,
              conn: int, req: int, payload: bytes) -> None:
        prev = self._chain.get(group, 0)
        link = chain_link(prev, group, term, index, etype, conn, req,
                          payload)
        self._chain[group] = link
        dterm, digest = self._digest_for(group, index)
        rec = dict(group=group, term=term, index=index, etype=etype,
                   conn=conn, req=req, payload=payload.hex(),
                   chain=link)
        if digest is not None:
            rec["digest"] = digest
            rec["dterm"] = dterm
        self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._count[group] = self._count.get(group, 0) + 1
        if self.obs is not None:
            self.obs.metrics.inc("cdc_exported_total", group=group)

    def write_records(self, group: int, records: Iterable) -> None:
        for r in records:
            self._emit(group, r.term, r.index, r.etype, r.conn,
                       r.req, r.payload)

    def write_batch(self, batch, *, group: Optional[int] = None
                    ) -> None:
        g = self.default_group if group is None else int(group)
        t, c, q, o, b = (batch.types, batch.conns, batch.reqs,
                         batch.offs, batch.blob)
        terms, gidx = batch.terms, batch.gidx
        for i in range(len(batch)):
            self._emit(
                g,
                -1 if terms is None else int(terms[i]),
                -1 if gidx is None else int(gidx[i]),
                int(t[i]), int(c[i]), int(q[i]), b[o[i]:o[i + 1]])

    def exported(self, group: int) -> int:
        return self._count.get(group, 0)

    def flush(self) -> None:
        if not self._f.closed:
            self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


# ---------------------------------------------------------------------------
# verification
# ---------------------------------------------------------------------------

def _ledger_index(dumps: List[dict]) -> dict:
    """``(group, index) -> (term, digest)`` from one or more
    AuditLedger dumps (``AuditLedger.dump()`` documents — merged
    per-replica files welcome; identical indices must agree, which
    the ledger's own merge already enforced)."""
    out = {}
    for doc in dumps:
        audit = doc.get("audit", doc)   # artifact wrapper or raw dump
        for grp in audit.get("groups", []):
            g = int(grp["group"])
            for si, ent in grp.get("indices", {}).items():
                out[(g, int(si))] = (int(ent[0]), int(ent[1]))
    return out


def verify_export(path: str, ledger_dumps: Optional[List[dict]] = None
                  ) -> dict:
    """Verify a CDC export file. Returns
    ``{ok, records, checked_digests, error, bad}`` where ``bad`` is
    ``(term, index)`` of the FIRST failing record (None when ok).

    Checks, in order per record: JSON well-formedness; per-group
    strictly increasing indices (gaps are legal — non-client entries
    occupy them); chain recomputation from the canonical fields; and,
    when ledger dumps are given, term/digest agreement for every
    index the ledger retains."""
    ledger = _ledger_index(ledger_dumps or [])
    chain = {}
    last_idx = {}
    n = 0
    checked = 0

    def bad(rec, why):
        return dict(ok=False, records=n, checked_digests=checked,
                    error=why,
                    bad=(int(rec.get("term", -1)),
                         int(rec.get("index", -1))))

    with open(path, "r", encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                return dict(ok=False, records=n,
                            checked_digests=checked,
                            error=f"line {ln}: malformed JSON",
                            bad=(-1, -1))
            n += 1
            g = int(rec["group"])
            idx = int(rec["index"])
            term = int(rec["term"])
            if idx >= 0:
                prev_i = last_idx.get(g)
                if prev_i is not None and idx <= prev_i:
                    return bad(rec,
                               f"line {ln}: index {idx} not above "
                               f"previous {prev_i} in group {g}")
                last_idx[g] = idx
            try:
                payload = bytes.fromhex(rec["payload"])
            except ValueError:
                return bad(rec, f"line {ln}: bad payload hex")
            want = chain_link(chain.get(g, 0), g, term, idx,
                              int(rec["etype"]), int(rec["conn"]),
                              int(rec["req"]), payload)
            if want != int(rec["chain"]):
                return bad(rec,
                           f"line {ln}: chain mismatch (record "
                           f"{int(rec['chain'])} != recomputed "
                           f"{want})")
            chain[g] = want
            ent = ledger.get((g, idx))
            if ent is not None:
                lterm, ldig = ent
                if term != lterm:
                    return bad(rec,
                               f"line {ln}: term {term} != ledger "
                               f"term {lterm} at index {idx}")
                if "digest" in rec and int(rec["digest"]) != ldig:
                    return bad(rec,
                               f"line {ln}: digest "
                               f"{int(rec['digest'])} != ledger "
                               f"{ldig} at index {idx}")
                checked += 1
    return dict(ok=True, records=n, checked_digests=checked,
                error=None, bad=None)
