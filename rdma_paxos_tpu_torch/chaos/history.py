"""Client-operation history recorder — the Jepsen-history analog.

The port's copy of the JAX package's ``chaos/history.py`` (standard library
and numpy only).

``ReplicatedKVS`` promises a client-visible contract (linearizable
PUT/RM/read-index GET, dedup across failover); nothing before this
module ever RECORDED what clients observed, so nothing could check the
contract. This recorder captures the full operation history as typed
events over LOGICAL step time (set by the nemesis runner per step — no
wall clocks, so the same seed yields a byte-identical history):

* ``invoke`` — a client issued an op (PUT/RM get a ``(client,
  req_id)`` stamp; reads carry the serving replica and a ``weak``
  flag);
* ``ok`` — the op completed with a result (write observed committed,
  read returned);
* ``fail`` — the op definitively did NOT take effect (e.g. a
  linearizable read refused because leadership was unverified);
* ``timeout`` — fate unknown: the checker must treat the op as
  AMBIGUOUS (it may or may not have taken effect, at any point after
  its invocation);
* ``retransmit`` — the client (or the network duplicating its
  message) re-sent an already-stamped request; recorded so a
  reproducer shows exactly which duplicates were in flight.

Values are arbitrary bytes; JSONL serialization uses latin-1 (a
lossless byte↔str bijection), so dumps round-trip exactly.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

INVOKE, OK, FAIL, TIMEOUT, RETRANSMIT = (
    "invoke", "ok", "fail", "timeout", "retransmit")


def _enc(b: Optional[bytes]) -> Optional[str]:
    return None if b is None else b.decode("latin-1")


def _dec(s: Optional[str]) -> Optional[bytes]:
    return None if s is None else s.encode("latin-1")


class HistoryRecorder:
    """Append-only event list + per-op aggregation for the checker."""

    def __init__(self):
        self.events: List[dict] = []
        self._clock = 0
        # op_id -> mutable op record (the checker's unit)
        self._ops: Dict[int, dict] = {}
        # (client_id, req_id) -> op_id for write-completion matching
        self._by_req: Dict[tuple, int] = {}

    # ---------------- clock (logical, runner-driven) ----------------

    def set_clock(self, step: int) -> None:
        self._clock = int(step)

    # ---------------- recording ----------------

    def invoke(self, op: str, key: bytes, value: Optional[bytes] = None,
               *, client: int = 0, req_id: int = 0,
               replica: int = -1, weak: bool = False) -> int:
        op_id = len(self._ops)
        rec = dict(op_id=op_id, op=op, key=_enc(key), value=_enc(value),
                   client=client, req_id=req_id, replica=replica,
                   weak=weak, inv=self._clock, res=None, status=None,
                   out=None)
        self._ops[op_id] = rec
        if req_id > 0 and client > 0:
            self._by_req[(client, req_id)] = op_id
        self.events.append(dict(t=self._clock, ev=INVOKE, **{
            k: rec[k] for k in ("op_id", "op", "key", "value", "client",
                                "req_id", "replica", "weak")}))
        return op_id

    def _complete(self, op_id: int, status: str,
                  out: Optional[bytes] = None, **extra) -> None:
        rec = self._ops[op_id]
        if rec["status"] is not None:
            return                      # first completion wins
        rec["status"] = status
        rec["res"] = self._clock
        rec["out"] = _enc(out)
        self.events.append(dict(t=self._clock, ev=status, op_id=op_id,
                                out=_enc(out), **extra))

    def ok(self, op_id: int, out: Optional[bytes] = None) -> None:
        self._complete(op_id, OK, out)

    def fail(self, op_id: int, reason: str = "") -> None:
        self._complete(op_id, FAIL, reason=reason)

    def timeout(self, op_id: int) -> None:
        self._complete(op_id, TIMEOUT)

    def retransmit(self, op_id: int, replica: int = -1,
                   network_dup: bool = False) -> None:
        self.events.append(dict(t=self._clock, ev=RETRANSMIT,
                                op_id=op_id, replica=replica,
                                network_dup=network_dup))

    # ---------------- queries ----------------

    def op_id_for(self, client: int, req_id: int) -> Optional[int]:
        return self._by_req.get((client, req_id))

    def op(self, op_id: int) -> dict:
        return self._ops[op_id]

    def pending(self) -> List[int]:
        """Op ids with no completion event yet (at run end the runner
        times them out — fate unknown)."""
        return [i for i, rec in sorted(self._ops.items())
                if rec["status"] is None]

    def ops(self, *, include_weak: bool = False) -> List[dict]:
        """Completed-or-ambiguous op records for the linearizability
        checker, in op_id order: each has ``op/key/value/out/inv/res/
        status``; ``res is None`` (timeout) means ambiguous. Weak reads
        are excluded by default — they are recorded evidence, not part
        of the linearizable contract.

        TIMEOUT ops are exported with ``res=None`` — the checker's
        ambiguity key — even though the raw event (and the internal
        record) keeps the give-up clock as evidence. The recorder used
        to leak that clock into ``res``, which silently made every
        timed-out write a DEFINITE op bounded by the moment the client
        gave up: stricter than the documented contract ("fate unknown
        — may take effect at any later point, or never"), and a false
        violation the moment a later read observed the pre-timeout
        value after the give-up time (surfaced by the long-interval
        read-index reads of the read-scaling chaos mix)."""
        out = []
        for i in sorted(self._ops):
            rec = self._ops[i]
            if rec["weak"] and not include_weak:
                continue
            rec = dict(rec)
            if rec["status"] == TIMEOUT:
                rec["res"] = None
            out.append(rec)
        return out

    def __len__(self) -> int:
        return len(self.events)

    # ---------------- serialization ----------------

    def to_jsonl(self) -> str:
        return "\n".join(json.dumps(e, sort_keys=True)
                         for e in self.events)

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_jsonl())
        return path

    @classmethod
    def from_jsonl(cls, text: str) -> "HistoryRecorder":
        """Rebuild a recorder (events + op records) from a dump — the
        reproducer-replay path re-checks a persisted history without
        re-running the cluster."""
        h = cls()
        for line in text.splitlines():
            if not line.strip():
                continue
            e = json.loads(line)
            h.events.append(e)
            if e["ev"] == INVOKE:
                h._ops[e["op_id"]] = dict(
                    op_id=e["op_id"], op=e["op"], key=e["key"],
                    value=e["value"], client=e["client"],
                    req_id=e["req_id"], replica=e["replica"],
                    weak=e["weak"], inv=e["t"], res=None, status=None,
                    out=None)
                if e["req_id"] > 0 and e["client"] > 0:
                    h._by_req[(e["client"], e["req_id"])] = e["op_id"]
            elif e["ev"] in (OK, FAIL, TIMEOUT):
                rec = h._ops[e["op_id"]]
                if rec["status"] is None:
                    rec["status"] = e["ev"]
                    rec["res"] = e["t"]
                    rec["out"] = e.get("out")
        return h
