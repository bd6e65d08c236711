"""Client surface of the transaction subsystem.

The port's copy of the JAX package's ``txn/api.py`` (host-only).

``transact()`` (also exposed as ``ShardedKVS.transact``) admits one
multi-key transaction against the attached coordinator and returns a
:class:`TxnHandle`. Ops are named strings mapped to the state-machine
op codes — plain writes (``put``/``rm``) take the 2PC commit lane;
mergeable writes (``incr``/``sadd``/``max``) with integer operands
take the coordination-free fast path when the WHOLE write set is
mergeable. Exactly-once rides the coordinator's stamped ``(conn,
req)`` records — a retried record commits at most once per group, the
same session dedup rule every client write already obeys.

The handle is asynchronous: the coordinator advances off the cluster's
finish() tail, so callers pump protocol steps (or run under a driver)
and poll ``handle.done`` / call ``handle.wait(pump)``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from rdma_paxos_tpu_torch.models.kvs import OP_PUT, OP_RM
from rdma_paxos_tpu_torch.txn import merge as _merge

_NAMED_OPS = {"put": OP_PUT, "rm": OP_RM}


class TxnHandle:
    """Client view of one admitted transaction."""

    def __init__(self, txn):
        self._txn = txn

    @property
    def tid(self) -> int:
        return self._txn.tid

    @property
    def state(self) -> str:
        return self._txn.state

    @property
    def done(self) -> bool:
        return self._txn.done

    @property
    def committed(self) -> bool:
        return self._txn.committed

    @property
    def abort_reason(self) -> Optional[str]:
        return self._txn.reason

    @property
    def reads(self) -> dict:
        """Read-set values fetched at the serialization point (commit
        decision time, under the participant locks)."""
        return dict(self._txn.reads)

    def wait(self, pump, max_steps: int = 256) -> bool:
        """Drive ``pump()`` (one protocol step) until the transaction
        decides; returns ``committed``. Raises after ``max_steps``
        pumps without a decision."""
        for _ in range(max_steps):
            if self.done:
                return self.committed
            pump()
        if not self.done:
            raise TimeoutError(
                f"txn {self.tid} undecided after {max_steps} pumps "
                f"(state={self.state})")
        return self.committed


def _encode_write(op_name: str, key: bytes, val) -> Tuple[int, bytes,
                                                          bytes]:
    op = _NAMED_OPS.get(op_name)
    if op is not None:
        return op, key, (val if isinstance(val, bytes) else b"")
    entry = _merge.MERGE_FNS.get(op_name)
    if entry is None:
        raise ValueError(f"unknown txn op {op_name!r}")
    code = entry[0]
    if isinstance(val, bytes):
        return code, key, val
    return code, key, _merge.encode_merge_val(code, int(val))


def transact(kvs, writes: Sequence[Tuple[str, bytes, object]],
             reads: Sequence[bytes] = ()) -> TxnHandle:
    """Admit one transaction on ``kvs`` (a ShardedKVS whose cluster
    has a coordinator attached). ``writes`` are ``(op_name, key,
    value)`` triples — op_name in {put, rm, incr, sadd, max}; integer
    values of mergeable ops are packed automatically. ``reads`` are
    keys whose values are captured at the serialization point."""
    coord = getattr(kvs.shard, "txn", None)
    if coord is None:
        raise RuntimeError(
            "no coordinator attached — call "
            "txn.attach_coordinator(kvs) first (requires a txn=True "
            "cluster)")
    encoded = [_encode_write(name, key, val)
               for name, key, val in writes]
    return TxnHandle(coord.begin(encoded, reads))
