"""Mergeable-op fast path — SafarDB-style coordination-free commits.

The port's copy of the JAX package's ``txn/merge.py`` (host-only;
``tests/test_torch_hygiene.py`` pins it against the reference).

A cross-group transaction whose writes are ALL mergeable needs no
prepare phase: each op is a commutative, associative fold into the
current value (``models/kvs.py`` ops 4-6), so per-group entries commit
independently in ANY interleaving and converge to the same state — the
replicated-data-type argument of SafarDB (arXiv:2603.08003). The
coordinator detects this shape and submits one stamped MERGE record
per write (``txn/records.py``) instead of the PREPARE/COMMIT record
pair; the fold applies a MERGE the moment it commits — no staging, no
votes. Atomicity demotes to eventual all-or-nothing via the retry
rule (every record is retried under its original ``(conn, req)``
until committed, deduped per tid by the fold), which is exactly the
guarantee merges need — there is no intermediate state a reader could
tear.

Host-side helpers only — device folds live in ``models/kvs.py``.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

from rdma_paxos_tpu_torch.models.kvs import OP_INCR, OP_MAX, OP_SADD, VAL_W

#: op name -> (op code, host fold used by tests/bench to predict state)
MERGE_FNS: Dict[str, Tuple[int, object]] = {
    "incr": (OP_INCR, lambda a, b: a + b),
    "sadd": (OP_SADD, lambda a, b: a | b),
    "max": (OP_MAX, max),
}

_MERGE_OPS = frozenset(code for code, _ in MERGE_FNS.values())


def is_mergeable(op: int) -> bool:
    return op in _MERGE_OPS


def encode_merge_val(op: int, value: int) -> bytes:
    """Pack a host integer operand into value words. The device folds
    are per-i32-LANE (``base + val`` elementwise, no carry between
    words), so INCR/MAX operands are a signed i32 in word 0 only; SADD
    sets one bit (``value`` mod the 256 value bits) of the lane
    bitset."""
    if op == OP_SADD:
        bit = value % (VAL_W * 32)
        words = [0] * VAL_W
        words[bit // 32] = 1 << (bit % 32)
        return struct.pack(f"<{VAL_W}i", *[
            w - (1 << 32) if w >= (1 << 31) else w for w in words])
    return struct.pack("<i", value) + b"\x00" * ((VAL_W - 1) * 4)


def decode_merge_val(op: int, raw: bytes) -> int:
    """Inverse of :func:`encode_merge_val` over a table read: the i32
    lane-0 counter value, or the popcount of the SADD bitset."""
    buf = raw.ljust(VAL_W * 4, b"\x00")
    if op == OP_SADD:
        return bin(int.from_bytes(buf, "little", signed=False)).count("1")
    return struct.unpack_from("<i", buf)[0]


def mergeable_plan(writes) -> bool:
    """True when EVERY write of a transaction is mergeable — the
    coordinator's fast-path admission test. ``writes`` is the
    transact() write set: ``(op, key, val_bytes)`` triples."""
    return bool(writes) and all(is_mergeable(op) for op, _k, _v in writes)
