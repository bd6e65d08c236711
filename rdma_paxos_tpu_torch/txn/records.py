"""Log-record wire format of the 2PC commit lane.

The port's copy of the JAX package's ``txn/records.py`` (numpy only;
``tests/test_torch_hygiene.py`` pins its constants against the
reference). The coordinator and the commit lane that write these
records are not ported (ROADMAP Queue 1, item 13); the chaos
serializability checker and the KVS fold read them.

Transaction records ride SEND entries through the SAME replicated log
as KVS commands, but at a DISTINCT payload width — the state-machine
fold dispatches on width, so a legacy fold (or any non-KVS consumer)
skips them without decoding. Layout (int32 words, little-endian):

    [txn_op][tid][arg][kvs_cmd CMD_W words]        TXN_CMD_W = 20

* ``PREPARE``: ``arg`` = 0; the embedded ``kvs_cmd`` is ONE staged
  write of transaction ``tid`` on this group. The fold BUFFERS it per
  tid — nothing touches the table until the commit record lands, so
  an aborted transaction leaves no partial writes by construction.
* ``COMMIT``: ``arg`` = the participant-group bitmask (G <= 32 — the
  strict-serializability checker's atomicity witness: a commit seen
  in one group's log must appear in every masked group's log);
  embedded command unused. The fold applies ``tid``'s buffered writes
  in staging order, then drops the buffer.
* ``ABORT``: ``arg`` = an abort-reason code (host telemetry only);
  the fold drops the buffer unapplied.
* ``MERGE``: one mergeable fast-path write; ``arg`` =
  how many merge records its transaction submits to THIS group. The
  fold applies the embedded command immediately (commutative — no
  staging) and retires the tid's dedup memory once all ``arg``
  records have folded, so the fast path stays coordination-free AND
  leaves no per-record registry residue.

Exactly-once for ALL of these is per tid, not per session: every
record's ``(conn, req)`` stamp is unique, the fold remembers only the
reqs of live tids, and a tid's memory is dropped with its decision
(or last merge record).
"""

from __future__ import annotations

import numpy as np

from rdma_paxos_tpu_torch.models.kvs import CMD_W, encode_cmd

TXN_PREPARE, TXN_COMMIT, TXN_ABORT, TXN_MERGE = 1, 2, 3, 4
TXN_CMD_W = 3 + CMD_W

# ABORT-record reason codes (mirrors the txn_aborted_total labels).
# TOPOLOGY: the key→group mapping of a participant key moved while the
# transaction was in flight (an elastic split/merge cutover bumped the
# router epoch) — locking or committing against the stale group would
# write state the new routing never serves, so the coordinator aborts
# deterministically instead.
ABORT_CONFLICT, ABORT_TIMEOUT, ABORT_FAILOVER, ABORT_TOPOLOGY = 1, 2, 3, 4


def encode_prepare(tid: int, op: int, key: bytes,
                   val: bytes = b"") -> bytes:
    """One staged write of ``tid`` (this group's share of the txn)."""
    return np.concatenate([
        np.array([TXN_PREPARE, tid, 0], "<i4"),
        encode_cmd(op, key, val)]).astype("<i4").tobytes()


def encode_commit(tid: int, participant_mask: int) -> bytes:
    return np.concatenate([
        np.array([TXN_COMMIT, tid, participant_mask], "<i4"),
        np.zeros(CMD_W, "<i4")]).astype("<i4").tobytes()


def encode_abort(tid: int, reason: int) -> bytes:
    return np.concatenate([
        np.array([TXN_ABORT, tid, reason], "<i4"),
        np.zeros(CMD_W, "<i4")]).astype("<i4").tobytes()


def encode_merge(tid: int, n_of: int, op: int, key: bytes,
                 val: bytes = b"") -> bytes:
    """One mergeable fast-path write of ``tid`` on this group;
    ``n_of`` = the transaction's total merge-record count here (the
    fold's retire trigger)."""
    return np.concatenate([
        np.array([TXN_MERGE, tid, n_of], "<i4"),
        encode_cmd(op, key, val)]).astype("<i4").tobytes()


def decode_record(payload: bytes):
    """``(txn_op, tid, arg, kvs_cmd_words)`` of a TXN_CMD_W payload."""
    words = np.frombuffer(payload, "<i4")
    return (int(words[0]), int(words[1]), int(words[2]), words[3:])
