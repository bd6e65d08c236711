"""Silent-divergence auditing — cluster audit ledger, flight recorder,
audit artifacts, and the first-divergence CLI.

The port's copy of the JAX package's ``obs/audit.py`` (numpy and the
standard library only; ``tests/test_torch_hygiene.py`` pins
``AUDIT_KEYS`` and ``DIGEST_EPOCH`` against the reference, and
``tests/test_torch_audit.py`` holds its dumps equal to the reference's).

The followers of this design are passive in the replication hot path:
the leader's window lands in follower log memory with no
receiver-side check, so silent state divergence is a first-class
failure mode. This module proves, continuously and cheaply, that R
replicas hold bit-identical committed state at matching
``(term, index)`` frontiers, and keeps enough recent history to debug
the step where they stopped. Three parts, all host-side:

* :class:`AuditLedger` — consumes the digest windows the replica step
  emits under ``audit=True`` (one u32 mul-fold checksum per committed
  entry in ``[commit - W, commit)``, see ``consensus/step.py``),
  aligns them across replicas by **absolute** ``(group, term, index)``
  (callers add their ``rebased_total`` so i32 rollovers never tear the
  chain), tolerates frontier skew (comparison is per-index, not
  per-step), and raises a ``DIVERGENCE`` finding naming the first
  mismatching index. A replica's first report of an index is
  cross-checked against the other replicas' digests, and every
  re-report is checked against the replica's own previous window — so
  post-commit bit corruption is caught even by a single-replica ledger.
* :class:`FlightRecorder` — a bounded ring of the last N step
  inputs/outputs + digest heads, dumped into a self-contained audit
  artifact, so the divergence window is inspectable after the fact.
* ``python -m rdma_paxos_tpu_torch.obs.audit`` — merges per-replica
  dumps and prints the first-divergence report; also reads audit
  artifacts and chaos reproducers that embed an audit dump.

Nothing here runs inside the replica step: the digest computation is
the step's ``audit=`` variant, and ``audit=False`` steps are unchanged.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from rdma_paxos_tpu_torch.config import DIGEST_EPOCH
from rdma_paxos_tpu_torch.obs.clock import anchor as clock_anchor

# StepOutput fields emitted by the audit=True replica step — the one
# list every host integration (SimCluster, ShardedCluster,
# HostReplicaDriver) extracts by
AUDIT_KEYS = ("audit_start", "audit_digest", "audit_term")

_SCHEMA = 1


def _mask_bits(mask: int) -> List[int]:
    return [i for i in range(mask.bit_length()) if (mask >> i) & 1]


def _finding_closed(f: dict, repairs: Sequence[dict]) -> bool:
    """A DIVERGENCE finding is closed only when EVERY replica on its
    diverging side has a covering repair record — a multi-replica
    finding (merge mode can name several holders of the same wrong
    digest) must not read 'repaired' after only one of them healed.
    'Covering' means the finding's index lies INSIDE the backfilled
    ``[lo, hi)`` range: an index below ``lo`` (the donor's ring had
    already pruned past it by repair time) was never re-verified, and
    closure is never claimed before it is proven — such a finding
    stays open (CLI exit 1) for the operator. A repair record closes
    only findings detected AT OR BEFORE it (step comparison, when
    both sides carry one): a stale record from an earlier incident
    must never close a LATER re-divergence it cannot have verified."""
    got = f.get("got_replicas", ())

    def covers(r):
        if r["group"] != f.get("group", 0):
            return False
        if not (r["lo"] <= f["index"] < r["hi"]):
            return False
        fs, rs = f.get("step"), r.get("step")
        return fs is None or rs is None or rs >= fs
    return bool(got) and all(
        any(covers(r) for r in repairs if r["replica"] == rr)
        for rr in got)


class AuditLedger:
    """Host-side digest ledger: per-index cross-replica comparison with
    bounded retention and exact first-divergence localization."""

    # findings are bounded too: a persistently corrupt replica would
    # otherwise grow findings/_flagged at commit throughput forever
    # (memory + lock-held summary scans + dump size) while the
    # operator responds to the page. The first MAX_FINDINGS localize
    # the divergence; further finding events only tick
    # ``findings_dropped`` (an EVENT count — post-cap re-reports of
    # the same index are no longer deduplicated, by design).
    MAX_FINDINGS = 256

    def __init__(self, n_replicas: int, n_groups: int = 1, *,
                 history: int = 4096, obs=None,
                 digest_epoch: int = DIGEST_EPOCH):
        self.R = int(n_replicas)
        self.G = int(n_groups)
        self.history = int(history)
        # digest LAYOUT version this ledger compares in
        # (config.DIGEST_EPOCH): windows/dumps stamped with a different
        # epoch are refused with an EPOCH_MISMATCH finding — digests
        # from different fold layouts are incomparable, not unequal
        self.digest_epoch = int(digest_epoch)
        # Observability facade for divergence counters/trace events;
        # may be (re)attached after construction — the engines assign
        # it lazily so driver-attached facades are picked up.
        self.obs = obs
        self._lock = threading.Lock()
        # per group: absolute index -> [term, digest, replica_bitmask]
        self._idx: List[Dict[int, list]] = [dict() for _ in range(self.G)]
        self._max: List[int] = [-1] * self.G
        # per (group, replica): last reported window, for the
        # vectorized self-recheck fast path
        self._lastwin: Dict[Tuple[int, int], tuple] = {}
        self._flagged: set = set()          # (group, index) reported once
        self._epoch_flagged: set = set()    # (group, replica, epoch)
        self.findings: List[dict] = []
        self.findings_dropped = 0           # events suppressed at cap
        self.windows = 0
        self.indices_checked = 0
        self.backfilled = 0                 # indices re-reported as backfill
        # completed repair records (mark_repaired): the audit loop's
        # closure evidence — rides dumps/merges so the CLI can verdict
        # "diverged but repaired + backfilled" with exit 0
        self.repairs: List[dict] = []

    # ---------------- recording ----------------

    def record_window(self, replica: int, start: int, digests, terms,
                      end: int, *, group: int = 0,
                      step: Optional[int] = None,
                      epoch: Optional[int] = None,
                      backfill: bool = False) -> None:
        """``digests``/``terms`` cover absolute indices ``[start,
        end)`` of ``replica``'s committed prefix (rebase-corrected by
        the caller). Re-reported indices are checked against the
        replica's previous window; first reports join the cross-replica
        store.

        ``epoch`` (when given) names the digest LAYOUT the window was
        computed under; a mismatch against this ledger's epoch is an
        ``EPOCH_MISMATCH`` finding and the window is refused — never
        compared, never a false ``DIVERGENCE`` (rolling digest-layout
        upgrades). ``backfill=True`` is the repair pipeline's history
        re-report (range re-digest): the frontier self-recheck is
        skipped — backfill windows arrive out of frontier order by
        design — and every index goes straight to the cross-replica
        store."""
        start, end = int(start), int(end)
        if epoch is not None and int(epoch) != self.digest_epoch:
            self._epoch_mismatch(group, replica, int(epoch), step)
            return
        if end <= start:
            return
        dig = np.asarray(digests)
        if dig.dtype != np.uint32:      # device emits u32; normalize
            dig = dig.astype(np.int64) & 0xFFFFFFFF
        trm = np.asarray(terms)
        with self._lock:
            self.windows += 1
            key = (group, replica)
            prev = None if backfill else self._lastwin.get(key)
            new_from = start
            if prev is not None:
                p_start, p_end, p_dig, p_trm = prev
                if start >= p_start and end >= p_end:
                    lo, hi = max(start, p_start), min(end, p_end)
                    if hi > lo:
                        a = dig[lo - start:hi - start]
                        b = p_dig[lo - p_start:hi - p_start]
                        # digest-only detection (the term column is
                        # FOLDED INTO the digest, so a term flip flips
                        # the digest too); terms are read back only to
                        # label the finding
                        if not np.array_equal(a, b):
                            j = int(np.argmax(a != b))
                            self._diverge(
                                group, lo + j, step, mode="self",
                                got=(int(trm[lo - start + j]),
                                     int(a[j])),
                                got_replicas=[replica],
                                expected=(int(p_trm[lo - p_start + j]),
                                          int(b[j])),
                                expected_replicas=[replica])
                        new_from = max(new_from, hi)
                # else: the window regressed (crash-restart recovery
                # re-reports a lower frontier) — fall through and
                # re-check every index against the cross-replica store
            if not backfill:
                self._lastwin[key] = (start, end, dig, trm)

            store = self._idx[group]
            bit = 1 << replica
            if new_from < end:
                # bulk-convert once: per-element numpy scalar indexing
                # in this loop was the dominant audit host cost
                new_t = trm[new_from - start:].tolist()
                new_d = dig[new_from - start:].tolist()
                for i, g_idx in enumerate(range(new_from, end)):
                    t, d = new_t[i], new_d[i]
                    ent = store.get(g_idx)
                    if ent is None:
                        store[g_idx] = [t, d, bit]
                    elif ent[0] == t and ent[1] == d:
                        ent[2] |= bit
                    else:
                        self._diverge(
                            group, g_idx, step, mode="replica",
                            got=(t, d), got_replicas=[replica],
                            expected=(ent[0], ent[1]),
                            expected_replicas=_mask_bits(ent[2]))
                        # the divergent replica's bit is deliberately
                        # NOT OR'd in: ent's mask means "replicas
                        # holding THIS digest" — polluting it would
                        # point dump/merge-based repair at the wrong
                        # replica set
                self.indices_checked += end - new_from
                if backfill:
                    self.backfilled += end - new_from
            if end - 1 > self._max[group]:
                self._max[group] = end - 1
            if len(store) > 2 * self.history:
                cut = self._max[group] - self.history
                for stale in [k for k in store if k < cut]:
                    del store[stale]

    def _diverge(self, group: int, index: int, step, *, mode: str,
                 got, got_replicas, expected, expected_replicas) -> None:
        fkey = (group, index)
        if fkey in self._flagged:
            return
        if len(self.findings) >= self.MAX_FINDINGS:
            self.findings_dropped += 1
            return
        self._flagged.add(fkey)
        finding = dict(
            type="DIVERGENCE", mode=mode, group=int(group),
            index=int(index), term=int(expected[0]),
            expected_digest=int(expected[1]),
            expected_replicas=list(expected_replicas),
            got_term=int(got[0]), got_digest=int(got[1]),
            got_replicas=list(got_replicas),
            step=(int(step) if step is not None else None))
        self.findings.append(finding)
        if self.obs is not None:
            from rdma_paxos_tpu_torch.obs import trace as _trace
            self.obs.metrics.inc("audit_divergence_total", group=group)
            self.obs.trace.record(
                _trace.AUDIT_DIVERGENCE,
                **{k: v for k, v in finding.items() if k != "type"})

    def _epoch_mismatch(self, group: int, replica: int, epoch: int,
                        step) -> None:
        """A window computed under a DIFFERENT digest layout was
        offered: refuse comparison with a distinct finding (once per
        (group, replica, epoch)) — a layout upgrade in progress must
        never read as state divergence."""
        key = (int(group), int(replica), int(epoch))
        with self._lock:
            if key in self._epoch_flagged:
                return
            if len(self.findings) >= self.MAX_FINDINGS:
                self.findings_dropped += 1
                return
            self._epoch_flagged.add(key)
            finding = dict(
                type="EPOCH_MISMATCH", group=int(group), index=-1,
                replica=int(replica),
                expected_epoch=self.digest_epoch, got_epoch=int(epoch),
                step=(int(step) if step is not None else None))
            self.findings.append(finding)
        if self.obs is not None:
            from rdma_paxos_tpu_torch.obs import trace as _trace
            self.obs.metrics.inc("audit_epoch_mismatch_total",
                                 group=group)
            self.obs.trace.record(
                _trace.AUDIT_EPOCH_MISMATCH,
                **{k: v for k, v in finding.items() if k != "type"})

    # ---------------- repair surface (runtime/repair.py) ----------------

    def digest_at(self, group: int, index: int) -> Optional[Tuple]:
        """``(term, digest, replica_bitmask)`` the store holds for the
        absolute ``index`` of ``group`` (the mask = replicas holding
        THIS digest), or None when not retained."""
        with self._lock:
            ent = self._idx[group].get(int(index))
            return None if ent is None else (int(ent[0]), int(ent[1]),
                                             int(ent[2]))

    def digest_range(self, group: int, lo: int,
                     hi: int) -> List[Optional[Tuple]]:
        """Bulk form of :meth:`digest_at` over absolute ``[lo, hi)``
        — ONE lock acquisition for the whole slice (snapshot
        verification walks up to n_slots indices per donor attempt;
        per-index locking would contend with the readback thread's
        live window recording for the entire walk)."""
        with self._lock:
            store = self._idx[group]
            return [
                (None if ent is None
                 else (int(ent[0]), int(ent[1]), int(ent[2])))
                for ent in (store.get(i)
                            for i in range(int(lo), int(hi)))]

    @property
    def majority(self) -> int:
        return self.R // 2 + 1

    def implicated_replicas(self, group: int = 0) -> set:
        """Replicas named on the DIVERGING side of any unrepaired
        DIVERGENCE finding of ``group`` — the minority set the repair
        pipeline quarantines, and the set donor selection must NEVER
        draw from."""
        with self._lock:
            out: set = set()
            for f in self.findings:
                if (f.get("type") == "DIVERGENCE"
                        and f["group"] == group
                        and not f.get("repaired")):
                    out.update(f["got_replicas"])
            return out

    def coverage(self, group: int, lo: int, hi: int) -> dict:
        """Audit coverage over absolute ``[lo, hi)`` of ``group``:
        ``ok`` iff every index is retained in the store AND held by a
        replica majority — the repair pipeline's 'fully audited again'
        acceptance check after a range-digest backfill."""
        lo, hi = int(lo), int(hi)
        maj = self.majority
        missing: List[int] = []
        minority: List[int] = []
        with self._lock:
            store = self._idx[group]
            for i in range(lo, hi):
                ent = store.get(i)
                if ent is None:
                    missing.append(i)
                elif bin(int(ent[2])).count("1") < maj:
                    minority.append(i)
        return dict(ok=not missing and not minority, lo=lo, hi=hi,
                    checked=hi - lo, missing=missing[:16],
                    non_majority=minority[:16])

    def reset_replica(self, group: int, replica: int) -> None:
        """Forget ``replica``'s last reported window (snapshot
        re-install rewrote its state: the next report legitimately
        disagrees with pre-repair memory and must not self-flag)."""
        with self._lock:
            self._lastwin.pop((group, replica), None)

    def mark_repaired(self, group: int, replica: int, lo: int, hi: int,
                      *, donor: int, index: int,
                      step: Optional[int] = None) -> dict:
        """Record a completed digest-verified repair of ``replica``
        (re-installed from ``donor``'s snapshot at determinant
        ``index``; ledger coverage backfilled over absolute ``[lo,
        hi)``) and mark every DIVERGENCE finding the repair covers
        ``repaired`` — the CLI report exits 0 once every divergence is
        repaired + backfilled."""
        rec = dict(group=int(group), replica=int(replica), lo=int(lo),
                   hi=int(hi), donor=int(donor), index=int(index),
                   step=(int(step) if step is not None else None))
        with self._lock:
            self.repairs.append(rec)
            for f in self.findings:
                if (f.get("type") == "DIVERGENCE"
                        and f["group"] == rec["group"]
                        and not f.get("repaired")
                        and _finding_closed(f, self.repairs)):
                    f["repaired"] = True
                    # re-arm detection at the closed index: the
                    # repaired replica holds NEW verified state there,
                    # so a LATER re-divergence (bad DRAM re-flipping
                    # the slot, a regressed-frontier re-report) must
                    # raise a fresh finding — not vanish into the
                    # dedup of a closed incident
                    self._flagged.discard((f["group"], f["index"]))
        return rec

    # ---------------- queries / export ----------------

    def first_divergence(self, group: Optional[int] = None
                         ) -> Optional[dict]:
        """The DIVERGENCE finding with the smallest ``(group, index)``
        — the first point the replicas stopped agreeing
        (EPOCH_MISMATCH findings are config refusals, not state
        divergence, and are excluded)."""
        cand = [f for f in self.findings
                if f.get("type", "DIVERGENCE") == "DIVERGENCE"
                and (group is None or f["group"] == group)]
        if not cand:
            return None
        return min(cand, key=lambda f: (f["group"], f["index"]))

    def summary(self) -> dict:
        """Deterministic (no wall clock) counters for health snapshots
        and chaos verdicts."""
        with self._lock:
            unrepaired = sum(
                1 for f in self.findings
                if f.get("type", "DIVERGENCE") != "DIVERGENCE"
                or not f.get("repaired"))
            return dict(
                n_replicas=self.R, n_groups=self.G,
                digest_epoch=self.digest_epoch,
                windows=self.windows,
                indices_checked=self.indices_checked,
                backfilled=self.backfilled,
                tracked=sum(len(s) for s in self._idx),
                findings=len(self.findings),
                findings_dropped=self.findings_dropped,
                repairs=len(self.repairs),
                unrepaired=unrepaired,
                first=self.first_divergence())

    def dump(self) -> dict:
        """Full ledger export: the retained per-index digest map (with
        replica masks) per group, plus every finding — the per-replica
        document the CLI merges across hosts."""
        with self._lock:
            groups = [dict(group=g, max_index=self._max[g],
                           indices={str(i): [int(e[0]), int(e[1]),
                                             int(e[2])]
                                    for i, e in sorted(
                                        self._idx[g].items())})
                      for g in range(self.G)]
            return dict(schema=_SCHEMA, kind="audit_ledger",
                        anchor=clock_anchor(),
                        n_replicas=self.R, n_groups=self.G,
                        digest_epoch=self.digest_epoch,
                        windows=self.windows,
                        indices_checked=self.indices_checked,
                        backfilled=self.backfilled,
                        findings=[dict(f) for f in self.findings],
                        findings_dropped=self.findings_dropped,
                        repairs=[dict(r) for r in self.repairs],
                        groups=groups)

    def write_json(self, path: str) -> str:
        """Atomic (tmp + rename) dump — the NodeDaemon's cadenced
        per-replica audit file."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.dump(), f, indent=2)
        os.replace(tmp, path)
        return path


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def _to_plain(obj):
    """Recursive numpy/bytes→JSON conversion, applied at DUMP time
    only — the hot loop records raw arrays and payload bytes so a ring
    entry costs no per-value Python (measured: eager int/hex
    conversion was the dominant share of audit overhead)."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, (bytes, bytearray)):
        return obj.hex()
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(x) for x in obj]
    return obj


class FlightRecorder:
    """Bounded ring of the last N step records (inputs, outputs, digest
    heads) — the evidence window an audit artifact ships when an alert
    fires. Entry values may be numpy arrays/scalars; conversion to
    plain JSON data happens at :meth:`dump`, never in the record path.
    The ring holds the most recent ``capacity`` entries."""

    def __init__(self, capacity: int = 64):
        self.capacity = int(capacity)
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def record(self, entry: dict) -> None:
        with self._lock:
            self._ring.append(entry)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def dump(self) -> dict:
        with self._lock:
            steps = [_to_plain(e) for e in self._ring]
        return dict(schema=_SCHEMA, kind="flight",
                    capacity=self.capacity, anchor=clock_anchor(),
                    steps=steps)


# ---------------------------------------------------------------------------
# audit artifacts (chaos/artifact.py conventions: one atomic JSON with
# everything a post-mortem needs)
# ---------------------------------------------------------------------------

def write_audit_artifact(path: Optional[str] = None, *, reason: str,
                         ledger: Optional[AuditLedger] = None,
                         flight: Optional[FlightRecorder] = None,
                         obs=None, config: Optional[dict] = None,
                         extra: Optional[dict] = None) -> str:
    """Persist a self-contained audit artifact (atomic tmp + rename):
    ledger dump + flight-recorder ring + obs trace/metrics. Returns
    the path (auto-generated under the system temp dir when None)."""
    doc = dict(
        schema=_SCHEMA, kind="audit_artifact", reason=reason,
        anchor=clock_anchor(), config=config or {},
        audit=(ledger.dump() if ledger is not None else None),
        flight=(flight.dump() if flight is not None else None),
        trace=(obs.trace.dump() if obs is not None else None),
        metrics=(obs.metrics.snapshot() if obs is not None else None),
        extra=extra or {},
    )
    if path is None:
        fd, path = tempfile.mkstemp(prefix="audit_dump_", suffix=".json")
        os.close(fd)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2)
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# merge + first-divergence report (multi-host dumps)
# ---------------------------------------------------------------------------

def _as_ledger_dumps(doc: dict, source: str) -> List[dict]:
    """Normalize any supported document into ledger-dump dicts: a raw
    AuditLedger dump, an audit artifact, or a chaos reproducer with an
    embedded audit dump."""
    if doc.get("kind") == "audit_ledger" or "groups" in doc:
        return [doc]
    if doc.get("kind") == "audit_artifact" and doc.get("audit"):
        return [doc["audit"]]
    if isinstance(doc.get("extra"), dict) and doc["extra"].get("audit"):
        return [doc["extra"]["audit"]]
    raise SystemExit(f"{source}: not an audit dump, audit artifact, or "
                     "reproducer with an embedded audit dump")


def merge_dumps(dumps: Sequence[dict]) -> dict:
    """Merge per-replica ledger dumps (e.g. one per NodeDaemon) into
    one report: each host's own findings are unioned (a ``repaired``
    flag from ANY dump wins — repair closure propagates), then shared
    absolute indices are cross-compared ACROSS dumps — the multi-host
    equivalent of the in-process ledger's cross-replica check.

    Dumps stamped with DIFFERENT digest-layout epochs are never
    cross-compared: the comparison runs within each epoch cohort, and
    one ``EPOCH_MISMATCH`` finding names the epochs seen (a rolling
    layout upgrade must read as 'incomparable', never as a false
    DIVERGENCE)."""
    findings: List[dict] = []
    flagged: Dict[tuple, dict] = {}
    repairs: List[dict] = []
    for doc in dumps:
        for f in doc.get("findings", []):
            # the union key carries the detection step too: a closed
            # incident and a LATER re-divergence at the same index are
            # distinct findings and must both survive the merge
            k = (f.get("type", "DIVERGENCE"), f.get("group", 0),
                 f["index"], f.get("step"))
            prev = flagged.get(k)
            if prev is None:
                prev = dict(f)
                flagged[k] = prev
                findings.append(prev)
            elif f.get("repaired") and not prev.get("repaired"):
                prev["repaired"] = True
        for r in doc.get("repairs", []):
            repairs.append(dict(r))
    # repair records from any dump close matching findings everywhere
    # — every replica on the diverging side must be covered, so a
    # multi-replica merge finding stays open until ALL of them healed
    for f in findings:
        if f.get("type", "DIVERGENCE") != "DIVERGENCE" \
                or f.get("repaired"):
            continue
        if _finding_closed(f, repairs):
            f["repaired"] = True
    # indices already carrying a host-reported DIVERGENCE finding —
    # the cross-dump comparison must not duplicate them
    seen_idx = {(f.get("group", 0), f["index"]) for f in findings
                if f.get("type", "DIVERGENCE") == "DIVERGENCE"}
    epochs = sorted({int(doc.get("digest_epoch", DIGEST_EPOCH))
                     for doc in dumps})
    if len(epochs) > 1:
        findings.append(dict(
            type="EPOCH_MISMATCH", group=-1, index=-1, replica=-1,
            expected_epoch=epochs[0], got_epoch=epochs[-1],
            epochs=epochs, step=None))
    indices = 0
    for epoch in epochs:
        cohort = [doc for doc in dumps
                  if int(doc.get("digest_epoch", DIGEST_EPOCH))
                  == epoch]
        by_group: Dict[int, Dict[int, list]] = {}
        for doc in cohort:
            for gdoc in doc.get("groups", []):
                tgt = by_group.setdefault(int(gdoc["group"]), {})
                for idx, (t, d, m) in gdoc["indices"].items():
                    tgt.setdefault(int(idx), []).append(
                        (int(t), int(d), int(m)))
        for g, idxmap in sorted(by_group.items()):
            for i, rows in sorted(idxmap.items()):
                indices += 1
                if len({(t, d) for (t, d, _m) in rows}) > 1 \
                        and (g, i) not in seen_idx:
                    exp = rows[0]
                    bad = next(r for r in rows
                               if (r[0], r[1]) != (exp[0], exp[1]))
                    f = dict(
                        type="DIVERGENCE", mode="merge", group=g,
                        index=i, term=exp[0], expected_digest=exp[1],
                        expected_replicas=_mask_bits(exp[2]),
                        got_term=bad[0], got_digest=bad[1],
                        got_replicas=_mask_bits(bad[2]), step=None)
                    seen_idx.add((g, i))
                    findings.append(f)
    # DIVERGENCE findings first (EPOCH_MISMATCH carries index -1 and
    # must not shadow the first real divergence)
    findings.sort(key=lambda f: (f.get("type", "DIVERGENCE")
                                 != "DIVERGENCE",
                                 f.get("group", 0), f["index"]))
    unrepaired = [f for f in findings
                  if f.get("type", "DIVERGENCE") != "DIVERGENCE"
                  or not f.get("repaired")]
    return dict(schema=_SCHEMA, kind="audit_report", dumps=len(dumps),
                indices=indices, findings=findings, repairs=repairs,
                unrepaired=len(unrepaired),
                first=(findings[0] if findings else None))


def format_report(report: dict) -> str:
    lines = [f"audit report: {report['dumps']} dump(s), "
             f"{report['indices']} indices compared, "
             f"{len(report['findings'])} finding(s)"]
    first = report.get("first")
    if first is None:
        lines.append("no divergence: all reported digests agree")
    elif first.get("type", "DIVERGENCE") != "DIVERGENCE":
        lines.append(
            "EPOCH MISMATCH: digest layout epochs %s are incomparable "
            "— finish the rolling digest upgrade before comparing"
            % (first.get("epochs",
                         [first.get("expected_epoch"),
                          first.get("got_epoch")]),))
    else:
        lines.append(
            "FIRST DIVERGENCE: group %d index %d term %d — expected "
            "digest 0x%08x (replicas %s) got 0x%08x (term %d, replicas "
            "%s) [%s]%s" % (
                first.get("group", 0), first["index"], first["term"],
                first["expected_digest"], first["expected_replicas"],
                first["got_digest"], first["got_term"],
                first["got_replicas"], first.get("mode", "?"),
                " — REPAIRED" if first.get("repaired") else ""))
        for f in report["findings"][1:6]:
            if f.get("type", "DIVERGENCE") != "DIVERGENCE":
                continue
            lines.append("  also: group %d index %d (0x%08x vs 0x%08x)%s"
                         % (f.get("group", 0), f["index"],
                            f["expected_digest"], f["got_digest"],
                            " — repaired" if f.get("repaired") else ""))
        if len(report["findings"]) > 6:
            lines.append(f"  ... {len(report['findings']) - 6} more")
    # repair-status section: the self-healing loop's closure evidence
    repairs = report.get("repairs", [])
    if repairs:
        lines.append("repair status: %d repair(s), %d unrepaired "
                     "finding(s)" % (len(repairs),
                                     report.get("unrepaired", 0)))
        for r in repairs[:8]:
            lines.append(
                "  repaired: group %d replica %d re-installed from "
                "donor %d at index %d, backfilled [%d, %d)%s"
                % (r["group"], r["replica"], r["donor"], r["index"],
                   r["lo"], r["hi"],
                   (" @ step %d" % r["step"])
                   if r.get("step") is not None else ""))
        if report.get("unrepaired", 0) == 0 and report["findings"]:
            lines.append("  all divergences repaired + backfilled "
                         "(exit 0)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _load(paths: Sequence[str]) -> List[dict]:
    dumps: List[dict] = []
    for p in paths:
        with open(p) as f:
            doc = json.load(f)
        dumps.extend(_as_ledger_dumps(doc, p))
    return dumps


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rdma_paxos_tpu_torch.obs.audit",
        description="Merge per-replica audit dumps and print the "
                    "first-divergence report.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("report", help="print the merged "
                        "first-divergence report (exit 1 on divergence)")
    rp.add_argument("files", nargs="+",
                    help="audit dumps / audit artifacts / reproducers")
    mp = sub.add_parser("merge", help="write the merged report JSON")
    mp.add_argument("files", nargs="+")
    mp.add_argument("-o", "--out", required=True)
    args = ap.parse_args(argv)

    report = merge_dumps(_load(args.files))
    if args.cmd == "merge":
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.out}: {len(report['findings'])} finding(s) "
              f"over {report['indices']} indices from "
              f"{report['dumps']} dump(s)")
    else:
        print(format_report(report))
    # a past divergence that is marked repaired + backfilled is a
    # CLOSED incident: the report exits clean (the self-healing loop's
    # CI contract); anything unrepaired — or any epoch mismatch —
    # still fails the check
    return 1 if report["unrepaired"] else 0


if __name__ == "__main__":
    sys.exit(main())
