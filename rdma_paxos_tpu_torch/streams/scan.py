"""Ordered range scans with consistent-cut pagination.

The port's copy of the JAX package's ``streams/scan.py``.

A scan rides the ReadHub (``runtime/reads.py``): ONE batched
read-index confirm per page (lease-served when the replica holds a
valid lease), then the page is computed at the linearization point —
on the readback thread, from the host-side key index this module folds
out of the committed stream. The first page pins a **consistent cut**: the stream position
at serve time (failover-stable — the committed prefix never shrinks
and rebases renumber slots, not stream entries), named in the token
by the log's own ``(term, index)`` coordinates. Every later page
resolves values AS OF that cut, so pagination never tears across a
leader failover: a key overwritten or deleted mid-scan still pages
out with its at-cut value via the MVCC-lite undo log recorded while
the pin is active.

Pins expire after ``pin_steps`` finished engine steps (an abandoned
scan must not grow the undo log forever); an expired token is an
explicit ``token-expired`` error — restart the scan — never a silent
tear.

Host-pure; all shared state is guarded by the manager's ``_slock``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from rdma_paxos_tpu_torch.streams.tail import (
    DedupFold, GroupTail, OP_PUT, OP_RM, decode_kvs)

_MISSING = None     # "absent at the cut" sentinel in undo entries


class TokenExpired(RuntimeError):
    """The scan token's cut pin lapsed (pin_steps elapsed) — the
    at-cut values are gone; restart the scan."""


def key_range(prefix: Optional[bytes] = None,
              lo: Optional[bytes] = None,
              hi: Optional[bytes] = None
              ) -> Tuple[bytes, Optional[bytes]]:
    """Normalize ``prefix`` | ``[lo, hi)`` into ``(lo, hi)`` bounds
    (``hi`` None = +inf). A prefix becomes its tight byte range."""
    if prefix is not None:
        if lo is not None or hi is not None:
            raise ValueError("prefix and lo/hi are exclusive")
        lo = bytes(prefix)
        p = bytearray(prefix)
        while p and p[-1] == 0xFF:
            p.pop()
        if p:
            p[-1] += 1
            hi = bytes(p)
        else:
            hi = None           # prefix of all 0xFF: unbounded above
        return lo, hi
    return (b"" if lo is None else bytes(lo),
            None if hi is None else bytes(hi))


def groups_for_range(router, lo: bytes,
                     hi: Optional[bytes]) -> Optional[List[int]]:
    """Router-aware fan-out narrowing: when a single range override
    fully covers ``[lo, hi)``, only that group can hold keys in the
    range; otherwise the hash ring scatters — every group serves.
    None = all groups (no router)."""
    if router is None:
        return None
    for rule in getattr(router, "overrides", ()):
        if lo >= rule.lo and (rule.hi is None
                              or (hi is not None and hi <= rule.hi)):
            return [rule.group]
    return list(range(router.n_groups))


class _GroupScanIndex:
    """One group's host-side sorted-key fold of the committed stream,
    plus the MVCC-lite undo log for pinned cuts. All access under the
    owning :class:`ScanManager`'s ``_slock`` (methods are ``_locked``
    by the lock-discipline convention)."""

    def __init__(self, tail: GroupTail):
        self.tail = tail
        self.vals: Dict[bytes, bytes] = {}
        self.fold = DedupFold()
        self.pos = 0                   # stream position folded through
        self.coord = (-1, -1)          # (term, index) at self.pos
        # undo log: key -> [(pos, prior_value_or_None)...] ascending,
        # recorded for every mutation applied while ANY pin is active
        self.undo: Dict[bytes, List[tuple]] = {}
        self.pins: Dict[int, int] = {}   # cut_pos -> expiry step

    def catch_up_locked(self) -> None:
        """Fold new committed records into the key index (records the
        undo entry for each mutation while pins are active)."""
        recs = self.tail.records(self.pos)
        pinned = bool(self.pins)
        for rec in recs:
            if rec.index >= 0:
                self.coord = (rec.term, rec.index)
            self.pos = rec.pos + 1
            if not self.fold.accept(rec):
                continue
            cmd = decode_kvs(rec.payload)
            if cmd is None:
                continue
            op, key, val = cmd
            if op == OP_PUT:
                if pinned:
                    self.undo.setdefault(key, []).append(
                        (rec.pos, self.vals.get(key, _MISSING)))
                self.vals[key] = val
            elif op == OP_RM and key in self.vals:
                if pinned:
                    self.undo.setdefault(key, []).append(
                        (rec.pos, self.vals[key]))
                del self.vals[key]

    def resolve_locked(self, key: bytes,
                       cut_pos: int) -> Optional[bytes]:
        """The value of ``key`` AS OF the cut: the prior value of the
        first recorded mutation past the cut, else the current value.
        Correct because the cut's pin was registered before any
        record past ``cut_pos`` was folded, so every later mutation
        has an undo entry."""
        for pos, prior in self.undo.get(key, ()):
            if pos >= cut_pos:
                return prior
        return self.vals.get(key, _MISSING)

    def page_locked(self, lo: bytes, hi: Optional[bytes],
                    after: Optional[bytes], limit: int,
                    cut_pos: int) -> List[Tuple[bytes, bytes]]:
        """Up to ``limit`` ``(key, at-cut value)`` pairs in key order,
        strictly after ``after``. Candidates include undo-only keys —
        a key deleted after the cut still existed AT the cut."""
        cands = set(self.vals)
        cands.update(self.undo)
        out: List[Tuple[bytes, bytes]] = []
        for key in sorted(cands):
            if key < lo or (hi is not None and key >= hi):
                continue
            if after is not None and key <= after:
                continue
            val = self.resolve_locked(key, cut_pos)
            if val is _MISSING:
                continue
            out.append((key, val))
            if len(out) >= limit:
                break
        return out

    def gc_locked(self) -> None:
        if not self.pins:
            self.undo.clear()
            return
        floor = min(self.pins)
        for key in list(self.undo):
            kept = [e for e in self.undo[key] if e[0] >= floor]
            if kept:
                self.undo[key] = kept
            else:
                del self.undo[key]


class ScanManager:
    """Per-group scan indexes + cut-pin lifecycle. Folding happens
    ONLY on scan serves (zero steady-state cost when nobody scans);
    pin expiry ticks on the hub's per-step observe."""

    def __init__(self, tails: List[GroupTail], *,
                 pin_steps: int = 512, obs=None):
        self.pin_steps = int(pin_steps)
        self.obs = obs
        self._slock = threading.Lock()
        # guarded-by: _slock
        self._sidx: Dict[int, _GroupScanIndex] = {
            t.group: _GroupScanIndex(t) for t in tails}
        self._sstep = 0       # guarded-by: _slock
        self.pages_served = 0     # guarded-by: _slock
        self.pins_expired = 0     # guarded-by: _slock
        from rdma_paxos_tpu_torch.analysis import runtime_guard
        runtime_guard.maybe_guard(self, "_slock", __file__)

    def on_step(self) -> None:
        """Pin-expiry tick (engine finish() tail, readback thread)."""
        with self._slock:
            self._sstep += 1
            step = self._sstep
            for idx in self._sidx.values():
                expired = [c for c, dl in idx.pins.items()
                           if dl <= step]
                for c in expired:
                    del idx.pins[c]
                    self.pins_expired += 1
                if expired:
                    idx.gc_locked()

    def pin_count(self) -> int:
        with self._slock:
            return sum(len(i.pins) for i in self._sidx.values())

    def serve_page(self, group: int, lo: bytes, hi: Optional[bytes],
                   after: Optional[bytes], limit: int,
                   cut_pos: Optional[int], kvs=None) -> dict:
        """ONE page at the linearization point (ReadHub serve
        callback, readback thread). ``cut_pos`` None = first page:
        pin a fresh cut at the current stream end. Returns
        ``{items, cut, term, index, done}`` or ``{error}``."""
        with self._slock:
            idx = self._sidx[group]
            if cut_pos is None:
                # pin BEFORE folding: every record folded past the
                # cut must leave an undo entry for resolve()
                cut_pos = idx.tail.length()
                idx.pins[cut_pos] = self._sstep + self.pin_steps
            elif cut_pos not in idx.pins:
                return dict(error="token-expired")
            else:
                idx.pins[cut_pos] = self._sstep + self.pin_steps
            idx.catch_up_locked()
            items = idx.page_locked(lo, hi, after, limit, cut_pos)
            if kvs is not None and items:
                # serve values through the tiered device dispatch for
                # keys NOT mutated past the cut (their at-cut value is
                # the current applied value); post-cut-mutated keys
                # keep the host-resolved at-cut value
                plain = [k for k, _ in items if k not in idx.undo]
                if plain:
                    got = self._device_vals(kvs, group, plain)
                    if got is not None:
                        merged = dict(items)
                        for k, v in zip(plain, got):
                            if v is not None:
                                merged[k] = v
                        items = sorted(merged.items())
            # done = this group has nothing past this page; the HUB
            # releases the pin once the whole (possibly multi-group)
            # scan completes — a short page here may still be
            # re-queried after a cross-group merge
            done = len(items) < limit
            self.pages_served += 1
            term, index = idx.coord
            if self.obs is not None:
                self.obs.metrics.inc("scan_pages_total", group=group)
            return dict(items=items, cut=cut_pos, term=term,
                        index=index, done=done)

    def _device_vals(self, kvs, group: int, keys: List[bytes]):
        """Batched values via ``ReplicatedKVS.get_many`` at the
        group's serving replica; None on any failure (host values are
        always a correct fallback)."""
        try:
            kv = kvs.groups[group] if hasattr(kvs, "groups") else kvs
            lm = getattr(kv.c, "leases", None)
            rep = -1
            if lm is not None:
                rep = lm.serving_holder(getattr(kv, "group", 0) or 0)
            if rep is None or rep < 0:
                rep = 0
            return kv.get_many(rep, keys)
        except Exception:  # noqa: BLE001 — fallback, never fail serve
            return None

    def release(self, group: int, cut_pos: int) -> None:
        with self._slock:
            idx = self._sidx.get(group)
            if idx is not None and idx.pins.pop(cut_pos, None) \
                    is not None:
                idx.gc_locked()

    def status(self) -> dict:
        with self._slock:
            return dict(
                pages_served=self.pages_served,
                pins_expired=self.pins_expired,
                pins={g: sorted(i.pins) for g, i in
                      self._sidx.items() if i.pins},
                folded={g: i.pos for g, i in self._sidx.items()})
