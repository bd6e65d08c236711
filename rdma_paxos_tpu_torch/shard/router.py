"""Deterministic key→group routing for the sharded multi-group cluster
(a copy of the JAX package's router, which imports no JAX: both
packages must route every key alike, so this copy keeps its constants,
its hash and its serialized form; the port's tests hold it against the
original and ``tests/golden/router_map.json``).

The reference scales by running one consensus group per application;
the sharded layer partitions ONE application's keyspace across many
independent groups instead (the way reconfigurable commit protocols
shard state across replica groups — PAPERS.md, arXiv:1906.01365). The
router is the contract every client, proxy, and operator tool must
agree on, so it is built from primitives that are stable across
process restarts, machines, and Python versions:

* a **hash ring**: each of the ``n_groups`` groups owns ``vnodes``
  points on a 32-bit ring, placed by :func:`ring_hash` (FNV-1a mixed
  through the Murmur3 finalizer — never Python's salted ``hash()``)
  over a canonical label; a key routes to the successor point of its
  own :func:`ring_hash`. The group COUNT stays fixed (G is baked into
  the compiled dispatch); elastic split/merge (``topology/``)
  reshapes routing by installing/removing override rules through the
  mutation surface below, bumping ``version`` at each cutover.
* an explicit **range-override table**: ordered ``(lo, hi, group)``
  rules on raw key bytes (``lo <= key < hi``, lexicographic;
  ``hi=None`` = unbounded). First matching rule wins and overrides
  take precedence over the ring — the operator's escape hatch for hot
  ranges, locality pinning, and migration staging.

Keys are raw bytes; ``str`` keys are accepted and canonicalized as
UTF-8. The empty key is a valid key (it hashes to the FNV offset
basis). The full routing table serializes to a plain dict
(:meth:`KeyRouter.to_dict`) that rides the sharded cluster's health
snapshots, so any observer can reconstruct the exact mapping without
importing this module's code — and ``tests/golden/router_map.json``
pins the mapping across releases.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple, Union

KeyLike = Union[bytes, bytearray, str]

_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 0x01000193


def fnv1a32(data: bytes) -> int:
    """32-bit FNV-1a — stable by construction (pure arithmetic over
    bytes), unlike Python's per-process-salted ``hash``; golden-file
    tested across restarts."""
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & 0xFFFFFFFF
    return h


def _fmix32(h: int) -> int:
    """Murmur3's 32-bit finalizer. Raw FNV-1a has weak avalanche in
    the high bits — sequential keys (``k0``, ``k1``, ...) cluster on
    the ring and skew group load badly; one finalizer round spreads
    them. Pure arithmetic, restart-stable."""
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def ring_hash(data: bytes) -> int:
    """The router's placement hash: FNV-1a mixed through the Murmur3
    finalizer — used for both ring points and keys."""
    return _fmix32(fnv1a32(data))


def canon_key(key: KeyLike) -> bytes:
    """Canonical key bytes: bytes pass through, ``str`` encodes UTF-8.
    The empty key is legal (it routes like any other)."""
    if isinstance(key, str):
        return key.encode("utf-8")
    if isinstance(key, (bytes, bytearray)):
        return bytes(key)
    raise TypeError(f"key must be bytes or str, not {type(key).__name__}")


class RangeRule:
    """One override: keys in ``[lo, hi)`` (byte-lexicographic; ``hi``
    ``None`` = +inf) route to ``group``, bypassing the ring."""

    __slots__ = ("lo", "hi", "group")

    def __init__(self, lo: KeyLike, hi: Optional[KeyLike], group: int):
        self.lo = canon_key(lo)
        self.hi = canon_key(hi) if hi is not None else None
        self.group = int(group)
        if self.hi is not None and self.hi <= self.lo:
            raise ValueError(f"empty range: lo={self.lo!r} hi={self.hi!r}")

    def matches(self, key: bytes) -> bool:
        return key >= self.lo and (self.hi is None or key < self.hi)

    def to_dict(self) -> dict:
        return dict(lo=self.lo.hex(),
                    hi=self.hi.hex() if self.hi is not None else None,
                    group=self.group)

    @classmethod
    def from_dict(cls, d: dict) -> "RangeRule":
        return cls(bytes.fromhex(d["lo"]),
                   bytes.fromhex(d["hi"]) if d["hi"] is not None else None,
                   d["group"])

    def __eq__(self, other) -> bool:
        return (isinstance(other, RangeRule) and self.lo == other.lo
                and self.hi == other.hi and self.group == other.group)

    def __hash__(self) -> int:
        return hash((self.lo, self.hi, self.group))

    def __repr__(self) -> str:
        return f"RangeRule({self.lo!r}, {self.hi!r}, {self.group})"


class KeyRouter:
    """Hash-ring + range-override key→group mapping (see module doc).

    Deterministic: ``group_of`` is a pure function of (key, n_groups,
    vnodes, overrides). The override table is the ONE mutable part —
    ``install_rule``/``remove_rule`` swap the whole list atomically
    (one reference assignment; concurrent ``group_of`` readers see
    the old table or the new, never a partial edit) and bump
    ``version``, the monotone counter topology cutovers fence txn
    admissions and serialized snapshots against.
    """

    def __init__(self, n_groups: int, *, vnodes: int = 64,
                 overrides: Sequence[Union[RangeRule, tuple]] = ()):
        if n_groups < 1:
            raise ValueError("n_groups must be >= 1")
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.n_groups = int(n_groups)
        self.vnodes = int(vnodes)
        self.version = 0
        self.overrides: List[RangeRule] = [
            r if isinstance(r, RangeRule) else RangeRule(*r)
            for r in overrides]
        for r in self.overrides:
            if not (0 <= r.group < self.n_groups):
                raise ValueError(
                    f"override group {r.group} out of range "
                    f"[0, {self.n_groups})")
        # ring points: FNV-1a of a canonical label per (group, vnode).
        # A 32-bit collision between two groups' points is resolved by
        # the (point, group) sort order — deterministically, the lower
        # group id wins the shared point.
        ring: List[Tuple[int, int]] = []
        for g in range(self.n_groups):
            for v in range(self.vnodes):
                ring.append((ring_hash(b"group:%d:vnode:%d" % (g, v)), g))
        ring.sort()
        self._ring = ring
        self._points = [p for p, _ in ring]

    # ---------------- routing ----------------

    def group_of(self, key: KeyLike) -> int:
        """The group serving ``key``: first matching range override,
        else the ring successor of the key's hash (wrapping)."""
        kb = canon_key(key)
        for rule in self.overrides:
            if rule.matches(kb):
                return rule.group
        h = ring_hash(kb)
        i = bisect.bisect_left(self._points, h)
        if i == len(self._points):
            i = 0                           # wrap to the ring start
        return self._ring[i][1]

    # ---------------- mutation (topology transitions) ----------------

    def _coerce(self, rule: Union[RangeRule, tuple]) -> RangeRule:
        r = rule if isinstance(rule, RangeRule) else RangeRule(*rule)
        if not (0 <= r.group < self.n_groups):
            raise ValueError(
                f"override group {r.group} out of range "
                f"[0, {self.n_groups})")
        return r

    def with_rule(self, rule: Union[RangeRule, tuple]) -> "KeyRouter":
        """CANDIDATE router: this one plus ``rule`` PREPENDED (first
        match wins, so the new rule beats any older overlapping rule
        — same precedence ``install_rule`` later gives it). The
        transition window routes donor/target decisions by diffing
        this candidate against the live router; nothing serves it."""
        r = self._coerce(rule)
        return KeyRouter(self.n_groups, vnodes=self.vnodes,
                         overrides=[r] + list(self.overrides))

    def without_rule(self, rule: Union[RangeRule, tuple]) -> "KeyRouter":
        """CANDIDATE router with the first override equal to ``rule``
        dropped — the merge direction of :meth:`with_rule`."""
        r = self._coerce(rule)
        rest = list(self.overrides)
        rest.remove(r)             # ValueError if absent — caller bug
        return KeyRouter(self.n_groups, vnodes=self.vnodes,
                         overrides=rest)

    def install_rule(self, rule: Union[RangeRule, tuple]) -> int:
        """Cutover: prepend ``rule`` to the live table (atomic list
        swap) and bump ``version``. Returns the new version."""
        r = self._coerce(rule)
        self.overrides = [r] + list(self.overrides)
        self.version += 1
        return self.version

    def remove_rule(self, rule: Union[RangeRule, tuple]) -> int:
        """Cutover (merge direction): drop the first override equal to
        ``rule`` (atomic list swap) and bump ``version``."""
        r = self._coerce(rule)
        rest = list(self.overrides)
        rest.remove(r)             # ValueError if absent — caller bug
        self.overrides = rest
        self.version += 1
        return self.version

    # ---------------- serialization (health snapshots) ----------------

    def to_dict(self) -> dict:
        """Plain-data routing table for health snapshots and golden
        files: everything needed to reconstruct the mapping, plus a
        ring checksum so observers can verify agreement without
        rebuilding the ring."""
        ck = _FNV_OFFSET
        for p, g in self._ring:
            for b in p.to_bytes(4, "big") + bytes([g & 0xFF]):
                ck = ((ck ^ b) * _FNV_PRIME) & 0xFFFFFFFF
        return dict(schema=1, kind="hash_ring", n_groups=self.n_groups,
                    vnodes=self.vnodes, hash="fnv1a32+fmix32",
                    ring_checksum=ck, version=self.version,
                    overrides=[r.to_dict() for r in self.overrides])

    @classmethod
    def from_dict(cls, d: dict) -> "KeyRouter":
        if (d.get("kind") != "hash_ring"
                or d.get("hash") != "fnv1a32+fmix32"):
            raise ValueError(f"unknown router serialization: {d!r}")
        router = cls(d["n_groups"], vnodes=d["vnodes"],
                     overrides=[RangeRule.from_dict(o)
                                for o in d["overrides"]])
        want = d.get("ring_checksum")
        have = router.to_dict()["ring_checksum"]
        if want is not None and want != have:
            raise ValueError(
                f"router ring checksum mismatch: snapshot {want} != "
                f"rebuilt {have} (incompatible router versions?)")
        # pre-elastic snapshots carry no version — reconstruct as 0
        router.version = int(d.get("version", 0))
        return router

    def __repr__(self) -> str:
        return (f"KeyRouter(n_groups={self.n_groups}, "
                f"vnodes={self.vnodes}, "
                f"overrides={len(self.overrides)})")
